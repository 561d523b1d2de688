"""The port's legacy word-level tokenizer and timer against the JAX
package's: sentence splitting, the corpus vocabulary, reversed encoding with
left truncation, decoding and ``shrink`` (identical), and the timer's
averages and ``time_since`` under one fixed clock."""

import numpy as np
import pytest

from visitron_torch.data.legacy_tokenizer import (BASE_VOCAB, LegacyTokenizer,
                                                  build_legacy_vocab, split_sentence)
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.utils import Timer, time_since
from visitron_torch.utils import timer as ttimer
from visitron_tpu.data import legacy_tokenizer as jlt
from visitron_tpu.utils import timer as jtimer

SENTENCES = [
    "Hello, world!!",
    "go to the red lamp... then turn LEFT",
    "  walk past the sofa; stop at the door-frame (near 2nd table)  ",
    "",
    "is it the one with a 'blue' chair?",
]


@pytest.fixture(scope="module")
def items():
    return TWorld(seed=7, num_scans=2, viewpoints_per_scan=24,
                  scene_feat_dim=8).ndh_items("train", 40)


@pytest.mark.parametrize("sentence", SENTENCES)
def test_split_sentence_matches_jax(sentence):
    assert split_sentence(sentence) == jlt.split_sentence(sentence)


@pytest.mark.parametrize("min_count", [1, 3, 5])
def test_vocab_matches_jax(items, min_count):
    vocab = build_legacy_vocab(items, min_count=min_count)
    assert vocab == jlt.build_legacy_vocab(items, min_count=min_count)
    assert vocab[:6] == BASE_VOCAB
    assert {it["target"] for it in items} <= set(vocab)


@pytest.mark.parametrize("length", [8, 20, 80])
def test_encode_decode_shrink_match_jax(items, length):
    vocab = build_legacy_vocab(items, min_count=1)
    tok, jtok = LegacyTokenizer(vocab, length), jlt.LegacyTokenizer(vocab, length)
    assert tok.vocab_size() == jtok.vocab_size() == len(vocab) + 1  # + <BOS>
    for item in items[:10]:
        turns = [t["message"] for t in item["dialog_history"]]
        seps = ["<NAV>" if t["nav_idx"] % 2 == 0 else "<ORA>" for t in item["dialog_history"]]
        enc = tok.encode_sentence(turns, seps=seps)
        np.testing.assert_array_equal(enc, jtok.encode_sentence(turns, seps=seps))
        assert len(enc) == length
        assert tok.decode_sentence(enc) == jtok.decode_sentence(enc)
        bos = [tok.word_to_index("<BOS>")] + list(enc)
        assert tok.shrink(bos) == jtok.shrink(bos)
    enc = tok.encode_sentence("go to the zebra")  # an unknown word
    np.testing.assert_array_equal(enc, jtok.encode_sentence("go to the zebra"))
    assert tok.shrink([]) == []


def test_round_trip_and_left_truncation():
    items = [{"dialog_history": [{"message": "go to the red lamp"}], "target": "lamp"},
             {"dialog_history": [{"message": "go past the red door"}], "target": "door"}]
    tok = LegacyTokenizer(build_legacy_vocab(items, min_count=1), encoding_length=12)
    enc = tok.encode_sentence(["go to the red lamp"], seps=["<NAV>"])
    assert "go to the red lamp" in tok.decode_sentence(enc)
    assert tok.word_to_index("<EOS>") not in tok.shrink(list(enc))
    short = LegacyTokenizer(tok.vocab, encoding_length=3).encode_sentence("go to the red lamp")
    # Reversed input, cut on the left: the sentence's start and <EOS> stay.
    assert tok.decode_sentence(short) == "<EOS> go to"
    with pytest.raises(ValueError):
        tok.add_word("<BOS>")


def test_timer_and_time_since_match_jax(monkeypatch):
    got = []
    for cls in (Timer, jtimer.Timer):
        clock = iter([100.0, 101.5, 200.0, 204.5, 206.0])
        monkeypatch.setattr(ttimer.time, "time", lambda: next(clock))
        t = cls()
        t.tic()
        first = t.toc()
        t.tic()
        got.append((first, t.toc(), t.toc(average=False), t.count))
    assert got[0] == got[1] == (1.5, 3.0, 12.0, 3)
    monkeypatch.setattr(ttimer.time, "time", lambda: 725.0)
    assert time_since(600.0, 0.25) == jtimer.time_since(600.0, 0.25) == "2m 5s (- 6m 15s)"
    t = Timer()
    with pytest.raises(RuntimeError):
        t.toc()
    t.reset()
    assert t.count == 0 and t.cul_time == 0.0
