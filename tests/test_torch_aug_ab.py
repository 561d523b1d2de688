"""The back-translation A/B (visitron_torch.testing.aug_ab,
tools/torch_aug_ab.py) against the JAX tool (tools/aug_ab.py, whose module
level imports only numpy) and the JAX package on the CPU: ``parse_hops`` and
``caption_fidelity`` equal on the world's own sentences, on malformed and
truncated captions and on captions swapped between walks; the set-up's
instances and the oracle records (tools/aug_ab.py:221-243, repeated here)
equal; a tiny four-arm run logs the JAX tool's tags and keys in its order.

The ``slow`` case runs both tools at chip_smoke.py phase 45's settings and
holds the port's speaker, fidelity and loss ratios to the JAX run's within
the margins PERF.md states (about 20 min on the CPU)."""

import importlib.util
import json
import os
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch.testing import aug_ab
from visitron_tpu.agents import NavRuntime as JRuntime
from visitron_tpu.agents.speaker import SpeakerAgent as JSpeaker
from visitron_tpu.data import SceneFeatureTable as JTable
from visitron_tpu.data import WordPieceTokenizer as JTokenizer
from visitron_tpu.data import build_wordpiece_vocab as j_build_vocab
from visitron_tpu.data.datasets import build_nav_instances as j_build_nav_instances
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_WORLD = dict(num_scans=2, viewpoints_per_scan=12, scene_feat_dim=32)
TINY_BERT = dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                 intermediate_size=128)
# The JAX tool's lines: tag, then these keys, in this order.
KEYS = {"speaker": ["step", "word_ce"], "aug": ["records", "instances"],
        "fidelity": ["n", "parse", "exact", "hop_acc", "len_mae"],
        "train": ["step", "loss"], "val": ["gp", "sr", "spl", "ndtw"],
        "delta_aug_minus_baseline": ["gp", "sr", "spl", "ndtw"]}


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_aug_ab",
                                                  os.path.join(ROOT, "tools", "aug_ab.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


JTOOL = _jax_tool()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    """The tool's seed-13 world in both packages, with the JAX runtime, the
    tokenizer and instances of tools/aug_ab.py:169-183 (150 / 64 episodes,
    S 128) and the port's set-up."""
    jw = JWorld(**aug_ab.WORLD)
    table = JTable.pack(jw.graphs, jw.scene_features(), vfov=60)
    jrt = JRuntime.build(jw.graphs, table, device_dtype=jnp.bfloat16)
    tok = JTokenizer(j_build_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=1024))
    with tempfile.TemporaryDirectory() as d:
        jw.write_task_data(d, counts={"train": 150, "val_unseen": 64})
        train = j_build_nav_instances(d, ["train"], tok, max_seq_length=128)
        val = j_build_nav_instances(d, ["val_unseen"], tok, max_seq_length=128)
    return {"jax": jw, "jrt": jrt, "jtok": tok, "jtrain": train, "jval": val,
            "ab": aug_ab.setup(device="cpu")}


def _oracle_sentences(world, n=200, seed=0):
    """(record, sentence) of ``n`` shortest paths of ``world``, drawn with
    a generator of their own."""
    rng = np.random.default_rng(seed)
    out = []
    scans = sorted(world.graphs)
    while len(out) < n:
        scan = scans[rng.integers(len(scans))]
        g = world.graphs[scan]
        u, v = (int(x) for x in rng.integers(g.num_viewpoints, size=2))
        if u == v or not np.isfinite(g.dist[u, v]):
            continue
        path = g.shortest_path(u, v)
        heading = float(rng.uniform(0, 2 * np.pi))
        sentence = world._directional_sentence(g, [g.index[p] for p in path], heading)
        out.append(({"scan": scan, "path": path, "heading": heading,
                     "path_id": f"AUG_{len(out)}", "instructions": [sentence]}, sentence))
    return out


def test_parse_hops_equal_on_the_worlds_sentences(worlds):
    pairs = _oracle_sentences(worlds["jax"])
    port = _oracle_sentences(worlds["ab"].world)
    assert [s for _, s in port] == [s for _, s in pairs]
    for _, sentence in pairs:
        hops = aug_ab.parse_hops(sentence)
        assert hops is not None and hops == JTOOL.parse_hops(sentence), sentence


def test_parse_hops_equal_on_malformed_and_truncated_captions(worlds):
    rng = np.random.default_rng(1)
    texts = ["", "go", "stop there", "go stop there", "go straight", "go straight then",
             "go then", "go turn", "go turn up", "turn left then stop there",
             "go straight straight then turn around stop", "go turn left then turn",
             "go straight then stop there there", "Go straight stop there",
             "go  turn   right then stop there"]
    for _, sentence in _oracle_sentences(worlds["jax"], n=40):
        words = sentence.split()
        texts += [" ".join(words[:k]) for k in range(len(words) + 1)]
        texts += [" ".join(words[k:]) for k in range(1, len(words))]
        texts.append(" ".join(rng.permutation(words)))
    texts += [" ".join(rng.choice(list(_WORDS) + ["go", "turn", "left", "then"], size=k))
              for k in rng.integers(1, 12, size=100)]
    results = [(aug_ab.parse_hops(t), JTOOL.parse_hops(t)) for t in texts]
    assert all(p == j for p, j in results)
    assert sum(p is None for p, _ in results) > 100  # malformed ones are refused


@pytest.mark.parametrize("swap", ["none", "rotated", "malformed", "truncated"])
def test_caption_fidelity_equal(worlds, swap):
    """Records with their own captions, with captions moved one walk on,
    with every third caption malformed, and with captions cut short."""
    jrecs = [r for r, _ in _oracle_sentences(worlds["jax"], n=120, seed=2)]
    caps = [r["instructions"][0] for r in jrecs]
    if swap == "rotated":
        caps = caps[1:] + caps[:1]
    elif swap == "malformed":
        caps = [c if i % 3 else "go up then " + c for i, c in enumerate(caps)]
    elif swap == "truncated":
        caps = [" ".join(c.split()[:1 + i % 7]) for i, c in enumerate(caps)]
    recs = [{**r, "instructions": [c]} for r, c in zip(jrecs, caps)]
    want = JTOOL.caption_fidelity(recs, worlds["jax"], worlds["jrt"])
    got = aug_ab.caption_fidelity(recs, worlds["ab"].world, worlds["ab"].runtime)
    assert got == want
    assert (want["exact"] == 1.0) == (swap == "none")


def test_setup_instances_equal_the_jax_package(worlds):
    ab = worlds["ab"]
    assert len(ab.tok) == len(worlds["jtok"])
    for port, jax_ in ((ab.train_inst, worlds["jtrain"]), (ab.val_inst, worlds["jval"])):
        assert len(port) == len(jax_) > 0
        for p, j in zip(port, jax_):
            assert (p.inst_idx, p.scan, p.length) == (j.inst_idx, j.scan, j.length)
            np.testing.assert_array_equal(p.token_ids, j.token_ids)
            np.testing.assert_array_equal(p.segment_ids, j.segment_ids)
            for kind in ("planner_path", "player_path", "trusted_path", "end_panos"):
                assert getattr(p, kind) == getattr(j, kind)
            assert p.start_pano == j.start_pano
    assert ab.cfg.hidden_size == 128 and ab.cfg.num_hidden_layers == 2
    assert ab.cfg.num_attention_heads == 4 and ab.cfg.intermediate_size == 256


def _jax_oracle_records(worlds, n_aug, aug_seed, targets, episode_len=8):
    """tools/aug_ab.py:214-243 with the JAX package."""
    world, runtime, tok = worlds["jax"], worlds["jrt"], worlds["jtok"]
    sp = JSpeaker(runtime=runtime, feature_dim=64, vocab_size=len(tok),
                  bos_id=tok.vocab[tok.cls_token], eos_id=tok.vocab[tok.sep_token],
                  pad_id=tok.pad_token_id, episode_len=episode_len, max_words=48,
                  hidden_size=128, wemb=64, learning_rate=1e-3, seed=88)
    aug_rng = np.random.default_rng(aug_seed)
    walks = sp.sample_walks(aug_rng, n_aug, min_hops=2, max_hops=episode_len - 2)
    records = []
    for i in range(n_aug):
        scan = walks["scans"][i]
        g = world.graphs[scan]
        off = runtime.feat_table.scan_offsets[scan]
        path = g.shortest_path(int(walks["start_rows"][i]) - off,
                               int(walks["goal_rows"][i]) - off)
        rec = {"scan": scan, "path": path, "heading": walks["headings"][i],
               "path_id": f"AUG_{i}",
               "instructions": [world._directional_sentence(
                   g, [g.index[p] for p in path], walks["headings"][i])]}
        if targets:
            rec["target"] = str(aug_rng.choice(_TARGETS))
        records.append(rec)
    return records


@pytest.mark.parametrize("targets", [False, True])
def test_oracle_records_equal_the_jax_tools(worlds, targets):
    ab = worlds["ab"]
    got = aug_ab.oracle_records(ab, aug_ab.make_speaker(ab), 64, 7, targets)
    want = _jax_oracle_records(worlds, 64, 7, targets)
    assert got == want
    assert ("target" in got[0]) == targets
    fidelity = aug_ab.caption_fidelity(got, ab.world, ab.runtime)
    assert fidelity == {"n": 64, "parse": 1.0, "exact": 1.0, "hop_acc": 1.0, "len_mae": 0.0}
    inst = aug_ab.aug_instances(ab, got)
    assert len(inst) == 64 and [i.planner_path for i in inst] == [r["path"] for r in got]


def test_tiny_four_arm_run_logs_the_jax_tools_lines(monkeypatch):
    monkeypatch.setattr(aug_ab, "SPEAKER_LOG_EVERY", 2)
    monkeypatch.setattr(aug_ab, "TRAIN_LOG_EVERY", 2)
    lines, stages = [], []
    out = aug_ab.run(iters=4, speaker_iters=4, n_aug=16, train_episodes=12, val_episodes=8,
                     batch=4, arms="baseline,aug,aug_only,real_only", targets=True,
                     feat_dropout=0.6, movement_frame=True, device="cpu",
                     log=lambda s: lines.append(json.loads(s)), on_stage=stages.append,
                     world=TINY_WORLD, bert=TINY_BERT)
    arms = ("baseline", "aug", "aug_only", "real_only")
    tags = [line["tag"] for line in lines]
    assert tags == (["speaker"] * 2 + ["aug", "fidelity"]
                    + sum(([f"train_{a}"] * 2 + [f"val_{a}"] for a in arms), [])
                    + ["delta_aug_minus_baseline"])
    for line in lines:
        kind = line["tag"].split("_")[0] if line["tag"][:4] in ("trai", "val_") else line["tag"]
        assert list(line) == ["tag"] + KEYS[kind], line
        assert all(np.isfinite(v) for k, v in line.items() if k != "tag"), line
    assert lines[2] == {"tag": "aug", "records": 16, "instances": 16}
    assert len(out["records"]) == out["aug_instances"] == 16
    assert all("target" in r for r in out["records"])
    assert {a: out["arms"][a]["instances"] for a in arms} == {
        "baseline": 12, "aug": 28, "aug_only": 16, "real_only": 16}
    assert len(out["speaker_losses"]) == 4
    assert all(len(out["arms"][a]["losses"]) == 4 for a in arms)
    assert stages == ["setup", "speaker", "augment"] + sum(
        ([f"train_{a}", f"val_{a}"] for a in arms), [])
    with pytest.raises(ValueError, match="unknown arm"):
        aug_ab.run(arms="baseline,augment", device="cpu")


# -- the learning curve at phase 45's settings, against the JAX tool ------------------

PHASE = dict(iters=250, speaker_iters=600, n_aug=300, feat_dropout=0.6, movement_frame=True,
             seed=88)
ARGV = sum(([f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
            for k, v in PHASE.items()), [])
WINDOW = 50


def _ratio(losses) -> float:
    return float(np.mean(losses[-WINDOW:]) / np.mean(losses[:WINDOW]))


def _jax_run(monkeypatch, capsys) -> dict:
    """The JAX tool's main at PHASE, with every step's loss kept (the tool
    prints them every 100 / 200 steps only)."""
    from visitron_tpu.agents import ViewpointAgent as JAgent

    losses = {"speaker": [], "train": []}

    def keeping(cls, key):
        make = cls.train_step_fn

        def train_step_fn(self):
            step = make(self)

            def run(state, batch):
                state, loss = step(state, batch)
                losses[key].append(float(loss))
                return state, loss

            return run

        monkeypatch.setattr(cls, "train_step_fn", train_step_fn)

    keeping(JSpeaker, "speaker")
    keeping(JAgent, "train")
    scored = []
    fidelity = JTOOL.caption_fidelity

    def keeping_records(records, world, runtime):
        scored.append((records, world, runtime))
        return fidelity(records, world, runtime)

    monkeypatch.setattr(JTOOL, "caption_fidelity", keeping_records)
    monkeypatch.setattr(sys, "argv", ["aug_ab.py", "--cpu", *ARGV])
    JTOOL.main()
    records, world, runtime = scored[0]
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    by_tag = {line["tag"]: line for line in lines}
    n = len(losses["train"]) // 2
    return {"speaker_ce": [line["word_ce"] for line in lines if line["tag"] == "speaker"],
            "fidelity": by_tag["fidelity"], "aug": by_tag["aug"],
            "control": fidelity(aug_ab.rotated_captions(records), world, runtime),
            "ratios": {"baseline": _ratio(losses["train"][:n]),
                       "aug": _ratio(losses["train"][n:])},
            "val": {a: by_tag[f"val_{a}"] for a in ("baseline", "aug")},
            "delta": by_tag["delta_aug_minus_baseline"]}


def _port_run() -> dict:
    lines = []
    out = aug_ab.run(**PHASE, device="cpu", log=lambda s: lines.append(json.loads(s)))
    return {"speaker_ce": [line["word_ce"] for line in lines if line["tag"] == "speaker"],
            "fidelity": out["fidelity"], "control": out["control"],
            "aug": {"tag": "aug", "records": len(out["records"]),
                    "instances": out["aug_instances"]},
            "ratios": {a: _ratio(out["arms"][a]["losses"]) for a in ("baseline", "aug")},
            "val": {a: out["arms"][a]["val"] for a in ("baseline", "aug")},
            "delta": out["delta"], "seconds": out["seconds"]}


# The margins PERF.md states for phase 45 (port against the JAX record);
# ``over_control`` is hop_acc less that of the captions rotated one walk
# on, ``len_mae`` is in hops a caption.
MARGINS = {"speaker_ce_ratio": 0.15, "parse": 0.15, "hop_acc": 0.15, "over_control": 0.15,
           "len_mae": 0.25, "loss_ratio": 0.10}


@pytest.mark.slow
def test_learning_curve_matches_the_jax_tool(monkeypatch, capsys):
    runs = {"jax": _jax_run(monkeypatch, capsys), "port": _port_run()}
    with capsys.disabled():
        for who, run in runs.items():
            print(json.dumps({"who": who, "settings": " ".join(ARGV), **run}), flush=True)
    j, p = runs["jax"], runs["port"]
    assert p["aug"] == j["aug"] == {"tag": "aug", "records": 300, "instances": 300}
    sp = {who: r["speaker_ce"][-1] / r["speaker_ce"][0] for who, r in runs.items()}
    assert abs(sp["port"] - sp["jax"]) <= MARGINS["speaker_ce_ratio"], sp
    for key in ("parse", "hop_acc", "len_mae"):
        assert abs(p["fidelity"][key] - j["fidelity"][key]) <= MARGINS[key], (key, runs)
    over = {who: r["fidelity"]["hop_acc"] - r["control"]["hop_acc"] for who, r in runs.items()}
    assert abs(over["port"] - over["jax"]) <= MARGINS["over_control"], over
    for arm in ("baseline", "aug"):
        assert abs(p["ratios"][arm] - j["ratios"][arm]) <= MARGINS["loss_ratio"], (arm, runs)
