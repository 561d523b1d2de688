"""Legacy word-level tokenizer and its corpus vocabulary.

Parity with the pre-BERT utilities the reference keeps around
(tasks/viewpoint_select/utils.py:33-260): regex sentence splitting, reversed
encoding that left-truncates to keep instruction starts, <PAD>/<UNK>/<EOS>
handling, and corpus vocabulary construction with target words included.
The port's copy of visitron_tpu/data/legacy_tokenizer.py.
"""

from __future__ import annotations

import re
import string
from collections import Counter, defaultdict

import numpy as np

BASE_VOCAB = ["<PAD>", "<UNK>", "<EOS>", "<NAV>", "<ORA>", "<TAR>"]
PADDING_IDX = BASE_VOCAB.index("<PAD>")

_SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def split_sentence(sentence: str) -> list[str]:
    """Break a sentence into words/punctuation (utils.py:180-195)."""
    toks = []
    for word in [s.strip().lower() for s in _SENTENCE_SPLIT_REGEX.split(sentence.strip())
                 if len(s.strip()) > 0]:
        if all(c in string.punctuation for c in word) and not all(c == "." for c in word):
            toks += list(word)
        else:
            toks.append(word)
    return toks


class LegacyTokenizer:
    """Reversed-sequence word tokenizer (utils.py:144-260)."""

    def __init__(self, vocab: list[str] | None = None, encoding_length: int = 20):
        self.encoding_length = encoding_length
        self.vocab = vocab
        self._word_to_index: dict = {}
        self._index_to_word: dict = {}
        if vocab:
            for i, word in enumerate(vocab):
                self._word_to_index[word] = i
            w2i = defaultdict(lambda: self._word_to_index["<UNK>"])
            w2i.update(self._word_to_index)
            self._word_to_index = w2i
            for k, v in dict(self._word_to_index).items():
                self._index_to_word[v] = k
        self.add_word("<BOS>")

    def vocab_size(self) -> int:
        return len(self._index_to_word)

    def add_word(self, word: str) -> None:
        if word in self._word_to_index:
            raise ValueError(f"{word!r} is in the vocabulary already")
        self._word_to_index[word] = self.vocab_size()
        self._index_to_word[self.vocab_size()] = word

    def word_to_index(self, word: str) -> int:
        return self._word_to_index[word]

    def encode_sentence(self, sentences, seps=None) -> np.ndarray:
        if len(self._word_to_index) == 0:
            raise RuntimeError("tokenizer has no vocab")
        encoding = []
        if not isinstance(sentences, list):
            sentences, seps = [sentences], [seps]
        for sentence, sep in zip(sentences, seps):
            if sep is not None:
                encoding.append(self._word_to_index[sep])
            for word in split_sentence(sentence)[::-1]:  # reversed input
                encoding.append(self._word_to_index.get(
                    word, self._word_to_index["<UNK>"]))
        encoding.append(self._word_to_index["<EOS>"])
        if len(encoding) < self.encoding_length:
            encoding += [self._word_to_index["<PAD>"]] * (
                self.encoding_length - len(encoding))
        # Keep the most recent QA pairs by cutting the left side.
        prefix_cut = max(0, len(encoding) - self.encoding_length)
        return np.array(encoding[prefix_cut:])

    def decode_sentence(self, encoding) -> str:
        sentence = []
        for ix in encoding:
            if ix == self._word_to_index["<PAD>"]:
                break
            if int(ix) in self._index_to_word:
                sentence.append(self._index_to_word[int(ix)])
        return " ".join(sentence[::-1])

    def shrink(self, inst):
        """Strip <BOS>/<EOS>; empty if no <EOS> (utils.py:244-260)."""
        if len(inst) == 0:
            return inst
        end = int(np.argmax(np.array(inst) == self._word_to_index["<EOS>"]))
        start = 1 if len(inst) > 1 and inst[0] == self._word_to_index["<BOS>"] else 0
        return inst[start:end]


def build_legacy_vocab(items: list[dict], min_count: int = 5,
                       start_vocab=BASE_VOCAB) -> list[str]:
    """Corpus vocab: base + target words + frequent dialog words
    (utils.py:92-117)."""
    count: Counter = Counter()
    for item in items:
        for turn in item.get("dialog_history", []):
            count.update(split_sentence(turn["message"]))
    vocab = list(start_vocab)
    targets = {item["target"] for item in items if "target" in item}
    vocab.extend(sorted(targets))
    for word, num in count.most_common():
        if word in vocab:
            continue
        if num >= min_count:
            vocab.append(word)
        else:
            break
    return vocab
