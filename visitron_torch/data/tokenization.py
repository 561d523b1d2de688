"""Self-contained BERT-style WordPiece tokenizer.

The reference relies on a vendored HuggingFace ``pytorch_transformers``
BertTokenizer plus three added special tokens [TAR]/[QUES]/[ANS]
(tasks/viewpoint_select/model_utils.py:29-33,101-109).  This is a dependency-
free implementation of the same algorithm (basic tokenization: lowercasing,
accent stripping, punctuation/CJK splitting; then greedy longest-match-first
WordPiece with ``##`` continuations), loading any standard BERT ``vocab.txt``.

A small trainer (`build_wordpiece_vocab`) exists so synthetic worlds and tests
can run without shipping the 30K-entry bert-base vocab.
"""

from __future__ import annotations

import collections
import unicodedata

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
EXTRA_SPECIAL_TOKENS = ("[TAR]", "[QUES]", "[ANS]")  # model_utils.py:29-33


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lower_case: bool = True) -> list[str]:
    # Clean: drop control chars, normalize whitespace, isolate CJK chars.
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif _is_whitespace(ch):
            out.append(" ")
        else:
            out.append(ch)
    tokens = []
    for tok in "".join(out).split():
        if lower_case:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        # Split punctuation into separate tokens.
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: dict[str, int] | list[str], lower_case: bool = True,
                 max_input_chars_per_word: int = 100):
        if isinstance(vocab, dict):
            self.vocab = dict(vocab)
        else:
            self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lower_case = lower_case
        self.max_input_chars_per_word = max_input_chars_per_word

    # -- special token surface (reference tokenizer attribute parity) -----
    pad_token = "[PAD]"
    unk_token = "[UNK]"
    cls_token = "[CLS]"
    sep_token = "[SEP]"
    mask_token = "[MASK]"
    tar_token = "[TAR]"
    ques_token = "[QUES]"
    ans_token = "[ANS]"

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    @property
    def all_special_tokens(self) -> list[str]:
        toks = list(SPECIAL_TOKENS) + [
            t for t in EXTRA_SPECIAL_TOKENS if t in self.vocab
        ]
        return toks

    @property
    def all_special_ids(self) -> list[int]:
        return [self.vocab[t] for t in self.all_special_tokens]

    def __len__(self) -> int:
        return len(self.vocab)

    def add_special_tokens(self, tokens=EXTRA_SPECIAL_TOKENS) -> int:
        """Append new special tokens; returns how many were added
        (embedding resize parity: model_utils.py:101-109)."""
        added = 0
        for t in tokens:
            if t not in self.vocab:
                i = len(self.vocab)
                self.vocab[t] = i
                self.ids_to_tokens[i] = t
                added += 1
        return added

    def wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for word in basic_tokenize(text, self.lower_case):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens) -> list[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids) -> list[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str) -> list[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    # -- persistence -----------------------------------------------------
    def save_vocab(self, path: str) -> None:
        with open(path, "w") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")

    @classmethod
    def from_vocab_file(cls, path: str, lower_case: bool = True) -> "WordPieceTokenizer":
        with open(path) as f:
            vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(vocab, lower_case=lower_case)


def build_wordpiece_vocab(texts, vocab_size: int = 4096, min_count: int = 1,
                          include_extra_special: bool = True) -> list[str]:
    """Build a simple WordPiece vocab: specials, single chars (+## variants),
    then whole words by frequency.  Sufficient for synthetic corpora; real runs
    load the published bert-base-uncased vocab.txt."""
    counter: collections.Counter = collections.Counter()
    chars: set[str] = set()
    for text in texts:
        for w in basic_tokenize(text):
            counter[w] += 1
            chars.update(w)
    vocab: list[str] = list(SPECIAL_TOKENS)
    if include_extra_special:
        vocab += list(EXTRA_SPECIAL_TOKENS)
    for c in sorted(chars):
        vocab.append(c)
    for c in sorted(chars):
        vocab.append("##" + c)
    for w, n in counter.most_common():
        if n < min_count or w in vocab:
            continue
        if len(vocab) >= vocab_size:
            break
        vocab.append(w)
    return vocab
