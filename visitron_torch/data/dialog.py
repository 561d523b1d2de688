"""Dialog-history assembly: truncation, special-token segmenting, padding.

Exact behavioral parity with the reference sequence builder
(tasks/viewpoint_select/data_loader.py:124-212, utils_data.py:287-328):

  [CLS] [TAR] target [QUES] q1 [ANS] a1 ... [SEP] -> padded to max length,
  with segment ids 0/1/2/3 for cls-sep/target/question/answer spans.
  ``oscar_setting`` replaces the task tokens by [SEP] with segment id 0.
  ``tar_back`` moves the target span after the dialog.
  Truncation keeps the *latest* turns, counting one separator per turn.

One deliberate deviation: the reference pads fine-tune sequences with the
integer ``0`` pushed through ``convert_tokens_to_ids`` (data_loader.py:203),
which in the vendored tokenizer maps to [UNK]; we pad with the real [PAD] id
and return an explicit length/attention mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain

import numpy as np

SEGMENT_IDS = {
    "cls": 0,
    "pad": 0,
    "sep": 0,
    "tar": 1,
    "ques": 2,
    "ans": 3,
}

MAX_SEQ_LENGTH = 512
MAX_DIALOG_LEN = MAX_SEQ_LENGTH - 4
MAX_TARGET_LENGTH = 2


def truncate_dialogs(sentences: list[list[str]], amount: int | None, left: bool = True) -> list[list[str]]:
    """Token-level dialog truncation (parity: utils_data.py:287-328).

    Each turn costs ``len(turn) + 1`` (its separator).  ``left=True`` keeps the
    most recent turns, trimming the oldest kept turn from its left edge.
    """
    if amount is None:
        return sentences
    if len(list(chain(*sentences))) + len(sentences) <= amount:
        return sentences
    if left:
        kept: list[list[str]] = []
        used = 0
        for turn in reversed(sentences):
            if used >= amount:
                break
            remaining = amount - used
            if len(turn) + 1 <= remaining:
                kept.append(turn)
                used += len(turn) + 1
            else:
                # Keep the last (remaining - 1) tokens plus the separator.
                # (The reference's turn[-remaining+1:] keeps the whole turn
                # when remaining == 1, overflowing the budget; fixed here.)
                keep = remaining - 1
                trimmed = turn[-keep:] if keep > 0 else []
                kept.append(trimmed)
                used += len(trimmed) + 1
                break
        return kept[::-1]
    else:
        kept = []
        used = 0
        for turn in sentences:
            if used >= amount:
                break
            remaining = amount - used
            if len(turn) + 1 <= remaining:
                kept.append(turn)
                used += len(turn) + 1
            else:
                trimmed = turn[: max(remaining - 1, 0)]
                kept.append(trimmed)
                used += len(trimmed) + 1
                break
        return kept


@dataclass
class DialogSequence:
    token_ids: np.ndarray  # (max_seq_length,) int32, [PAD]-padded
    segment_ids: np.ndarray  # (max_seq_length,) int32
    length: int  # number of real (non-pad) tokens
    tokens: list[str]  # unpadded token strings
    region_span: tuple[int, int] | None = None  # [start, end) of region tokens

    @property
    def attention_mask(self) -> np.ndarray:
        m = np.zeros(len(self.token_ids), dtype=np.int32)
        m[: self.length] = 1
        return m


def build_dialog_sequence(
    tokenizer,
    dialog_turns: list[list[str]],
    target_tokens: list[str] | None = None,
    oscar_setting: bool = False,
    tar_back: bool = False,
    max_seq_length: int = MAX_SEQ_LENGTH,
    max_dialog_len: int | None = None,
    region_tokens: list[str] | None = None,
    truncate: bool = True,
) -> DialogSequence:
    """Assemble the [CLS]/[TAR]/[QUES]/[ANS]-segmented dialog sequence.

    ``region_tokens`` (pretraining) are appended after the dialog [SEP] with a
    trailing [SEP] (data_loader_pretrain.py:187-209).
    """
    if max_dialog_len is None:
        max_dialog_len = max_seq_length - 4
        if region_tokens is not None:
            max_dialog_len = max_seq_length - 180 - 4  # data_loader_pretrain.py:91
    if truncate:
        dialog_turns = truncate_dialogs(dialog_turns, amount=max_dialog_len, left=True)

    tokens: list[str] = [tokenizer.cls_token]
    segments: list[int] = [SEGMENT_IDS["cls"]]

    def add_target():
        sep = tokenizer.sep_token if oscar_setting else tokenizer.tar_token
        tokens.extend([sep] + list(target_tokens))
        segments.extend([SEGMENT_IDS["tar"]] * (len(target_tokens) + 1))

    if target_tokens is not None and not tar_back:
        add_target()
    for i, turn in enumerate(dialog_turns):
        if oscar_setting:
            sep, seg = tokenizer.sep_token, SEGMENT_IDS["sep"]
        elif i % 2 == 0:
            sep, seg = tokenizer.ques_token, SEGMENT_IDS["ques"]
        else:
            sep, seg = tokenizer.ans_token, SEGMENT_IDS["ans"]
        tokens.extend([sep] + list(turn))
        segments.extend([seg] * (len(turn) + 1))
    if target_tokens is not None and tar_back:
        add_target()
    tokens.append(tokenizer.sep_token)
    segments.append(SEGMENT_IDS["sep"])
    region_span = None
    if region_tokens is not None:
        region_start = len(tokens)
        tokens.extend(region_tokens)
        segments.extend([SEGMENT_IDS["sep"]] * len(region_tokens))
        region_span = (region_start, len(tokens))
        tokens.append(tokenizer.sep_token)
        segments.append(SEGMENT_IDS["sep"])

    # The reference reserves one slot (pads to max_seq_length - 1,
    # data_loader.py:203): sequences are 511 long with 512 capacity. We fill
    # to max_seq_length but cap real content identically.
    if len(tokens) > max_seq_length - 1:
        tokens = tokens[: max_seq_length - 1]
        segments = segments[: max_seq_length - 1]
        if region_span is not None:
            region_span = (min(region_span[0], len(tokens)),
                           min(region_span[1], len(tokens)))
    length = len(tokens)
    ids = tokenizer.convert_tokens_to_ids(tokens)
    token_ids = np.full(max_seq_length, tokenizer.pad_token_id, dtype=np.int32)
    token_ids[:length] = ids
    segment_ids = np.full(max_seq_length, SEGMENT_IDS["pad"], dtype=np.int32)
    segment_ids[:length] = segments
    return DialogSequence(token_ids=token_ids, segment_ids=segment_ids,
                          length=length, tokens=tokens, region_span=region_span)
