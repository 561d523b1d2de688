"""Question-asking classifier dataset: CVDN episodes with per-timestep dialog
(visitron_tpu/data/classifier_dataset.py).

Parity: tasks/viewpoint_select/classifier/data_loader.py:105-475 +
utils_data.py:108-166.  Each episode carries a dialog *snapshot per nav
timestep* (the dialog visible at that point of gameplay); ``language[t]``
serves the snapshot at the latest question <= t, and ``request_locations``
are the timesteps where the navigator asked a question (the positive class).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from visitron_torch.data.dialog import MAX_TARGET_LENGTH, build_dialog_sequence
from visitron_torch.data.datasets import load_classifier_episodes


@dataclass
class ClassifierInstance:
    inst_idx: str
    scan: str
    start_pano: dict
    player_path: list[str]
    planner_path: list[str]
    request_locations: list[int]
    max_timestep: int
    # Per-timestep language arrays, shape (max_timestep + 1, S).
    token_ids: np.ndarray
    segment_ids: np.ndarray
    lengths: np.ndarray
    raw: dict = field(default_factory=dict)

    def language_at(self, t: int) -> int:
        """Snapshot row index for timestep t (get_language_input parity)."""
        return min(t, self.max_timestep)


def build_classifier_instances(
    root: str,
    splits,
    tokenizer,
    oscar_setting: bool = False,
    tar_back: bool = False,
    max_seq_length: int = 512,
    truncate_dialog: bool = True,
) -> list[ClassifierInstance]:
    out = []
    for item in load_classifier_episodes(root, splits):
        target_tokens = tokenizer.tokenize(item["target"])[:MAX_TARGET_LENGTH]
        snapshots = item["dialog_history"]  # {timestep: [messages...]}
        max_timestep = max(snapshots.keys())
        # language[t] for every t in 0..max_timestep: the snapshot at the
        # latest request <= t (classifier/data_loader.py:221-241).
        req = sorted(snapshots.keys())
        seqs = []
        for t in range(max_timestep + 1):
            latest = max((r for r in req if r <= t), default=0)
            turns = [tokenizer.tokenize(m) for m in snapshots[latest]]
            seqs.append(
                build_dialog_sequence(
                    tokenizer, turns, target_tokens=target_tokens,
                    oscar_setting=oscar_setting, tar_back=tar_back,
                    max_seq_length=max_seq_length, truncate=truncate_dialog))
        out.append(
            ClassifierInstance(
                inst_idx=item["inst_idx"],
                scan=item["scan"],
                start_pano=item["start_pano"],
                player_path=list(item["player_path"]),
                planner_path=list(item["planner_path"]),
                request_locations=list(item["request_locations"]),
                max_timestep=max_timestep,
                token_ids=np.stack([s.token_ids for s in seqs]),
                segment_ids=np.stack([s.segment_ids for s in seqs]),
                lengths=np.array([s.length for s in seqs], np.int32),
                raw=item,
            )
        )
    return out
