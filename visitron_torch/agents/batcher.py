"""Batching of navigation instances for evaluation
(visitron_tpu/agents/batcher.py: ``trim_to_bucket``, ``_make_batch`` and
``eval_batches``).  Host-side numpy; the agent moves each batch onto the
device.  The training schedule (shuffled, length-sorted, multi-host) is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.data.datasets import NavInstance


def trim_to_bucket(batch: dict, max_len: int, bucket: int) -> dict:
    """Trim the dialog arrays (ids/segs) to ``max_len`` rounded up to a
    ``bucket`` multiple."""
    s_full = batch["ids"].shape[1]
    s = int(min(s_full, -(-int(max(1, max_len)) // bucket) * bucket))
    if s == s_full:
        return batch
    out = dict(batch)
    out["ids"] = batch["ids"][:, :s]
    out["segs"] = batch["segs"][:, :s]
    return out


class NavEpisodeBatcher:
    def __init__(self, instances: list[NavInstance], runtime: NavRuntime,
                 batch_size: int, path_type: str = "trusted_path"):
        self.instances = instances
        self.runtime = runtime
        self.batch_size = batch_size
        self.path_type = path_type

    def _make_batch(self, items: list[NavInstance]) -> dict:
        rt = self.runtime
        b = len(items)
        s = len(items[0].token_ids)
        out = {
            "ids": np.zeros((b, s), np.int32),
            "segs": np.zeros((b, s), np.int32),
            "lengths": np.zeros((b,), np.int32),
            "scans": [it.scan for it in items],
            "inst_idx": [it.inst_idx for it in items],
            "start_rows": np.zeros((b,), np.int32),
            "start_views": np.zeros((b,), np.int32),
            "goal_rows": np.zeros((b,), np.int32),
        }
        for i, it in enumerate(items):
            out["ids"][i] = it.token_ids
            out["segs"][i] = it.segment_ids
            out["lengths"][i] = it.length
            path = it.path(self.path_type)
            # Episodes always start at elevation 0 regardless of the dataset's
            # start_pano elevation (reference EnvBatch.newEpisodes passes
            # [0]*batch, data_loader.py:52).
            row, view = rt.start_state(it.scan, path[0], it.start_pano["heading"], 0.0)
            out["start_rows"][i] = row
            out["start_views"][i] = view
            out["goal_rows"][i] = rt.row(it.scan, path[-1])
        return out

    def eval_batches(self):
        """One sequential pass; the final batch wraps to the front (the test
        loop dedupes repeats, agent.py:49-63)."""
        n = len(self.instances)
        for start in range(0, n, self.batch_size):
            idx = [(start + j) % n for j in range(self.batch_size)]
            yield self._make_batch([self.instances[i] for i in idx])
