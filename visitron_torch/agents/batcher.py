"""Batching of navigation instances (visitron_tpu/agents/batcher.py:
``trim_to_bucket``, ``_make_batch``, ``with_teacher``, the training schedule
``train_batches`` / ``skip_batches`` and ``eval_batches``).  Host-side numpy;
the agent moves each batch onto the device.

The training schedule is the JAX package's for one host: epoch-shuffled with
``np.random.default_rng(seed)``, length-sorted within windows of
``LENGTH_SORT_WINDOW`` batches, the epoch tail wrapped into the next epoch,
so the same seed gives the same batches.  Multi-host streams are not ported.
"""

from __future__ import annotations

import numpy as np

from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.data.datasets import NavInstance

# Within each shuffled window of this many batches the instances are ordered
# by dialog length, so batches are length-homogeneous and trim to small
# buckets (the JAX batcher's default window).
LENGTH_SORT_WINDOW = 8


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
                 batch_size: int, path_type: str = "trusted_path", seed: int = 88):
        self.instances = instances
        self.runtime = runtime
        self.batch_size = batch_size
        self.path_type = path_type
        self.rng = np.random.default_rng(seed)
        self._stream = None

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

    def with_teacher(self, batch: dict, episode_len: int) -> dict:
        """The batch plus its teacher-forced episode arrays (cur_row, view,
        teacher, active; NavRuntime.teacher_rollout_arrays)."""
        batch = dict(batch)
        batch.update(self.runtime.teacher_rollout_arrays(
            batch["scans"], batch["start_rows"], batch["start_views"],
            batch["goal_rows"], episode_len))
        return batch

    def _window_sort(self, idx: list[int]) -> list[int]:
        """Length-sort ``idx`` within windows of ``LENGTH_SORT_WINDOW``
        batches, starting at index 0 so window boundaries stay aligned to
        batch boundaries."""
        w = LENGTH_SORT_WINDOW * self.batch_size
        if len(idx) <= self.batch_size:
            return list(idx)
        arr = np.asarray(idx)
        lengths = np.array([self.instances[i].length for i in arr])
        out: list[int] = []
        for s in range(0, len(arr), w):
            chunk, cl = arr[s:s + w], lengths[s:s + w]
            out.extend(chunk[np.argsort(cl, kind="stable")].tolist())
        return out

    def _batch_stream(self):
        """Yield ``batch_size`` index lists: epoch-shuffled, window-aligned
        length-sorted, the tail wrapped into the next epoch."""
        order: list[int] = []
        while True:
            while len(order) < self.batch_size:
                epoch = np.arange(len(self.instances))
                self.rng.shuffle(epoch)
                order = self._window_sort(order + epoch.tolist())
            take, order = order[: self.batch_size], order[self.batch_size:]
            yield take

    def _next_take(self) -> list[int]:
        if self._stream is None:
            self._stream = self._batch_stream()
        return next(self._stream)

    def skip_batches(self, n: int) -> None:
        """Advance the schedule by ``n`` batches without building them (a
        resumed run replays the stream to its checkpoint position)."""
        for _ in range(n):
            self._next_take()

    def train_batches(self, num_batches: int, episode_len: int):
        """``num_batches`` full-size batches of the training schedule, each
        with its teacher-forced episode arrays of ``episode_len`` steps; the
        schedule's state persists across calls."""
        for _ in range(num_batches):
            batch = self._make_batch([self.instances[i] for i in self._next_take()])
            yield self.with_teacher(batch, episode_len)

    def eval_batches(self):
        """One sequential pass; the final batch wraps to the front (the test
        loop dedupes repeats, agent.py:49-63)."""
        n = len(self.instances)
        for start in range(0, n, self.batch_size):
            idx = [(start + j) % n for j in range(self.batch_size)]
            yield self._make_batch([self.instances[i] for i in idx])
