"""Batching of navigation instances (visitron_tpu/agents/batcher.py:
``trim_to_bucket``, ``_make_batch``, ``with_teacher``, ``with_sample_teacher``,
the training schedule ``train_batches`` / ``skip_batches`` and
``eval_batches``).  Host-side numpy; the agent moves each batch onto the
device.

The training schedule is the JAX package's: epoch-shuffled with
``np.random.default_rng(seed)``, length-sorted within windows of
``length_sort_window`` batches (default ``LENGTH_SORT_WINDOW``; 0 or 1
turns it off), the epoch tail wrapped into the next epoch, so the same seed
gives the same batches.  Under data parallelism each rank is a JAX "host"
(``host_id`` = rank, ``num_hosts`` = world size): it takes the strided
shard ``instances[host_id::num_hosts]`` (DistributedSampler's), and runs
every other host's stream as a shadow (each shard's schedule is
deterministic given the instances and the seed), so it trims its batch to
the global length bucket, the longest dialog of every host's concurrent
batch rounded up to ``length_bucket``, with no collective.
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
                 batch_size: int, path_type: str = "trusted_path", seed: int = 88,
                 host_id: int = 0, num_hosts: int = 1,
                 length_sort_window: int = LENGTH_SORT_WINDOW, length_bucket: int = 128):
        self.instances_all = instances
        self.instances = instances[host_id::num_hosts]
        self.runtime = runtime
        self.batch_size = batch_size
        self.path_type = path_type
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.length_sort_window = length_sort_window
        self.length_bucket = length_bucket
        self.rng = np.random.default_rng(seed)
        self._streams = None
        self._shards = None

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

    def with_sample_teacher(self, batch: dict) -> dict:
        """The batch plus its per-item teacher and distance columns for
        student-forced and RL training (NavRuntime.sample_rollout_arrays)."""
        batch = dict(batch)
        batch.update(self.runtime.sample_rollout_arrays(batch["scans"],
                                                        batch["goal_rows"]))
        return batch

    def with_turn_teacher(self, batch: dict, episode_len: int) -> dict:
        """The batch with its low-level (turn-based) teacher episode."""
        batch = dict(batch)
        batch.update(self.runtime.turn_based_rollout_arrays(
            batch["scans"], batch["start_rows"], batch["start_views"],
            batch["goal_rows"], episode_len))
        return batch

    def _window_sort(self, idx: list[int], shard) -> list[int]:
        """Length-sort ``idx`` (into ``shard``) within windows of
        ``length_sort_window`` batches, starting at index 0 so window
        boundaries stay aligned to batch boundaries."""
        w = self.length_sort_window * self.batch_size
        if self.length_sort_window <= 1 or len(idx) <= self.batch_size:
            return list(idx)
        arr = np.asarray(idx)
        lengths = np.array([shard[i].length for i in arr])
        out: list[int] = []
        for s in range(0, len(arr), w):
            chunk, cl = arr[s:s + w], lengths[s:s + w]
            out.extend(chunk[np.argsort(cl, kind="stable")].tolist())
        return out

    def _batch_stream(self, shard, rng):
        """Yield ``batch_size`` index lists into ``shard``: epoch-shuffled,
        window-aligned length-sorted, the tail wrapped into the next epoch."""
        order: list[int] = []
        while True:
            while len(order) < self.batch_size:
                epoch = np.arange(len(shard))
                rng.shuffle(epoch)
                order = self._window_sort(order + epoch.tolist(), shard)
            take, order = order[: self.batch_size], order[self.batch_size:]
            yield take

    def _ensure_streams(self) -> None:
        """Every host's stream: this host's draws from ``self.rng``, the
        shadows from fresh generators of the same seed (what each of them
        runs itself)."""
        if self._streams is not None:
            return
        if self.num_hosts > 1:
            self._shards = [self.instances_all[h::self.num_hosts]
                            for h in range(self.num_hosts)]
            self._streams = [self._batch_stream(sh, self.rng if h == self.host_id
                                                else np.random.default_rng(self.seed))
                             for h, sh in enumerate(self._shards)]
        else:
            self._shards = [self.instances]
            self._streams = [self._batch_stream(self.instances, self.rng)]

    def _global_trim(self, batch: dict, global_max_len: int) -> dict:
        return trim_to_bucket(batch, global_max_len, self.length_bucket)

    def skip_batches(self, n: int) -> None:
        """Advance the schedule by ``n`` batches without building them (a
        resumed run replays the stream to its checkpoint position); the
        shadow streams advance in lock-step, so the global length buckets
        stay the same after a resume."""
        self._ensure_streams()
        for _ in range(n):
            for stream in self._streams:
                next(stream)

    def train_batches(self, num_batches: int, episode_len: int | None = None):
        """``num_batches`` full-size batches of the training schedule, each
        with its teacher-forced episode arrays of ``episode_len`` steps
        (None: without them); the schedule's state persists across calls.
        With several hosts each batch is trimmed to the global length
        bucket."""
        self._ensure_streams()
        my = self.host_id if self.num_hosts > 1 else 0
        for _ in range(num_batches):
            takes = [next(stream) for stream in self._streams]
            batch = self._make_batch([self._shards[my][i] for i in takes[my]])
            if self.num_hosts > 1:
                gmax = max(self._shards[h][i].length
                           for h, take in enumerate(takes) for i in take)
                batch = self._global_trim(batch, int(gmax))
            yield batch if episode_len is None else self.with_teacher(batch, episode_len)

    def eval_batches(self, episode_len: int | None = None):
        """One sequential pass; the final batch wraps to the front (the test
        loop dedupes repeats, agent.py:49-63); with ``episode_len``, each
        batch carries its teacher-forced episode arrays."""
        n = len(self.instances)
        for start in range(0, n, self.batch_size):
            idx = [(start + j) % n for j in range(self.batch_size)]
            batch = self._make_batch([self.instances[i] for i in idx])
            yield batch if episode_len is None else self.with_teacher(batch, episode_len)
