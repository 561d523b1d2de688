"""The port's timing harness (visitron_torch/utils/benchmark.py) on the CPU:
``stack_batches`` equals the JAX package's, a window is positive, and a
window that collapses is refused, as in visitron_tpu/utils/benchmark.py."""

import itertools

import numpy as np
import pytest

from visitron_torch.utils import benchmark as tb
from visitron_tpu.utils import benchmark as jb


def test_stack_batches_equals_the_jax_one():
    rng = np.random.default_rng(0)
    batches = [{"ids": rng.integers(0, 9, (4, 6)), "feats": {"img": rng.random((4, 3, 2))},
                "pair": (rng.random(4), rng.integers(0, 2, 4))} for _ in range(3)]
    got, want = tb.stack_batches(batches), jb.stack_batches(batches)
    for path, leaf in (("ids", lambda t: t["ids"]), ("img", lambda t: t["feats"]["img"]),
                       ("pair0", lambda t: t["pair"][0]), ("pair1", lambda t: t["pair"][1])):
        np.testing.assert_array_equal(leaf(got), np.asarray(leaf(want)), err_msg=path)
        assert leaf(got).shape[0] == 3


def test_windows_are_positive_and_a_collapsed_one_is_refused(monkeypatch):
    pool = tb.stack_batches([{"x": np.full(8, i, np.float32)} for i in range(2)])
    seen = []

    def step(state, batch):
        seen.append(float(batch["x"][0]))
        return state + float(np.sum(np.sin(batch["x"] * np.arange(2000)[:, None]))), None

    assert tb.time_step_fn(step, 0.0, pool, n_lo=2, n_hi=6, repeats=2, device="cpu") > 0
    assert set(seen) == {0.0, 1.0}  # both pool entries, in turn
    assert tb.time_fn(np.dot, np.ones((64, 64)), np.ones((64, 64)), device="cpu") > 0
    # A clock that advances one second a reading: every window is as long
    # at n_hi as at n_lo.
    clock = itertools.count()
    monkeypatch.setattr(tb.time, "perf_counter", lambda: float(next(clock)))
    with pytest.raises(tb.TimingWindowCollapsed, match="collapsed after retry"):
        tb.time_fn(np.dot, np.ones(4), np.ones(4), device="cpu")
    with pytest.raises(tb.TimingWindowCollapsed):
        tb.time_step_fn(step, 0.0, pool, device="cpu")
    assert tb.PEAK_BF16_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
    assert not any(k.startswith("TPU") for k in tb.PEAK_BF16_FLOPS)
