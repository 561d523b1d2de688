"""A run of each cell on the CPU at a tiny size with the timed path broken
underneath (the look for a chip skipped): ``correct`` comes out false for
each fault the cell can have, and true without one.  The control (the
reference in the program's place with float8 products) comes out false too.
Limits are the cells' own files'."""

import time

import pytest
import torch

from h100bench import compare, run
from h100bench.loops import pretrain
from h100bench.reference.core import Prec
from h100bench.tests import tiny

CPU = torch.device("cpu")


def unchanged(step, state, batch):
    """A step that returns its state unchanged."""
    return state, step(state, batch)[1]


def half_batch(step, state, batch):
    """Half of the batch left out, the mean taken over the rest."""
    return step(state, {k: v[:len(v) // 2] for k, v in batch.items()})


def _pretrain(monkeypatch, fault=None, seed=21):
    from visitron_torch.train.pretrain import PretrainTrainer

    if fault is not None:
        raw = PretrainTrainer.raw_step_fn

        def broken(self):
            step = raw(self)
            return lambda state, batch: fault(step, state, batch)

        monkeypatch.setattr(PretrainTrainer, "raw_step_fn", broken)
    return run.run_cell(tiny.cell("pretrain.s768.b64"), seed, 0.2, False, CPU,
                        time.perf_counter())


def test_pretrain_sound_run_is_correct(monkeypatch):
    out = _pretrain(monkeypatch)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=lambda f: f.__name__)
def test_pretrain_fault_is_caught(monkeypatch, fault):
    out = _pretrain(monkeypatch, fault)
    assert not out["correct"], out["checks"]


def test_pretrain_control_is_caught():
    cell = tiny.cell("pretrain.s768.b64")
    cfg, traffic = cell["config"], cell["traffic"]
    first = pretrain.pool(cfg, traffic, 21, CPU)[:pretrain.COMPARED_STEPS]
    ref = pretrain.reference_steps(cfg, traffic, first, 21, CPU)
    low = pretrain.reference_steps(cfg, traffic, first, 21, CPU, prec=Prec("fp8"))
    readings = compare.training(low[0], ref[0], low[1], ref[1], low[2], ref[2])
    ok, _ = compare.judge(readings, traffic["limits"])
    assert not ok, readings
