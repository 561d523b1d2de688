"""A run of each cell on the CPU at a tiny size with the timed path broken
underneath (the look for a chip skipped): ``correct`` comes out false for
each fault the cell can have, and true without one.  The control (the
reference in the program's place with float8 products) comes out false too.
Limits are the cells' own files'.  The NDH loops run with the program's
stop slot mended in the test (their cells wait for the mend), and without
it their limits refuse the program."""

import json
import time

import pytest
import torch

from h100bench import compare, controls, run, spec
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


NDH = ["ndh_train.mp3d.b128.t10", "ndh_eval.mp3d.b256.t40"]


def _ndh_cell(monkeypatch, name):
    """The tiny NDH cell ``name`` in float32 with the configuration's
    2048-d scene features (the logits then have the cell's scale), on worlds
    whose viewpoints have one padded candidate slot."""
    cell = tiny.cell(name)
    cell["config"]["dtype"] = "float32"
    with open(spec.HERE / "configs" / "visitron-ndh.json") as f:
        cell["config"]["agent"]["feature_dim"] = json.load(f)["agent"]["feature_dim"]
    tiny.complete_graphs(monkeypatch, cell["config"]["agent"]["max_candidates"], cell)
    return cell


def _ndh(monkeypatch, name, seed=21):
    return run.run_cell(_ndh_cell(monkeypatch, name), seed, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", NDH)
def test_ndh_limits_see_the_stop_slot(monkeypatch, name):
    out = _ndh(monkeypatch, name)
    assert not out["correct"], out["checks"]
    tiny.mend_stop_slot(monkeypatch)
    out = _ndh(monkeypatch, name)
    assert out["correct"], out["checks"]


def _break_train_step(monkeypatch, fault):
    from visitron_torch.agents import ViewpointAgent

    raw = ViewpointAgent.train_step_fn

    def broken(self, *args, **kwargs):
        step = raw(self, *args, **kwargs)
        return lambda state, batch: fault(step, state, batch)

    monkeypatch.setattr(ViewpointAgent, "train_step_fn", broken)


def _alter_first_action(monkeypatch):
    """Each rollout's first action: the candidate the program ranks second."""
    from visitron_torch.agents import ViewpointAgent

    rollout, decode = ViewpointAgent.decode_rollout, ViewpointAgent.decode_step

    def first_altered(self, *args, **kwargs):
        self.first_step = True
        return rollout(self, *args, **kwargs)

    def step(self, *args, **kwargs):
        logit, h, c = decode(self, *args, **kwargs)
        if self.first_step:
            self.first_step = False
            logit = logit.scatter(1, logit.argmax(1, keepdim=True), torch.finfo(logit.dtype).min)
        return logit, h, c

    monkeypatch.setattr(ViewpointAgent, "decode_rollout", first_altered)
    monkeypatch.setattr(ViewpointAgent, "decode_step", step)


@pytest.mark.parametrize("fault", [unchanged, half_batch], ids=lambda f: f.__name__)
def test_ndh_train_fault_is_caught(monkeypatch, fault):
    tiny.mend_stop_slot(monkeypatch)
    _break_train_step(monkeypatch, fault)
    out = _ndh(monkeypatch, NDH[0])
    assert not out["correct"], out["checks"]


def test_ndh_eval_altered_action_is_caught(monkeypatch):
    tiny.mend_stop_slot(monkeypatch)
    _alter_first_action(monkeypatch)
    out = _ndh(monkeypatch, NDH[1])
    assert not out["correct"], out["checks"]


def test_ndh_eval_dropped_state_is_caught(monkeypatch):
    """From the second step on, each decoder step of a rollout starts from
    the state its first one got: the first action is sound, the rest not."""
    tiny.mend_stop_slot(monkeypatch)
    controls.drop_state(monkeypatch)
    out = _ndh(monkeypatch, NDH[1])
    assert not out["correct"], out["checks"]
    assert out["checks"]["first_logit_gap"]["value"] <= out["checks"]["first_logit_gap"]["limit"]


def test_ndh_eval_control_is_caught(monkeypatch):
    """``controls.py``'s readings of the evaluation: the program's within
    the limits; the control's (float8 products), the altered first action's
    and the dropped state's not."""
    tiny.mend_stop_slot(monkeypatch)
    cell = _ndh_cell(monkeypatch, NDH[1])
    lines = controls.serving(cell, 21, ["program", "control", "altered_first", "state_dropped"],
                             CPU)
    assert [line["what"] for line in lines] == ["program", "control", "altered_first",
                                               "state_dropped"]
    for line in lines:
        ok, _ = compare.judge(line, cell["traffic"]["limits"])
        assert ok == (line["what"] == "program"), line


def test_ndh_train_controls_read_as_the_run(monkeypatch):
    """``controls.py``'s program reading of NDH training is the benchmark
    run's; its control and half batch give readings of the same kinds."""
    tiny.mend_stop_slot(monkeypatch)
    cell = _ndh_cell(monkeypatch, NDH[0])
    checks = run.run_cell(cell, 21, 0.2, False, CPU, time.perf_counter())["checks"]
    lines = controls.ndh_training(cell, 21, ["program", "control", "half_batch"], CPU)
    assert [line["what"] for line in lines] == ["program", "control", "half_batch"]
    for name in cell["traffic"]["limits"]:
        assert lines[0][name] == pytest.approx(checks[name]["value"], rel=0.05, abs=1e-6)
        assert all(name in line for line in lines)
    for line in lines:
        ok, _ = compare.judge(line, cell["traffic"]["limits"])
        assert ok == (line["what"] == "program"), line
