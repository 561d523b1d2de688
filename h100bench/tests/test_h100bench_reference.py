"""The plain reference against the program on the CPU at a tiny size, for
each loop's entry, in float32 with every dropout on: they agree to
round-off, except where the program departs from the published agent."""

import time

import pytest
import torch

from h100bench import run
from h100bench.tests import tiny


# Every gap a loop reads, compared or not (counts of leaves left out aside).
GAPS = {"pretrain.s768.b64": ("loss_gap", "grad_gap", "change_gap", "nonfinite_window_losses"),
        "ndh_train.mp3d.b128.t10": ("loss_gap", "grad_gap", "change_gap", "first_loss_gap",
                                    "row_loss_gap", "nonfinite_window_losses"),
        "ndh_eval.mp3d.b256.t40": ("logit_gap", "first_logit_gap", "step_logit_gap", "state_gap",
                                   "bad_actions")}


def _readings(cell, dtype="float32", seed=11):
    """The readings ``GAPS`` names for the cell, compared or not."""
    cell["config"]["dtype"] = dtype
    out = run.run_cell(cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter())
    got = {**out["other_readings"], **{k: v["value"] for k, v in out["checks"].items()}}
    return {k: got[k] for k in GAPS[cell["entry"]["name"]]}


def test_pretrain_agrees():
    got = _readings(tiny.cell("pretrain.s768.b64"))
    assert got["loss_gap"] < 1e-6 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-3, got


@pytest.mark.parametrize("name", ["ndh_train.mp3d.b128.t10", "ndh_eval.mp3d.b256.t40"])
def test_ndh_agrees_where_the_stop_slot_is_the_zero_slot(monkeypatch, name):
    """Every viewpoint with max_candidates neighbours: the program's stop
    slot is then its zero slot, as the published agent's is."""
    cell = tiny.cell(name)
    tiny.complete_graphs(monkeypatch, cell["config"]["agent"]["max_candidates"] + 1, cell)
    got = _readings(cell)
    assert all(v < 1e-4 for v in got.values()), got


@pytest.mark.parametrize("name", ["ndh_train.mp3d.b128.t10", "ndh_eval.mp3d.b256.t40"])
def test_ndh_stop_slot_departs_from_the_published_agent(monkeypatch, name):
    """With fewer neighbours than slots the program scores "stop" on the
    first padded candidate's features (view 0 of the panorama and the angle
    of heading 0), where the published agent appends a zero vector: the
    readings are far from round-off (the NDH cells stay out of the
    benchmark until the program is mended)."""
    cell = tiny.cell(name)
    tiny.complete_graphs(monkeypatch, cell["config"]["agent"]["max_candidates"], cell)
    got = _readings(cell)
    key = "loss_gap" if "loss_gap" in got else "logit_gap"
    assert got[key] > 0.05, got


def test_program_stop_slot_holds_padding_features():
    from h100bench.loops import common
    from visitron_torch.agents.viewpoint import gather_step_inputs

    cell = tiny.cell("ndh_train.mp3d.b128.t10")
    cfg, traffic = cell["config"], cell["traffic"]
    world, table = common.ndh_world(cfg, traffic, 3, torch.device("cpu"))
    runtime, _ = common.ndh_program(cfg, traffic, world, table, 4, torch.device("cpu"), 4)
    rows = torch.arange(world.num_rows)
    _, _, cand, invalid = gather_step_inputs(runtime, rows, torch.full_like(rows, 12))
    counts = runtime.count[rows]
    stop = cand[rows, counts]
    assert not invalid[rows, counts].any()
    assert (counts < runtime.max_candidates).all() and (stop.abs().sum(-1) > 0).all()
