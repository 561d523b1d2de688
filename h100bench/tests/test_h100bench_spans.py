"""The readers of the program's spans and counters on hand-made traces:
each step's share of the device idle inside the copy span and inside the
compute spans, to the nanosecond, the median step's read; a gap outside every
span counted nowhere; overlapping spans counted once; a stall in one step
ignored; None without a trace, on another loop, or from a program without
the spans or the counter."""

import sys

import pytest
import torch

from h100bench import spans, spec, trace as tracing
from h100bench.loops import common, pretrain
from h100bench.tests import tiny

MS = 1_000_000  # ns


def _steps(stalls):
    """Device and host records of one step per entry of ``stalls``, ms.  A
    step of 100 ms (plus its stall): the copy span [0, 20] holds 10 ms of
    idle, forward [20, 50] and backward [45, 80] overlap and their union
    holds 15, the optimizer [80, 95 + stall] holds 5 + stall, and [95 +
    stall, 100 + stall] lies outside every span: a step's idle is 40 ms plus
    its stall, its busy 60 ms."""
    device, host, o = [], [], 0
    for stall in stalls:
        device += [("Memcpy HtoD (Pageable -> Device)", o + 10 * MS, o + 20 * MS),
                   ("gemm", o + 30 * MS, o + 45 * MS), ("ce_fwd", o + 55 * MS, o + 90 * MS)]
        host += [("vt.batch_to_device", o, o + 20 * MS), ("aten::to", o + MS, o + 19 * MS),
                 ("vt.forward", o + 20 * MS, o + 50 * MS),
                 ("aten::linear", o + 21 * MS, o + 29 * MS), ("vt.backward", o + 45 * MS, o + 80 * MS),
                 ("vt.optimizer", o + 80 * MS, o + (95 + stall) * MS)]
        o += (100 + stall) * MS
    # the last step ends at its last device record
    device.append(("gemm", o, o + MS))
    return device, host, o + MS


def _record(stalls=(0, 0, 0), host=None, loop="pretrain"):
    device, made, t1 = _steps(stalls)
    rec = common.Record(loop)
    rec.trace = tracing.Trace(len(stalls), t1 / 1e9, device, made if host is None else host,
                              0, t1)
    return rec


def _read(metric, rec):
    return spec.reader(metric)(rec)


def test_copy_gap_reads_its_exact_share():
    """The copy holds 10 ms of each step's 40 ms of idle."""
    assert spans.step_shares(_record().trace, ("vt.batch_to_device",)) == [0.25] * 3
    assert _read("copy_idle_share.pretrain", _record()) == 25.0


def test_overlapping_spans_count_once_and_outer_gaps_nowhere():
    rec = _record()
    compute = spans.step_shares(rec.trace, ("vt.forward", "vt.backward", "vt.optimizer"))
    assert compute == [0.625] * 3  # 25 of 40 ms: [45, 50] once; [95, 100] nowhere
    assert _read("compute_idle_share.pretrain", rec) == 62.5


def test_a_stall_in_one_step_moves_no_reading():
    """A collector's stall of 300 ms inside one step's optimizer moves
    neither reading (the median step's share); the two readings sum to no
    more than 100, here with 2 steps of 4 stalled."""
    plain, stalled = _record(), _record(stalls=(0, 300, 0))
    assert spans.step_shares(stalled.trace, ("vt.batch_to_device",))[1] == 10 / 340
    for metric in ("copy_idle_share.pretrain", "compute_idle_share.pretrain"):
        assert _read(metric, stalled) == _read(metric, plain)
    stalled = _record(stalls=(300, 0, 300, 0))
    total = sum(_read(m, stalled) for m in ("copy_idle_share.pretrain",
                                            "compute_idle_share.pretrain"))
    assert total <= 100.0


def test_the_stretch_before_the_first_step_counts_nowhere():
    device, host, t1 = _steps((0, 0))
    early = [(n, s + 50 * MS, e + 50 * MS) for n, s, e in device]
    late = [(n, s + 50 * MS, e + 50 * MS) for n, s, e in host]
    # 50 ms of idle inside an optimizer span before the first copy
    trace = tracing.Trace(2, 0.0, early, late + [("vt.optimizer", 0, 50 * MS)], 0, t1 + 50 * MS)
    assert spans.step_shares(trace, ("vt.optimizer",)) == [5 / 40] * 2


@pytest.mark.parametrize("metric", ["copy_idle_share.pretrain", "compute_idle_share.pretrain",
                                    "h2d_mb.pretrain"])
def test_none_without_a_trace_or_on_another_loop(metric):
    rec = _record()
    rec.trace = None
    assert _read(metric, rec) is None
    assert _read(metric, _record(loop="ndh_train")) is None


@pytest.mark.parametrize("metric", ["copy_idle_share.pretrain", "compute_idle_share.pretrain"])
def test_none_from_a_program_without_the_spans(metric):
    host = _steps((0, 0, 0))[1]
    assert _read(metric, _record(host=[r for r in host if not r[0].startswith("vt.")])) is None
    # the phases' spans without the copy's, which starts each step
    assert _read(metric, _record(host=[r for r in host if r[0] != spans.STEP_START])) is None


def test_h2d_mb_reads_the_set_counters(monkeypatch):
    from visitron_torch.train.pretrain import batch_to_device

    monkeypatch.setattr(batch_to_device, "bytes", 3 * 143_851_776)
    monkeypatch.setattr(batch_to_device, "calls", 3)
    assert _read("h2d_mb.pretrain", _record()) == 143.851776
    monkeypatch.setattr(batch_to_device, "calls", 0)
    assert _read("h2d_mb.pretrain", _record()) is None
    monkeypatch.delattr(batch_to_device, "bytes")
    assert _read("h2d_mb.pretrain", _record()) is None
    monkeypatch.setitem(sys.modules, "visitron_torch.train.pretrain", None)
    assert _read("h2d_mb.pretrain", _record()) is None


def test_h2d_mb_reads_the_programs_copies_of_the_pool(monkeypatch):
    """The tiny cell's pool through the program's own copy: the reading is
    the bytes a batch on the wire, integers as int64, floats as fp32."""
    from visitron_torch.train.pretrain import batch_to_device

    monkeypatch.setattr(batch_to_device, "bytes", 0)
    monkeypatch.setattr(batch_to_device, "calls", 0)
    cell = tiny.cell("pretrain.s768.b64")
    batches = pretrain.pool(cell["config"], cell["traffic"], 21, torch.device("cpu"))
    for batch in batches:
        batch_to_device(batch, "cpu")
    per_batch = sum(a.size * (4 if a.dtype.kind == "f" else 8) for a in batches[0].values())
    assert batch_to_device.calls == len(batches)
    assert _read("h2d_mb.pretrain", _record()) == per_batch / 1e6
