"""The program's own spans and counters, read from a run's record.

Spans are host records of the traced stretch's profiler session (the
program's ``visitron_torch/utils/tracing.py`` names them), so they share the
device records' clock.  A span's reading is its share of a step's device
idle, the median step's: milliseconds of idle on the profiled timeline are
stretched by the profiler's host cost, the unprofiled stretch's wall by the
collector's stalls (tens of ms a step where one lands in it), and one stall
inside the profiled stretch moves a mean over its steps by as much.  Program
counters are attributes of the program's functions, read from the program's
process (the one the loop ran in) after the loop returns.
"""

from __future__ import annotations

import statistics

STEP_START = "vt.batch_to_device"  # the first phase of each pretraining step


def merged(intervals) -> list:
    """[start, end] intervals merged, in order, empty ones dropped.
    ``trace.py:Trace.busy_intervals`` merges only the trace's device
    records, and that frozen file takes no other."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> int:
    """Summed overlap of two merged, ordered interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def step_shares(trace, names) -> list | None:
    """For each traced step, the share of the device's idle in it that lies
    inside the union of the host records named ``names``.  A step starts at
    a ``STEP_START`` record and ends at the next (the last at ``t1_ns``).
    None where the trace holds no step start or no such record."""
    starts = sorted(s for n, s, _ in trace.host
                    if n == STEP_START and trace.t0_ns <= s < trace.t1_ns)
    spans = merged((s, e) for n, s, e in trace.host if n in names)
    if not starts or not spans:
        return None
    busy = trace.busy_intervals()
    shares = []
    for lo, hi in zip(starts, starts[1:] + [trace.t1_ns]):
        inside = merged((max(s, lo), min(e, hi)) for s, e in spans)
        idle = hi - lo - _overlap([[lo, hi]], busy)
        idle_inside = sum(e - s for s, e in inside) - _overlap(inside, busy)
        shares.append(idle_inside / idle if idle > 0 else 0.0)
    return shares


def idle_share(rec, loop: str, names) -> float | None:
    """The share of a step's device idle inside the spans ``names``, the
    median step's, %.  The median is a step's own (``median_low``), so one
    step's stall moves it not at all, and readings of disjoint spans sum to
    no more than 100.  None where the run has no trace, ran another loop, or
    holds no such span."""
    t = rec.trace if rec.loop == loop else None
    shares = None if t is None else step_shares(t, names)
    return None if shares is None else 100.0 * statistics.median_low(shares)
