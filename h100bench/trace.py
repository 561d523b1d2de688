"""Device traces: one torch.profiler session over a few steps, read from
kineto's raw records, and reduced to what the per-layer readers take.

``KERNEL_KINDS`` is a frozen copy of the program's classification of device
kernels by name (visitron_torch/testing/nav_profile.py), so that a later
change to the program's copy cannot move this yardstick.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter
from dataclasses import dataclass, field

# Device kernels by kind (first match).  K1, K4 and K5 launch the same device
# kernels (csrc/attention.cu).
KERNEL_KINDS = (("K1/K4/K5 attention", ("::attention_fwd", "::attention_bwd")),
                ("K3 softmax-CE", ("::ce_fwd", "::ce_bwd")),
                ("K2f add+LayerNorm", ("::add_layernorm_fwd",)),
                ("K2b add+LayerNorm backward", ("::add_layernorm_bwd",)),
                ("GEMM (cuBLAS/CUTLASS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
                ("host-to-device copies", ("Memcpy HtoD",)),
                ("optimizer (foreach)", ("foreach", "multi_tensor")),
                ("other elementwise / reductions", ("",)))
COPIES = "host-to-device copies"
NAME_WIDTH = 120


def kind_of(name: str) -> str:
    """The first kind of ``KERNEL_KINDS`` whose keys a part of ``name`` is."""
    return next(kind for kind, keys in KERNEL_KINDS if any(key in name for key in keys))


@dataclass
class Trace:
    """The device records (name, start ns, end ns) and host op records of
    ``steps`` traced steps that took ``wall_s`` under the profiler."""
    steps: int
    wall_s: float
    device: list
    host: list = field(repr=False, default_factory=list)
    t0_ns: int = 0
    t1_ns: int = 0

    def busy_intervals(self) -> list:
        """The union of the device records' intervals, merged, in order."""
        out = []
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self, kind: str | None = None) -> list:
        """Device records other than host-to-device copies, or those of ``kind``."""
        return [r for r in self.device
                if (kind_of(r[0]) == kind if kind else kind_of(r[0]) != COPIES)]

    def seconds(self, match) -> float:
        """Summed device seconds of the records whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e9

    def kind_seconds(self, kind: str) -> float:
        return self.seconds(lambda n: kind_of(n) == kind)

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...] of the ``n`` device operations that took
        the most time over the traced window."""
        total = Counter()
        for name, s, e in self.device:
            total[name[:NAME_WIDTH]] += (e - s) / 1e9
        return [[k, v] for k, v in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host activity, seconds], ...]: the device's idle time inside the
        traced window, each gap named by the host operation that overlaps it
        most ("python" where host ops cover less than half of it), summed by
        name, the ``n`` largest."""
        busy = self.busy_intervals()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda r: r[1])
        starts = [r[1] for r in host]
        longest = max((e - s for _, s, e in host), default=0)
        total = Counter()
        for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            lo = bisect.bisect_left(starts, gs - longest)
            hi = bisect.bisect_right(starts, ge)
            best, cover = "python", 0
            for name, s, e in host[lo:hi]:
                ov = min(e, ge) - max(s, gs)
                if ov > cover:
                    best, cover = name, ov
            if cover * 2 < ge - gs:
                best = "python"
            total[best[:NAME_WIDTH]] += (ge - gs) / 1e9
        return [[k, v] for k, v in total.most_common(n)]


def profile(run_steps, steps: int, sync) -> Trace:
    """Trace ``run_steps()`` (``steps`` steps, then ``sync()``) under one
    torch.profiler session with CPU and CUDA activities.  A session that
    records no device record raises: there is no device time to report."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        run_steps()
        sync()
        wall_s = time.perf_counter() - t0
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in ("[memory]", "[OutOfMemory]") or getattr(e, "is_hidden_event", lambda: False)():
            continue
        rec = (name, e.start_ns(), e.end_ns())
        (device if e.device_type() == cuda else host).append(rec)
    if not device:
        raise RuntimeError("the profile holds no device record: no device time to report")
    t0_ns = min(min(r[1] for r in device), min((r[1] for r in host), default=2 ** 63))
    t1_ns = max(r[2] for r in device)
    return Trace(steps, wall_s, device, host, t0_ns, t1_ns)
