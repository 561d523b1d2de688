"""The readers behind the metric files: each takes a run's record
(loops/common.py:Record) and returns the metric, or None where the run has
nothing to read for it.  A traced run's stretch of steps ran once without
the profiler (its wall: ``traced_wall_s``) and once under it (the device
records): shares of the wall divide by the unprofiled wall."""

from __future__ import annotations

from h100bench import flops

GEMM, ELEMENTWISE, OPTIMIZER = ("GEMM (cuBLAS/CUTLASS)", "other elementwise / reductions",
                                "optimizer (foreach)")
KERNELS = {"attn": ("::attention_fwd", "::attention_bwd"),
           "ln": ("::add_layernorm_fwd", "::add_layernorm_bwd")}


def rate(rec, unit: str):
    """Units of ``unit`` completed in the window over the window's seconds."""
    if unit not in rec.work or rec.window_s <= 0:
        return None
    return rec.work[unit] / rec.window_s


def setup_s(rec):
    return rec.setup_s


def _trace(rec, loop: str):
    return rec.trace if rec.loop == loop and rec.trace is not None else None


def mfu(rec, loop: str):
    """Model FLOPs of the stretch over its unprofiled wall x the bf16 peak, %."""
    if _trace(rec, loop) is None or rec.traced_wall_s <= 0:
        return None
    return 100.0 * rec.traced_flops / (rec.traced_wall_s * flops.PEAK_FLOPS)


def idle_share(rec, loop: str):
    """1 - device busy (union of kernel intervals, profiled) over the
    unprofiled wall of the same steps, %."""
    t = _trace(rec, loop)
    if t is None or rec.traced_wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / rec.traced_wall_s)


def busy_ms(rec, loop: str):
    """Device busy (union of kernel intervals) a step, profiled, ms."""
    t = _trace(rec, loop)
    return None if t is None else 1e3 * t.busy_s() / t.steps


def kernels_per_step(rec, loop: str):
    t = _trace(rec, loop)
    return None if t is None else len(t.kernels()) / t.steps


def kind_ms(rec, loop: str, kind: str):
    """Device ms a step in one kind of tracing.KERNEL_KINDS."""
    t = _trace(rec, loop)
    if t is None:
        return None
    return 1e3 * t.kind_seconds(kind) / t.steps


def roofline(rec, loop: str, kernel: str):
    """The launches' least time over their device time, %: None where the
    trace holds no such kernel."""
    t = _trace(rec, loop)
    if t is None or not rec.traced_launches.get(kernel):
        return None
    keys = KERNELS[kernel]
    device_s = t.seconds(lambda n: any(k in n for k in keys))
    if device_s <= 0:
        return None
    return 100.0 * flops.bound_s(rec.traced_launches[kernel]) / device_s

