"""The NDH train step's device profile (tools/profile_nav_step.py's
counterpart).

Builds the exact ``bench.py`` NDH train step (the seed-3 world of 4 scans x
60 viewpoints, 2048-d features, dialogs of 2-6 turns of 10-30 words,
BERT-base bf16, batch 64, S 512, T 10, planner path, one trimmed batch),
runs it once warm, then ``steps`` times under torch.profiler (CPU + CUDA
activities), and sums the CUDA kernels' time a step by kind
(``KERNEL_KINDS``, first match) and by name.

    from visitron_torch.testing import nav_profile
    step, state, batch = nav_profile.build_step()            # on the card
    summary, state = nav_profile.profile_steps(step, state, batch)

A profile with no CUDA kernel in it (any profile on the CPU) raises: there
is no device time to report.
"""

from __future__ import annotations

import time

import torch

from visitron_torch.testing import realscale

EPISODE_LEN = 10
# bench.py's world: realscale.WORLD's features and dialogs (2048-d, 2-6 turns
# of 10-30 words) on 4 scans x 60 viewpoints drawn from seed 3.
WORLD = dict(seed=3, num_scans=4, viewpoints_per_scan=60)

# Device kernels by kind (first match).  K1, K4 and K5 launch the same
# device kernels (csrc/attention.cu).
KERNEL_KINDS = (("K1/K4/K5 attention", ("::attention_fwd", "::attention_bwd")),
                ("K3 softmax-CE", ("::ce_fwd", "::ce_bwd")),
                ("K2f add+LayerNorm", ("::add_layernorm_fwd",)),
                ("K2b add+LayerNorm backward", ("::add_layernorm_bwd",)),
                ("GEMM (cuBLAS/CUTLASS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
                ("host-to-device copies", ("Memcpy HtoD",)),
                ("optimizer (foreach)", ("foreach", "multi_tensor")),
                ("other elementwise / reductions", ("",)))
# The device kernel that one launch of a port kernel runs exactly once (K1,
# K4 and K5 share theirs; K1b/K4b/K5b run dq and dk/dv kernels, K2b its row
# kernel and the final sum).
LAUNCH_KERNELS = (("K1f/K4f/K5f", "::attention_fwd"), ("K1b/K4b/K5b", "::attention_bwd_dq"),
                  ("K2f", "::add_layernorm_fwd"), ("K2b", "::add_layernorm_bwd_sum"),
                  ("K3f", "::ce_fwd"), ("K3b", "::ce_bwd"))
NAME_WIDTH = 120


def build_step(device=None):
    """(step, state, batch): ``ViewpointAgent.train_step_fn()``, a fresh
    state and one trimmed teacher batch of the JAX tool's set-up on
    ``device`` (None: the card), built with realscale's helpers (128 train
    instances at S 512, vocabulary 4096, BERT-base bf16, batch 64)."""
    rw = realscale.build_world(device, **WORLD)
    instances, tok = realscale.instances(rw)
    agent = realscale.make_agent(rw, tok, EPISODE_LEN)
    batch = realscale.first_batch(rw, instances, "planner_path", EPISODE_LEN)
    return agent.train_step_fn(), agent.init_state(), agent.trim_batch(batch)


def kind_of(name: str) -> str:
    """The first kind of ``KERNEL_KINDS`` whose keys a part of ``name`` is."""
    return next(kind for kind, keys in KERNEL_KINDS if any(key in name for key in keys))


def device_kernels(prof) -> list:
    """(name, us) of each device record of a finished torch.profiler
    session: the records ``prof.events()`` lists, read from the raw ones
    (``events()`` builds a Python object for every host op too, some
    seconds for one NDH step's ~10^5 records)."""
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and e.name() not in ("[memory]", "[OutOfMemory]")
            and not getattr(e, "is_hidden_event", lambda: False)()]


def summarize(kernels: list, steps: int, wall_s: float, top: int = 20) -> dict:
    """Per-step sums of ``kernels`` ((name, us) of the device records of
    ``steps`` steps that took ``wall_s`` on the host clock): the wall, the
    device busy time and idle share, the kernel count, time and kernels by
    kind, the launches of each port kernel (``LAUNCH_KERNELS``), and the
    ``top`` kernels by time."""
    if not kernels:
        raise RuntimeError("the profile holds no CUDA kernel: there is no device time "
                           "to summarize (profile on the card)")
    by_name: dict = {}
    groups: dict = {}
    for name, us in kernels:
        for table, key in ((by_name, name[:NAME_WIDTH]), (groups, kind_of(name))):
            n, total = table.get(key, (0, 0.0))
            table[key] = (n + 1, total + us)
    busy_us = sum(us for _, us in kernels)
    per = lambda us: round(us / 1e3 / steps, 4)  # noqa: E731
    ranked = lambda table: sorted(table.items(), key=lambda kv: -kv[1][1])  # noqa: E731
    return {
        "steps": steps,
        "ms_per_step": round(wall_s * 1e3 / steps, 4),
        "busy_ms_per_step": per(busy_us),
        "idle_share": round(1 - busy_us / (wall_s * 1e6), 4),
        "kernels_per_step": len(kernels) / steps,
        "groups_ms_per_step": {k: per(us) for k, (_, us) in ranked(groups)},
        "groups_kernels_per_step": {k: n / steps for k, (n, _) in ranked(groups)},
        "launches_per_step": {k: sum(key in name for name, _ in kernels) / steps
                              for k, key in LAUNCH_KERNELS},
        "top_ops_ms_per_step": {k: per(us) for k, (_, us) in ranked(by_name)[:top]},
    }


def profile_steps(step, state, batch, steps: int = 3):
    """(summary, state): one warm step, then ``steps`` steps under
    torch.profiler (CPU + CUDA), summarized by :func:`summarize`; the wall
    is the host clock over the profiled steps up to a synchronize, and so
    includes the profiler's own cost."""
    from torch.profiler import ProfilerActivity, profile

    def sync(loss):
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)

    state, loss = step(state, batch)
    sync(loss)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, batch)
        sync(loss)
        wall_s = time.perf_counter() - t0
    return summarize(device_kernels(prof), steps, wall_s), state
