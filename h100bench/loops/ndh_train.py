"""NDH teacher-forced fine-tuning: ``NavEpisodeBatcher.train_batches`` feeding
``ViewpointAgent.train_step_fn``, one step after another.

Set-up builds the world, the program's runtime and agent with weights from
the seed, and the one training object the window then drives; its first
three steps, through the window's own feed and call, are the ones the
reference follows, and a step on each further length bucket of the traffic
warms the rest.  The window counts completed (batch x T) decoder actions.
"""

from __future__ import annotations

import time

import torch

from h100bench import compare, flops, params, trace as tracing
from h100bench.loops import common
from h100bench.reference import adam as ref_adam, layout, ndh as ref_ndh
from h100bench.reference.core import Prec, Streams, set_fp32_math

COMPARED_STEPS = 3
TRACED_STEPS = 8


def bucket_of(lengths, bucket: int, cap: int) -> int:
    return min(cap, -(-int(max(lengths)) // bucket) * bucket)


def warm_batches(insts, runtime, traffic, seen: set):
    """One batch for each length bucket the traffic reaches and the first
    steps did not: the instances of that bucket first, filled up with
    shorter ones."""
    from visitron_torch.agents import NavEpisodeBatcher

    b, bucket, cap = traffic["batch"], traffic["length_bucket"], traffic.get("max_seq_length", 512)
    by_len = sorted(insts, key=lambda it: it.length)
    for top in sorted({bucket_of([it.length], bucket, cap) for it in insts} - seen):
        fit = [it for it in by_len if it.length <= top]
        if len(fit) < b:
            continue
        chosen = fit[-b:]
        if bucket_of([it.length for it in chosen], bucket, cap) != top:
            continue
        yield next(NavEpisodeBatcher(chosen, runtime, batch_size=b,
                                     path_type=traffic["path_type"],
                                     seed=traffic["batcher_seed"]).train_batches(
            1, episode_len=traffic["episode_len"]))


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    from visitron_torch.agents import NavEpisodeBatcher

    cfg, traffic = cell["config"], cell["traffic"]
    b, T = traffic["batch"], traffic["episode_len"]
    bucket, cap = traffic["length_bucket"], traffic.get("max_seq_length", 512)
    rec = common.Record("ndh_train")
    st = common.Stages(device, t_start)
    world, table = common.ndh_world(cfg, traffic, seed, device)
    st.done("world_and_table")
    eps = common.episodes(world, traffic, seed, "train", traffic["instances"])
    insts = common.nav_instances(world, eps)
    st.done("episodes")
    agent_seed = common.derive(seed, "agent")
    runtime, agent = common.ndh_program(cfg, traffic, world, table, agent_seed, device, T)
    st.done("runtime_and_agent")
    shapes = layout.ndh_shapes(cfg)
    state = agent.init_state(params=params.nested(common.weights(shapes, seed, device)))
    st.done("params")
    batcher = NavEpisodeBatcher(insts, runtime, batch_size=b, path_type=traffic["path_type"],
                                seed=traffic["batcher_seed"], length_bucket=bucket)
    feed = batcher.train_batches(10 ** 12, episode_len=T)
    step = agent.train_step_fn()
    first, losses, seen = [], [], set()
    for i in range(COMPARED_STEPS):
        batch = next(feed)
        state, loss = step(state, batch)
        first.append(list(batch["inst_idx"]))
        losses.append(loss)
        seen.add(bucket_of(batch["lengths"], bucket, cap))
        if i == 0:
            mu1 = {k: v.detach().clone() for k, v in
                   params.flatten(common.adam_moment(state["opt_state"])).items()}
    p3 = {k: v.detach().clone() for k, v in params.flatten(state["params"]).items()}
    st.done("first_steps")
    for batch in warm_batches(insts, runtime, traffic, seen):
        state, _ = step(state, batch)
    st.done("warm_buckets")
    rec.setup_stages, rec.setup_s = st.seconds, st.total()

    window_losses, n = [], 0
    t0 = time.perf_counter()
    while True:
        state, loss = step(state, next(feed))
        window_losses.append(loss)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    rec.window_s = time.perf_counter() - t0
    rec.work = {"steps": n, "actions": n * b * T}
    rec.attempted = n

    if trace:
        kept = []
        common.sync(device)
        t1 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            kept.append(next(feed))
            state, _ = step(state, kept[-1])
        common.sync(device)
        rec.traced_wall_s = time.perf_counter() - t1

        def replay():
            nonlocal state
            for batch in kept:
                state, _ = step(state, batch)

        rec.trace = tracing.profile(replay, TRACED_STEPS, lambda: common.sync(device))
        bert_cfg, agent_cfg = cfg["bert"], cfg["agent"]
        rec.traced_launches = {"attn": [], "ln": []}
        for batch in kept:
            s = bucket_of(batch["lengths"], bucket, cap)
            rec.traced_flops += flops.ndh_flops(b, s, T, bert_cfg, agent_cfg, train=True)
            for k, v in flops.bert_launches(b, s, bert_cfg, train=True).items():
                rec.traced_launches[k] += v
    rec.memory_peak_bytes = common.memory_peak(device)
    window = torch.stack(window_losses).float().cpu()
    rec.failed = int((~torch.isfinite(window)).sum())
    prog_losses = [float(x) for x in losses]
    del state, step, feed, batcher, agent, runtime, window_losses, losses
    common.free()

    t_ref = time.perf_counter()
    readings = reference(cfg, traffic, world, table, eps, first, seed, agent_seed, device,
                         prog_losses, mu1, p3)
    readings["nonfinite_window_losses"] = float(rec.failed)
    rec.readings = readings
    rec.limits = {**traffic["limits"], "nonfinite_window_losses": 0}
    rec.correct, _ = compare.judge(rec.readings, rec.limits)
    rec.reference_s = time.perf_counter() - t_ref
    return rec


def reference_steps(cfg, traffic, world, table, eps, first, seed, agent_seed, device):
    """(losses, first clipped gradient, change after the steps) of the plain
    fp32 reference over the batches ``first`` (instance indices), from the
    weights of the seed."""
    set_fp32_math()
    p0 = common.weights(layout.ndh_shapes(cfg), seed, device)
    adam = ref_adam.Adam(p0, {**cfg["optimizer"], "schedule": None})
    cands = ref_ndh.Candidates(world)
    streams = Streams(agent_seed, device)
    P, losses, g1 = p0, [], None
    for idxs in first:
        loss, grads = ref_ndh.train_loss_grads(
            P, [eps[i] for i in idxs], world, cands, table, traffic["episode_len"], cfg["bert"],
            cfg["agent"], agent_seed, Prec("fp32"), traffic["reference_block"], streams)
        P, clipped = adam.step(P, grads)
        g1 = clipped if g1 is None else g1
        losses.append(loss)
    return losses, g1, common.leaves_minus(P, p0)


def reference(cfg, traffic, world, table, eps, first, seed, agent_seed, device, prog_losses,
              mu1, p3) -> dict:
    """The readings of the program's first three steps (losses, Adam's mu
    after the first, parameters after the third) against the reference's."""
    losses, g1, change = reference_steps(cfg, traffic, world, table, eps, first, seed,
                                         agent_seed, device)
    p0 = common.weights(layout.ndh_shapes(cfg), seed, device)
    prog_grad = {k: v / (1 - ref_adam.B1) for k, v in mu1.items()}
    return compare.training(prog_losses, losses, prog_grad, g1,
                            common.leaves_minus(p3, p0), change)
