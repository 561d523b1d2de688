"""NDH teacher-forced fine-tuning: ``NavEpisodeBatcher.train_batches`` feeding
``ViewpointAgent.train_step_fn``, one step after another.

Set-up builds the world, the program's runtime and agent with weights from
the seed, and the one training object the window then drives; its first
three steps, through the window's own feed and call, are the ones the
reference follows, and a step on each further length bucket of the traffic
warms the rest.  The window counts completed (batch x T) decoder actions.
In the first step the harness keeps the candidate logits of each decoder
step, from which each row's loss at each step is read.
"""

from __future__ import annotations

import math
import time

import numpy as np
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
    rec, judged = drive(cell, seed, seconds, trace, device, t_start)
    cfg, traffic = cell["config"], cell["traffic"]
    t_ref = time.perf_counter()
    world, table, eps, first, *prog = judged
    ref = reference_steps(cfg, traffic, world, table, eps, first, seed, device)
    rec.readings = program_readings(cfg, seed, device, *prog, ref)
    rec.readings["nonfinite_window_losses"] = float(rec.failed)
    rec.limits = {**traffic["limits"], "nonfinite_window_losses": 0}
    rec.correct, _ = compare.judge(rec.readings, rec.limits)
    rec.reference_s = time.perf_counter() - t_ref
    return rec


def drive(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set-up, the window and the traced stretch, the program then freed:
    (record, (world, table, episodes, the compared steps' instance indices,
    their losses, the first step's row losses, Adam's mu after the first,
    the parameters after the third)) for :func:`reference_steps` and
    :func:`program_readings`."""
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
        if i == 0:
            logits = keep_logits(agent)
            state, loss = step(state, batch)
            del agent.decode_step
            rows = row_losses(logits, batch)
        else:
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
    return rec, (world, table, eps, first, prog_losses, rows, mu1, p3)


def keep_logits(agent) -> list:
    """The masked candidate logits of each decoder step the agent runs, kept
    (detached) until ``del agent.decode_step``."""
    kept, raw = [], agent.decode_step

    def decode_step(*args, **kwargs):
        out = raw(*args, **kwargs)
        kept.append(out[0].detach())
        return out

    agent.decode_step = decode_step
    return kept


def row_losses(logits: list, batch: dict):
    """(rows, T) float64: each row's cross-entropy at each step of the
    teacher-forced loss from the kept logits, NaN where it has ended (and
    on rows that the step left without logits)."""
    teacher, active = np.asarray(batch["teacher"]), np.asarray(batch["active"], bool)
    out = np.full(active.shape, np.nan)
    for t, logit in enumerate(logits):
        lg, n = logit.double(), logit.shape[0]
        tgt = torch.as_tensor(np.where(active[:n, t], teacher[:n, t], 0), device=lg.device)
        ce = (torch.logsumexp(lg, -1) - lg.gather(1, tgt[:, None].long())[:, 0]).cpu().numpy()
        out[:n, t] = np.where(active[:n, t], ce, np.nan)
    return out


def reference_steps(cfg, traffic, world, table, eps, first, seed, device,
                    prec: Prec | None = None, drop_half: bool = False):
    """(losses, first step's row losses, first clipped gradient, change
    after the steps) of the plain reference over the batches ``first``
    (instance indices), from the weights and the agent's dropout draws of
    the seed.  ``prec``: its precision (default fp32); ``drop_half``: each
    batch's second half left out, a planted fault."""
    set_fp32_math()
    agent_seed = common.derive(seed, "agent")
    p0 = common.weights(layout.ndh_shapes(cfg), seed, device)
    adam = ref_adam.Adam(p0, {**cfg["optimizer"], "schedule": None})
    cands = ref_ndh.Candidates(world)
    streams = Streams(agent_seed, device)
    P, losses, rows, g1 = p0, [], None, None
    for idxs in first:
        if drop_half:
            idxs = idxs[:len(idxs) // 2]
        loss, grads, step_rows = ref_ndh.train_loss_grads(
            P, [eps[i] for i in idxs], world, cands, table, traffic["episode_len"], cfg["bert"],
            cfg["agent"], agent_seed, prec or Prec("fp32"), traffic["reference_block"], streams)
        P, clipped = adam.step(P, grads)
        g1 = clipped if g1 is None else g1
        rows = step_rows if rows is None else rows
        losses.append(loss)
    return losses, rows, g1, common.leaves_minus(P, p0)


def program_readings(cfg, seed, device, prog_losses, rows, mu1, p3, ref) -> dict:
    """The readings of the program's first three steps (losses, the first
    step's row losses, Adam's mu after the first, parameters after the
    third) against ``ref``, the reference's (:func:`reference_steps`)."""
    return readings(program_steps(cfg, seed, device, prog_losses, rows, mu1, p3), ref)


def program_steps(cfg, seed, device, prog_losses, rows, mu1, p3) -> tuple:
    """The program's (losses, row losses, first gradient, change), as
    :func:`reference_steps` gives the reference's."""
    p0 = common.weights(layout.ndh_shapes(cfg), seed, device)
    prog_grad = {k: v / (1 - ref_adam.B1) for k, v in mu1.items()}
    return prog_losses, rows, prog_grad, common.leaves_minus(p3, p0)


def published_leaves(tree: dict) -> dict:
    """The leaves as the published BERT has them: each packed
    ``attention.qkv`` weight and bias split into its query, key and value
    parts (the key's bias has a gradient of nought under softmax, so its
    own leaf falls under ``compare.SKIP_BELOW``)."""
    out = {}
    for k, v in tree.items():
        if ".attention.qkv." in k:
            for part, x in zip(("query", "key", "value"), v.chunk(3, 0)):
                out[k.replace(".qkv.", f".{part}.")] = x
        else:
            out[k] = v
    return out


def readings(got, ref) -> dict:
    """``compare.training`` of (losses, first gradient, change) ``got``
    against ``ref`` over the published leaves (:func:`published_leaves`),
    and beside it: ``first_loss_gap``, the first step's loss alone (the
    later steps start from parameters that one Adam step has moved by the
    sign of each gradient, round-off's included); ``row_loss_gap``, the
    median over the first step's active (row, step) pairs of the gap
    between the two sides' cross-entropies (infinite where they have not
    the same rows and steps)."""
    out = compare.training(got[0], ref[0], published_leaves(got[2]), published_leaves(ref[2]),
                           published_leaves(got[3]), published_leaves(ref[3]))
    out["first_loss_gap"] = abs(got[0][0] - ref[0][0]) / max(abs(ref[0][0]), 1e-30)
    p_rows, r_rows = got[1], ref[1]
    if p_rows.shape != r_rows.shape or (np.isnan(p_rows) != np.isnan(r_rows)).any():
        out["row_loss_gap"] = math.inf
    else:
        out["row_loss_gap"] = float(np.median(np.abs(p_rows - r_rows)[~np.isnan(r_rows)]))
    return out
