"""NDH argmax evaluation: ``ViewpointAgent.test`` over the evaluation
split's batches (``NavEpisodeBatcher.eval_batches``), one pass after
another; each batch is one ``device_rollout`` and one read-back of its
trajectories.

Set-up builds the world and the agent with weights from the seed and runs
one pass, which warms every shape the passes use (the same batches each
time).  The window counts episodes completed.  Once it has closed, a sample
of the episodes it finished, drawn from the seed with the longest among
them, is replayed by the reference along the program's actions.
"""

from __future__ import annotations

import time

import numpy as np

from h100bench import compare, flops, params, trace as tracing
from h100bench.loops import common
from h100bench.reference import layout, ndh as ref_ndh
from h100bench.reference.core import Prec, set_fp32_math


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    from visitron_torch.agents import NavEpisodeBatcher

    cfg, traffic = cell["config"], cell["traffic"]
    b, T = traffic["batch"], traffic["episode_len"]
    rec = common.Record("ndh_eval")
    st = common.Stages(device, t_start)
    world, table = common.ndh_world(cfg, traffic, seed, device)
    st.done("world_and_table")
    eps = common.episodes(world, traffic, seed, "eval", traffic["instances"])
    insts = common.nav_instances(world, eps)
    st.done("episodes")
    runtime, agent = common.ndh_program(cfg, traffic, world, table, common.derive(seed, "agent"),
                                        device, T)
    st.done("runtime_and_agent")
    weights = params.nested(common.weights(layout.ndh_shapes(cfg), seed, device))
    batcher = NavEpisodeBatcher(insts, runtime, batch_size=b, path_type=traffic["path_type"],
                                length_bucket=traffic["length_bucket"])
    st.done("params")
    agent.test(weights, batcher.eval_batches())
    st.done("warm_pass")
    rec.setup_stages, rec.setup_s = st.seconds, st.total()

    passes = []
    t0 = time.perf_counter()
    while True:
        passes.append(dict(agent.test(weights, batcher.eval_batches())))
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    done = sum(len(p) for p in passes)
    rec.work = {"passes": len(passes), "episodes": done}
    rec.attempted = done

    if trace:
        common.sync(device)
        t1 = time.perf_counter()
        agent.test(weights, batcher.eval_batches())
        rec.traced_wall_s = time.perf_counter() - t1
        batches = list(batcher.eval_batches())
        rec.trace = tracing.profile(lambda: agent.test(weights, batcher.eval_batches()),
                                    len(batches), lambda: common.sync(device))
        rec.traced_launches = {"attn": [], "ln": []}
        for batch in batches:
            s = min(traffic.get("max_seq_length", 512),
                    -(-int(batch["lengths"].max()) // traffic["length_bucket"])
                    * traffic["length_bucket"])
            rec.traced_flops += flops.ndh_flops(b, s, T, cfg["bert"], cfg["agent"], train=False)
            for k, v in flops.bert_launches(b, s, cfg["bert"], train=False).items():
                rec.traced_launches[k] += v
    rec.memory_peak_bytes = common.memory_peak(device)
    del agent, runtime, batcher, weights
    common.free()

    t_ref = time.perf_counter()
    rec.readings = reference(cfg, traffic, world, table, eps, passes, seed, device)
    rec.failed = int(rec.readings["bad_actions"])
    rec.limits = dict(traffic["limits"])
    rec.correct, _ = compare.judge(rec.readings, rec.limits)
    rec.reference_s = time.perf_counter() - t_ref
    return rec


def served_actions(world, eps: list, passes: list, seed: int, k: int) -> tuple:
    """(episodes, actions, paths) of a sample of ``k`` finished episodes drawn
    from the seed, the one with the most moves among them: per step the row
    moved to, -1 for stop."""
    done = [(p, idx) for p, res in enumerate(passes) for idx in res]
    moves = [len(passes[p][idx]) - 1 for p, idx in done]
    pick = common.sample(common.derive(seed, "sample"), len(done), k, [int(np.argmax(moves))])
    chosen, actions, paths = [], [], []
    for i in pick:
        p, idx = done[i]
        e, path = eps[idx], passes[p][idx]
        sc, off = world.scans[e.scan], int(world.offsets[e.scan])
        index = {vp: j for j, vp in enumerate(sc.viewpoints)}
        acts = [off + index.get(vp, -10 ** 9) for vp, _, _ in path[1:]]
        chosen.append(e)
        actions.append(acts + [-1])
        paths.append(path)
    return chosen, actions, paths


def reference(cfg, traffic, world, table, eps, passes, seed, device) -> dict:
    """The readings of a sample of the window's episodes against the plain
    fp32 reference replaying them."""
    set_fp32_math()
    chosen, actions, paths = served_actions(world, eps, passes, seed, traffic["sample"])
    cands = ref_ndh.Candidates(world)
    bad = 0
    for e, acts, path in zip(chosen, actions, paths):
        row, view = int(world.offsets[e.scan]) + e.path[0], ref_ndh.start_view(e.heading)
        start = path[0]
        if (start[0] != world.scans[e.scan].viewpoints[e.path[0]]
                or abs(start[1] - ref_ndh.view_heading(view)) > 1e-6):
            bad += 1
        for (_, heading, elevation), nxt in zip(path[1:], acts):
            slot = cands.slot(row, nxt)
            if slot < 0:
                break
            view = int(cands.point[row, slot])
            if (abs(heading - ref_ndh.view_heading(view)) > 1e-6
                    or abs(elevation - ref_ndh.view_elevation(view)) > 1e-6):
                bad += 1
            row = nxt
    P = common.weights(layout.ndh_shapes(cfg), seed, device)
    recs = ref_ndh.rollout_logits(P, chosen, actions, world, cands, table, traffic["episode_len"],
                                  cfg["bert"], cfg["agent"], Prec("fp32"),
                                  traffic["reference_block"])
    out = compare.served([r for ep in recs for r in ep])
    out["bad_actions"] += bad
    return out
