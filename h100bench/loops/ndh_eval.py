"""NDH argmax evaluation: ``ViewpointAgent.test`` over the evaluation
split's batches (``NavEpisodeBatcher.eval_batches``), one pass after
another; each batch is one ``device_rollout`` and one read-back of its
trajectories.

Set-up builds the world and the agent with weights from the seed and runs
one pass, which warms every shape the passes use (the same batches each
time).  The window counts episodes completed.  In the window the harness
keeps, by reference, what the pass in progress carried into each decoder
step (the recurrent state, the encoder's context and mask).  Once it has
closed, a sample of the episodes the last pass finished, drawn from the
seed with the longest among them, is judged by the fp32 reference: each
served step taken from the state the program carried into it, each state
against the reference's step from the one before, and the first step and
the whole episode from the reference's own encoder and state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import compare, flops, params, trace as tracing
from h100bench.loops import common
from h100bench.reference import layout, ndh as ref_ndh
from h100bench.reference.core import Prec, set_fp32_math


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    rec, judged = serve(cell, seed, seconds, trace, device, t_start)
    t_ref = time.perf_counter()
    rec.readings = readings(*replay(cell["config"], cell["traffic"], *judged, seed, device))
    rec.failed = int(rec.readings["bad_actions"])
    rec.limits = dict(cell["traffic"]["limits"])
    rec.correct, _ = compare.judge(rec.readings, rec.limits)
    rec.reference_s = time.perf_counter() - t_ref
    return rec


class Carried:
    """What the program carried into each decoder step of the pass in
    progress, kept by reference (no copy, no sync): per batch its
    instances, encoder context and mask, and per step the (h, c) passed in."""

    def __init__(self, agent):
        self.on, self.batches = True, []
        rollout, step = agent.device_rollout, agent.decode_step

        def device_rollout(params, batch, *args, **kwargs):
            if self.on:
                self.batches.append({"inst_idx": list(batch["inst_idx"]), "steps": []})
            return rollout(params, batch, *args, **kwargs)

        def decode_step(params, h1, c, ctx, ctx_mask, *args, **kwargs):
            if self.on:
                b = self.batches[-1]
                if not b["steps"]:
                    b["ctx"], b["ctx_mask"] = ctx, ctx_mask
                b["steps"].append((h1, c))
            return step(params, h1, c, ctx, ctx_mask, *args, **kwargs)

        agent.device_rollout, agent.decode_step = device_rollout, decode_step

    def states(self, picked: list) -> dict:
        """{instance: (ctx, ctx_mask, h (T, H), c (T, H))} of ``picked``,
        float32 copies."""
        out = {}
        for b in self.batches:
            for i, idx in enumerate(b["inst_idx"]):
                if idx in picked:
                    out[idx] = (b["ctx"][i].float().clone(), b["ctx_mask"][i].clone(),
                                torch.stack([h[i] for h, _ in b["steps"]]).float(),
                                torch.stack([c[i] for _, c in b["steps"]]).float())
        return out


def serve(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    """Set-up, the window and the traced pass, the program then freed:
    (record, (world, table, episodes, the last pass's trajectories, the
    sampled instances, the states carried into their steps)) for
    :func:`replay`."""
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

    carried = Carried(agent)
    passes, done, last = 0, 0, None
    t0 = time.perf_counter()
    while True:
        carried.batches = []
        last = dict(agent.test(weights, batcher.eval_batches()))
        passes, done = passes + 1, done + len(last)
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    carried.on = False
    rec.work = {"passes": passes, "episodes": done}
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
    picked = sample(last, seed, traffic["sample"])
    states = carried.states(picked)
    del agent, runtime, batcher, weights, carried
    common.free()
    return rec, (world, table, eps, last, picked, states)


def sample(last: dict, seed: int, k: int) -> list:
    """``k`` of the instances a pass finished, drawn from the seed, the one
    with the most moves among them."""
    idxs = sorted(last)
    moves = [len(last[i]) - 1 for i in idxs]
    return [idxs[j] for j in common.sample(common.derive(seed, "sample"), len(idxs), k,
                                           [int(np.argmax(moves))])]


def actions_of(world, cands, eps: list, last: dict, picked: list) -> tuple:
    """(episodes, actions, bad): per sampled episode the rows it moved to
    and -1 for stop, and the count of served poses (start pose, each move's
    heading and elevation) that are not the reference's."""
    chosen, actions, bad = [], [], 0
    for idx in picked:
        e, path = eps[idx], last[idx]
        sc, off = world.scans[e.scan], int(world.offsets[e.scan])
        index = {vp: j for j, vp in enumerate(sc.viewpoints)}
        acts = [off + index.get(vp, -10 ** 9) for vp, _, _ in path[1:]]
        chosen.append(e)
        actions.append(acts + [-1])
        row, view = off + e.path[0], ref_ndh.start_view(e.heading)
        if (path[0][0] != sc.viewpoints[e.path[0]]
                or abs(path[0][1] - ref_ndh.view_heading(view)) > 1e-6):
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
    return chosen, actions, bad


def replay(cfg, traffic, world, table, eps, last, picked, states, seed, device) -> tuple:
    """(walks, own, judged, state gaps, bad) of the sampled episodes:
    ``walks`` the program's (rows, views, served slots) (``ref_ndh.walk``),
    ``own`` the fp32 reference driven along them from its own encoder and
    state (``ref_ndh.rollout``), ``judged`` and the gaps
    :func:`from_states` of the states the program carried, ``bad`` the
    poses counted by :func:`actions_of`."""
    set_fp32_math()
    cands = ref_ndh.Candidates(world)
    chosen, actions, bad = actions_of(world, cands, eps, last, picked)
    walks = [ref_ndh.walk(world, cands, e, a, traffic["episode_len"])
             for e, a in zip(chosen, actions)]
    P = common.weights(layout.ndh_shapes(cfg), seed, device)
    own = ref_ndh.rollout(P, chosen, walks, cands, table, cfg["bert"], cfg["agent"],
                          Prec("fp32"), traffic["reference_block"])
    judged, gaps = from_states(P, table, cands, [states[idx] for idx in picked], walks,
                               traffic["reference_block"])
    return walks, own, judged, gaps, bad


def from_states(P, table, cands, carried: list, walks: list, block: int) -> tuple:
    """The fp32 reference's decoder step from each state carried into a
    served step: ``carried`` per episode (ctx, ctx_mask, h (n, H), c (n,
    H)), ``walks`` per episode (rows, views, served slots).  Returns the
    (logits of the valid slots, served slot) of every served step, and for
    every step but an episode's last the relative gap between the state
    carried into the next step and the one the reference's step gives (the
    larger of h's and c's)."""
    jobs = [(i, t) for i, w in enumerate(walks) for t in range(len(w[2]))]
    records, gaps = [], []
    for lo in range(0, len(jobs), block):
        chunk = jobs[lo:lo + block]
        width = max(carried[i][0].shape[0] for i, _ in chunk)
        ctx = torch.stack([_pad(carried[i][0], width, 0.0) for i, _ in chunk])
        mask = torch.stack([_pad(carried[i][1], width, True) for i, _ in chunk])
        h = torch.stack([carried[i][2][t] for i, t in chunk])
        c = torch.stack([carried[i][3][t] for i, t in chunk])
        rows = [walks[i][0][t] for i, t in chunk]
        views = [walks[i][1][t] for i, t in chunk]
        logit, h1, c1 = ref_ndh.step_from(P, table, cands, rows, views, h, c, ctx, mask,
                                          Prec("fp32"))
        logit = logit.double().cpu().numpy()
        for j, (i, t) in enumerate(chunk):
            records.append((logit[j, :int(cands.count[rows[j]]) + 1], walks[i][2][t]))
            if t + 1 < len(walks[i][2]):
                gaps.append(max(_rel(carried[i][2][t + 1], h1[j]),
                                _rel(carried[i][3][t + 1], c1[j])))
    return records, gaps


def _pad(x, width: int, value):
    if x.shape[0] == width:
        return x
    pad = torch.full((width - x.shape[0],) + tuple(x.shape[1:]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def _rel(got, ref) -> float:
    return float(torch.linalg.vector_norm(got.double() - ref.double())
                 / torch.linalg.vector_norm(ref.double()).clamp_min(1e-30))


def readings(walks, own, judged, gaps, bad: int) -> dict:
    """``step_logit_gap``: the widest gap of a served action's logit below
    the fp32 reference's best, each step taken from the state the program
    carried into it; ``state_gap``: the median relative gap between the
    state carried into a step and the reference's step from the one before;
    ``first_logit_gap``: the
    widest gap at each episode's first step from the reference's own
    encoder, and ``logit_gap`` over the whole episode from its own state
    (from the second step on, an attention weight that rounding tips parts
    the two sides' states); ``bad_actions``: served actions that name no
    candidate, and poses that are not the reference's."""
    g = np.asarray(gaps if gaps else [0.0])
    step = compare.served(judged)
    whole = compare.served([r for w, ep in zip(walks, own) for r in zip(ep["logits"], w[2])])
    return {"step_logit_gap": step["logit_gap"],
            "state_gap": float(np.median(g)),
            "first_logit_gap": compare.served([(ep["logits"][0], w[2][0])
                                               for w, ep in zip(walks, own)])["logit_gap"],
            "logit_gap": whole["logit_gap"],
            "bad_actions": step["bad_actions"] + bad}
