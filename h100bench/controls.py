"""The readings that a cell's limits are set from: the program's on many
seeds, the control's (the reference in the program's place, its products
in float8 e4m3: the step below the configuration's bfloat16) and each
planted fault's, at the cell's own size.  Not part of a benchmark run.

    python3 -m h100bench.controls --workload pretrain.s768.b64 --seeds 1 2 3 \\
        --what program control half_batch

prints one JSON line a seed and kind: {"seed", "what", readings...}.  A
state left unchanged by the step reads 1 on the gradient and change numbers
by their definition and needs no run.

The faults: ``half_batch`` (training) leaves each compared batch's second
half out of the reference put in the program's place; ``altered_first``
(argmax evaluation) serves, at the first step of each sampled episode, the
action the fp32 reference ranks second; ``state_dropped`` (argmax
evaluation) plants in the program a rollout that does not carry its
recurrent state: every decoder step starts from the state its first one got
(:func:`drop_state`).  The evaluation's control takes at each step of the
program's episodes the action that the float8 reference, along the same
poses from its own state, ranks first.  The NDH lines also name the three
leaves that read worst on the gradient and on the change (``worst_grad``,
``worst_change``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import numpy as np

from h100bench import compare, spec
from h100bench.loops import common
from h100bench.reference.core import Prec


def training(cell: dict, seed: int, what: list, device) -> list:
    """Readings of a training cell whose loop has ``pool`` and
    ``reference_steps``: each faulty or lower-precision reference against the
    float32 reference over the same first three batches."""
    loop = importlib.import_module(f"h100bench.loops.{cell['traffic']['loop']}")
    cfg, traffic = cell["config"], cell["traffic"]
    out = []
    if "program" in what:
        rec = loop.run(cell, seed, 0.2, False, device, time.perf_counter())
        out.append({"seed": seed, "what": "program", **rec.readings})
    kinds = [w for w in what if w != "program"]
    if not kinds:
        return out
    first = loop.pool(cfg, traffic, seed, device)[:loop.COMPARED_STEPS]
    ref = loop.reference_steps(cfg, traffic, first, seed, device)
    for kind in kinds:
        got = loop.reference_steps(cfg, traffic, first, seed, device,
                                   prec=Prec("fp8") if kind == "control" else None,
                                   drop_half=kind == "half_batch")
        out.append({"seed": seed, "what": kind, **compare.training(got[0], ref[0], got[1], ref[1],
                                                                   got[2], ref[2])})
    return out


def ndh_training(cell: dict, seed: int, what: list, device) -> list:
    """Readings of the NDH training loop: the program's, and each faulty or
    lower-precision reference's, against one float32 reference run."""
    from h100bench.loops import ndh_train as loop

    cfg, traffic = cell["config"], cell["traffic"]
    _, (world, table, eps, first, *prog) = loop.drive(cell, seed, 0.2, False, device,
                                                      time.perf_counter())
    ref = loop.reference_steps(cfg, traffic, world, table, eps, first, seed, device)
    out = []
    for kind in what:
        if kind == "program":
            got = loop.program_steps(cfg, seed, device, *prog)
        else:
            got = loop.reference_steps(cfg, traffic, world, table, eps, first, seed, device,
                                       prec=Prec("fp8") if kind == "control" else None,
                                       drop_half=kind == "half_batch")
        out.append({"seed": seed, "what": kind, **loop.readings(got, ref),
                    **worst_leaves(got, ref)})
    return out


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: |program's norm - reference's| over the larger of the
    reference's and the median leaf's}, as ``compare.training`` takes them."""
    norms = {k: float(ref[k].double().norm()) for k in ref}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in ref}


def worst_leaves(got, ref) -> dict:
    """The three published leaves that read worst on the first gradient and
    on the change that ``compare.training`` holds, and the leaves it leaves
    out of the change with the largest of their reference gradients over
    the median leaf's."""
    from h100bench.loops import ndh_train as loop

    grad_p, grad_r = loop.published_leaves(got[2]), loop.published_leaves(ref[2])
    change_p, change_r = loop.published_leaves(got[3]), loop.published_leaves(ref[3])
    norms = {k: float(v.double().norm()) for k, v in grad_r.items()}
    med = float(np.median(list(norms.values())))
    moving = {k: v for k, v in change_r.items() if norms[k] >= compare.SKIP_BELOW * med}
    left = [k for k in change_r if k not in moving]

    def worst(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    return {"worst_grad": worst(leaf_gaps(grad_p, grad_r)),
            "worst_change": worst(leaf_gaps(change_p, moving)),
            "left_out": left, "left_out_grad": max((norms[k] / med for k in left), default=0.0)}


class Patches:
    """``setattr`` with an ``undo``, as pytest's monkeypatch has them."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name: str, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo = []


def drop_state(mp) -> None:
    """Plant "a state not carried" in the program's argmax rollout: every
    decoder step of a rollout starts from the (h, c) its first step got.
    ``mp``: pytest's monkeypatch or :class:`Patches`."""
    from visitron_torch.agents import ViewpointAgent

    rollout, step = ViewpointAgent.decode_rollout, ViewpointAgent.decode_step

    def decode_rollout(self, params, ctx, h1, c, *args, **kwargs):
        self.first_state = (h1, c)
        return rollout(self, params, ctx, h1, c, *args, **kwargs)

    def decode_step(self, params, h1, c, *args, **kwargs):
        h1, c = getattr(self, "first_state", (h1, c))
        return step(self, params, h1, c, *args, **kwargs)

    mp.setattr(ViewpointAgent, "decode_rollout", decode_rollout)
    mp.setattr(ViewpointAgent, "decode_step", decode_step)


def serving(cell: dict, seed: int, what: list, device) -> list:
    """Readings of the NDH argmax evaluation over a sample of the episodes
    one pass of the program served, judged by the float32 reference: the
    program's, the float8 reference's first-ranked actions along the same
    poses from its own states (control), the program's with each episode's
    first action altered, and the program with its state dropped."""
    from h100bench.loops import ndh_eval as loop
    from h100bench.reference import layout, ndh as ref_ndh

    cfg, traffic = cell["config"], cell["traffic"]
    block = traffic["reference_block"]
    out = []
    if set(what) - {"state_dropped"}:
        _, judged = loop.serve(cell, seed, 0.2, False, device, time.perf_counter())
        walks, own, steps, gaps, bad = loop.replay(cfg, traffic, *judged, seed, device)
        world, table, eps, last, picked, states = judged
        cands = ref_ndh.Candidates(world)
        P = common.weights(layout.ndh_shapes(cfg), seed, device)
    for kind in what:
        if kind == "program":
            got = loop.readings(walks, own, steps, gaps, bad)
        elif kind == "control":
            chosen = [eps[idx] for idx in picked]
            low = ref_ndh.rollout(P, chosen, walks, cands, table, cfg["bert"], cfg["agent"],
                                  Prec("fp8"), block)
            low_walks = [(w[0], w[1], [int(np.argmax(lg)) for lg in r["logits"]])
                         for w, r in zip(walks, low)]
            carried = [(r["ctx"], r["ctx_mask"], r["h"], r["c"]) for r in low]
            got = loop.readings(low_walks, own,
                                *loop.from_states(P, table, cands, carried, low_walks, block), 0)
        elif kind == "altered_first":
            alt = [(w[0], w[1], [int(np.argsort(-r["logits"][0])[1]) if len(r["logits"][0]) > 1
                                 else w[2][0]] + w[2][1:]) for w, r in zip(walks, own)]
            carried = [states[idx] for idx in picked]
            got = loop.readings(alt, own, *loop.from_states(P, table, cands, carried, alt, block),
                                bad)
        else:
            mp = Patches()
            drop_state(mp)
            try:
                _, dropped = loop.serve(cell, seed, 0.2, False, device, time.perf_counter())
            finally:
                mp.undo()
            got = loop.readings(*loop.replay(cfg, traffic, *dropped, seed, device))
        out.append({"seed": seed, "what": kind, **got})
    return out


KINDS = {"pretrain": (training, ("program", "control", "half_batch")),
         "ndh_train": (ndh_training, ("program", "control", "half_batch")),
         "ndh_eval": (serving, ("program", "control", "altered_first", "state_dropped"))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+",
                   help="program, control and the loop's faults (default: all of them)")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100bench.controls: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    readings, kinds = KINDS[cell["traffic"]["loop"]]
    what = args.what or list(kinds)
    if set(what) - set(kinds):
        p.error(f"--what takes {', '.join(kinds)} for this cell")
    for seed in args.seeds:
        for line in readings(cell, seed, what, torch.device("cuda", 0)):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
