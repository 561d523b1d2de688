"""The readings that a cell's limits are set from: the program's on many
seeds, the control's (the reference in the program's place, its products
in float8 e4m3: the step below the configuration's bfloat16) and each
planted fault's, at the cell's own size.  Not part of a benchmark run.

    python3 -m h100bench.controls --workload pretrain.s768.b64 --seeds 1 2 3 \\
        --what program control half_batch

prints one JSON line a seed and kind: {"seed", "what", readings...}.  A
state left unchanged by the step reads 1 on the gradient and change numbers
by their definition and needs no run.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from h100bench import compare, spec
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--what", nargs="+", default=["program", "control", "half_batch"],
                   choices=["program", "control", "half_batch"])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100bench.controls: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        for line in training(cell, seed, args.what, torch.device("cuda", 0)):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
