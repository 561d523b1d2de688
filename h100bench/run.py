"""Run one cell of the benchmark once.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (its configuration and traffic mix, found by
name through BENCHMARK.json), measures for ``--seconds``, checks the timed
path's output against the plain reference, and prints the result as the
last line of standard output, one JSON object; the numbers compared, each
with its limit, are the last lines of standard error.  ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.  Exits
non-zero, printing no result, without a CUDA device (or with fewer than the
cell asks for), or when JAX or the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Keep libraries from loading JAX or flax on their own, and keep CUPTI set up
# between profiler sessions.
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("TEARDOWN_CUPTI", "0")

from h100bench import spec  # noqa: E402


def _number(x):
    return x if isinstance(x, int) or math.isfinite(x) else str(x)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run ``cell`` (``spec.cell``'s dict) once on ``device``: the result
    object, the ``checks`` key last."""
    import torch

    loop = importlib.import_module(f"h100bench.loops.{cell['traffic']['loop']}")
    rec = loop.run(cell, seed, seconds, trace, device, t_start)
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    out = {"correct": bool(rec.correct), "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                      "count": cell["entry"]["chips"],
                      "memory_peak_bytes": rec.memory_peak_bytes}}
    if trace and rec.trace is not None:
        out["device"]["busy_s"] = rec.trace.busy_s()
        out["device"]["window_s"] = rec.trace.wall_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                            "idle_gaps": rec.trace.idle_gaps(10)}
    out["setup_stages_s"] = {**rec.setup_stages, "reference_after_window": rec.reference_s}
    out["other_readings"] = {k: v for k, v in rec.readings.items() if k not in rec.limits}
    out["checks"] = {k: {"value": _number(rec.readings[k]), "limit": rec.limits[k]}
                     for k in rec.limits}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_START)
    loaded = spec.forbidden_modules(sys.modules)
    if loaded:
        print(f"h100bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    print(json.dumps({"setup_stages_s": out.pop("setup_stages_s"),
                      "other_readings": out.pop("other_readings")}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
