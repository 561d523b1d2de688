"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a configuration's file (``configs/<config>.json``), a traffic
mix's file (``workloads/<traffic>.json``) and a per-layer or end-to-end
metric's reader (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "visitron_tpu")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` of BENCHMARK.json: :func:`assemble` of its entry."""
    bench = bench or load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return assemble(found[0], bench)


def assemble(entry: dict, bench: dict) -> dict:
    """A cell from a workloads entry: the entry, its configuration's data
    (the file BENCHMARK.json names, else ``configs/<config>.json``), its
    traffic's data, and the metrics it reports ({"end_to_end": [...],
    "per_layer": [...]})."""
    name = entry["name"]
    files = {c["name"]: ROOT / c["file"] for c in bench["configs"]}
    with open(files.get(entry["config"], HERE / "configs" / f"{entry['config']}.json")) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {"entry": entry, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one the port must not load."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})
