"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from h100bench import spec

HERE = Path(spec.__file__).resolve().parent
REFERENCE = ("visitron_torch",) + spec.FORBIDDEN


def test_forbidden_names_are_compared_whole():
    assert spec.forbidden_modules(["visitron_torch", "visitron_torch.ops", "jaxtyping",
                                   "flaxen", "torch"]) == []
    assert spec.forbidden_modules(["jax.numpy", "visitron_tpu.models", "flax"]) == [
        "flax", "jax.numpy", "visitron_tpu.models"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def _reachable(start: str) -> set:
    """The h100bench modules reachable from ``start`` by import statements,
    and every name they import."""
    seen, names, todo = set(), set(), [start]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = HERE.parent / (mod.replace(".", "/") + ".py")
        if not path.exists():
            path = HERE.parent / mod.replace(".", "/") / "__init__.py"
        if not path.exists():
            continue
        for name in _imports(path):
            names.add(name)
            if name.split(".")[0] == "h100bench":
                todo.append(name)
    return names


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        names = _reachable(f"h100bench.reference.{path.stem}")
        assert not {n for n in names if n.split(".")[0] in REFERENCE}, path.name


def test_no_jax_reachable_from_the_entry():
    names = set()
    for mod in ["h100bench.run", "h100bench.controls"] + [
            f"h100bench.loops.{p.stem}" for p in (HERE / "loops").glob("*.py")]:
        names |= _reachable(mod)
    assert not spec.forbidden_modules(names)


def test_a_run_loads_no_jax():
    """A whole run of the tiny pretraining cell on the CPU, in a process of
    its own, leaves no forbidden module in sys.modules."""
    code = ("import sys, time, torch\n"
            "from h100bench import run, spec\n"
            "from h100bench.tests import tiny\n"
            "out = run.run_cell(tiny.cell('pretrain.s768.b64'), 5, 0.2, False,"
            " torch.device('cpu'), time.perf_counter())\n"
            "print(__import__('json').dumps(spec.forbidden_modules(sys.modules)))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
