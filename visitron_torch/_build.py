"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources in parallel, and the objects are linked into ONE shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers: the build
takes seconds).  The library lands in ``visitron_torch/_build/`` (git-ignored)
under a name keyed by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: the first kernel launch calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("attention.cu", "layernorm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# The C entry points and their ctypes signatures.  Every pointer and the
# stream are c_void_p: an undeclared argument would be passed as a 32-bit int.
_P, _I, _LL, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float)
SIGNATURES = {
    "vt_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _LL, _LL, _LL, _LL, _LL, _LL, _I, _U, _U, _F, _I, _F,
                         _P],
    "vt_attention_bwd": [_P] * 10 + [_I, _I, _I, _I] + [_LL] * 6
                        + [_I, _U, _U, _F, _I, _F, _P],
    "vt_layernorm_fwd": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "vt_layernorm_bwd": [_P] * 7 + [_I, _I, _F, _I, _I, _P],
}

_lib = None
_lock = threading.Lock()
# What the last build in this process did: seconds, whether it compiled or
# reused a cached library, and the ptxas resource lines per source.
build_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> dict:
    """Compile every source in parallel, then link; returns ptxas lines."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    procs = {}
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC_DIR / name),
               "-o", str(obj)]
        procs[name] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    ptxas = {}
    failed = []
    for name, (obj, proc) in procs.items():
        text, _ = proc.communicate()
        ptxas[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling" in ln]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = out.with_suffix(f".{tag}.so")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
            *(str(obj) for obj, _ in procs.values())]
    res = subprocess.run(link, capture_output=True, text=True)
    for obj, _ in procs.values():
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return ptxas


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out = BUILD_DIR / f"libvisitron_kernels_{_key()}.so"
        compiled = not out.exists()
        ptxas = _compile(nvcc_path(), out) if compiled else {}
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, compiled=compiled,
                          library=str(out), ptxas=ptxas)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
