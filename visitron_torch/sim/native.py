"""ctypes bindings to the native (C++) graph-simulator engine
(visitron_tpu/sim/native.py).

``NativeGraphSimulator`` exposes the same API as the Python
``GraphSimulator`` (simulator.py); the two are interchangeable and held to
each other in tests/test_torch_sim.py.  The shared library is built with
``g++ -O3`` at first use from the port's own copy of the source
(visitron_torch/sim/csrc/graph_sim.cpp) into visitron_torch/_build/
(git-ignored), under a name keyed by a hash of the source and the flags, so a
changed source is rebuilt.  This is host code; the card plays no part.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.graph import NavGraph
from visitron_torch.sim.simulator import Location, SimState

_SRC = Path(__file__).resolve().parent / "csrc" / "graph_sim.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build_library() -> str:
    """The path of the built library: compiled unless a library of this
    source and these flags is there already.  The compiler writes a file of
    its own, renamed into place, so concurrent builds never load a partial
    library."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libgraph_sim-{key}.so"
    if not lib.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    return str(lib)


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library())
    lib.vsim_world_new.restype = ctypes.c_void_p
    lib.vsim_world_new.argtypes = [ctypes.c_double]
    lib.vsim_world_free.argtypes = [ctypes.c_void_p]
    lib.vsim_world_add_viewpoints.restype = ctypes.c_int32
    lib.vsim_world_add_viewpoints.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
    lib.vsim_world_add_edges.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    lib.vsim_sim_new.restype = ctypes.c_void_p
    lib.vsim_sim_new.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vsim_sim_free.argtypes = [ctypes.c_void_p]
    lib.vsim_new_episode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.vsim_make_action.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.vsim_make_action_at.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double]
    lib.vsim_get_state.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.vsim_get_navigable.restype = ctypes.c_int32
    lib.vsim_get_navigable.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


class NativeGraphSimulator:
    """GraphSimulator API over the C++ engine (global-row world layout)."""

    MAX_NAV = 64

    def __init__(self, graphs: dict[str, NavGraph] | None = None):
        self._libh = _load()
        self._graphs: dict[str, NavGraph] = {}
        self._row_base: dict[str, int] = {}
        self._row_to_scan: list[tuple[int, str]] = []  # (base, scan) sorted
        self._pending: list[str] = []
        self.batch_size = 1
        self.image_w, self.image_h = 640, 480
        self.vfov = math.radians(60)
        self._world = None
        self._sim = None
        for g in (graphs or {}).values():
            self.add_graph(g)

    # -- configuration ------------------------------------------------------
    def add_graph(self, graph: NavGraph) -> None:
        self._graphs[graph.scan] = graph
        self._pending.append(graph.scan)

    def set_batch_size(self, n: int) -> None:
        self.batch_size = int(n)

    def set_camera_resolution(self, w: int, h: int) -> None:
        self.image_w, self.image_h = int(w), int(h)

    def set_camera_vfov(self, v: float) -> None:
        self.vfov = float(v)

    def set_rendering_enabled(self, flag: bool) -> None:
        if flag:
            raise NotImplementedError

    def set_discretized_viewing_angles(self, flag: bool) -> None:
        if not flag:
            raise NotImplementedError

    @property
    def hfov(self) -> float:
        return geo.camera_hfov(self.image_w, self.image_h, self.vfov)

    def initialize(self) -> None:
        lib = self._libh
        self._world = ctypes.c_void_p(lib.vsim_world_new(self.hfov))
        for scan in sorted(self._graphs):
            g = self._graphs[scan]
            pos = np.ascontiguousarray(g.positions, dtype=np.float64)
            base = lib.vsim_world_add_viewpoints(
                self._world, g.num_viewpoints, _ptr(pos, ctypes.c_double))
            self._row_base[scan] = int(base)
            self._row_to_scan.append((int(base), scan))
            iu, iv = np.nonzero(np.triu(g.adjacency, k=1))
            edges = np.ascontiguousarray(
                np.stack([iu + base, iv + base], axis=1).astype(np.int32))
            lib.vsim_world_add_edges(self._world, len(iu), _ptr(edges, ctypes.c_int32))
        self._row_to_scan.sort()
        self._sim = ctypes.c_void_p(lib.vsim_sim_new(self._world, self.batch_size))
        self._scan_of_elem = [""] * self.batch_size

    # -- helpers --------------------------------------------------------------
    def _row(self, scan: str, vp) -> int:
        g = self._graphs[scan]
        idx = g.index[vp] if isinstance(vp, str) else int(vp)
        return self._row_base[scan] + idx

    def _unrow(self, row: int) -> tuple[str, int]:
        base, scan = max((b, s) for b, s in self._row_to_scan if b <= row)
        return scan, row - base

    # -- episode control -------------------------------------------------------
    def new_episode(self, scans, viewpoints, headings, elevations=None) -> None:
        if elevations is None:
            elevations = [0.0] * self.batch_size
        rows = np.array([self._row(s, v) for s, v in zip(scans, viewpoints)], np.int32)
        h = np.asarray(headings, np.float64)
        e = np.asarray(elevations, np.float64)
        self._scan_of_elem = list(scans)
        self._libh.vsim_new_episode(self._sim, _ptr(rows, ctypes.c_int32),
                                    _ptr(h, ctypes.c_double), _ptr(e, ctypes.c_double))

    def make_action(self, indices, headings, elevations) -> None:
        ix = np.asarray(indices, np.int32)
        dh = np.asarray(headings, np.float64)
        de = np.asarray(elevations, np.float64)
        self._libh.vsim_make_action(self._sim, _ptr(ix, ctypes.c_int32),
                                    _ptr(dh, ctypes.c_double), _ptr(de, ctypes.c_double))

    def make_action_at(self, i, index, heading, elevation) -> None:
        self._libh.vsim_make_action_at(self._sim, int(i), int(index),
                                       float(heading), float(elevation))

    # -- state -------------------------------------------------------------------
    def raw_state(self):
        rows = np.zeros(self.batch_size, np.int32)
        views = np.zeros(self.batch_size, np.int32)
        steps = np.zeros(self.batch_size, np.int32)
        self._libh.vsim_get_state(self._sim, _ptr(rows, ctypes.c_int32),
                                  _ptr(views, ctypes.c_int32), _ptr(steps, ctypes.c_int32))
        return rows, views, steps

    def get_states(self) -> list[SimState]:
        rows, views, steps = self.raw_state()
        return [self._state(i, int(rows[i]), int(views[i]), int(steps[i]))
                for i in range(self.batch_size)]

    def get_state_at(self, i: int) -> SimState:
        rows, views, steps = self.raw_state()
        return self._state(int(i), int(rows[i]), int(views[i]), int(steps[i]))

    def _state(self, i: int, row: int, view: int, step: int) -> SimState:
        scan, local = self._unrow(row)
        g = self._graphs[scan]
        cap = self.MAX_NAV
        out_rows = np.zeros(cap, np.int32)
        rel_h = np.zeros(cap, np.float64)
        rel_e = np.zeros(cap, np.float64)
        dist = np.zeros(cap, np.float64)
        n = self._libh.vsim_get_navigable(
            self._sim, i, cap, _ptr(out_rows, ctypes.c_int32),
            _ptr(rel_h, ctypes.c_double), _ptr(rel_e, ctypes.c_double),
            _ptr(dist, ctypes.c_double))
        n = min(n, cap)
        px, py, pz = (float(c) for c in g.positions[local])
        cur = Location(g.viewpoints[local], local, 0.0, 0.0, 0.0, px, py, pz)
        locs = [cur]
        for k in range(n):
            nscan, nlocal = self._unrow(int(out_rows[k]))
            ng = self._graphs[nscan]
            nx, ny, nz = (float(c) for c in ng.positions[nlocal])
            locs.append(Location(ng.viewpoints[nlocal], nlocal, float(rel_h[k]),
                                 float(rel_e[k]), float(dist[k]), nx, ny, nz))
        return SimState(
            scanId=scan, location=cur,
            heading=geo.heading_of_view(view), elevation=geo.elevation_of_view(view),
            viewIndex=view, step=step, navigableLocations=locs)
