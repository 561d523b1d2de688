"""Batched discretized graph simulator (rendering-free MatterSim semantics).

The reference trains entirely against MatterSim with rendering disabled
(tasks/viewpoint_select/data_loader.py:40-46, utils.py:321-337): the simulator
is then a pure pose/graph state machine over the connectivity graph.  This
module defines those semantics precisely and implements them batched:

  * 36 discretized views: 12 headings x 3 elevation rows (-30/0/+30 deg);
    ``viewIndex = 12*elevation_row + heading_step``.
  * ``new_episode`` snaps the given continuous heading/elevation to the
    nearest bins and resets ``step`` to 0.
  * ``make_action(ix, dh, de)`` first moves to ``navigableLocations[ix]``
    (0 = stay), then rotates: heading by sign(dh)*30deg (wrapping), elevation
    by sign(de)*30deg (clamped to the 3 rows). Camera pose persists across
    location changes.
  * ``navigableLocations`` = [current location] + unobstructed neighbors whose
    relative heading lies within +-HFOV/2 of the camera, sorted ascending by
    angular distance sqrt(rel_heading^2 + rel_elevation^2) (ties broken by
    neighbor index, deterministically). rel_heading is wrapped to (-pi, pi];
    rel_elevation is relative to the camera elevation.

A C++ engine (visitron_torch/sim/csrc, the port's copy of the JAX package's
source) implements the same state machine for host-loop throughput;
``make_simulator`` picks it when it builds.  These are host modules of the
port (visitron_tpu/sim/simulator.py), with no device work: the port's
training paths read NavRuntime's tables instead.  Both engines are held to
each other and to the JAX package's in tests/test_torch_sim.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.graph import NavGraph


@dataclass
class Location:
    """One entry of ``navigableLocations`` (MatterSim ``Viewpoint`` parity)."""

    viewpointId: str
    ix: int  # index into the scan's viewpoint table
    rel_heading: float
    rel_elevation: float
    rel_distance: float
    x: float
    y: float
    z: float


@dataclass
class SimState:
    """MatterSim ``SimState`` parity (rgb omitted; rendering is out of scope here)."""

    scanId: str
    location: Location
    heading: float
    elevation: float
    viewIndex: int
    step: int
    navigableLocations: list[Location]


class _ScanCache:
    """Per-scan precomputed neighbor geometry + per-(viewpoint, view) navigable lists."""

    def __init__(self, graph: NavGraph, hfov: float):
        self.graph = graph
        self.hfov = hfov
        v = graph.num_viewpoints
        # Ragged neighbor data per viewpoint.
        self.nbr_idx: list[np.ndarray] = []
        self.nbr_heading: list[np.ndarray] = []
        self.nbr_elevation: list[np.ndarray] = []
        self.nbr_distance: list[np.ndarray] = []
        pos = graph.positions.astype(np.float64)
        for u in range(v):
            nbrs = graph.neighbors(u)
            d = pos[nbrs] - pos[u]
            horiz = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
            heading = (np.pi / 2.0 - np.arctan2(d[:, 1], d[:, 0])) % (2 * np.pi)
            elevation = np.arctan2(d[:, 2], horiz)
            self.nbr_idx.append(nbrs.astype(np.int32))
            self.nbr_heading.append(heading)
            self.nbr_elevation.append(elevation)
            self.nbr_distance.append(np.sqrt((d**2).sum(-1)))
        # navigable[(vp, view_index)] -> int32 array of neighbor table rows
        self._navigable: dict[tuple[int, int], np.ndarray] = {}

    def navigable(self, vp: int, view_index: int) -> np.ndarray:
        """Ordered neighbor-row indices visible from (vp, view_index)."""
        key = (vp, view_index)
        got = self._navigable.get(key)
        if got is not None:
            return got
        cam_h = geo.heading_of_view(view_index)
        cam_e = geo.elevation_of_view(view_index)
        rel_h = geo.normalize_angle(self.nbr_heading[vp] - cam_h)
        rel_e = self.nbr_elevation[vp] - cam_e
        visible = np.abs(rel_h) <= self.hfov / 2.0 + 1e-9
        order = np.flatnonzero(visible)
        ang = np.sqrt(rel_h[order] ** 2 + rel_e[order] ** 2)
        order = order[np.argsort(ang, kind="stable")].astype(np.int32)
        self._navigable[key] = order
        return order


class GraphSimulator:
    """Batched graph-state simulator with the reference MatterSim API surface.

    API parity (data_loader.py:40-93): ``set_*`` configuration, ``initialize``,
    ``new_episode`` / ``make_action`` / ``get_states`` operate on the whole
    batch; ``make_action_at`` steps a single batch element (EnvBatch
    ``makeActionsatIndex`` semantics, with no-ops elsewhere being free).
    """

    def __init__(self, graphs: dict[str, NavGraph] | None = None):
        self._graphs: dict[str, NavGraph] = dict(graphs or {})
        self._caches: dict[str, _ScanCache] = {}
        self.batch_size = 1
        self.image_w = 640
        self.image_h = 480
        self.vfov = math.radians(60)
        self._initialized = False
        # Per-element state arrays.
        self._scan: list[str] = []
        self._vp: np.ndarray | None = None
        self._hstep: np.ndarray | None = None
        self._erow: np.ndarray | None = None
        self._step: np.ndarray | None = None

    # -- configuration (MatterSim parity) --------------------------------
    def set_batch_size(self, n: int) -> None:
        self.batch_size = int(n)

    def set_camera_resolution(self, w: int, h: int) -> None:
        self.image_w, self.image_h = int(w), int(h)

    def set_camera_vfov(self, vfov_rad: float) -> None:
        self.vfov = float(vfov_rad)

    def set_rendering_enabled(self, flag: bool) -> None:
        if flag:
            raise NotImplementedError(
                "rendering is handled by the offline feature pipeline, not the simulator"
            )

    def set_discretized_viewing_angles(self, flag: bool) -> None:
        if not flag:
            raise NotImplementedError("only discretized viewing angles are supported")

    def add_graph(self, graph: NavGraph) -> None:
        self._graphs[graph.scan] = graph

    def initialize(self) -> None:
        self._initialized = True
        self._vp = np.zeros(self.batch_size, dtype=np.int32)
        self._hstep = np.zeros(self.batch_size, dtype=np.int32)
        self._erow = np.ones(self.batch_size, dtype=np.int32)
        self._step = np.zeros(self.batch_size, dtype=np.int32)
        self._scan = [""] * self.batch_size

    @property
    def hfov(self) -> float:
        return geo.camera_hfov(self.image_w, self.image_h, self.vfov)

    def _cache(self, scan: str) -> _ScanCache:
        cache = self._caches.get(scan)
        if cache is None:
            cache = _ScanCache(self._graphs[scan], self.hfov)
            self._caches[scan] = cache
        return cache

    # -- episode control ---------------------------------------------------
    def new_episode(self, scans, viewpoints, headings, elevations=None) -> None:
        if not self._initialized:
            raise RuntimeError("call initialize() first")
        if len(scans) != self.batch_size:
            raise ValueError(f"{len(scans)} scans for a batch of {self.batch_size}")
        if elevations is None:
            elevations = [0.0] * self.batch_size
        for i in range(self.batch_size):
            g = self._graphs[scans[i]]
            self._scan[i] = scans[i]
            self._vp[i] = g.index[viewpoints[i]] if isinstance(viewpoints[i], str) else int(viewpoints[i])
            self._hstep[i] = geo.snap_heading(float(headings[i]))
            self._erow[i] = geo.snap_elevation(float(elevations[i]))
            self._step[i] = 0

    def make_action(self, indices, headings, elevations) -> None:
        for i in range(self.batch_size):
            self._apply(i, int(indices[i]), float(headings[i]), float(elevations[i]))

    def make_action_at(self, i: int, index: int, heading: float, elevation: float) -> None:
        """Step one batch element; all others keep their state (no-op cost O(1))."""
        self._apply(int(i), int(index), float(heading), float(elevation))

    def _apply(self, i: int, index: int, dh: float, de: float) -> None:
        if index != 0:
            cache = self._cache(self._scan[i])
            view = int(self._erow[i]) * 12 + int(self._hstep[i])
            order = cache.navigable(int(self._vp[i]), view)
            row = int(order[index - 1])  # navigableLocations[0] is current
            self._vp[i] = cache.nbr_idx[int(self._vp[i])][row]
        if dh > 0:
            self._hstep[i] = (self._hstep[i] + 1) % 12
        elif dh < 0:
            self._hstep[i] = (self._hstep[i] - 1) % 12
        if de > 0:
            self._erow[i] = min(int(self._erow[i]) + 1, 2)
        elif de < 0:
            self._erow[i] = max(int(self._erow[i]) - 1, 0)
        self._step[i] += 1

    # -- state -------------------------------------------------------------
    def get_states(self) -> list[SimState]:
        return [self._state(i) for i in range(self.batch_size)]

    def get_state_at(self, i: int) -> SimState:
        return self._state(int(i))

    def _state(self, i: int) -> SimState:
        scan = self._scan[i]
        g = self._graphs[scan]
        cache = self._cache(scan)
        vp = int(self._vp[i])
        hstep, erow = int(self._hstep[i]), int(self._erow[i])
        view = erow * 12 + hstep
        cam_h = geo.heading_of_view(view)
        cam_e = geo.elevation_of_view(view)
        px, py, pz = (float(c) for c in g.positions[vp])
        cur = Location(g.viewpoints[vp], vp, 0.0, 0.0, 0.0, px, py, pz)
        locs = [cur]
        order = cache.navigable(vp, view)
        for row in order:
            nbr = int(cache.nbr_idx[vp][row])
            nx, ny, nz = (float(c) for c in g.positions[nbr])
            locs.append(
                Location(
                    g.viewpoints[nbr],
                    nbr,
                    float(geo.normalize_angle(cache.nbr_heading[vp][row] - cam_h)),
                    float(cache.nbr_elevation[vp][row] - cam_e),
                    float(cache.nbr_distance[vp][row]),
                    nx,
                    ny,
                    nz,
                )
            )
        return SimState(
            scanId=scan,
            location=cur,
            heading=cam_h,
            elevation=cam_e,
            viewIndex=view,
            step=int(self._step[i]),
            navigableLocations=locs,
        )

    # Raw-array views used by the vectorized rollout paths.
    def raw_state(self) -> tuple[list[str], np.ndarray, np.ndarray]:
        """(scans, viewpoint indices, view indices) without building objects."""
        return list(self._scan), self._vp.copy(), (self._erow * 12 + self._hstep).copy()


def make_simulator(
    graphs: dict[str, NavGraph],
    batch_size: int = 1,
    image_w: int = 640,
    image_h: int = 480,
    vfov_deg: float = 60.0,
    prefer_native: bool = True,
):
    """Create a configured simulator; uses the C++ engine when available."""
    if prefer_native:
        import subprocess

        try:
            from visitron_torch.sim.native import NativeGraphSimulator

            sim = NativeGraphSimulator(graphs)
        except (ImportError, OSError, subprocess.CalledProcessError):
            sim = GraphSimulator(graphs)
    else:
        sim = GraphSimulator(graphs)
    sim.set_batch_size(batch_size)
    sim.set_camera_resolution(image_w, image_h)
    sim.set_camera_vfov(math.radians(vfov_deg))
    sim.initialize()
    return sim
