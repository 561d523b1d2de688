"""Precomputed navigation-candidate tables.

The reference sweeps a probe simulator through all 36 views per (scan,
viewpoint) to enumerate navigable candidates, deduping each neighbor to its
most-centered view, and caches the result per episode
(tasks/viewpoint_select/data_loader.py:516-598).  We precompute the entire
table per scan as padded arrays once, so the rollout hot loop is pure integer
gathers — no simulator, no python dicts, no host<->device traffic for
features.

Per viewpoint u and neighbor n:
  * ``point``: the view index where n is most angularly centered (among views
    where n is visible, i.e. |rel_heading| <= HFOV/2);
  * ``nav_idx``: n's position in ``navigableLocations`` at that view (needed
    to drive the simulator with MatterSim-style location indices);
  * ``heading``/``elevation``: n's absolute bearing (the reference's
    ``normalized_heading``/``elevation``, data_loader.py:557-567);
  * candidate order matches the reference's dict-insertion order: first sweep
    view where the neighbor becomes visible, then navigable index.

Candidate features at runtime: scene_feature[u, point] ++ angle_feature(
heading - base_heading, elevation), plus a zero "stop" slot appended at
position ``count`` (agent.py:202-217).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.graph import NavGraph

MAX_CANDIDATES = 15  # padded K; Matterport max degree ~13 (reference caps none)


@dataclass
class ScanCandidateTable:
    scan: str
    count: np.ndarray  # (V,) int32 number of candidates per viewpoint
    nbr: np.ndarray  # (V, K) int32 neighbor viewpoint index, -1 padded
    point: np.ndarray  # (V, K) int32 best view index
    nav_idx: np.ndarray  # (V, K) int32 index into navigableLocations at `point`
    heading: np.ndarray  # (V, K) float32 absolute heading of neighbor
    elevation: np.ndarray  # (V, K) float32 absolute elevation of neighbor

    @property
    def max_candidates(self) -> int:
        return self.nbr.shape[1]


def build_candidate_table(
    graph: NavGraph,
    hfov: float,
    max_candidates: int = MAX_CANDIDATES,
) -> ScanCandidateTable:
    v = graph.num_viewpoints
    pos = graph.positions.astype(np.float64)
    count = np.zeros(v, np.int32)
    nbr = np.full((v, max_candidates), -1, np.int32)
    point = np.zeros((v, max_candidates), np.int32)
    nav_idx = np.zeros((v, max_candidates), np.int32)
    heading = np.zeros((v, max_candidates), np.float32)
    elevation = np.zeros((v, max_candidates), np.float32)

    views = np.arange(geo.NUM_VIEWS)
    cam_h = (views % geo.HEADINGS_PER_ROW) * geo.ANGLE_INC  # (36,)
    cam_e = (views // geo.HEADINGS_PER_ROW - 1) * geo.ANGLE_INC

    for u in range(v):
        nbrs = graph.neighbors(u)
        if len(nbrs) == 0:
            continue
        d = pos[nbrs] - pos[u]
        horiz = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
        abs_h = (np.pi / 2.0 - np.arctan2(d[:, 1], d[:, 0])) % (2 * np.pi)  # (N,)
        abs_e = np.arctan2(d[:, 2], horiz)
        # (N, 36) relative geometry for every view.
        rel_h = geo.normalize_angle(abs_h[:, None] - cam_h[None, :])
        rel_e = abs_e[:, None] - cam_e[None, :]
        visible = np.abs(rel_h) <= hfov / 2.0 + 1e-9
        ang = np.sqrt(rel_h**2 + rel_e**2)
        ang = np.where(visible, ang, np.inf)
        best_view = np.argmin(ang, axis=1).astype(np.int32)  # (N,)
        assert visible[np.arange(len(nbrs)), best_view].all(), (
            f"neighbor of viewpoint {u} not visible from any view"
        )
        # navigableLocations order at a view: ascending angular distance among
        # visible neighbors, ties by neighbor table row (simulator parity).
        order_keys = ang  # (N, 36); inf when invisible
        # first view (sweep order) where each neighbor is visible, and its
        # nav position there -> reference insertion order.
        first_view = np.argmax(visible, axis=1).astype(np.int32)

        def nav_position(view: int, n_row: int) -> int:
            vis_rows = np.flatnonzero(visible[:, view])
            keys = order_keys[vis_rows, view]
            sorted_rows = vis_rows[np.argsort(keys, kind="stable")]
            return 1 + int(np.nonzero(sorted_rows == n_row)[0][0])

        insertion = sorted(
            range(len(nbrs)),
            key=lambda r: (int(first_view[r]), nav_position(int(first_view[r]), r)),
        )
        k = len(insertion)
        if k > max_candidates:
            raise ValueError(
                f"viewpoint {u} has {k} candidates > max_candidates={max_candidates}")
        count[u] = k
        for slot, r in enumerate(insertion):
            bv = int(best_view[r])
            nbr[u, slot] = nbrs[r]
            point[u, slot] = bv
            nav_idx[u, slot] = nav_position(bv, r)
            heading[u, slot] = abs_h[r]
            elevation[u, slot] = abs_e[r]
    return ScanCandidateTable(
        scan=graph.scan, count=count, nbr=nbr, point=point,
        nav_idx=nav_idx, heading=heading, elevation=elevation,
    )


def candidate_angle_features(table: ScanCandidateTable, vp: np.ndarray,
                             base_view: np.ndarray) -> np.ndarray:
    """(B, K, 4) angle features of each candidate relative to the camera's
    base heading (data_loader.py:589-595 re-attachment semantics)."""
    base_heading = (np.asarray(base_view) % geo.HEADINGS_PER_ROW) * geo.ANGLE_INC
    h = table.heading[vp] - base_heading[:, None]
    e = table.elevation[vp]
    return geo.angle_feature(h, e)


def relative_point_id(abs_point: np.ndarray, current_heading: float) -> np.ndarray:
    """Map an absolute best-view id to the rotated frame used for the 1-in-36
    pretraining action label (scripts/generate_pretraining_data.py:196-233:
    sweep restarted at heading ``current_heading - pi``)."""
    base_step = geo.snap_heading(current_heading - np.pi)
    row = abs_point // geo.HEADINGS_PER_ROW
    step = (abs_point % geo.HEADINGS_PER_ROW - base_step) % geo.HEADINGS_PER_ROW
    return row * geo.HEADINGS_PER_ROW + step


def build_candidate_tables(graphs: dict[str, NavGraph], hfov: float,
                           max_candidates: int = MAX_CANDIDATES) -> dict[str, ScanCandidateTable]:
    return {s: build_candidate_table(g, hfov, max_candidates) for s, g in graphs.items()}
