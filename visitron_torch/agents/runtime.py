"""NavRuntime: the packed, device-resident world model for rollouts
(visitron_tpu/agents/runtime.py).

Everything a navigation step reads is packed into tensors indexed by
*viewpoint row* (scan-contiguous, shared with SceneFeatureTable):

  feats    (R, 36, D)   scene features per view            [device]
  count    (R,)         number of candidates               [device]
  nbr      (R, K)       candidate target row (global), -1  [device]
  point    (R, K)       candidate best-view index          [device]
  heading  (R, K)       candidate absolute heading         [device]
  elev     (R, K)       candidate absolute elevation       [device]
  pano_af  (36, 36, 4)  per-base-view panorama angle table [device]
  view_af  (36, 4)      camera angle feature by view       [device]

so a navigation step is pure gathers and elementwise math on the device, and
a student rollout moves only (B,) action/viewpoint indices to the host.
Integer tables are int64 on the device (PyTorch's index type) and int32 on
the host, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from visitron_torch import geometry as geo
from visitron_torch._device import resolve_device
from visitron_torch.data.candidates import ScanCandidateTable, build_candidate_tables
from visitron_torch.data.features import SceneFeatureTable
from visitron_torch.graph import NavGraph


@dataclass(eq=False)
class NavRuntime:
    graphs: dict[str, NavGraph]
    feat_table: SceneFeatureTable
    tables: dict[str, ScanCandidateTable]
    max_candidates: int
    device: torch.device
    # host copies
    count_h: np.ndarray
    nbr_h: np.ndarray
    point_h: np.ndarray
    nav_idx_h: np.ndarray
    heading_h: np.ndarray
    elev_h: np.ndarray
    # device tensors
    feats: torch.Tensor
    count: torch.Tensor
    nbr: torch.Tensor
    point: torch.Tensor
    heading: torch.Tensor
    elev: torch.Tensor
    pano_af: torch.Tensor
    view_af: torch.Tensor

    @classmethod
    def build(cls, graphs: dict[str, NavGraph], feat_table: SceneFeatureTable,
              hfov: float | None = None, max_candidates: int = 15,
              tables: dict[str, ScanCandidateTable] | None = None,
              device_dtype=torch.float32, device=None) -> "NavRuntime":
        """``device``: where the tables live; None means the card."""
        dev = resolve_device(device)
        if hfov is None:
            hfov = geo.camera_hfov(feat_table.image_w, feat_table.image_h,
                                   np.radians(feat_table.vfov))
        if tables is None:
            tables = build_candidate_tables(graphs, hfov, max_candidates)
        total = feat_table.table.shape[0]
        k = max_candidates
        count = np.zeros(total, np.int32)
        nbr = np.full((total, k), -1, np.int32)
        point = np.zeros((total, k), np.int32)
        nav_idx = np.zeros((total, k), np.int32)
        heading = np.zeros((total, k), np.float32)
        elev = np.zeros((total, k), np.float32)
        for scan in sorted(graphs):
            g = graphs[scan]
            t = tables[scan]
            off = feat_table.scan_offsets[scan]
            rows = slice(off, off + g.num_viewpoints)
            count[rows] = t.count
            valid = t.nbr >= 0
            nbr[rows] = np.where(valid, t.nbr + off, -1)
            point[rows] = t.point
            nav_idx[rows] = t.nav_idx
            heading[rows] = t.heading
            elev[rows] = t.elevation

        def index_table(a):
            return torch.as_tensor(a, dtype=torch.int64).to(dev)

        def float_table(a, dtype):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dtype)

        return cls(
            graphs=graphs,
            feat_table=feat_table,
            tables=tables,
            max_candidates=k,
            device=dev,
            count_h=count,
            nbr_h=nbr,
            point_h=point,
            nav_idx_h=nav_idx,
            heading_h=heading,
            elev_h=elev,
            feats=float_table(feat_table.table, device_dtype),
            count=index_table(count),
            nbr=index_table(nbr),
            point=index_table(point),
            heading=float_table(heading, torch.float32),
            elev=float_table(elev, torch.float32),
            pano_af=float_table(geo.all_point_angle_feature(), device_dtype),
            view_af=float_table(geo.point_angle_feature(0), device_dtype),
        )

    # ------------------------------------------------------------------ host
    def row(self, scan: str, viewpoint: str) -> int:
        return self.feat_table.row(scan, viewpoint)

    def row_to_id(self, row: int) -> tuple[str, str]:
        """Global row -> (scan, viewpointId); O(1) via a flat lookup table."""
        table = getattr(self, "_row_ids", None)
        if table is None:
            table = [None] * self.feat_table.table.shape[0]
            for scan in self.graphs:
                off = self.feat_table.scan_offsets[scan]
                g = self.graphs[scan]
                for i, vp in enumerate(g.viewpoints):
                    table[off + i] = (scan, vp)
            self._row_ids = table
        got = table[row]
        if got is None:
            raise IndexError(row)
        return got

    def start_state(self, scan: str, viewpoint: str, heading: float,
                    elevation: float = 0.0) -> tuple[int, int]:
        """(row, view_index) after new_episode snapping."""
        return (
            self.row(scan, viewpoint),
            geo.view_of(geo.snap_heading(heading), geo.snap_elevation(elevation)),
        )

    def teacher_slot(self, scan: str, row: int, goal_row: int) -> int:
        """Index of the teacher candidate: slot of the next-hop neighbor, or
        ``count`` (the stop slot) at the goal (agent.py:237-251)."""
        g = self.graphs[scan]
        off = self.feat_table.scan_offsets[scan]
        u, goal = row - off, goal_row - off
        if u == goal:
            return int(self.count_h[row])
        nxt = int(g.next_hop[u, goal]) + off
        slots = np.flatnonzero(self.nbr_h[row] == nxt)
        if len(slots) != 1:
            raise ValueError(f"no unique teacher slot from row {row} toward "
                             f"{goal_row} in scan {scan}")
        return int(slots[0])

    def teacher_rollout_arrays(self, scans: list[str], start_rows: np.ndarray,
                               start_views: np.ndarray, goal_rows: np.ndarray,
                               episode_len: int, ignore_id: int = -100) -> dict:
        """The full teacher-forced episode of a batch, on the host.

        Returns (B, T) int32 arrays cur_row, view and teacher (the teacher
        slot, ``ignore_id`` once ended) and the (B, T) bool active mask; the
        rollout itself (features, decoder, loss) then runs on the device."""
        b = len(start_rows)
        cur_row = np.zeros((b, episode_len), np.int32)
        view = np.zeros((b, episode_len), np.int32)
        teacher = np.full((b, episode_len), ignore_id, np.int32)
        active = np.zeros((b, episode_len), bool)
        for i in range(b):
            row, v = int(start_rows[i]), int(start_views[i])
            goal = int(goal_rows[i])
            ended = False
            for t in range(episode_len):
                cur_row[i, t] = row
                view[i, t] = v
                if ended:
                    continue
                slot = self.teacher_slot(scans[i], row, goal)
                teacher[i, t] = slot
                active[i, t] = True
                if slot == int(self.count_h[row]):  # stop
                    ended = True
                else:
                    row, v = self.step_to(row, slot)
        return {"cur_row": cur_row, "view": view, "teacher": teacher,
                "active": active}

    def step_to(self, row: int, slot: int) -> tuple[int, int]:
        """Apply candidate ``slot`` from ``row``: (new_row, new_view).

        make_equiv_action parity (agent.py:278-321): the agent rotates onto
        the candidate's pointId and moves; camera pose persists, so the new
        view index is exactly the candidate's point.
        """
        new_row = int(self.nbr_h[row, slot])
        new_view = int(self.point_h[row, slot])
        assert new_row >= 0
        return new_row, new_view
