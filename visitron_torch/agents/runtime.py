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
a student rollout moves only (B,) action/viewpoint indices to the host.  The
turn-based helpers (``navigable_at``, ``turn_based_teacher``,
``apply_turn_action``, ``turn_based_rollout_arrays``) work on the host
copies.
Integer tables are int64 on the device (PyTorch's index type) and int32 on
the host, as in the JAX package.  A scene table packed as a torch tensor in
the device dtype (``SceneFeatureTable.pack(dtype=torch.bfloat16)``) goes to
the device as it is, in one copy, page-locked if it was packed so; the
host table stays where it is.
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
            if isinstance(a, torch.Tensor):  # a packed torch table: no fp32 copy
                return a.to(dev, dtype)
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

    def sample_rollout_arrays(self, scans: list[str], goal_rows) -> dict:
        """Per-item teacher columns for student-forced and RL training, on
        the host.

        For a fixed goal the shortest-path teacher from any viewpoint v is one
        column of the next-hop table: ``teacher_col[i, v]`` is the global row
        of the next hop from scan-local v toward goal_i (-1 if unreachable),
        ``dist_col[i, v]`` the metric distance from v to goal_i (1e6 if
        unreachable), ``scan_offset[i]`` the first global row of item i's
        scan.  With these on the device, a sampled rollout computes its
        teacher and its rewards there (reference feedback='sample' training,
        agent.py:406-425)."""
        b = len(goal_rows)
        v_max = max(g.num_viewpoints for g in self.graphs.values())
        teacher_col = np.full((b, v_max), -1, np.int32)
        dist_col = np.full((b, v_max), 1e6, np.float32)
        offsets = np.zeros(b, np.int32)
        for i, scan in enumerate(scans):
            g = self.graphs[scan]
            off = self.feat_table.scan_offsets[scan]
            goal = int(goal_rows[i]) - off
            col = g.next_hop[:, goal].astype(np.int32)
            teacher_col[i, : g.num_viewpoints] = np.where(col >= 0, col + off, -1)
            d = g.dist[:, goal].astype(np.float32)
            dist_col[i, : g.num_viewpoints] = np.where(np.isfinite(d), d, 1e6)
            offsets[i] = off
        return {"teacher_col": teacher_col, "dist_col": dist_col,
                "scan_offset": offsets}

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

    # ---------------------------------------------------------- turn-based
    # Host numpy with the JAX package's dtypes and its stable sort, so the
    # visible neighbours, their order and the hfov / 2 edge are the same in
    # both packages.
    def navigable_at(self, row: int, view: int) -> list[tuple[int, float, float]]:
        """Ordered (neighbor_row, rel_heading, rel_elevation) visible from
        (row, view): simulator navigableLocations[1:] parity."""
        hfov = geo.camera_hfov(self.feat_table.image_w, self.feat_table.image_h,
                               np.radians(self.feat_table.vfov))
        cam_h = geo.heading_of_view(view)
        cam_e = geo.elevation_of_view(view)
        n = int(self.count_h[row])
        rel_h = geo.normalize_angle(self.heading_h[row, :n] - cam_h)
        rel_e = self.elev_h[row, :n] - cam_e
        vis = np.abs(rel_h) <= hfov / 2.0 + 1e-9
        order = np.flatnonzero(vis)
        ang = np.sqrt(rel_h[order] ** 2 + rel_e[order] ** 2)
        order = order[np.argsort(ang, kind="stable")]
        return [(int(self.nbr_h[row, s]), float(rel_h[s]), float(rel_e[s])) for s in order]

    def turn_based_teacher(self, scan: str, row: int, view: int, goal_row: int) -> int:
        """Low-level teacher action id (model_actions order: left, right, up,
        down, forward, <end>): tasks/turn_based/data_loader.py:509-546 +
        agent.py:212-232 parity."""
        LEFT, RIGHT, UP, DOWN, FORWARD, END = range(6)
        if row == goal_row:
            return END
        g = self.graphs[scan]
        off = self.feat_table.scan_offsets[scan]
        nxt = int(g.next_hop[row - off, goal_row - off]) + off
        for nbr_row, rel_h, rel_e in self.navigable_at(row, view):
            if nbr_row == nxt:
                if rel_h > np.pi / 6.0:
                    return RIGHT
                if rel_h < -np.pi / 6.0:
                    return LEFT
                if rel_e > np.pi / 6.0 and view // 12 < 2:
                    return UP
                if rel_e < -np.pi / 6.0 and view // 12 > 0:
                    return DOWN
                return FORWARD
        # Not visible: neutralise the elevation, else turn the shorter way.
        if view // 12 == 0:
            return UP
        if view // 12 == 2:
            return DOWN
        slot = int(np.flatnonzero(self.nbr_h[row] == nxt)[0])
        target_heading = float(self.heading_h[row, slot]) % (2 * np.pi)
        heading = geo.heading_of_view(view)
        if heading > target_heading and heading - target_heading < np.pi:
            return LEFT
        if target_heading > heading and target_heading - heading > np.pi:
            return LEFT
        return RIGHT

    def apply_turn_action(self, row: int, view: int, action: int) -> tuple[int, int]:
        """Apply a low-level action id; returns (row, view).  forward moves to
        the first (most centred) navigable location, as the reference agent,
        which can only pick 'the one in the middle' (agent.py:67)."""
        LEFT, RIGHT, UP, DOWN, FORWARD, END = range(6)
        hstep, erow = view % 12, view // 12
        if action == LEFT:
            hstep = (hstep - 1) % 12
        elif action == RIGHT:
            hstep = (hstep + 1) % 12
        elif action == UP:
            erow = min(erow + 1, 2)
        elif action == DOWN:
            erow = max(erow - 1, 0)
        elif action == FORWARD:
            nav = self.navigable_at(row, view)
            if nav:
                row = nav[0][0]
        return row, erow * 12 + hstep

    def turn_based_rollout_arrays(self, scans: list[str], start_rows, start_views,
                                  goal_rows, episode_len: int, ignore_id: int = -100):
        """A teacher-forced low-level episode, on the host: (B, T) int32
        cur_row, view and teacher action ids (``ignore_id`` once ended), and
        (B, T) bool forward-allowed flags and active mask."""
        b = len(start_rows)
        cur_row = np.zeros((b, episode_len), np.int32)
        view = np.zeros((b, episode_len), np.int32)
        teacher = np.full((b, episode_len), ignore_id, np.int32)
        fwd_ok = np.zeros((b, episode_len), bool)
        active = np.zeros((b, episode_len), bool)
        END = 5
        for i in range(b):
            row, v = int(start_rows[i]), int(start_views[i])
            goal = int(goal_rows[i])
            ended = False
            for t in range(episode_len):
                cur_row[i, t] = row
                view[i, t] = v
                fwd_ok[i, t] = len(self.navigable_at(row, v)) > 0
                if ended:
                    continue
                a = self.turn_based_teacher(scans[i], row, v, goal)
                teacher[i, t] = a
                active[i, t] = True
                if a == END:
                    ended = True
                else:
                    row, v = self.apply_turn_action(row, v, a)
        return {"cur_row": cur_row, "view": view, "teacher": teacher,
                "fwd_ok": fwd_ok, "active": active}
