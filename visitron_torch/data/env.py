"""EnvBatch + observation assembly: the simulator-in-the-loop data path.

Parity with the reference environment layer (tasks/viewpoint_select/
data_loader.py:22-93,474-659 and the per-view variant in tasks/turn_based/
data_loader.py:23-95): a batched simulator joined with precomputed features,
live candidate extraction with per-(scan, viewpoint) caching, shortest-path
teacher computation, and obs-dict assembly.

The training paths (both packages') use NavRuntime's precomputed tables
instead (pure gathers; the same candidates, tests/test_candidates.py);
EnvBatch remains for simulator-driven workflows (changed graphs, feature
extraction sweeps, debugging) and for parity checking.  Host code: the
port's copy of visitron_tpu/data/env.py, held to it in
tests/test_torch_env.py.
"""

from __future__ import annotations

import math

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.data.features import SceneFeatureTable
from visitron_torch.graph import NavGraph
from visitron_torch.sim import make_simulator


class EnvBatch:
    """Batched simulator + feature join (data_loader.py:22-93)."""

    def __init__(self, graphs: dict[str, NavGraph], feature_table: SceneFeatureTable | None,
                 batch_size: int, pano_features: bool = True, prefer_native: bool = True):
        self.graphs = graphs
        self.features = feature_table
        self.batch_size = batch_size
        self.pano = pano_features
        image_w = feature_table.image_w if feature_table else 600
        image_h = feature_table.image_h if feature_table else 600
        vfov = feature_table.vfov if feature_table else 80
        self.sim = make_simulator(graphs, batch_size=batch_size, image_w=image_w,
                                  image_h=image_h, vfov_deg=vfov,
                                  prefer_native=prefer_native)

    def new_episodes(self, scan_ids, viewpoint_ids, headings) -> None:
        self.sim.new_episode(scan_ids, viewpoint_ids, headings, [0.0] * self.batch_size)

    def get_states(self):
        """[(feature, state), ...]; pano mode yields (36, D), per-view (D,)
        (turn_based/data_loader.py:61)."""
        out = []
        for state in self.sim.get_states():
            if self.features is None:
                out.append((None, state))
                continue
            feat = self.features.get(state.scanId, state.location.viewpointId)
            if not self.pano:
                feat = feat[state.viewIndex]
            out.append((feat, state))
        return out

    def make_actions(self, actions) -> None:
        ix = [int(a[0]) for a in actions]
        h = [float(a[1]) for a in actions]
        e = [float(a[2]) for a in actions]
        self.sim.make_action(ix, h, e)

    def make_actions_at_index(self, action, index: int) -> None:
        self.sim.make_action_at(index, int(action[0]), float(action[1]), float(action[2]))


class SimNavEnv:
    """Simulator-driven navigation environment with live candidate extraction
    and obs assembly (VLNDataLoader parity, data_loader.py:474-659)."""

    def __init__(self, graphs: dict[str, NavGraph], feature_table: SceneFeatureTable,
                 batch_size: int, path_type: str = "trusted_path",
                 prefer_native: bool = True):
        self.env = EnvBatch(graphs, feature_table, batch_size, prefer_native=prefer_native)
        self.graphs = graphs
        self.features = feature_table
        self.path_type = path_type
        self.angle_feature = geo.all_point_angle_feature()  # (36, 36, 4)
        self.probe = make_simulator(graphs, batch_size=1,
                                    image_w=feature_table.image_w,
                                    image_h=feature_table.image_h,
                                    vfov_deg=feature_table.vfov,
                                    prefer_native=prefer_native)
        self.buffered_state_dict: dict[str, list[dict]] = {}
        self.batch: list | None = None

    # -- candidate extraction (data_loader.py:516-598) ----------------------
    def make_candidate(self, feature: np.ndarray, scan: str, viewpoint: str,
                       view_id: int) -> list[dict]:
        base_heading = (view_id % 12) * geo.ANGLE_INC
        long_id = f"{scan}_{viewpoint}"
        if long_id not in self.buffered_state_dict:
            adj: dict[str, dict] = {}
            for ix in range(36):
                if ix == 0:
                    self.probe.new_episode([scan], [viewpoint], [0.0],
                                           [math.radians(-30)])
                elif ix % 12 == 0:
                    self.probe.make_action([0], [1.0], [1.0])
                else:
                    self.probe.make_action([0], [1.0], [0.0])
                state = self.probe.get_states()[0]
                if state.viewIndex != ix:
                    raise RuntimeError(f"probe at view {state.viewIndex}, expected {ix}")
                heading = state.heading - base_heading
                for j, loc in enumerate(state.navigableLocations[1:]):
                    dist = math.sqrt(loc.rel_heading**2 + loc.rel_elevation**2)
                    loc_heading = heading + loc.rel_heading
                    loc_elevation = state.elevation + loc.rel_elevation
                    if loc.viewpointId not in adj or dist < adj[loc.viewpointId]["distance"]:
                        adj[loc.viewpointId] = {
                            "heading": loc_heading,
                            "elevation": loc_elevation,
                            "normalized_heading": state.heading + loc.rel_heading,
                            "scanId": scan,
                            "viewpointId": loc.viewpointId,
                            "pointId": ix,
                            "distance": dist,
                            "idx": j + 1,
                            "feature": np.concatenate(
                                (feature[ix], geo.angle_feature(loc_heading, loc_elevation)), -1),
                        }
            candidate = list(adj.values())
            self.buffered_state_dict[long_id] = [
                {k: c[k] for k in ["normalized_heading", "elevation", "scanId",
                                   "viewpointId", "pointId", "idx"]}
                for c in candidate
            ]
            return candidate
        # Cache hit: re-attach per-heading angle features (:584-598).
        out = []
        for c in self.buffered_state_dict[long_id]:
            c_new = dict(c)
            ix = c_new["pointId"]
            loc_heading = c_new.pop("normalized_heading") - base_heading
            c_new["heading"] = loc_heading
            c_new["feature"] = np.concatenate(
                (feature[ix], geo.angle_feature(loc_heading, c_new["elevation"])), -1)
            out.append(c_new)
        return out

    # -- obs assembly (data_loader.py:600-659) --------------------------------
    def _get_obs(self) -> list[dict]:
        obs = []
        for i, (feature, state) in enumerate(self.env.get_states()):
            item = self.batch[i]
            base_view = state.viewIndex
            if self.path_type in item and item[self.path_type]:
                target = item[self.path_type][-1]
            else:
                target = item["start_pano"]["pano"]
            candidate = self.make_candidate(
                feature, state.scanId, state.location.viewpointId, base_view)
            pano_feature = np.concatenate(
                (feature, self.angle_feature[base_view]), -1)
            g = self.graphs[state.scanId]
            teacher = g.next_on_path(state.location.viewpointId, target)
            obs.append({
                "inst_idx": item["inst_idx"],
                "scan": state.scanId,
                "viewpoint": state.location.viewpointId,
                "viewIndex": state.viewIndex,
                "heading": state.heading,
                "elevation": state.elevation,
                "feature": pano_feature,
                "candidate": candidate,
                "step": state.step,
                "navigableLocations": state.navigableLocations,
                "teacher": teacher,
            })
        return obs

    def reset(self, batch: list[dict]) -> list[dict]:
        self.batch = batch
        scans = [item["scan"] for item in batch]
        vps = [item[self.path_type][0] if item.get(self.path_type)
               else item["start_pano"]["pano"] for item in batch]
        headings = [item["start_pano"]["heading"] for item in batch]
        self.env.new_episodes(scans, vps, headings)
        return self._get_obs()

    def step(self, actions) -> list[dict]:
        self.env.make_actions(actions)
        return self._get_obs()
