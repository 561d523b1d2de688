"""NDH/R2R trajectory evaluation: GP, SR, OSR, SPL, nDTW, CLS and friends
(visitron_tpu/evaluation/metrics.py, the port's own copy; host numpy).

Formula-for-formula parity with the reference Evaluation class
(tasks/viewpoint_select/eval.py:20-246), over the NavGraph distance
matrices.  Headline NDH metric: Goal Progress ``dist_to_end_reduction``, the
reduction in metric distance to the nearest end pano between the start and
the final position (eval.py:136-155, 239-240).
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from visitron_torch.graph import NavGraph

ERROR_MARGIN = 3.0  # meters (eval.py:24)


def ndtw(graph: NavGraph, prediction: list[str], reference: list[str], margin: float = ERROR_MARGIN) -> float:
    """Normalized dynamic time warping over graph distances (eval.py:92-104)."""
    p = np.array([graph.index[v] for v in prediction])
    r = np.array([graph.index[v] for v in reference])
    cost = graph.dist[np.ix_(p, r)].astype(np.float64)  # (|p|, |r|)
    n, m = cost.shape
    dtw = np.full((n + 1, m + 1), np.inf)
    dtw[0, 0] = 0.0
    for i in range(1, n + 1):
        # dtw[i, j] = cost + min(dtw[i-1, j], dtw[i, j-1], dtw[i-1, j-1]);
        # the row-wise recurrence on dtw[i, j-1] stays sequential.
        prev = np.minimum(dtw[i - 1, 1:], dtw[i - 1, :-1])
        acc = np.inf
        for j in range(1, m + 1):
            acc = cost[i - 1, j - 1] + min(prev[j - 1], acc)
            dtw[i, j] = acc
    return float(np.exp(-dtw[n, m] / (margin * len(reference))))


def cls_metric(graph: NavGraph, prediction: list[str], reference: list[str], margin: float = ERROR_MARGIN) -> float:
    """Coverage-weighted length score (eval.py:106-118)."""
    p = np.array([graph.index[v] for v in prediction])
    r = np.array([graph.index[v] for v in reference])
    nearest = graph.dist[np.ix_(r, p)].min(axis=1)
    coverage = float(np.mean(np.exp(-nearest / margin)))
    ref_len = graph.path_length(reference)
    pred_len = graph.path_length(prediction)
    expected = coverage * ref_len
    denom = expected + abs(expected - pred_len)
    if denom == 0.0:
        # Zero-length reference and prediction: full marks. (The reference
        # formula hits 0/0 = NaN here; single-node episodes do occur in NDH.)
        return coverage
    score = expected / denom
    return coverage * score


class Evaluator:
    """Scores agent trajectories against ground-truth episodes.

    ``gt_items`` are NDH-schema records (must contain ``inst_idx``, ``scan``,
    ``planner_path``, ``player_path``, ``end_panos``); ``path_type`` selects
    the supervision path including ``trusted_path`` derivation
    (eval.py:36-46: trust the player iff it passes the planner goal after the
    start).
    """

    def __init__(self, gt_items: list[dict], graphs: dict[str, NavGraph], path_type: str = "planner_path"):
        self.graphs = graphs
        self.path_type = path_type
        self.gt: dict = {}
        for item in gt_items:
            item = dict(item)
            if path_type == "trusted_path" and "trusted_path" not in item:
                planner_goal = item["planner_path"][-1]
                if planner_goal in item["player_path"][1:]:
                    item["trusted_path"] = list(item["player_path"])
                else:
                    item["trusted_path"] = list(item["planner_path"])
            self.gt[item["inst_idx"]] = item
        self.instr_ids = set(self.gt.keys())

    def _nearest(self, graph: NavGraph, goal: str, path_vps: list[str]) -> str:
        d = [graph.distance(v, goal) for v in path_vps]
        return path_vps[int(np.argmin(d))]

    def _score_item(self, scores: dict, gt: dict, path: list) -> None:
        graph = self.graphs[gt["scan"]]
        path_vps = [p[0] for p in path]
        start = gt[self.path_type][0]
        if start != path_vps[0]:
            raise ValueError(f"trajectory of {gt['inst_idx']} starts at {path_vps[0]}, "
                             f"not at the start position {start}")
        goal = gt[self.path_type][-1]
        planner_goal = gt["planner_path"][-1]
        final = path_vps[-1]
        nearest = self._nearest(graph, goal, path_vps)
        nearest_planner = self._nearest(graph, planner_goal, path_vps)
        d_start = min(graph.distance(start, e) for e in gt["end_panos"])
        d_end = min(graph.distance(final, e) for e in gt["end_panos"])
        scores["nav_errors"].append(graph.distance(final, goal))
        scores["oracle_errors"].append(graph.distance(nearest, goal))
        scores["oracle_plan_errors"].append(graph.distance(nearest_planner, planner_goal))
        scores["dist_to_end_reductions"].append(d_start - d_end)
        # Path length/hops; every move must traverse a real edge (eval.py:156-173).
        distance, hops = 0.0, 0
        for a, b in zip(path_vps[:-1], path_vps[1:]):
            if a != b and not graph.adjacency[graph.index[a], graph.index[b]]:
                raise ValueError(f"trajectory moves {a}->{b} but the graph has no such edge")
            distance += graph.distance(a, b)
            hops += 1
        scores["trajectory_lengths"].append(distance)
        scores["trajectory_hops"].append(hops)
        scores["shortest_path_lengths"].append(graph.distance(start, goal))
        scores["ndtw"].append(ndtw(graph, path_vps, gt[self.path_type]))
        scores["cls"].append(cls_metric(graph, path_vps, gt[self.path_type]))

    def score_results(self, results: dict) -> tuple[dict, dict]:
        """``results``: {inst_idx: [(viewpointId, heading, elevation), ...]}."""
        scores: dict = defaultdict(list)
        remaining = set(self.instr_ids)
        for inst_idx, path in results.items():
            if inst_idx in remaining:
                remaining.remove(inst_idx)
                self._score_item(scores, self.gt[inst_idx], path)
        if remaining:
            raise ValueError(f"trajectories not provided for {len(remaining)} instruction ids")
        assert len(scores["nav_errors"]) == len(self.instr_ids)

        nav_err = np.array(scores["nav_errors"])
        successes = nav_err < ERROR_MARGIN
        oracle_successes = np.array(scores["oracle_errors"]) < ERROR_MARGIN
        oracle_plan_successes = np.array(scores["oracle_plan_errors"]) < ERROR_MARGIN
        spls = []
        for err, length, sp in zip(
            scores["nav_errors"], scores["trajectory_lengths"], scores["shortest_path_lengths"]
        ):
            if err < ERROR_MARGIN:
                if sp > 0:
                    spls.append(sp / max(length, sp))
                else:
                    # Q/A may start inside the goal region; no-op is correct (eval.py:223-224).
                    spls.append(1.0 if length == 0 else 0.0)
            else:
                spls.append(0.0)

        summary = {
            "length": float(np.mean(scores["trajectory_lengths"])),
            "hops": float(np.mean(scores["trajectory_hops"])),
            "nav_error": float(np.mean(nav_err)),
            "oracle_success_rate": float(np.mean(oracle_successes)),
            "success_rate": float(np.mean(successes)),
            "spl": float(np.mean(spls)),
            "oracle_path_success_rate": float(np.mean(oracle_plan_successes)),
            "dist_to_end_reduction": float(np.mean(scores["dist_to_end_reductions"])),
            "ndtw": float(np.mean(scores["ndtw"])),
            "cls": float(np.mean(scores["cls"])),
        }
        assert summary["spl"] <= summary["success_rate"] + 1e-9  # invariant (eval.py:245)
        return summary, dict(scores)

    def score(self, output_file: str) -> tuple[dict, dict]:
        """Score a predictions JSON file (EvalAI submission format parity:
        [{"inst_idx": ..., "trajectory": [(vp, heading, elev), ...]}])."""
        with open(output_file) as f:
            payload = json.load(f)
        results = {item["inst_idx"]: item["trajectory"] for item in payload}
        return self.score_results(results)
