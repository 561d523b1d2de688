"""Navigation graphs from Matterport connectivity JSONs.

Replaces the reference's networkx graphs + per-pair Dijkstra dict-of-dicts
(tasks/viewpoint_select/utils_data.py:26-60, data_loader.py:497-506) with
dense arrays: one ``scipy.sparse.csgraph.dijkstra`` call yields the all-pairs
distance matrix *and* a next-hop table, so shortest-path supervision becomes a
pure integer gather — which is what lets the teacher-forced rollout run fully
on-device (see visitron_torch.agents.viewpoint).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra


@dataclass
class NavGraph:
    """A single scan's navigation graph with precomputed shortest paths.

    Attributes:
      scan: scan id.
      viewpoints: viewpoint ids in index order.
      positions: (V, 3) float32 world positions (pose[3], pose[7], pose[11]).
      heights: (V,) float32 per-viewpoint height field from the JSON.
      adjacency: (V, V) bool, undirected unobstructed connectivity.
      dist: (V, V) float64 shortest-path metric distances (inf if unreachable).
      next_hop: (V, V) int32; ``next_hop[u, g]`` is the first node after ``u``
        on a shortest path u->g; ``next_hop[u, u] == u``; -1 if unreachable.
    """

    scan: str
    viewpoints: list[str]
    positions: np.ndarray
    heights: np.ndarray
    adjacency: np.ndarray
    dist: np.ndarray
    next_hop: np.ndarray
    index: dict[str, int] = field(default_factory=dict)
    _neighbors: list[np.ndarray] | None = None

    def __post_init__(self):
        if not self.index:
            self.index = {v: i for i, v in enumerate(self.viewpoints)}

    @property
    def num_viewpoints(self) -> int:
        return len(self.viewpoints)

    def neighbors(self, u: int | str) -> np.ndarray:
        """Sorted array of neighbor indices of u."""
        if self._neighbors is None:
            self._neighbors = [np.flatnonzero(row) for row in self.adjacency]
        return self._neighbors[self._idx(u)]

    def _idx(self, v: int | str) -> int:
        return self.index[v] if isinstance(v, str) else int(v)

    def distance(self, u: int | str, g: int | str) -> float:
        return float(self.dist[self._idx(u), self._idx(g)])

    def shortest_path(self, u: int | str, g: int | str) -> list[str]:
        """Shortest path as viewpoint ids, inclusive of both endpoints."""
        ui, gi = self._idx(u), self._idx(g)
        if not np.isfinite(self.dist[ui, gi]):
            raise ValueError(f"{self.viewpoints[ui]} unreachable from {self.viewpoints[gi]}")
        path = [ui]
        while path[-1] != gi:
            path.append(int(self.next_hop[path[-1], gi]))
        return [self.viewpoints[i] for i in path]

    def next_on_path(self, u: int | str, g: int | str) -> str:
        """The shortest-path teacher action: the next viewpoint toward g (u
        itself at g).  Parity: tasks/viewpoint_select/data_loader.py:508-514."""
        ui, gi = self._idx(u), self._idx(g)
        if ui == gi:
            return self.viewpoints[ui]
        return self.viewpoints[int(self.next_hop[ui, gi])]

    def path_length(self, nodes: list[str]) -> float:
        """Sum of shortest-path distances over consecutive node pairs
        (parity: tasks/viewpoint_select/eval.py:82-90)."""
        return float(sum(self.distance(a, b) for a, b in zip(nodes[:-1], nodes[1:])))

    @classmethod
    def from_connectivity(cls, scan: str, entries: list[dict]) -> "NavGraph":
        """Build from parsed ``<scan>_connectivity.json`` content.

        Mirrors the reference loader exactly (utils_data.py:26-60): only
        ``included`` nodes participate; an edge (i, j) exists when
        ``entries[i]["unobstructed"][j]`` and node j is included; the graph is
        validated to be undirected; edge weight is 3-D euclidean distance
        between poses.  Unlike the reference, nodes with no edges are still
        assigned positions.
        """
        n_raw = len(entries)
        included = np.array([bool(e["included"]) for e in entries])
        pose = np.array(
            [[e["pose"][3], e["pose"][7], e["pose"][11]] for e in entries],
            dtype=np.float64,
        )
        raw_adj = np.zeros((n_raw, n_raw), dtype=bool)
        for i, e in enumerate(entries):
            if not included[i]:
                continue
            unob = e["unobstructed"]
            for j, conn in enumerate(unob):
                if conn and included[j] and i != j:
                    raw_adj[i, j] = True
        if not np.array_equal(raw_adj, raw_adj.T):
            raise ValueError(f"scan {scan}: connectivity graph must be undirected")

        keep = np.flatnonzero(included)
        viewpoints = [entries[i]["image_id"] for i in keep]
        positions = pose[keep].astype(np.float32)
        heights = np.array(
            [float(entries[i].get("height", 0.0)) for i in keep], dtype=np.float32
        )
        adj = raw_adj[np.ix_(keep, keep)]

        # Edge weights from the RAW float64 poses — rounding positions to f32
        # first perturbs distances at ~1e-7 relative, which the differential
        # test against the reference Evaluation catches (utils_data.py:29-35
        # computes weights in full precision).
        pose64 = pose[keep]
        diffs = pose64[:, None, :] - pose64[None, :, :]
        eucl = np.sqrt((diffs**2).sum(-1))
        weights = np.where(adj, eucl, 0.0)
        graph = csr_matrix(weights)
        dist, predecessors = dijkstra(
            graph, directed=False, return_predecessors=True
        )
        # next_hop[u, g]: first hop from u toward g. For an undirected graph,
        # predecessors[g, u] is the node before u on the path g->u, i.e. the
        # node after u on the path u->g.
        next_hop = predecessors.T.astype(np.int32)
        v = len(viewpoints)
        ar = np.arange(v)
        next_hop[ar, ar] = ar
        return cls(
            scan=scan,
            viewpoints=viewpoints,
            positions=positions,
            heights=heights,
            adjacency=adj,
            dist=dist,  # float64: host-side eval math; device packers cast
            next_hop=next_hop,
        )

    @classmethod
    def load(cls, connectivity_dir: str, scan: str) -> "NavGraph":
        path = os.path.join(connectivity_dir, f"{scan}_connectivity.json")
        with open(path) as f:
            entries = json.load(f)
        return cls.from_connectivity(scan, entries)


def load_nav_graphs(connectivity_dir: str, scans) -> dict[str, NavGraph]:
    """Load NavGraphs for a set of scans (parity: utils_data.py:26-60)."""
    return {scan: NavGraph.load(connectivity_dir, scan) for scan in sorted(set(scans))}
