"""Deterministic synthetic VLN worlds for tests and benchmarks.

The reference repo ships no data (srv/ is empty); its datasets (Matterport3D
connectivity, NDH/CVDN/R2R/R4R/RxR JSONs, precomputed features) are downloaded
at setup time.  This module fabricates structurally identical artifacts:
random connected navigation graphs written in the exact connectivity-JSON
schema (utils_data.py:26-60), NDH/CVDN/R2R-shaped episode records
(utils_data.py:87-238), and scene features — so every pipeline in the
framework can be exercised end-to-end, deterministically, without Matterport.
A copy of visitron_tpu/testing/synthetic.py: the same seed gives the same
graphs, scene and region features, region tokens and task JSON byte for
byte.
"""

from __future__ import annotations

import json
import os
import string

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.graph import NavGraph

_WORDS = (
    "go left right straight ahead turn around the room into towards past "
    "kitchen bedroom bathroom hallway stairs door table chair lamp sofa "
    "window plant picture mirror rug shelf stop there next then you should "
    "yes no see find reach wait exit enter corner wall blue red green white"
).split()

_TARGETS = "lamp sofa plant mirror rug shelf table chair".split()


def _identity_pose(x: float, y: float, z: float) -> list[float]:
    return [1.0, 0.0, 0.0, x, 0.0, 1.0, 0.0, y, 0.0, 0.0, 1.0, z, 0.0, 0.0, 0.0, 1.0]


class SyntheticWorld:
    """A reproducible multi-scan world with graphs, dialogs and features."""

    def __init__(
        self,
        seed: int = 0,
        num_scans: int = 2,
        viewpoints_per_scan: int = 24,
        mean_degree: float = 3.0,
        scene_feat_dim: int = 2048,
        region_feat_dim: int = 2054,
        regions_per_view: int = 5,
        dialog_turns: tuple[int, int] = (1, 4),
        words_per_turn: tuple[int, int] = (4, 12),
        directional_language: bool = False,
    ):
        # ``directional_language``: dialogs/instructions DESCRIBE the path
        # (relative turn words derived from the graph geometry) instead of
        # random word salad — language -> action becomes learnable, making
        # generalization and augmentation studies meaningful on this world.
        self.directional_language = directional_language
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.dialog_turns = dialog_turns
        self.words_per_turn = words_per_turn
        self.scene_feat_dim = scene_feat_dim
        self.region_feat_dim = region_feat_dim
        self.regions_per_view = regions_per_view
        self.scans = [f"scan{j:02d}" for j in range(num_scans)]
        self.connectivity: dict[str, list[dict]] = {}
        self.graphs: dict[str, NavGraph] = {}
        for si, scan in enumerate(self.scans):
            entries = self._make_connectivity(viewpoints_per_scan, mean_degree, si)
            self.connectivity[scan] = entries
            self.graphs[scan] = NavGraph.from_connectivity(scan, entries)

    # -- graphs --------------------------------------------------------------
    def _make_connectivity(self, n: int, mean_degree: float, scan_index: int = 0) -> list[dict]:
        # Random positions in a ~25m x 25m floor; spanning tree + extra edges.
        pos = np.zeros((n, 3))
        pos[:, 0] = self.rng.uniform(0, 25, n)
        pos[:, 1] = self.rng.uniform(0, 25, n)
        pos[:, 2] = 1.5 + self.rng.uniform(-0.2, 0.2, n)
        adj = np.zeros((n, n), dtype=bool)
        # Spanning tree: attach each node to the nearest already-connected node.
        order = self.rng.permutation(n)
        connected = [order[0]]
        for v in order[1:]:
            d = np.linalg.norm(pos[connected] - pos[v], axis=1)
            u = connected[int(np.argmin(d))]
            adj[u, v] = adj[v, u] = True
            connected.append(v)
        extra = int(max(0, (mean_degree - 2.0)) * n / 2)
        d2 = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        np.fill_diagonal(d2, np.inf)
        for _ in range(extra):
            u = int(self.rng.integers(n))
            near = np.argsort(d2[u])[:4]
            v = int(self.rng.choice(near))
            adj[u, v] = adj[v, u] = True
        entries = []
        ids = [self._vp_id(scan_index * 100000 + i) for i in range(n)]
        for i in range(n):
            entries.append(
                {
                    "image_id": ids[i],
                    "pose": _identity_pose(*pos[i]),
                    "included": True,
                    "height": float(pos[i, 2]),
                    "unobstructed": [bool(adj[i, j]) for j in range(n)],
                }
            )
        return entries

    def _vp_id(self, i: int) -> str:
        # 32-char hex-ish ids like real Matterport viewpoint ids.
        alphabet = string.hexdigits[:16]
        s = f"{i:032d}"
        return "vp" + s[-30:] + alphabet[i % 16] + alphabet[(i * 7) % 16]

    def write_connectivity(self, out_dir: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        for scan, entries in self.connectivity.items():
            with open(os.path.join(out_dir, f"{scan}_connectivity.json"), "w") as f:
                json.dump(entries, f)
        return out_dir

    # -- dialogs / episodes ----------------------------------------------------
    def _sentence(self, lo=None, hi=None) -> str:
        lo = lo if lo is not None else self.words_per_turn[0]
        hi = hi if hi is not None else self.words_per_turn[1]
        k = int(self.rng.integers(lo, hi))
        return " ".join(self.rng.choice(_WORDS, size=k))

    def _directional_sentence(self, g: NavGraph, path_idx: list[int],
                              start_heading: float) -> str:
        """Relative turn-by-turn description of ``path_idx`` from
        ``start_heading``, using the framework's heading convention
        (pi/2 - atan2(dy, dx), candidates.py:77).  Vocabulary is restricted
        to _WORDS so tokenizers built from the standard corpus cover it."""
        words = ["go"]
        prev = start_heading
        for a, b in zip(path_idx[:-1], path_idx[1:]):
            d = g.positions[b] - g.positions[a]
            heading = float(np.pi / 2.0 - np.arctan2(d[1], d[0])) % (2 * np.pi)
            delta = (heading - prev + np.pi) % (2 * np.pi) - np.pi
            if abs(delta) <= np.pi / 6:
                words += ["straight"]
            elif abs(delta) >= 5 * np.pi / 6:
                words += ["turn", "around"]
            elif delta > 0:
                words += ["turn", "right"]
            else:
                words += ["turn", "left"]
            words.append("then")
            prev = heading
        words += ["stop", "there"]
        return " ".join(words)

    def _random_path(self, graph: NavGraph, min_len=3, max_len=8) -> list[int]:
        v = graph.num_viewpoints
        while True:
            s, g = self.rng.integers(v), self.rng.integers(v)
            if s == g or not np.isfinite(graph.dist[s, g]):
                continue
            path = [graph.index[p] for p in graph.shortest_path(int(s), int(g))]
            if min_len <= len(path) <= max_len:
                return path

    def ndh_items(self, split: str, n: int, start_idx: int = 0) -> list[dict]:
        """NDH-schema episode records (fields used by VLNDataset/Evaluation)."""
        items = []
        for k in range(n):
            scan = self.scans[int(self.rng.integers(len(self.scans)))]
            g = self.graphs[scan]
            planner = self._random_path(g)
            # Player path: planner path plus optional wandering suffix/detour.
            player = list(planner)
            if self.rng.random() < 0.5:
                tail = player[-1]
                for _ in range(int(self.rng.integers(1, 3))):
                    nbrs = g.neighbors(tail)
                    if len(nbrs) == 0:
                        break
                    tail = int(self.rng.choice(nbrs))
                    player.append(tail)
            goal = planner[-1]
            end_panos = {goal}
            for nb in g.neighbors(goal):
                if g.dist[goal, nb] < 3.0:
                    end_panos.add(int(nb))
            turns = int(self.rng.integers(*self.dialog_turns)) * 2
            dialog = []
            for t in range(turns):
                dialog.append(
                    {
                        "message": self._sentence(),
                        "role": "navigator" if t % 2 == 0 else "oracle",
                        "nav_idx": min(t, len(player) - 1),
                    }
                )
            # Drawn here to preserve the rng stream of pre-existing seeded
            # worlds (the heading draw has always followed the dialog draws).
            start_heading = float(self.rng.uniform(0, 2 * np.pi))
            if self.directional_language:
                # The LAST oracle turn carries the path description (left
                # truncation keeps the latest turns, utils_data.py:287-314).
                dialog.append({
                    "message": self._directional_sentence(g, planner, start_heading),
                    "role": "oracle",
                    "nav_idx": len(player) - 1,
                })
            items.append(
                {
                    "inst_idx": start_idx + k,
                    "scan": scan,
                    "target": str(self.rng.choice(_TARGETS)),
                    "dialog_history": dialog,
                    "planner_path": [g.viewpoints[i] for i in planner],
                    "player_path": [g.viewpoints[i] for i in player],
                    "nav_history": [g.viewpoints[i] for i in player],
                    "start_pano": {
                        "heading": start_heading,
                        "elevation": 0.0,
                        "pano": g.viewpoints[planner[0]],
                    },
                    "end_panos": [g.viewpoints[i] for i in sorted(end_panos)],
                }
            )
        return items

    def r2r_items(self, split: str, n: int, start_idx: int = 0) -> list[dict]:
        items = []
        for k in range(n):
            scan = self.scans[int(self.rng.integers(len(self.scans)))]
            g = self.graphs[scan]
            path = self._random_path(g)
            heading = float(self.rng.uniform(0, 2 * np.pi))
            if self.directional_language:
                instructions = [self._directional_sentence(g, path, heading)]
            else:
                instructions = [self._sentence(8, 20) for _ in range(3)]
            items.append(
                {
                    "path_id": start_idx + k,
                    "scan": scan,
                    "heading": heading,
                    "path": [g.viewpoints[i] for i in path],
                    "instructions": instructions,
                }
            )
        return items

    def rxr_items(self, n: int) -> list[dict]:
        """RxR guide-annotation records (fields used by build_nav_instances
        + pretrain datagen: instruction_id/instruction/scan/path/heading).
        Drawn from a DERIVED rng so pre-existing seeded worlds' main stream
        (ndh/cvdn/r2r draws) is unchanged."""
        rng = np.random.default_rng((self._seed + 1) * 7919)
        items = []
        for k in range(n):
            scan = self.scans[int(rng.integers(len(self.scans)))]
            g = self.graphs[scan]
            # Inline path sampling on the derived rng (self._random_path
            # consumes the main stream).
            start = int(rng.integers(g.num_viewpoints))
            path = [start]
            for _ in range(int(rng.integers(3, 8))):
                nbrs = g.neighbors(path[-1])
                if len(nbrs) == 0:
                    break
                path.append(int(rng.choice(nbrs)))
            heading = float(rng.uniform(0, 2 * np.pi))
            if self.directional_language:
                instruction = self._directional_sentence(g, path, heading)
            else:
                instruction = " ".join(
                    str(rng.choice(_WORDS)) for _ in range(int(rng.integers(8, 20))))
            items.append({
                "instruction_id": k,
                "scan": scan,
                "heading": heading,
                "path": [g.viewpoints[i] for i in path],
                "instruction": instruction,
                "language": "en-US",
            })
        return items

    def cvdn_items(self, split: str, n: int, start_idx: int = 0) -> list[dict]:
        """CVDN gameplay-schema records (fields used by load_classifier_data)."""
        items = []
        for k in range(n):
            scan = self.scans[int(self.rng.integers(len(self.scans)))]
            g = self.graphs[scan]
            player = self._random_path(g, min_len=4, max_len=10)
            planner = player[: max(2, len(player) - 2)]
            goal = planner[-1]
            n_qa = int(self.rng.integers(1, 3))
            nav_idxs = sorted(
                self.rng.choice(np.arange(len(player)), size=n_qa, replace=False)
            )
            dialog = []
            for idx in nav_idxs:
                dialog.append(
                    {"message": self._sentence(), "role": "navigator", "nav_idx": int(idx)}
                )
                dialog.append(
                    {"message": self._sentence(), "role": "oracle", "nav_idx": int(idx)}
                )
            items.append(
                {
                    "idx": start_idx + k,
                    "scan": scan,
                    "target": str(self.rng.choice(_TARGETS)),
                    "dialog_history": dialog,
                    "planner_nav_steps": [g.viewpoints[i] for i in planner],
                    "nav_steps": [g.viewpoints[i] for i in player],
                    "nav_camera": [
                        {
                            "message": [
                                {
                                    "heading": float(self.rng.uniform(0, 2 * np.pi)),
                                    "elevation": 0.0,
                                }
                            ]
                        }
                    ],
                    "end_panos": [g.viewpoints[goal]],
                }
            )
        return items

    def write_task_data(self, root: str, counts: dict[str, int] | None = None) -> str:
        """Write NDH/CVDN/R2R JSON files under ``root`` in the reference layout
        (srv/task_data/<DS>/data/...; utils_data.py:63-105).  Each file is
        written whole under a temporary name and then renamed, so the ranks
        of a data-parallel ``--debug`` run, which write the same files into
        one output directory, never read a half-written one."""
        counts = counts or {"train": 12, "val_seen": 4, "val_unseen": 4}
        idx = 0
        for split, n in counts.items():
            _write_atomic(os.path.join(root, "NDH", "data", f"{split}.json"),
                          json.dumps(self.ndh_items(split, n, start_idx=idx)))
            _write_atomic(os.path.join(root, "CVDN", "data", f"{split}.json"),
                          json.dumps(self.cvdn_items(split, n, start_idx=idx)))
            _write_atomic(os.path.join(root, "R2R", "data", f"R2R_{split}.json"),
                          json.dumps(self.r2r_items(split, n, start_idx=idx)))
            idx += 1000
        # RxR ships train-guide annotations only (utils_data.py:92-99); the
        # records come off a derived rng so existing seeded streams hold.
        _write_atomic(os.path.join(root, "RxR", "data", "rxr_train_guide.jsonl"),
                      "".join(json.dumps(item) + "\n"
                              for item in self.rxr_items(counts.get("train", 12))))
        return root

    # -- features ---------------------------------------------------------------
    def scene_features(self) -> dict[str, np.ndarray]:
        """{scan_vp: (36, scene_feat_dim) float32} scene features (ResNet-style)."""
        out = {}
        for scan, g in self.graphs.items():
            for vp in g.viewpoints:
                key = f"{scan}_{vp}"
                out[key] = self.rng.standard_normal(
                    (geo.NUM_VIEWS, self.scene_feat_dim), dtype=np.float32
                )
        return out

    def region_features(self) -> tuple[dict[bytes, np.ndarray], dict[bytes, list[str]]]:
        """Region features + tokens keyed ``scan_vp_viewIdx`` (FeaturesReader parity)."""
        feats: dict[bytes, np.ndarray] = {}
        tokens: dict[bytes, list[str]] = {}
        for scan, g in self.graphs.items():
            for vp in g.viewpoints:
                for view in range(geo.NUM_VIEWS):
                    key = f"{scan}_{vp}_{view}".encode()
                    feats[key] = self.rng.standard_normal(
                        (self.regions_per_view, self.region_feat_dim), dtype=np.float32
                    )
                    tokens[key] = list(
                        self.rng.choice(_TARGETS, size=self.regions_per_view)
                    )
        return feats, tokens


def _write_atomic(path: str, text: str) -> None:
    """``text`` into ``path`` through a temporary file of this process and a
    rename."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
