"""The benchmark's inputs, made from the seed: a Matterport-shaped world of
navigation graphs, NDH dialog episodes on it, and pretraining batches.

Plain numpy and scipy; nothing of the program.  Both sides read what this
module makes: the program through its own data classes (the loops build
them), the reference directly.  The generators follow the repository's
synthetic world (random floor plans of 25 m x 25 m, a nearest-neighbour
spanning tree plus extra edges to a mean degree of 3, shortest-path episodes
of 3 to 8 viewpoints, dialogs of 2-5 navigator/oracle exchanges of 10-29
words), with token ids drawn directly instead of through a tokenizer.

Every position is rounded to float32 when drawn, so the program's float32
positions and this module's float64 arithmetic see the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

NUM_VIEWS = 36
FLOOR_M = 25.0

# bert-base-uncased ids: [PAD] 0, [CLS] 101, [SEP] 102, ordinary wordpieces
# from 1996 up.  The task tokens [TAR] / [QUES] / [ANS] take unused slots.
PAD, CLS, SEP, TAR, QUES, ANS = 0, 101, 102, 1, 2, 3
FIRST_WORD = 1996
SEGMENTS = {"cls": 0, "tar": 1, "ques": 2, "ans": 3}


def stream(seed: int, name: str) -> np.random.Generator:
    """An independent numpy generator for one named input of a seed."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), sum(map(ord, name)), len(name)])


@dataclass
class Scan:
    name: str
    viewpoints: list
    positions: np.ndarray  # (V, 3) float64 holding float32 values
    adjacency: np.ndarray  # (V, V) bool, symmetric
    dist: np.ndarray = field(repr=False, default=None)  # (V, V) metres
    pred: np.ndarray = field(repr=False, default=None)  # predecessor[g, u] on g->u

    def path(self, u: int, g: int) -> list:
        """Shortest path u -> g as viewpoint indices, both ends included."""
        out = [u]
        while out[-1] != g:
            out.append(int(self.pred[g, out[-1]]))
        return out

    def connectivity(self) -> list:
        """The scan in the Matterport connectivity-JSON schema."""
        entries = []
        for i, vp in enumerate(self.viewpoints):
            x, y, z = (float(c) for c in self.positions[i])
            entries.append({"image_id": vp, "included": True, "height": z,
                            "pose": [1.0, 0.0, 0.0, x, 0.0, 1.0, 0.0, y,
                                     0.0, 0.0, 1.0, z, 0.0, 0.0, 0.0, 1.0],
                            "unobstructed": self.adjacency[i].tolist()})
        return entries


def shortest_paths(positions: np.ndarray, adjacency: np.ndarray):
    """(dist, predecessors) over edges weighted by 3-D distance."""
    diff = positions[:, None, :] - positions[None, :, :]
    weights = np.where(adjacency, np.sqrt((diff ** 2).sum(-1)), 0.0)
    return dijkstra(csr_matrix(weights), directed=False, return_predecessors=True)


def make_scan(rng: np.random.Generator, name: str, n: int, mean_degree: float) -> Scan:
    pos = np.zeros((n, 3))
    pos[:, :2] = rng.uniform(0, FLOOR_M, (n, 2))
    pos[:, 2] = 1.5 + rng.uniform(-0.2, 0.2, n)
    pos = pos.astype(np.float32).astype(np.float64)
    adj = np.zeros((n, n), bool)
    order = rng.permutation(n)
    for j in range(1, n):
        v, done = order[j], order[:j]
        u = done[int(np.argmin(np.linalg.norm(pos[done] - pos[v], axis=1)))]
        adj[u, v] = adj[v, u] = True
    d2 = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d2, np.inf)
    near = np.argsort(d2, axis=1)[:, :4]
    for _ in range(int(max(0.0, mean_degree - 2.0) * n / 2)):
        u = int(rng.integers(n))
        v = int(near[u, int(rng.integers(4))])
        adj[u, v] = adj[v, u] = True
    scan = Scan(name, [f"{name}v{i:04d}" for i in range(n)], pos, adj)
    scan.dist, scan.pred = shortest_paths(pos, adj)
    return scan


@dataclass
class Episode:
    """One NDH episode: a dialog as token ids and its path on a scan."""
    idx: int
    scan: int
    token_ids: np.ndarray  # (max_len,) int32, [PAD]-padded
    segment_ids: np.ndarray  # (max_len,) int32
    length: int
    path: list  # viewpoint indices in the scan, start to goal
    heading: float  # start heading (radians)


class World:
    """``scans`` x ``viewpoints_per_scan`` viewpoints in scan-major rows."""

    def __init__(self, seed: int, scans: int, viewpoints_per_scan: int,
                 mean_degree: float = 3.0):
        rng = stream(seed, "graphs")
        self.scans = [make_scan(rng, f"s{j:02d}", viewpoints_per_scan, mean_degree)
                      for j in range(scans)]
        self.offsets = np.cumsum([0] + [len(s.viewpoints) for s in self.scans])[:-1]
        self.num_rows = int(sum(len(s.viewpoints) for s in self.scans))

    def row(self, scan: int, vp: int) -> int:
        return int(self.offsets[scan] + vp)

    def episodes(self, seed: int, name: str, n: int, turns=(2, 6), words=(10, 30),
                 path_nodes=(3, 8), max_len: int = 512) -> list:
        """``n`` episodes: a scan, a shortest path of ``path_nodes`` viewpoints,
        a start heading and a dialog of ``turns`` (half-open) exchanges of
        ``words`` (half-open) words a message, laid out as
        [CLS] [TAR] target [QUES] q1 [ANS] a1 ... [SEP].

        The dialogs' lengths come from a stream that does not depend on
        ``seed``: every seed gives the same length at each index, so a
        schedule over the indices meets the same shapes in the same order,
        and the seed changes only what the episodes hold."""
        rng, sizes = stream(seed, name), stream(0, name + "/lengths")
        out = []
        for k in range(n):
            si = int(rng.integers(len(self.scans)))
            sc = self.scans[si]
            while True:
                s, g = (int(x) for x in rng.integers(len(sc.viewpoints), size=2))
                if s != g and np.isfinite(sc.dist[g, s]):
                    path = sc.path(s, g)
                    if path_nodes[0] <= len(path) <= path_nodes[1]:
                        break
            ids, segs = [CLS], [SEGMENTS["cls"]]
            target = rng.integers(FIRST_WORD, 30522, int(sizes.integers(1, 3))).tolist()
            ids += [TAR] + target
            segs += [SEGMENTS["tar"]] * (len(target) + 1)
            for m in range(int(sizes.integers(*turns)) * 2):
                words_m = rng.integers(FIRST_WORD, 30522, int(sizes.integers(*words))).tolist()
                ids += [QUES if m % 2 == 0 else ANS] + words_m
                segs += [SEGMENTS["ques" if m % 2 == 0 else "ans"]] * (len(words_m) + 1)
            ids, segs = ids[:max_len - 2] + [SEP], segs[:max_len - 2] + [0]
            token_ids = np.full(max_len, PAD, np.int32)
            segment_ids = np.zeros(max_len, np.int32)
            token_ids[:len(ids)], segment_ids[:len(segs)] = ids, segs
            out.append(Episode(k, si, token_ids, segment_ids, len(ids), path,
                               float(rng.uniform(0, 2 * np.pi))))
        return out


def scene_table(seed: int, rows: int, dim: int, device, dtype):
    """The (rows, 36, dim) scene-feature table, N(0, 1), drawn on ``device``
    in one call from a generator there, in the type it is served in."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    return torch.randn((rows, NUM_VIEWS, dim), generator=g, device=device, dtype=dtype)


def pretrain_pool(seed: int, batches: int, batch: int, text: int, img: int,
                  text_len=(96, 512), regions=(128, 256), vocab: int = 30525,
                  img_dim: int = 2054, classes: int = 1601, actions: int = 36,
                  mlm_share: float = 0.15, token_share: float = 0.05, device="cpu") -> list:
    """``batches`` distinct pretraining batches (numpy, the trainer's host
    layout) of ``batch`` rows x (``text`` + ``img``) slots: valid text
    lengths and region counts uniform in their (inclusive) ranges, MLM
    labels on ``mlm_share`` of the valid text tokens, region-token labels
    on ``token_share`` of them, one next-action label a row.  Drawn on
    ``device`` in a few large calls."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    shape = (batches, batch)
    n_text = torch.randint(text_len[0], text_len[1] + 1, shape, generator=g, device=device)
    n_img = torch.randint(regions[0], regions[1] + 1, shape, generator=g, device=device)
    pos_t = torch.arange(text, device=device)
    pos_i = torch.arange(img, device=device)
    text_ok = pos_t < n_text[..., None]
    img_ok = pos_i < n_img[..., None]
    ids = torch.randint(FIRST_WORD, vocab, shape + (text,), generator=g, device=device)
    ids = torch.where(text_ok, ids, PAD)
    ids[..., 0] = CLS
    ids = torch.where(pos_t == n_text[..., None] - 1, SEP, ids)
    types = torch.randint(0, 4, shape + (text,), generator=g, device=device) * text_ok
    mask = torch.cat([text_ok, img_ok], -1).to(torch.int32)
    pad_img = torch.zeros(shape + (img,), dtype=torch.int64, device=device) - 1
    draw = torch.rand(shape + (text,), generator=g, device=device)
    mlm = torch.randint(FIRST_WORD, vocab, shape + (text,), generator=g, device=device)
    labels = torch.cat([torch.where(text_ok & (draw < mlm_share), mlm, -1), pad_img], -1)
    draw = torch.rand(shape + (text,), generator=g, device=device)
    cls = torch.randint(0, classes, shape + (text,), generator=g, device=device)
    tokens = torch.cat([torch.where(text_ok & (draw < token_share), cls, -1), pad_img], -1)
    feats = torch.randn(shape + (img, img_dim), generator=g, device=device)
    loc = torch.randn(shape + (img, 128), generator=g, device=device)
    nxt = torch.randint(0, actions, shape, generator=g, device=device)
    host = {"input_ids": ids, "token_type_ids": types, "attention_mask": mask,
            "labels": labels, "token_labels": tokens, "img_feats": feats,
            "img_location_embeddings": loc, "next_action": nxt}
    host = {k: v.cpu().numpy() for k, v in host.items()}
    for k in ("input_ids", "token_type_ids", "labels", "token_labels", "next_action"):
        host[k] = host[k].astype(np.int32)
    return [{k: v[i] for k, v in host.items()} for i in range(batches)]
