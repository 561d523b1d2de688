"""Feature stores: the reference TSV reader and writer, the packed
scene-feature table and the in-memory region-feature store.

Reference format (tasks/viewpoint_select/utils_data.py:331-373): one TSV row
per (scan, viewpoint) with base64 (36, 2048) float32 features.

`SceneFeatureTable` packs all scans into a single (total_viewpoints, 36, D)
array with an id->row index, so the rollout hot loop is a device gather
instead of a host dict lookup + copy per step.  Host-side numpy; the runtime
(agents/runtime.py) moves the table onto the device.

`RegionFeatureStore` holds per-view region features and detector tokens for
pretraining (visitron_tpu/data/features.py): in memory, or read from and
written to the reference pickle or LMDB formats (the LMDB ones need the
optional ``lmdb`` module, imported where they run).
"""

from __future__ import annotations

import base64
import csv
import pickle
import sys
from dataclasses import dataclass

import numpy as np

from visitron_torch import geometry as geo

csv.field_size_limit(sys.maxsize)

TSV_FIELDNAMES = ["scanId", "viewpointId", "image_w", "image_h", "vfov", "features"]


def read_tsv_img_features(path: str | None = None, feature_size: int = 2048, blind: bool = False) -> dict:
    """Parity: utils_data.py:331-373. Returns {"features": {scan_vp: (36,D)},
    "image_w", "image_h", "vfov"}."""
    if not path:
        return {"features": None, "image_w": 640, "image_h": 480, "vfov": 60}
    features = {}
    image_w, image_h, vfov = 640, 480, 60
    with open(path, "rt") as f:
        reader = csv.DictReader(f, delimiter="\t", fieldnames=TSV_FIELDNAMES)
        for item in reader:
            image_w, image_h = int(item["image_w"]), int(item["image_h"])
            vfov = int(item["vfov"])
            long_id = item["scanId"] + "_" + item["viewpointId"]
            if blind:
                features[long_id] = np.zeros((geo.NUM_VIEWS, feature_size), dtype=np.float32)
            else:
                features[long_id] = np.frombuffer(
                    base64.b64decode(item["features"]), dtype=np.float32
                ).reshape((geo.NUM_VIEWS, feature_size))
    return {"features": features, "image_w": image_w, "image_h": image_h, "vfov": vfov}


def write_tsv_img_features(path: str, features: dict[str, np.ndarray],
                           image_w: int = 640, image_h: int = 480, vfov: int = 60) -> None:
    """Write the reference TSV format (output parity with
    scripts/precompute_resnet_img_features.py)."""
    with open(path, "wt") as f:
        writer = csv.DictWriter(f, delimiter="\t", fieldnames=TSV_FIELDNAMES)
        for long_id, feat in features.items():
            scan, vp = long_id.split("_", 1)
            writer.writerow(
                {
                    "scanId": scan,
                    "viewpointId": vp,
                    "image_w": image_w,
                    "image_h": image_h,
                    "vfov": vfov,
                    "features": base64.b64encode(
                        np.ascontiguousarray(feat, dtype=np.float32).tobytes()
                    ).decode("ascii"),
                }
            )


@dataclass
class SceneFeatureTable:
    """Packed per-viewpoint scene features for gather-based rollouts.

    ``table[row(scan, vp)] -> (36, D)``; rows are contiguous per scan so a
    whole batch's panorama features are one integer-gather on device.
    """

    table: np.ndarray  # (total_vps, 36, D) float32
    row_index: dict[str, int]  # "scan_vp" -> row
    scan_offsets: dict[str, int]  # scan -> first row
    image_w: int = 640
    image_h: int = 480
    vfov: int = 60

    def row(self, scan: str, viewpoint: str) -> int:
        return self.row_index[f"{scan}_{viewpoint}"]

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        """The (36, D) features of one viewpoint (the environment's join)."""
        return self.table[self.row(scan, viewpoint)]

    @classmethod
    def pack(cls, graphs: dict, features: dict[str, np.ndarray],
             image_w: int = 640, image_h: int = 480, vfov: int = 60,
             dtype=np.float32) -> "SceneFeatureTable":
        """Pack a {scan_vp: (36, D)} dict scan-contiguously (graph index order)."""
        rows: list[np.ndarray] = []
        row_index: dict[str, int] = {}
        scan_offsets: dict[str, int] = {}
        r = 0
        for scan in sorted(graphs):
            g = graphs[scan]
            scan_offsets[scan] = r
            for vp in g.viewpoints:
                key = f"{scan}_{vp}"
                rows.append(np.asarray(features[key], dtype=dtype))
                row_index[key] = r
                r += 1
        return cls(
            table=np.stack(rows, axis=0),
            row_index=row_index,
            scan_offsets=scan_offsets,
            image_w=image_w,
            image_h=image_h,
            vfov=vfov,
        )

    @classmethod
    def zeros(cls, graphs: dict, feature_dim: int, **kw) -> "SceneFeatureTable":
        """An all-zero table (a run without a scene-feature file)."""
        feats = {}
        for scan, g in graphs.items():
            for vp in g.viewpoints:
                feats[f"{scan}_{vp}"] = np.zeros((geo.NUM_VIEWS, feature_dim), np.float32)
        return cls.pack(graphs, feats, **kw)


class RegionFeatureStore:
    """Region features + tokens keyed ``scan_vp_viewIdx``, held in memory,
    or read from the reference pickle (:meth:`from_pickle`) or LMDB
    (:meth:`from_lmdb`) layouts."""

    def __init__(self, features: dict[bytes, np.ndarray], region_tokens: dict[bytes, list[str]],
                 image_w: int = 640, image_h: int = 480, vfov: int = 60):
        self.features = features
        self.region_tokens = region_tokens
        self.keys = list(features.keys())
        self.image_w, self.image_h, self.vfov = image_w, image_h, vfov
        self.viewpoints: dict[str, set] = {}
        for key in self.keys:
            scan_id, viewpoint_id, _ = key.decode().split("_")
            self.viewpoints.setdefault(scan_id, set()).add(viewpoint_id)

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, key: bytes) -> np.ndarray:
        if key not in self.features:
            raise TypeError(f"invalid key: {key!r}")
        return self.features[key]

    def get_region_tokens(self, key: bytes) -> list[str]:
        if key not in self.region_tokens:
            raise TypeError(f"invalid key: {key!r}")
        return self.region_tokens[key]

    # -- persistence (reference pickle format parity) ----------------------
    @classmethod
    def from_pickle(cls, path_prefix: str) -> "RegionFeatureStore":
        """Load ``<prefix>.pickle`` written as a list of per-(scan,vp,view)
        dicts (utils_data.py:448-479)."""
        with open(path_prefix + ".pickle", "rb") as f:
            loaded = pickle.load(f)
        features, tokens = {}, {}
        meta = loaded[0]
        for item in loaded:
            key = f"{item['scanId']}_{item['viewpointId']}_{item['featureViewIndex']}".encode()
            features[key] = item["features"]
            tokens[key] = item["region_tokens"]
        return cls(features, tokens, meta["image_w"], meta["image_h"], meta["vfov"])

    def to_pickle(self, path_prefix: str) -> None:
        out = []
        for key in self.keys:
            scan, vp, view = key.decode().split("_")
            out.append(
                {
                    "scanId": scan,
                    "viewpointId": vp,
                    "featureViewIndex": view,
                    "features": self.features[key],
                    "region_tokens": self.region_tokens[key],
                    "image_w": self.image_w,
                    "image_h": self.image_h,
                    "vfov": self.vfov,
                }
            )
        with open(path_prefix + ".pickle", "wb") as f:
            pickle.dump(out, f, protocol=-1)

    @classmethod
    def from_lmdb(cls, path_prefix: str) -> "RegionFeatureStore":
        """Load the reference LMDB layout (requires the optional lmdb module)."""
        import lmdb  # optional: not part of the base environment

        env = lmdb.open(path_prefix + ".lmdb", readonly=True, readahead=False,
                        max_readers=1, lock=False)
        with env.begin(write=False) as txn:
            keys = pickle.loads(txn.get("keys".encode()))
            features = {k: pickle.loads(txn.get(k))["features"] for k in keys}
            meta = pickle.loads(txn.get(keys[0]))
        with open(path_prefix + "-region_labels.pickle", "rb") as f:
            tokens = pickle.load(f)
        return cls(features, tokens, meta["image_w"], meta["image_h"], meta["vfov"])

    def to_lmdb(self, path_prefix: str, map_size: int = 1 << 34) -> None:
        """Write the reference LMDB layout (utils_data.py:415-438 read side):
        a "keys" entry listing every ``scan_vp_view`` key, one pickled record
        per key, plus the ``-region_labels.pickle`` sidecar.  Round-trips with
        :meth:`from_lmdb`."""
        import lmdb  # optional: not part of the base environment

        env = lmdb.open(path_prefix + ".lmdb", map_size=map_size)
        with env.begin(write=True) as txn:
            txn.put("keys".encode(), pickle.dumps(self.keys, protocol=-1))
            for key in self.keys:
                scan, vp, view = key.decode().split("_")
                item = {
                    "scanId": scan, "viewpointId": vp, "featureViewIndex": view,
                    "features": self.features[key],
                    "image_w": self.image_w, "image_h": self.image_h,
                    "vfov": self.vfov,
                }
                txn.put(key, pickle.dumps(item, protocol=-1))
        env.sync()
        env.close()
        with open(path_prefix + "-region_labels.pickle", "wb") as f:
            pickle.dump(self.region_tokens, f, protocol=-1)
