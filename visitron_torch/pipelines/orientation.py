"""Orientation appender: bottom-up TSV -> pickle with 2054-d features
(visitron_tpu/pipelines/orientation.py; the port's own copy).

Script-level parity with scripts/add_orientation_to_features.py: read the
bottom-up TSV (per-(scan, viewpoint, view) rows with base64 arrays), decode,
concatenate 6 normalized box stats onto each 2048-d feature, and write the
pickle the FeaturesReader/RegionFeatureStore consumes.
"""

from __future__ import annotations

import base64
import csv
import pickle
import sys

import numpy as np

from visitron_torch.ops.detection import append_orientation

csv.field_size_limit(sys.maxsize)

BOTTOMUP_TSV_FIELDNAMES = [
    "scanId", "viewpointId", "image_w", "image_h", "vfov",
    "features", "region_tokens", "boxes", "cls_prob", "attr_prob",
    "featureViewIndex", "featureHeading", "featureElevation",
    "viewHeading", "viewElevation",
]


def _decode(value: str, dtype, shape=None):
    arr = np.frombuffer(base64.b64decode(value), dtype=dtype)
    return arr.reshape(shape) if shape is not None else arr


def read_bottomup_tsv(path: str) -> list[dict]:
    """Decode the bottom-up TSV rows (precompute_bottom-up_features.py:390-397
    writer format)."""
    items = []
    with open(path, "rt") as f:
        reader = csv.DictReader(f, delimiter="\t", fieldnames=BOTTOMUP_TSV_FIELDNAMES)
        for row in reader:
            item = {
                "scanId": row["scanId"],
                "viewpointId": row["viewpointId"],
                "image_w": int(row["image_w"]),
                "image_h": int(row["image_h"]),
                "vfov": int(row["vfov"]),
                "region_tokens": row["region_tokens"].split("|") if row["region_tokens"] else [],
                "featureViewIndex": row["featureViewIndex"],
            }
            feats = _decode(row["features"], np.float32)
            boxes = _decode(row["boxes"], np.float32)
            item["boxes"] = boxes.reshape(-1, 4)
            item["features"] = feats.reshape(item["boxes"].shape[0], -1)
            item["cls_prob"] = _decode(row["cls_prob"], np.float32).reshape(
                item["boxes"].shape[0], -1)
            items.append(item)
    return items


def write_bottomup_tsv(path: str, items: list[dict]) -> None:
    with open(path, "wt") as f:
        writer = csv.DictWriter(f, delimiter="\t", fieldnames=BOTTOMUP_TSV_FIELDNAMES,
                                extrasaction="ignore")
        for item in items:
            row = dict(item)
            row["region_tokens"] = "|".join(item.get("region_tokens", []))
            for key in ["features", "boxes", "cls_prob"]:
                row[key] = base64.b64encode(
                    np.ascontiguousarray(item[key], np.float32).tobytes()).decode("ascii")
            writer.writerow(row)


def add_orientation(items: list[dict]) -> list[dict]:
    """Append the 6 normalized box stats in place
    (add_orientation_to_features.py:98-133)."""
    for item in items:
        item["features"] = append_orientation(
            item["features"], item["boxes"], item["image_w"], item["image_h"])
    return items


def convert_tsv_to_oriented_pickle(tsv_path: str, pickle_path: str) -> int:
    items = add_orientation(read_bottomup_tsv(tsv_path))
    with open(pickle_path, "wb") as f:
        pickle.dump(items, f, protocol=-1)
    return len(items)
