"""Detection post-processing: NMS, confidence pooling, angular dedup,
geometry (visitron_tpu/ops/detection.py; the port's own copy).

Numpy implementations of the reference bottom-up pipeline's host steps
(scripts/precompute_bottom-up_features.py:177-289):
  * per-class NMS (threshold 0.3) pooling each ROI's max surviving confidence;
  * keep-box selection clamped to [MIN_LOCAL_BOXES, MAX_LOCAL_BOXES];
  * per-box heading/elevation from camera intrinsics (focal length from VFOV);
  * greedy pairwise dedup to MAX_TOTAL_BOXES by cosine-feature + heading +
    elevation distance (the reference's `filter`, with its `featrueElevation`
    typo fixed: elevation arrays are filtered here too);
  * region-token extraction (attribute + class strings);
  * orientation append: 6 normalized box stats -> 2054-d features
    (scripts/add_orientation_to_features.py:98-133).
"""

from __future__ import annotations

import math

import numpy as np

NMS_THRESH = 0.3
CONF_THRESH = 0.4
MIN_LOCAL_BOXES = 1
MAX_LOCAL_BOXES = 20
MAX_TOTAL_BOXES = 10
ATTR_THRESHOLD = 0.1


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = NMS_THRESH) -> np.ndarray:
    """Greedy non-maximum suppression; returns kept indices (descending score)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= iou_thresh]
    return np.array(keep, np.int64)


def select_boxes(boxes: np.ndarray, cls_prob: np.ndarray,
                 conf_thresh: float = CONF_THRESH,
                 nms_thresh: float = NMS_THRESH,
                 min_boxes: int = MIN_LOCAL_BOXES,
                 max_boxes: int = MAX_LOCAL_BOXES) -> np.ndarray:
    """Per-class NMS confidence pooling + keep selection
    (precompute_bottom-up_features.py:189-203)."""
    n = boxes.shape[0]
    max_conf = np.zeros(n, np.float32)
    for cls in range(1, cls_prob.shape[1]):
        scores = cls_prob[:, cls]
        keep = nms(boxes, scores, nms_thresh)
        max_conf[keep] = np.maximum(max_conf[keep], scores[keep])
    keep_boxes = np.where(max_conf >= conf_thresh)[0]
    if len(keep_boxes) < min_boxes:
        keep_boxes = np.argsort(max_conf)[::-1][:min_boxes]
    elif len(keep_boxes) > max_boxes:
        keep_boxes = np.argsort(max_conf)[::-1][:max_boxes]
    return keep_boxes


def box_orientation(boxes: np.ndarray, view_heading: float, view_elevation: float,
                    width: int, height: int, vfov_deg: float):
    """Per-box absolute (heading in (-pi, pi], elevation) from the camera pose
    and pinhole intrinsics (precompute_bottom-up_features.py:205-221)."""
    foc = (height / 2.0) / math.tan(math.radians(vfov_deg / 2.0))
    cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
    cy = 0.5 * (boxes[:, 1] + boxes[:, 3])
    heading = view_heading + np.arctan2(cx - width / 2.0, foc)
    heading = np.mod(heading + 2 * math.pi, 2 * math.pi)
    heading = np.where(heading > math.pi, heading - 2 * math.pi, heading)
    elevation = view_elevation + np.arctan2(-cy + height / 2.0, foc)
    return heading[:, None].astype(np.float32), elevation[:, None].astype(np.float32)


def _pairwise_cosine(x: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    norm = np.maximum(norm, 1e-12)
    sim = (x / norm) @ (x / norm).T
    return 1.0 - sim


def dedup_boxes(record: dict, max_boxes: int = MAX_TOTAL_BOXES) -> dict:
    """Greedy pairwise dedup keeping the higher-confidence of each close pair
    (the reference `filter`, :234-269).  Mutates and returns ``record``."""
    n = record["features"].shape[0]
    if n <= max_boxes:
        return record
    feat_dist = _pairwise_cosine(record["features"])
    hd = np.abs(record["featureHeading"] - record["featureHeading"].T)
    hd = np.minimum(hd, 2 * math.pi - hd)
    ed = np.abs(record["featureElevation"] - record["featureElevation"].T)
    dist = feat_dist + hd + ed
    dist += 10.0 * np.identity(n, np.float32)
    dist[np.triu_indices(n)] = 10.0
    ind = np.unravel_index(np.argsort(dist, axis=None), dist.shape)
    keep = set(range(n))
    ix = 0
    while len(keep) > max_boxes:
        i, j = int(ind[0][ix]), int(ind[1][ix])
        ix += 1
        if i not in keep or j not in keep:
            continue
        if record["cls_prob"][i, 1:].max() > record["cls_prob"][j, 1:].max():
            keep.remove(j)
        else:
            keep.remove(i)
    sel = sorted(keep)
    for k in ["boxes", "cls_prob", "attr_prob", "features",
              "featureHeading", "featureElevation"]:
        record[k] = record[k][sel]
    return record


def region_tokens(cls_prob: np.ndarray, attr_prob: np.ndarray,
                  classes: list[str], attributes: list[str],
                  attr_threshold: float = ATTR_THRESHOLD) -> list[str]:
    """Attr+class token strings per box (:272-289)."""
    objects = np.argmax(cls_prob[:, 1:], axis=1)
    attr = np.argmax(attr_prob[:, 1:], axis=1)
    attr_conf = np.max(attr_prob[:, 1:], axis=1)
    out = []
    for i in range(cls_prob.shape[0]):
        tok = classes[objects[i] + 1]
        if attr_conf[i] > attr_threshold:
            tok = attributes[attr[i] + 1] + " " + tok
        out.append(tok)
    return out


def append_orientation(features: np.ndarray, boxes: np.ndarray,
                       image_w: int, image_h: int) -> np.ndarray:
    """Concat 6 normalized box stats -> (N, D+6)
    (add_orientation_to_features.py:103-133)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    orient = np.stack([
        x1 / image_w, y1 / image_h, x2 / image_w, y2 / image_h,
        w / image_w, h / image_h,
    ], axis=1).astype(features.dtype)
    return np.concatenate([features, orient], axis=1)
