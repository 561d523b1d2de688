"""Region-feature (bottom-up) extraction pipeline
(visitron_tpu/pipelines/region_features.py).

Structure parity with scripts/precompute_bottom-up_features.py: for every
(scan, viewpoint, view) render, a detector proposes boxes with class and
attribute distributions and pooled features; host post-processing
(ops/detection.py) applies per-class NMS confidence pooling, box-count
clamping, per-box heading/elevation from the intrinsics, greedy
angular-feature dedup to 10 boxes, and region-token extraction.  Output: the
reference pickle layout (RegionFeatureStore) with the orientation-appended
2054-d features (scripts/add_orientation_to_features.py).

The detector is pluggable (the ``RegionDetector`` protocol):
models/detector.py's ``BottomUpDetector`` (Faster R-CNN on the card, views
batched ``views_per_dispatch`` at a time), or the deterministic host-side
``StubDetector`` that drives the pipeline without weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol

import numpy as np
import torch

from visitron_torch import geometry as geo
from visitron_torch._device import resolve_device
from visitron_torch.data.features import RegionFeatureStore
from visitron_torch.ops import detection as det
from visitron_torch.pipelines.rendering import CubemapLUT, view_rays


class RegionDetector(Protocol):
    num_classes: int
    num_attributes: int
    feature_dim: int

    def __call__(self, image: np.ndarray) -> dict:
        """image (H, W, 3) -> {"boxes" (N,4), "cls_prob" (N,C), "attr_prob"
        (N,A), "features" (N,D)}."""
        ...


@dataclass
class StubDetector:
    """Deterministic pseudo-detector (pipeline tests, --debug runs)."""

    num_classes: int = 12
    num_attributes: int = 5
    feature_dim: int = 2048
    boxes_per_image: int = 24
    seed: int = 0

    def __call__(self, image: np.ndarray) -> dict:
        h, w = image.shape[:2]
        # Deterministic per-image rng from content.
        key = int(np.abs(image).sum() * 1000) % (2**31)
        rng = np.random.default_rng(self.seed + key)
        n = self.boxes_per_image
        x1 = rng.uniform(0, w * 0.7, n)
        y1 = rng.uniform(0, h * 0.7, n)
        bw = rng.uniform(w * 0.1, w * 0.3, n)
        bh = rng.uniform(h * 0.1, h * 0.3, n)
        boxes = np.stack([x1, y1, np.minimum(x1 + bw, w - 1),
                          np.minimum(y1 + bh, h - 1)], axis=1).astype(np.float32)
        cls_prob = rng.dirichlet(np.ones(self.num_classes), n).astype(np.float32)
        attr_prob = rng.dirichlet(np.ones(self.num_attributes), n).astype(np.float32)
        feats = rng.standard_normal((n, self.feature_dim)).astype(np.float32)
        return {"boxes": boxes, "cls_prob": cls_prob, "attr_prob": attr_prob,
                "features": feats}


@dataclass
class RegionFeatureExtractor:
    detector: RegionDetector
    classes: list[str]       # index 0 = __background__
    attributes: list[str]    # index 0 = __no_attribute__
    image_w: int = 600
    image_h: int = 600
    vfov: int = 80
    max_total_boxes: int = det.MAX_TOTAL_BOXES
    # Views a detector call (detect_batch) when the detector has one: 6, the
    # JAX package's choice, a divisor of 36.  1 forces per-view calls.
    views_per_dispatch: int = 6
    # Where provider="faces" renders: the detector's device where it has
    # one, else this one (None: the card).
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(getattr(self.detector, "device", self.device))
        self._lut = None

    def extract_view(self, image: np.ndarray, view_heading: float,
                     view_elevation: float) -> dict:
        """One rendered view -> deduped record with <=10 boxes, tokens and
        orientation-appended features."""
        return self._postprocess(self.detector(image), view_heading,
                                 view_elevation)

    def _postprocess(self, raw: dict, view_heading: float,
                     view_elevation: float) -> dict:
        keep = det.select_boxes(raw["boxes"], raw["cls_prob"])
        rec = {
            "boxes": raw["boxes"][keep],
            "cls_prob": raw["cls_prob"][keep],
            "attr_prob": raw["attr_prob"][keep],
            "features": raw["features"][keep],
        }
        rec["featureHeading"], rec["featureElevation"] = det.box_orientation(
            rec["boxes"], view_heading, view_elevation,
            self.image_w, self.image_h, self.vfov)
        det.dedup_boxes(rec, self.max_total_boxes)
        rec["region_tokens"] = det.region_tokens(
            rec["cls_prob"], rec["attr_prob"], self.classes, self.attributes)
        rec["features"] = det.append_orientation(
            rec["features"], rec["boxes"], self.image_w, self.image_h)
        return rec

    def render(self, faces: np.ndarray) -> torch.Tensor:
        """(6, S, S, 3) uint8 skybox faces -> (36, H, W, 3) fp32 views on
        the extractor's device (CubemapLUT.render_torch)."""
        if self._lut is None or self._lut.face_size != faces.shape[1]:
            self._lut = CubemapLUT(view_rays(self.image_w, self.image_h, self.vfov),
                                   faces.shape[1])
        with torch.inference_mode():
            return self._lut.render_torch(torch.as_tensor(faces, device=self.device),
                                          dtype=torch.float32)

    def extract_all(self, graphs: dict, image_provider: Callable,
                    provider: str = "images") -> RegionFeatureStore:
        """image_provider(scan, vp) -> (36, H, W, 3) views ("images" mode) or
        (6, S, S, 3) uint8 skybox faces ("faces" mode: the cubemap resample
        runs on the card, the same math as SkyboxRenderer, and the views go
        to ``detect_batch`` without leaving it); returns the store keyed
        ``scan_vp_viewIdx`` (reference FeaturesReader layout)."""
        features: dict[bytes, np.ndarray] = {}
        tokens: dict[bytes, list[str]] = {}
        detect_batch = (getattr(self.detector, "detect_batch", None)
                        if self.views_per_dispatch > 1 else None)
        for scan in sorted(graphs):
            g = graphs[scan]
            for vp in g.viewpoints:
                pano = image_provider(scan, vp)
                if provider == "faces":
                    pano = self.render(pano)
                    if detect_batch is None:
                        pano = pano.cpu().numpy()
                if detect_batch is not None:
                    raws = [r for s in range(0, geo.NUM_VIEWS, self.views_per_dispatch)
                            for r in detect_batch(pano[s:s + self.views_per_dispatch])]
                else:
                    raws = [self.detector(pano[view]) for view in range(geo.NUM_VIEWS)]
                for view, raw in enumerate(raws):
                    rec = self._postprocess(raw, geo.heading_of_view(view),
                                            geo.elevation_of_view(view))
                    key = f"{scan}_{vp}_{view}".encode()
                    features[key] = rec["features"]
                    tokens[key] = rec["region_tokens"]
        return RegionFeatureStore(features, tokens, self.image_w, self.image_h, self.vfov)


def verify_region_store(path_prefix: str) -> dict:
    """Round-trip sanity check of a written store
    (scripts/verify_bottom-up_features_in_python3.py parity)."""
    store = RegionFeatureStore.from_pickle(path_prefix)
    if len(store) == 0:
        raise ValueError(f"{path_prefix}: empty region store")
    key = store.keys[0]
    feats = store[key]
    toks = store.get_region_tokens(key)
    if not (feats.ndim == 2 and feats.shape[0] == len(toks) and np.isfinite(feats).all()):
        raise ValueError(f"{path_prefix}: key {key!r} holds features {feats.shape} "
                         f"and {len(toks)} tokens, or non-finite values")
    return {"num_keys": len(store), "feature_dim": int(feats.shape[1]),
            "boxes_first": int(feats.shape[0])}
