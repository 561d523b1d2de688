"""Scene-feature extraction: ResNet global features for all 36 views
(visitron_tpu/pipelines/scene_features.py), on the card.

Replaces scripts/precompute_resnet_img_features.py (render 36 views per
viewpoint, torchvision ResNet-152 in batches of 12, TSV output): the
backbone processes whole panoramas (2 a forward, 72 views) in bfloat16 by
default, and the writer emits the identical TSV schema.

Rendering is decoupled: the extractor consumes an ``image_provider``
callable, ``(scan, viewpoint) -> (36, H, W, 3) float32 in [0, 1]``
(pre-rendered views) or, with ``provider="faces"``, ``-> (6, S, S, 3)``
uint8 skybox faces, which are resampled on the card in the same forward
(CubemapLUT.render_torch): only the faces cross from the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from visitron_torch import geometry as geo
from visitron_torch._device import resolve_device
from visitron_torch.data.features import write_tsv_img_features
from visitron_torch.models.resnet import ResNet, convert_torchvision_resnet, random_state
from visitron_torch.pipelines.rendering import CubemapLUT, view_rays
from visitron_torch.utils import Timer


@dataclass
class SceneFeatureExtractor:
    state: dict  # torchvision-layout ResNet state dict (``fc.*`` ignored)
    depth: int = 152
    image_w: int = 640
    image_h: int = 480
    vfov: int = 60
    # Panoramas per forward: 2 (72 views), the JAX package's choice.
    viewpoints_per_batch: int = 2
    # Conv compute dtype: bf16 by default; fp32 (without TF32) reproduces
    # torchvision.  Parameters stay fp32; the pooled output is always fp32.
    dtype: torch.dtype = torch.bfloat16
    device: object = None  # None: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = ResNet(self.depth, dtype=self.dtype)
        convert_torchvision_resnet(self.state, self.model)
        self.model.to(self.device).eval()
        self._lut = None

    @classmethod
    def from_torch_checkpoint(cls, path: str, depth: int = 152, **kw):
        """The extractor of a torchvision ResNet ``.pth`` state dict."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        return cls(state=state, depth=depth, **kw)

    @classmethod
    def random_init(cls, rng_seed: int = 0, depth: int = 50, **kw):
        """A randomly initialised backbone (tests, --debug runs)."""
        return cls(state=random_state(ResNet(depth), rng_seed), depth=depth, **kw)

    def _forward(self, images: torch.Tensor) -> np.ndarray:
        with torch.inference_mode():
            return self.model(images).cpu().numpy()

    def forward_faces(self, faces: np.ndarray) -> np.ndarray:
        """(P, 6, S, S, 3) uint8 skybox faces -> (P*36, D) features: the
        faces go to the card, are resampled there into the 36 views in the
        compute dtype and run through the backbone."""
        if self._lut is None or self._lut.face_size != faces.shape[2]:
            self._lut = CubemapLUT(view_rays(self.image_w, self.image_h, self.vfov),
                                   faces.shape[2])
        with torch.inference_mode():
            views = self._lut.render_torch(torch.as_tensor(faces, device=self.device),
                                           dtype=self.dtype)
            return self.model(views.reshape(-1, *views.shape[2:])).cpu().numpy()

    def extract_viewpoint(self, images: np.ndarray) -> np.ndarray:
        """(36, H, W, 3) -> (36, 2048) float32."""
        if images.shape[0] != geo.NUM_VIEWS:
            raise ValueError(f"expected {geo.NUM_VIEWS} views, got {images.shape[0]}")
        return self._forward(torch.as_tensor(images, dtype=torch.float32, device=self.device))

    def _flush(self, buf: list, features: dict, faces: bool = False) -> None:
        """Run one multi-panorama forward over the buffered viewpoints.

        The final partial batch pads with zeros to the steady-state shape
        (the JAX package's one jit variant); padded rows are discarded.
        ``faces``: buf holds (key, (6, S, S, 3) uint8 skybox faces), rendered
        on the card in the same forward."""
        vpb = self.viewpoints_per_batch
        if faces:
            stack = np.stack([f for _, f in buf])  # (P, 6, S, S, 3)
            if len(buf) < vpb:
                pad = np.zeros((vpb - len(buf), *stack.shape[1:]), stack.dtype)
                stack = np.concatenate([stack, pad], axis=0)
            out = self.forward_faces(stack)
        else:
            for key, images in buf:
                # A wrong view count would shift every panorama of the batch.
                if images.shape[0] != geo.NUM_VIEWS:
                    raise ValueError(f"{key}: expected {geo.NUM_VIEWS} views, "
                                     f"got {images.shape[0]}")
            imgs = np.concatenate([images for _, images in buf], axis=0)
            if len(buf) < vpb:
                pad = np.zeros(((vpb - len(buf)) * geo.NUM_VIEWS, *imgs.shape[1:]),
                               imgs.dtype)
                imgs = np.concatenate([imgs, pad], axis=0)
            out = self._forward(torch.as_tensor(imgs, dtype=torch.float32,
                                                device=self.device))
        for i, (key, _) in enumerate(buf):
            features[key] = out[i * geo.NUM_VIEWS:(i + 1) * geo.NUM_VIEWS]
        buf.clear()

    def extract_all(self, graphs: dict, image_provider, out_tsv: str | None = None,
                    log_every: int = 100, logger=None,
                    provider: str = "images") -> dict[str, np.ndarray]:
        """All (scan, viewpoint) panoramas -> {scan_vp: (36, D)}; optional TSV.

        ``provider="images"``: image_provider(scan, vp) -> (36, H, W, 3)
        float [0, 1] pre-rendered views (host rendering).
        ``provider="faces"``: image_provider(scan, vp) -> (6, S, S, 3) uint8
        skybox faces; the cubemap resample runs on the card in the forward
        (the same math as SkyboxRenderer.render_views, see CubemapLUT), so
        the host's only work is the JPEG decode.

        Mirrors the reference throughput accounting (render/net time per
        viewpoint, projected totals; precompute_resnet_img_features.py:270-282).
        """
        faces = provider == "faces"
        features: dict[str, np.ndarray] = {}
        render_t, net_t = Timer(), Timer()
        total = sum(g.num_viewpoints for g in graphs.values())
        done = 0
        start = time.time()
        buf: list = []
        for scan in sorted(graphs):
            g = graphs[scan]
            for vp in g.viewpoints:
                render_t.tic()
                images = image_provider(scan, vp)
                render_t.toc()
                buf.append((f"{scan}_{vp}", images))
                if len(buf) == self.viewpoints_per_batch:
                    net_t.tic()
                    self._flush(buf, features, faces=faces)
                    net_t.toc()
                done += 1
                if logger and done % log_every == 0:
                    avg_r = render_t.toc(average=True)
                    # net_t ticks once per flush of viewpoints_per_batch.
                    avg_n = (net_t.toc(average=True)
                             / max(self.viewpoints_per_batch, 1))
                    rate = done / (time.time() - start)
                    logger.info(
                        "%d/%d viewpoints; render %.3fs net %.3fs; ~%.1f h left",
                        done, total, avg_r, avg_n, (total - done) / rate / 3600)
        if buf:
            self._flush(buf, features, faces=faces)
        if out_tsv:
            write_tsv_img_features(out_tsv, features, self.image_w, self.image_h, self.vfov)
        return features
