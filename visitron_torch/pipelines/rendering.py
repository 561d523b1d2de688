"""Skybox -> perspective-view rendering for the offline feature pipelines
(visitron_tpu/pipelines/rendering.py; the port's own copy).

The reference renders the 36 discretized views of every panorama through
MatterSim's OpenGL renderer (scripts/precompute_resnet_img_features.py:224-232,
precompute_bottom-up_features.py:334-405).  MatterSim itself textures a cube
with the six Matterport skybox JPEGs and rasterizes a pinhole camera; no scene
geometry is involved.  We therefore replace OpenGL with closed-form cubemap
resampling: for every (heading, elevation) view a pinhole ray grid is cast and
bilinearly sampled from the cube faces — pure array math, no GL context, and
bit-stable across machines.

Coordinate frame (Matterport convention, geometry.py): x=east, y=north, z=up;
heading measured clockwise from north; elevation positive upward.  The six
canonical cube faces are ordered ``(+x, -x, +y, -y, +z, -z)``; face images are
what an upright viewer at the centre sees looking at that axis (u rightward,
v downward, top of side faces = +z).  The up/down faces use u=east and
v=north/south respectively.  ``SKYBOX_FACE_INDEX`` maps canonical faces to
Matterport ``*_skybox{i}_sami.jpg`` indices (0=up, 5=down, 1..4 = sides
starting north going clockwise); pass a different mapping if your scan export
orders them otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

import torch

from visitron_torch import geometry as geo

# Canonical face order used internally.
FACES = ("+x", "-x", "+y", "-y", "+z", "-z")

# Matterport skybox file index for each canonical face (documented assumption;
# configurable): skybox0=up, skybox1=north, skybox2=east, skybox3=south,
# skybox4=west, skybox5=down.
SKYBOX_FACE_INDEX = {"+z": 0, "+y": 1, "+x": 2, "-y": 3, "-x": 4, "-z": 5}

# Default Matterport-v1 dataset layout.
SKYBOX_PATH_TEMPLATE = os.path.join(
    "{root}", "{scan}", "matterport_skybox_images", "{viewpoint}_skybox{i}_sami.jpg")


def view_ray_grid(heading: float, elevation: float, width: int, height: int,
                  vfov_rad: float) -> np.ndarray:
    """(H, W, 3) unit ray directions of a pinhole camera at (heading, elevation).

    Pinhole intrinsics match the reference's camera maths
    (precompute_bottom-up_features.py:94-99: focal length = H/2 / tan(vfov/2)).
    """
    f = np.array([np.sin(heading) * np.cos(elevation),
                  np.cos(heading) * np.cos(elevation),
                  np.sin(elevation)], np.float64)
    r = np.array([np.cos(heading), -np.sin(heading), 0.0], np.float64)
    u = np.cross(r, f)
    t_v = np.tan(vfov_rad / 2.0)
    t_h = t_v * width / height  # square pixels
    xs = (2.0 * (np.arange(width) + 0.5) / width - 1.0) * t_h
    ys = (1.0 - 2.0 * (np.arange(height) + 0.5) / height) * t_v
    d = (f[None, None]
         + xs[None, :, None] * r[None, None]
         + ys[:, None, None] * u[None, None])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def view_rays(image_w: int, image_h: int, vfov_deg: float) -> np.ndarray:
    """(36, H, W, 3) unit rays of the 36 discretised views."""
    vf = np.radians(vfov_deg)
    return np.stack([view_ray_grid(geo.heading_of_view(v), geo.elevation_of_view(v),
                                   image_w, image_h, vf)
                     for v in range(geo.NUM_VIEWS)])


def _face_uv(d: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rays (..., 3) -> (face_idx, u, v) per ray, faces in FACES order, u/v in
    [0, 1] with v measured downward in the face image."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = np.abs(dx), np.abs(dy), np.abs(dz)
    face = np.where(
        (ax >= ay) & (ax >= az), np.where(dx >= 0, 0, 1),
        np.where(ay >= az, np.where(dy >= 0, 2, 3), np.where(dz >= 0, 4, 5)))
    ma = np.maximum(np.maximum(ax, ay), az)
    ma = np.where(ma == 0, 1.0, ma)
    # Per-face (sc, tc): u ∝ viewer-right, v ∝ downward (see module docstring).
    sc = np.choose(face, [-dy, dy, dx, -dx, dx, dx])
    tc = np.choose(face, [-dz, -dz, -dz, -dz, dy, -dy])
    u = (sc / ma + 1.0) / 2.0
    v = (tc / ma + 1.0) / 2.0
    return face, u, v


def sample_cubemap(faces: np.ndarray, rays: np.ndarray) -> np.ndarray:
    """Bilinearly sample a cubemap.

    faces: (6, S, S, C) in canonical FACES order; rays: (..., 3).
    Returns (..., C) with faces' dtype promoted to float32.
    """
    six, s, s2, c = faces.shape
    assert six == 6 and s == s2, faces.shape
    face, u, v = _face_uv(rays)
    x = u * (s - 1)
    y = v * (s - 1)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, s - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, s - 2)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    f = faces.astype(np.float32)
    p00 = f[face, y0, x0]
    p01 = f[face, y0, x0 + 1]
    p10 = f[face, y0 + 1, x0]
    p11 = f[face, y0 + 1, x0 + 1]
    return (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
            + p10 * (1 - fx) * fy + p11 * fx * fy)


class CubemapLUT:
    """Precomputed, skybox-INDEPENDENT bilinear sampling tables.

    ``sample_cubemap`` recomputes the ray->face/uv math and gathers per
    call, on one host core for every pixel.  The (face, x0, y0, fx, fy) of
    every output pixel depend only on the view geometry and face size, so
    they are computed ONCE here; rendering any skybox is then 4 flat
    gathers + a weighted sum, on the host (``render_np``, exact
    ``sample_cubemap`` parity) or on the card (``render_torch``, in the
    feature extractors' forward, so only the 6 uint8 faces cross from the
    host to the card).

    Layout: ``idx00`` is the flat index into the flattened ``(6*S*S, C)``
    faces of the top-left tap; the other taps are ``+1`` (x), ``+S`` (y),
    ``+S+1``.  x0/y0 are clipped to ``S-2`` exactly as ``sample_cubemap``
    does, so the offsets never leave the face.
    """

    def __init__(self, rays: np.ndarray, face_size: int):
        s = int(face_size)
        face, u, v = _face_uv(rays)
        x = u * (s - 1)
        y = v * (s - 1)
        x0 = np.clip(np.floor(x).astype(np.int64), 0, s - 2)
        y0 = np.clip(np.floor(y).astype(np.int64), 0, s - 2)
        self.face_size = s
        self.idx00 = ((face.astype(np.int64) * s + y0) * s + x0).astype(np.int32)
        self.fx = (x - x0).astype(np.float32)
        self.fy = (y - y0).astype(np.float32)
        self._tables: dict = {}  # device -> (flat tap indices, fx, fy)

    def _weights(self, fx, fy):
        fx, fy = fx[..., None], fy[..., None]
        return ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)

    def render_np(self, faces: np.ndarray) -> np.ndarray:
        """(6, S, S, C) -> rays-shaped (..., C) float32; == sample_cubemap."""
        six, s, s2, c = faces.shape
        assert six == 6 and s == s2 == self.face_size, faces.shape
        flat = faces.reshape(6 * s * s, c).astype(np.float32)
        w00, w01, w10, w11 = self._weights(self.fx, self.fy)
        return (flat[self.idx00] * w00 + flat[self.idx00 + 1] * w01
                + flat[self.idx00 + s] * w10 + flat[self.idx00 + s + 1] * w11)

    def render_torch(self, faces: torch.Tensor, dtype=None) -> torch.Tensor:
        """(..., 6, S, S, C) uint8 faces (on any device) ->
        (..., *rays.shape[:-1], C) in ``dtype`` (fp32 by default), scaled to
        [0, 1] as ``SkyboxRenderer.render_views`` is; leading batch dims are
        kept.  The taps are gathered in the faces' own dtype (1 byte an
        element) and cast after the gather."""
        s, c = self.face_size, faces.shape[-1]
        lead = faces.shape[:-4]
        if faces.shape[-4:-1] != (6, s, s):
            raise ValueError(f"faces {tuple(faces.shape)} are not (..., 6, {s}, {s}, C)")
        dt = dtype or torch.float32
        dev = faces.device
        if dev not in self._tables:
            self._tables[dev] = tuple(torch.from_numpy(a).to(dev) for a in
                                      (self.idx00.reshape(-1).astype(np.int64),
                                       self.fx, self.fy))
        idx, fx, fy = self._tables[dev]
        flat = faces.reshape(*lead, 6 * s * s, c)
        ax = len(lead)
        out_shape = (*lead, *self.fx.shape, c)

        def tap(offset):
            return flat.index_select(ax, idx + offset).reshape(out_shape).to(dt)

        w00, w01, w10, w11 = (w.to(dt) for w in self._weights(fx, fy))
        taps = tap(0) * w00 + tap(1) * w01 + tap(s) * w10 + tap(s + 1) * w11
        return taps / 255.0


def rasterize_cubemap(color_fn, size: int) -> np.ndarray:
    """Analytic direction->color function -> (6, S, S, C) cube faces.

    The exact inverse of ``_face_uv``'s per-face mapping; used by tests to
    verify the sampler against ground truth and available to synthesize
    worlds without skybox files.
    """
    # Face basis: direction(u, v) = normalize(axis + (2u-1)*right + (2v-1)*down)
    basis = {
        "+x": ((1, 0, 0), (0, -1, 0), (0, 0, -1)),
        "-x": ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
        "+y": ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        "-y": ((0, -1, 0), (-1, 0, 0), (0, 0, -1)),
        "+z": ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        "-z": ((0, 0, -1), (1, 0, 0), (0, -1, 0)),
    }
    uv = (2.0 * (np.arange(size) + 0.5) / size - 1.0)
    out = []
    for name in FACES:
        axis, right, down = (np.asarray(b, np.float64) for b in basis[name])
        d = (axis[None, None]
             + uv[None, :, None] * right[None, None]
             + uv[:, None, None] * down[None, None])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out.append(color_fn(d))
    return np.stack(out).astype(np.float32)


@dataclass
class SkyboxRenderer:
    """Renders the 36 discretized views from Matterport skybox JPEGs.

    An ``image_provider`` for both feature extractors
    (SceneFeatureExtractor.extract_all, RegionFeatureExtractor.extract_all):
    ``renderer(scan, viewpoint) -> (36, H, W, 3) float32 in [0, 1]``.
    """

    root: str
    image_w: int = 640
    image_h: int = 480
    vfov: float = 60.0  # degrees (reference default, params --vfov)
    path_template: str = SKYBOX_PATH_TEMPLATE
    face_index: dict = field(default_factory=lambda: dict(SKYBOX_FACE_INDEX))

    def __post_init__(self):
        self._rays = view_rays(self.image_w, self.image_h, self.vfov)

    def load_faces(self, scan: str, viewpoint: str) -> np.ndarray:
        """(6, S, S, 3) uint8 cube faces in canonical order."""
        from PIL import Image

        faces = []
        for name in FACES:
            path = self.path_template.format(
                root=self.root, scan=scan, viewpoint=viewpoint,
                i=self.face_index[name])
            with Image.open(path) as im:
                faces.append(np.asarray(im.convert("RGB")))
        sizes = {f.shape for f in faces}
        assert len(sizes) == 1, f"inconsistent skybox face sizes {sizes}"
        return np.stack(faces)

    def render_views(self, faces: np.ndarray) -> np.ndarray:
        """(6, S, S, 3) -> (36, H, W, 3) float32 in [0, 1]."""
        out = sample_cubemap(faces, self._rays)
        return (out / 255.0).astype(np.float32)

    def __call__(self, scan: str, viewpoint: str) -> np.ndarray:
        return self.render_views(self.load_faces(scan, viewpoint))
