"""Discretized panorama geometry shared by the simulator, data layer and models.

The Matterport panorama is discretized into 36 views: 12 headings x 3
elevation rows (bottom/middle/top = -30/0/+30 degrees).  ``view_index`` is
``12 * elevation_row + heading_step`` (reference sweep:
tasks/viewpoint_select/utils.py:288-314, data_loader.py:524-535).

Everything here is pure math (numpy), no simulator required: the reference
drives a probe MatterSim instance just to enumerate these angles; we compute
them in closed form.
"""

from __future__ import annotations

import numpy as np

NUM_VIEWS = 36
HEADINGS_PER_ROW = 12
NUM_ELEVATIONS = 3
ANGLE_INC = np.pi / 6.0  # 30 degrees
ANGLE_FEAT_SIZE = 4


def heading_of_view(view_index: int) -> float:
    """Absolute camera heading (radians) of a discretized view."""
    return (view_index % HEADINGS_PER_ROW) * ANGLE_INC


def elevation_of_view(view_index: int) -> float:
    """Absolute camera elevation (radians) of a discretized view."""
    return (view_index // HEADINGS_PER_ROW - 1) * ANGLE_INC


def view_of(heading_step: int, elevation_row: int) -> int:
    return elevation_row * HEADINGS_PER_ROW + heading_step


def snap_heading(heading: float) -> int:
    """Nearest discretized heading step for an arbitrary heading (radians)."""
    step = int(round(heading / ANGLE_INC)) % HEADINGS_PER_ROW
    return step


def snap_elevation(elevation: float) -> int:
    """Nearest elevation row (0, 1, 2) for an arbitrary elevation (radians)."""
    row = int(round(elevation / ANGLE_INC)) + 1
    return int(np.clip(row, 0, NUM_ELEVATIONS - 1))


def normalize_angle(a: np.ndarray | float):
    """Wrap angle(s) into (-pi, pi]."""
    return -((-np.asarray(a) + np.pi) % (2.0 * np.pi) - np.pi)


def angle_feature(heading, elevation) -> np.ndarray:
    """4-d angle feature [sin h, cos h, sin e, cos e].

    Parity: tasks/viewpoint_select/utils.py:271-285.  Broadcasts: scalar in ->
    (4,); array in -> (..., 4).
    """
    heading = np.asarray(heading, dtype=np.float32)
    elevation = np.asarray(elevation, dtype=np.float32)
    return np.stack(
        [np.sin(heading), np.cos(heading), np.sin(elevation), np.cos(elevation)],
        axis=-1,
    ).astype(np.float32)


def point_angle_feature(base_view_id: int = 0) -> np.ndarray:
    """(36, 4) angle features of all views relative to ``base_view_id``'s heading.

    Parity: tasks/viewpoint_select/utils.py:288-314 (computed there by driving
    a probe simulator through all 36 views; identical closed form here).
    """
    base_heading = (base_view_id % HEADINGS_PER_ROW) * ANGLE_INC
    ix = np.arange(NUM_VIEWS)
    headings = (ix % HEADINGS_PER_ROW) * ANGLE_INC - base_heading
    elevations = (ix // HEADINGS_PER_ROW - 1) * ANGLE_INC
    return angle_feature(headings, elevations)


def all_point_angle_feature() -> np.ndarray:
    """(36, 36, 4): angle table for every possible base view.

    Parity: utils.py:317-318 (list of 36 tables); ours is one stacked array so
    it can live on device and be gathered by base-view index.
    """
    return np.stack([point_angle_feature(b) for b in range(NUM_VIEWS)], axis=0)


def viewpoint_loc_embedding(view_index: int) -> np.ndarray:
    """(36, 128) sinusoidal relative-view location embedding.

    heading 64-d (32 sin + 32 cos) + elevation 64-d, all views relative to
    ``view_index``.  Parity: tasks/viewpoint_select/data_loader_pretrain.py:25-43.
    """
    emb = np.zeros((NUM_VIEWS, 128), np.float32)
    abs_idx = np.arange(NUM_VIEWS)
    rel_idx = (abs_idx - view_index) % HEADINGS_PER_ROW + (abs_idx // HEADINGS_PER_ROW) * HEADINGS_PER_ROW
    rel_heading = (rel_idx % HEADINGS_PER_ROW) * ANGLE_INC
    rel_elevation = (rel_idx // HEADINGS_PER_ROW - 1) * ANGLE_INC
    emb[:, 0:32] = np.sin(rel_heading)[:, None]
    emb[:, 32:64] = np.cos(rel_heading)[:, None]
    emb[:, 64:96] = np.sin(rel_elevation)[:, None]
    emb[:, 96:128] = np.cos(rel_elevation)[:, None]
    return emb


def all_viewpoint_loc_embeddings() -> np.ndarray:
    """(36, 36, 128) stacked location embeddings for every base view."""
    return np.stack([viewpoint_loc_embedding(v) for v in range(NUM_VIEWS)], axis=0)


def camera_hfov(width: int, height: int, vfov_rad: float) -> float:
    """Horizontal FOV from the vertical FOV and aspect ratio (pinhole model)."""
    return 2.0 * np.arctan(np.tan(vfov_rad / 2.0) * width / height)


def heading_elevation_to(src_pos: np.ndarray, dst_pos: np.ndarray) -> tuple[float, float]:
    """Absolute (heading, elevation) of dst as seen from src.

    Matterport convention: heading measured clockwise from the +Y axis
    (tasks/turn_based/data_loader.py:535-539 uses pi/2 - atan2(dy, dx)).
    """
    d = np.asarray(dst_pos, dtype=np.float64) - np.asarray(src_pos, dtype=np.float64)
    heading = np.pi / 2.0 - np.arctan2(d[1], d[0])
    heading = float(heading % (2.0 * np.pi))
    horiz = float(np.sqrt(d[0] ** 2 + d[1] ** 2))
    elevation = float(np.arctan2(d[2], horiz))
    return heading, elevation
