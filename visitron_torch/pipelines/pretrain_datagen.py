"""Generate per-path-step pretraining examples by walking episode paths
(visitron_tpu/pipelines/pretrain_datagen.py).

Parity with scripts/generate_pretraining_data.py: for every step i of each
path, record the current viewpoint, the camera's view index, and the next
viewpoint's best view index in absolute and rotated ("relative") frames — the
1-in-36 next-action label (generate_pretraining_data.py:267-318).

The candidate table makes each step O(1) closed-form (the camera pose after
``goToNextViewpoint`` is exactly the target's best view, so the walk needs no
simulator).  ``write_pretrain_data`` writes the examples of each split as
the reference's JSON files (the ``datagen`` task of run.py).
"""

from __future__ import annotations

import json
import os

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.data.candidates import ScanCandidateTable, relative_point_id
from visitron_torch.data.datasets import load_split
from visitron_torch.graph import NavGraph


def walk_path_examples(
    graph: NavGraph,
    table: ScanCandidateTable,
    path: list[str],
    start_heading: float,
    start_elevation: float = 0.0,
) -> list[dict]:
    """Per-step records for one path: [{viewpoint, current_view_index,
    target_abs_view_index, target_rel_view_index}, ...] (len(path)-1 steps)."""
    out = []
    hstep = geo.snap_heading(start_heading)
    erow = geo.snap_elevation(start_elevation)
    view = geo.view_of(hstep, erow)
    for i in range(len(path) - 1):
        u = graph.index[path[i]]
        n = graph.index[path[i + 1]]
        slots = np.flatnonzero(table.nbr[u] == n)
        if len(slots) == 0:
            raise ValueError(f"path step {path[i]}->{path[i+1]} is not a graph edge")
        slot = int(slots[0])
        abs_point = int(table.point[u, slot])
        cam_heading = geo.heading_of_view(view)
        rel_point = int(relative_point_id(np.asarray(abs_point), cam_heading))
        out.append(
            {
                "viewpoint": path[i],
                "current_view_index": view,
                "target_abs_view_index": abs_point,
                "target_rel_view_index": rel_point,
            }
        )
        # goToNextViewpoint rotates the camera onto the target's best view,
        # then moves; pose persists across the move.
        view = abs_point
    return out


def generate_pretrain_examples(
    root: str,
    splits,
    dataset_type: str,
    graphs: dict[str, NavGraph],
    tables: dict[str, ScanCandidateTable],
) -> list[dict]:
    """Full dataset walk (generate_pretraining_data.py:236-318 parity)."""
    data = []
    for item in load_split(root, splits, dataset_type):
        if dataset_type == "NDH":
            path = item["planner_path"]
            heading = item["start_pano"]["heading"]
            elevation = item["start_pano"]["elevation"]
        else:
            path = item["path"]
            heading = item["heading"]
            elevation = 0.0
        if len(path) < 2:
            continue
        scan = item["scan"]
        steps = walk_path_examples(graphs[scan], tables[scan], path, heading, elevation)
        for i, step in enumerate(steps):
            base = {
                "scan": scan,
                "viewpoint": step["viewpoint"],
                "current_view_index": step["current_view_index"],
                "target_abs_view_index": step["target_abs_view_index"],
                "target_rel_view_index": step["target_rel_view_index"],
            }
            if dataset_type == "NDH":
                base["inst_idx"] = f"ndh_{item['inst_idx']}_{i}"
                base["dialog_history"] = item["dialog_history"]
                base["target"] = item["target"]
                data.append(base)
            elif dataset_type in ("R2R", "R4R"):
                for j, instr in enumerate(item["instructions"]):
                    rec = dict(base)
                    rec["inst_idx"] = f"{dataset_type.lower()}_{item['path_id']}_{i}_{j}"
                    rec["dialog_history"] = instr
                    data.append(rec)
            elif dataset_type == "RxR":
                base["inst_idx"] = f"rxr_{item['instruction_id']}_{i}"
                base["dialog_history"] = item["instruction"]
                data.append(base)
    return data


def write_pretrain_data(root: str, splits, dataset_type: str, graphs, tables) -> str:
    """Write ``<root>/pretrain_data/<DS>_<split>.json`` (reference layout)."""
    os.makedirs(os.path.join(root, "pretrain_data"), exist_ok=True)
    for split in splits:
        data = generate_pretrain_examples(root, [split], dataset_type, graphs, tables)
        path = os.path.join(root, "pretrain_data", f"{dataset_type}_{split}.json")
        with open(path, "w") as f:
            json.dump(data, f)
    return os.path.join(root, "pretrain_data")
