"""Episode dataset loaders: NDH, R2R, R4R, RxR, CVDN gameplay.

Directory-layout and schema parity with the reference loaders
(tasks/viewpoint_select/utils_data.py:63-238) under a configurable root:

  <root>/NDH/data/{split}.json            dialog navigation episodes
  <root>/CVDN/data/{split}.json           raw gameplay (classifier task)
  <root>/R2R/data/R2R_{split}.json        instruction-following
  <root>/R4R/data/R4R_{split}.json
  <root>/RxR/data/rxr_train_guide.jsonl   multilingual guide annotations

`load_classifier_episodes` reads CVDN gameplay with its per-timestep dialog
snapshots for the question-asking classifier.

`build_nav_instances` merges any subset into one instance list with tokenized
dialog sequences and trusted-path supervision, mirroring VLNDataset
(data_loader.py:96-471) but producing packed numpy arrays.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from visitron_torch.data.dialog import MAX_TARGET_LENGTH, build_dialog_sequence

VALID_SPLITS = ("train", "val_seen", "val_unseen", "test")


def _data_path(root: str, dataset_type: str, split: str) -> str:
    if dataset_type == "NDH":
        return os.path.join(root, "NDH", "data", f"{split}.json")
    if dataset_type == "CVDN":
        return os.path.join(root, "CVDN", "data", f"{split}.json")
    if dataset_type in ("R2R", "R4R"):
        return os.path.join(root, dataset_type, "data", f"{dataset_type}_{split}.json")
    if dataset_type == "RxR":
        return os.path.join(root, "RxR", "data", "rxr_train_guide.jsonl")
    if dataset_type.startswith("Pretrain"):
        ds = dataset_type[len("Pretrain"):]
        return os.path.join(root, "pretrain_data", f"{ds}_{split}.json")
    raise NotImplementedError(dataset_type)


def load_split(root: str, splits, dataset_type: str = "NDH") -> list[dict]:
    """Load raw episode records (parity: utils_data.py:87-105)."""
    data: list[dict] = []
    if dataset_type == "RxR":
        assert list(splits) == ["train"], "RxR ships train-guide annotations only"
        path = _data_path(root, dataset_type, "train")
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    data.append(json.loads(line))
        return data
    for split in splits:
        assert split in VALID_SPLITS, split
        with open(_data_path(root, dataset_type, split)) as f:
            data += json.load(f)
    return data


def trusted_path_of(item: dict) -> list[str]:
    """Trust the player path iff it passes the planner goal after the start;
    else fall back to the planner path (data_loader.py:215-237)."""
    planner_goal = item["planner_path"][-1]
    if planner_goal in item["player_path"][1:]:
        return list(item["player_path"])
    return list(item["planner_path"])


@dataclass
class NavInstance:
    """One navigation training instance with a tokenized dialog sequence."""

    inst_idx: object
    scan: str
    token_ids: np.ndarray
    segment_ids: np.ndarray
    length: int
    start_pano: dict
    planner_path: list[str] = field(default_factory=list)
    player_path: list[str] = field(default_factory=list)
    trusted_path: list[str] = field(default_factory=list)
    end_panos: list[str] = field(default_factory=list)
    raw: dict = field(default_factory=dict)

    def path(self, path_type: str) -> list[str]:
        got = getattr(self, path_type, None)
        if got:
            return got
        return [self.start_pano["pano"]]


def _tokenize_turns(tokenizer, messages: list[str]) -> list[list[str]]:
    return [tokenizer.tokenize(m) for m in messages]


def build_nav_instances(
    root: str,
    splits,
    tokenizer,
    path_type: str = "trusted_path",
    add_ndh: bool = True,
    add_r2r: bool = False,
    add_r4r: bool = False,
    add_rxr: bool = False,
    oscar_setting: bool = False,
    tar_back: bool = False,
    truncate_dialog: bool = True,
    max_seq_length: int = 512,
) -> list[NavInstance]:
    """Merged NDH(+R2R/R4R/RxR) instance list (VLNDataset parity,
    data_loader.py:96-471)."""
    assert add_ndh or add_r2r or add_r4r or add_rxr
    instances: list[NavInstance] = []

    def _mk(inst_idx, item, dialog_turns, target_tokens, planner, player, trusted, end_panos, start_pano):
        seq = build_dialog_sequence(
            tokenizer,
            dialog_turns,
            target_tokens=target_tokens,
            oscar_setting=oscar_setting,
            tar_back=tar_back,
            max_seq_length=max_seq_length,
            truncate=truncate_dialog,
        )
        instances.append(
            NavInstance(
                inst_idx=inst_idx,
                scan=item["scan"],
                token_ids=seq.token_ids,
                segment_ids=seq.segment_ids,
                length=seq.length,
                start_pano=start_pano,
                planner_path=planner,
                player_path=player,
                trusted_path=trusted,
                end_panos=end_panos,
                raw=item,
            )
        )

    if add_ndh:
        for item in load_split(root, splits, "NDH"):
            target_tokens = tokenizer.tokenize(item["target"])[:MAX_TARGET_LENGTH]
            dialog_turns = _tokenize_turns(
                tokenizer, [t["message"] for t in item["dialog_history"]]
            )
            planner = list(item.get("planner_path", []))
            player = list(item.get("player_path", []))
            trusted = []
            if list(splits) != ["test"] and path_type == "trusted_path" and planner and player:
                trusted = trusted_path_of(item)
            _mk(
                item["inst_idx"], item, dialog_turns, target_tokens,
                planner, player, trusted, list(item.get("end_panos", [])),
                item["start_pano"],
            )

    def _add_instruction_dataset(ds: str, prefix: str):
        for item in load_split(root, splits, ds):
            for j, instr in enumerate(item["instructions"]):
                dialog_turns = [_t for _t in [tokenizer.tokenize(instr)]]
                path = list(item["path"])
                start_pano = {"heading": item["heading"], "elevation": 0, "pano": path[0]}
                _mk(
                    f"{prefix}_{item['path_id']}_{j}", item, dialog_turns, None,
                    path, path, path, [path[-1]], start_pano,
                )

    if add_r2r:
        _add_instruction_dataset("R2R", "R2R")
    if add_r4r:
        _add_instruction_dataset("R4R", "R4R")
    if add_rxr:
        for item in load_split(root, ["train"], "RxR"):
            dialog_turns = [tokenizer.tokenize(item["instruction"])]
            path = list(item["path"])
            start_pano = {"heading": item["heading"], "elevation": 0, "pano": path[0]}
            _mk(
                f"RxR_{item['instruction_id']}", item, dialog_turns, None,
                path, path, path, [path[-1]], start_pano,
            )
    return instances


def load_classifier_episodes(root: str, splits) -> list[dict]:
    """CVDN gameplay episodes with per-timestep dialog snapshots
    (parity: utils_data.py:108-166).

    Each returned item carries ``dialog_history``: {nav_timestep: [messages...]}
    accumulating turns up to that step, and ``request_locations``: the
    timesteps at which the navigator asked a question.
    """
    raw: list[dict] = []
    for split in splits:
        if split not in VALID_SPLITS:
            raise ValueError(f"unknown split {split!r}")
        with open(_data_path(root, "CVDN", split)) as f:
            raw.extend(json.load(f))

    data = []
    for item in raw:
        item = dict(item)
        item["inst_idx"] = str(item["idx"])
        item["planner_path"] = item["planner_nav_steps"]
        item["player_path"] = item["nav_steps"]
        item["nav_history"] = item["player_path"]
        heading, elevation = 2.0, 17.5
        cams = item.get("nav_camera") or []
        if cams and "message" in cams[0]:
            heading = cams[0]["message"][-1]["heading"]
            elevation = cams[0]["message"][-1]["elevation"]
        item["start_pano"] = {
            "heading": heading,
            "elevation": elevation,
            "pano": item["planner_nav_steps"][0],
        }
        dialog: dict[int, list[str]] = {0: []}
        last_timestep = 0
        timestep = 0
        for index, turn in enumerate(item["dialog_history"]):
            if index % 2 == 0:
                if turn["role"] != "navigator":
                    raise ValueError(f"episode {item['idx']}: turn {index} is not the navigator's")
                timestep = turn["nav_idx"]
                history = dialog[last_timestep]
                history = history + [turn["message"]]
                dialog[timestep] = history
                last_timestep = timestep
            else:
                if turn["role"] != "oracle":
                    raise ValueError(f"episode {item['idx']}: turn {index} is not the oracle's")
                dialog[timestep] = dialog[timestep] + [turn["message"]]
        item["dialog_history"] = dialog
        item["request_locations"] = list(dialog.keys())
        data.append(item)
    return data
