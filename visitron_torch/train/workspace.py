"""Workspace: loads or builds the shared assets a trainer needs
(visitron_tpu/train/workspace.py).

Mirrors the setup performed by the reference mains (tasks/viewpoint_select/
train.py:502-588: features, graphs, tokenizer, model config) behind one
object, with a ``debug`` mode that fabricates a synthetic world (the
reference's --debug random-features switch, data_loader_pretrain.py:620-623,
generalized to the whole stack).  The navigation tables live on the
workspace's device (``device=None``: the card), in bf16 when
``use_bfloat16``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from visitron_torch._device import resolve_device
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.config import RunConfig
from visitron_torch.data import (SceneFeatureTable, WordPieceTokenizer,
                                 build_wordpiece_vocab, read_tsv_img_features)
from visitron_torch.graph import load_nav_graphs
from visitron_torch.models import BertConfig


# The synthetic (--debug) world's task data: the JAX package's counts, and a
# test split after them (the draws of the other splits stay the same), so
# that --test_only has a split to roll out.
SYNTHETIC_COUNTS = {"train": 12, "val_seen": 4, "val_unseen": 4, "test": 4}


@dataclass
class Workspace:
    cfg: RunConfig
    tokenizer: WordPieceTokenizer
    graphs: dict
    feat_table: SceneFeatureTable
    runtime: NavRuntime
    bert_config: BertConfig
    synthetic: object | None = None
    _task_root: str | None = field(default=None, init=False, repr=False)

    def task_data_root(self, output_dir: str) -> str:
        """Where the task JSON lives: ``cfg.data_root``, or for the
        synthetic world its task data, written once (later calls reuse it:
        each write draws new episodes) under
        ``<output_dir>/synthetic_task_data`` with SYNTHETIC_COUNTS."""
        if self.synthetic is None:
            return self.cfg.data_root
        if self._task_root is None:
            root = os.path.join(output_dir, "synthetic_task_data")
            self.synthetic.write_task_data(root, counts=SYNTHETIC_COUNTS)
            self._task_root = root
        return self._task_root

    @classmethod
    def from_config(cls, cfg: RunConfig, scans=None, device=None) -> "Workspace":
        if cfg.debug:
            return cls.synthetic_workspace(cfg, device=device)
        if scans is None:
            raise ValueError("pass the scan set (from the loaded datasets)")
        graphs = load_nav_graphs(cfg.connectivity_dir, scans)
        if cfg.img_feature_file:
            loaded = read_tsv_img_features(
                os.path.join(cfg.img_feat_dir, cfg.img_feature_file),
                feature_size=cfg.lstm_img_feature_dim, blind=cfg.blind)
            feat_table = SceneFeatureTable.pack(
                graphs, loaded["features"], image_w=loaded["image_w"],
                image_h=loaded["image_h"], vfov=loaded["vfov"])
        else:
            feat_table = SceneFeatureTable.zeros(graphs, cfg.lstm_img_feature_dim)
        tokenizer = cls._tokenizer(cfg)
        return cls(cfg=cfg, tokenizer=tokenizer, graphs=graphs, feat_table=feat_table,
                   runtime=cls._runtime(cfg, graphs, feat_table, device),
                   bert_config=cls._bert_config(cfg, tokenizer))

    @classmethod
    def synthetic_workspace(cls, cfg: RunConfig, seed: int = 7, device=None) -> "Workspace":
        from visitron_torch.testing import SyntheticWorld
        from visitron_torch.testing.synthetic import _TARGETS, _WORDS

        world = SyntheticWorld(seed=seed, num_scans=2, viewpoints_per_scan=24,
                               scene_feat_dim=cfg.lstm_img_feature_dim,
                               region_feat_dim=cfg.img_feature_dim)
        feat_table = SceneFeatureTable.pack(world.graphs, world.scene_features(), vfov=60)
        tokenizer = WordPieceTokenizer(build_wordpiece_vocab(
            [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=4096))
        return cls(cfg=cfg, tokenizer=tokenizer, graphs=world.graphs, feat_table=feat_table,
                   runtime=cls._runtime(cfg, world.graphs, feat_table, device),
                   bert_config=cls._bert_config(cfg, tokenizer), synthetic=world)

    @staticmethod
    def _runtime(cfg: RunConfig, graphs, feat_table, device) -> NavRuntime:
        return NavRuntime.build(
            graphs, feat_table,
            device_dtype=torch.bfloat16 if cfg.use_bfloat16 else torch.float32,
            device=resolve_device(device))

    @staticmethod
    def _tokenizer(cfg: RunConfig) -> WordPieceTokenizer:
        if cfg.vocab_file and os.path.exists(cfg.vocab_file):
            tok = WordPieceTokenizer.from_vocab_file(cfg.vocab_file)
        elif cfg.model_name_or_path and os.path.exists(
                os.path.join(cfg.model_name_or_path, "vocab.txt")):
            tok = WordPieceTokenizer.from_vocab_file(
                os.path.join(cfg.model_name_or_path, "vocab.txt"))
        else:
            raise FileNotFoundError(
                "no vocab available: set --vocab_file or --model_name_or_path")
        # +3 task special tokens (model_utils.py:29-33,101-103).
        tok.add_special_tokens()
        return tok

    @staticmethod
    def _bert_config(cfg: RunConfig, tokenizer) -> BertConfig:
        return BertConfig(
            vocab_size=len(tokenizer),
            max_position_embeddings=max(cfg.max_seq_length, 512),
            type_vocab_size=4,  # model_utils.py:104-106
            hidden_dropout_prob=cfg.drop_out,
            attention_probs_dropout_prob=cfg.drop_out,
            img_feature_dim=cfg.img_feature_dim,
            action_space=cfg.action_space,
            detector_classes=cfg.detector_classes,
            dtype=torch.bfloat16 if cfg.use_bfloat16 else torch.float32,
            use_flash_attention=cfg.use_flash_attention,
            use_fused_attention=cfg.use_fused_attention,
            use_fused_mlm_ce=cfg.use_fused_mlm_ce,
            use_fused_layernorm=cfg.use_fused_layernorm,
            remat=cfg.remat,
        )
