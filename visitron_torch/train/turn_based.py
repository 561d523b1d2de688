"""Turn-based (low-level action space) trainer and validation
(visitron_tpu/train/turn_based.py; reference tasks/turn_based/train.py).

Shuffled teacher-forced training of the 6-action agent
(``NavEpisodeBatcher.with_turn_teacher`` batches) through ``train/loop.py``'s
loop (CSV logging with one read-back at the logging boundary, checkpoints
every ``saving_steps`` and at the end, the preemption guard), with resume
(the batch schedule replayed to the checkpoint).  ``val()`` scores each checkpoint on val_seen and
val_unseen: the teacher-forced loss with dropout on, then the argmax
rollout, written to preds_turn_{split}_{step}.json and scored with the NDH
metrics (turn_based/train.py val(); eval.py parity).  The JAX trainer loads
no pretrained BERT; neither does this one.

Everything runs on the trainer's device (``device=None``: the card); in a
process group the training is data-parallel over its ranks, as the
viewpoint trainer's (train/finetune.py), without ``--zero1``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from visitron_torch.agents.turn_based import TurnBasedAgent
from visitron_torch.config import RunConfig, refuse_pretrain_axes
from visitron_torch.evaluation import Evaluator
from visitron_torch.models.layers import DropoutRng
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.finetune import (nav_batcher, nav_instances, per_host_batch_size,
                                           setup_trainer_mesh)
from visitron_torch.train.logging import MetricsLogger
from visitron_torch.train.loop import restore_latest, run_loop
from visitron_torch.train.workspace import Workspace


@dataclass
class TurnBasedTrainer:
    cfg: RunConfig
    ws: Workspace
    device: object = None  # None: the card

    def __post_init__(self):
        refuse_pretrain_axes(self.cfg)
        setup_trainer_mesh(self)
        self.agent = TurnBasedAgent(
            self.ws.bert_config, self.ws.runtime,
            feature_dim=self.cfg.lstm_img_feature_dim,
            episode_len=self.cfg.episode_len, aemb=self.cfg.aemb,
            rnn_dim=self.cfg.rnn_dim,
            encoder_hidden_size=self.cfg.encoder_hidden_size,
            dropout=self.cfg.dropout, learning_rate=self.cfg.learning_rate,
            bf16_adam_moments=self.cfg.bf16_adam_moments,
            seed=self.cfg.seed, device=self.device, mesh=self.mesh)
        self.dp = self.agent.dp
        self.ckpt = CheckpointManager(self.cfg.output_dir,
                                      async_save=self.cfg.async_checkpoints)
        self.preempted = False

    def _instances(self, splits):
        return nav_instances(self.cfg, self.ws, splits)

    def _batcher(self, instances, batch_size, mesh=None):
        return nav_batcher(self.cfg, self.ws, instances, batch_size, mesh)

    def train(self, state=None, resume: bool = False) -> dict:
        """Train loop from ``state`` (default: the agent's ``init_state``);
        ``resume`` restores the latest checkpoint's params and optimizer
        state and replays the batch schedule to it."""
        cfg = self.cfg
        batch_size = per_host_batch_size(cfg, self.mesh)
        instances = self._instances(["train"])
        self.logger.info("turn-based: %d instances, batch %d, %d iterations",
                         len(instances), batch_size, cfg.num_iterations)
        batcher = self._batcher(instances, batch_size, self.mesh)
        if state is None:
            state = self.agent.init_state()
        start_it = 0
        if resume:
            state, start_it = restore_latest(self.ckpt, state, self.logger, self.dp)
            batcher.skip_batches(start_it)
        batches = (batcher.with_turn_teacher(b, cfg.episode_len)
                   for b in batcher.train_batches(cfg.num_iterations - start_it))
        state, self.preempted = run_loop(self, self.agent.train_step_fn(), batches, state,
                                         start_it)
        return state

    def val(self, steps=None, splits=("val_seen", "val_unseen")) -> dict:
        """{(checkpoint step, split): NDH metrics with the loss} for
        ``steps`` (default: every completed checkpoint, or the initial
        parameters when there is none); writes preds_turn_{split}_{step}.json
        and val.csv."""
        cfg = self.cfg
        steps = steps if steps is not None else (self.ckpt.steps() or [None])
        metrics = MetricsLogger(cfg.output_dir, "val")
        out = {}
        split_assets = {}
        for split in splits:
            instances = self._instances([split])
            split_assets[split] = (instances,
                                   self._batcher(instances, cfg.per_gpu_eval_batch_size))
        template = self.agent.init_params()
        eval_loss = self.agent.eval_loss_fn(use_dropout=True)
        for ckpt_step in steps:
            params = template if ckpt_step is None else self.ckpt.restore(
                ckpt_step, {"params": template})["params"]
            for split in splits:
                instances, batcher = split_assets[split]
                rng = DropoutRng(
                    masks=torch.Generator(device=self.device).manual_seed(cfg.seed),
                    seeds=torch.Generator().manual_seed(cfg.seed))
                losses = [eval_loss(params, batcher.with_turn_teacher(b, cfg.episode_len), rng)
                          for b in batcher.eval_batches()]
                results = self.agent.test(params, batcher.eval_batches(), feedback="argmax")
                self.agent.write_results(os.path.join(
                    cfg.output_dir, f"preds_turn_{split}_{ckpt_step}.json"))
                gt = [it.raw for it in instances if it.raw.get("end_panos")]
                evaluator = Evaluator(gt, self.ws.graphs, path_type=cfg.path_type)
                scored = {k: v for k, v in results.items() if k in evaluator.instr_ids}
                summary, _ = evaluator.score_results(scored)
                summary["loss"] = float(torch.stack(losses).mean()) if losses else 0.0
                self.logger.info("ckpt %s %s: %s", ckpt_step, split, summary)
                metrics.log(summary, step=ckpt_step or 0, prefix=f"{split}/")
                out[(ckpt_step, split)] = summary
        metrics.close()
        return out

