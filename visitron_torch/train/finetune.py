"""Viewpoint fine-tuning trainer and validation
(visitron_tpu/train/finetune.py: ``ViewpointTrainer``; reference train.py).

``train()`` runs the agent's train steps over the shuffled episode batches
of ``NavEpisodeBatcher``, with ``feedback_method`` choosing the step as in
the JAX trainer: ``teacher`` the teacher-forced ``train_step_fn``, ``rl``
the advantage actor-critic ``rl_train_step_fn`` (the critic in the state),
every other strategy the student-forced ``sample_train_step_fn(feedback)``
over ``with_sample_teacher`` batches.  The loop is ``train/loop.py``'s:
logging at the boundary with one read-back, checkpoints, and on SIGTERM a
checkpoint of the current iteration and a stop with ``preempted`` set.

``val()``: per checkpoint and split, (a) the teacher-forced loss with
dropout on (allow_cheat parity, train.py:318-320), (b) the argmax rollout,
written as predictions in the EvalAI format and scored by the
``Evaluator`` (train.py:326-348).  ``test_submission()`` writes the
submission of a split from the latest checkpoint.

``--aug_data`` appends the speaker-generated instances of that file
(``run augment``) to the train split.  Everything runs on the trainer's
device (``device=None``: the card), the workspace's.

In a process group (``python -m torch.distributed.run``) the trainer runs
over a (dp, tp) mesh of its ranks (``parallel.maybe_mesh(--mesh_dp,
--mesh_tp)``): each dp row draws its per-host batch of the global
``train_batch_size(world)`` from its strided shard of the instances
(``NavEpisodeBatcher(host_id, num_hosts)``), ``--mesh_tp`` splits the
encoder's BERT layers over the ranks of a row, ``--zero1`` shards the
optimizer state over dp, rank 0 writes the checkpoints (the single-device
layout), the logs and the CSV, and validation and submission run on rank 0
alone, the mesh-free evaluation path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from visitron_torch._device import resolve_device
from visitron_torch.agents import ViewpointAgent
from visitron_torch.agents.batcher import NavEpisodeBatcher
from visitron_torch.agents.speaker import build_aug_instances
from visitron_torch.config import RunConfig, refuse_pretrain_axes
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.evaluation import Evaluator
from visitron_torch.models.layers import DropoutRng
from visitron_torch.models.oscar_import import (graft_bert_into_encoder,
                                                graft_pretrain_checkpoint_into_encoder,
                                                is_pretrain_checkpoint)
from visitron_torch.parallel.mesh import (host_shard_info, is_primary, maybe_mesh,
                                          replicate_state)
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.logging import MetricsLogger, setup_logger
from visitron_torch.train.loop import restore_latest, run_loop
from visitron_torch.train.workspace import Workspace


def nav_instances(cfg: RunConfig, ws: Workspace, splits) -> list:
    """The navigation episodes of ``splits`` with the run's datasets and
    dialog settings (the viewpoint and turn-based trainers')."""
    return build_nav_instances(
        ws.task_data_root(cfg.output_dir), splits, ws.tokenizer,
        path_type=cfg.path_type, add_ndh=cfg.add_ndh_data, add_r2r=cfg.add_r2r_data,
        add_r4r=cfg.add_r4r_data, add_rxr=cfg.add_rxr_data,
        oscar_setting=cfg.oscar_setting, tar_back=cfg.tar_back,
        max_seq_length=cfg.max_seq_length)


def viewpoint_instances(cfg: RunConfig, ws: Workspace, splits, logger) -> list:
    """:func:`nav_instances`, and with ``--aug_data`` the speaker-generated
    instances of that file after a train split's (the viewpoint trainer's
    and the speaker's training data)."""
    instances = nav_instances(cfg, ws, splits)
    if cfg.aug_data and "train" in splits:
        aug = build_aug_instances(cfg.aug_data, ws.tokenizer,
                                  max_seq_length=cfg.max_seq_length,
                                  oscar_setting=cfg.oscar_setting, tar_back=cfg.tar_back)
        logger.info("aug_data: +%d speaker-generated instances", len(aug))
        instances = instances + aug
    return instances


def nav_batcher(cfg: RunConfig, ws: Workspace, instances, batch_size: int, mesh=None):
    """The run's batcher of ``instances``; under a ``mesh`` this rank's
    stream of its strided shard, ``batch_size`` being the per-host batch."""
    host_id, num_hosts = host_shard_info(mesh)
    return NavEpisodeBatcher(instances, ws.runtime, batch_size=batch_size,
                             path_type=cfg.path_type, seed=cfg.seed,
                             host_id=host_id, num_hosts=num_hosts,
                             length_sort_window=cfg.length_sort_window)


def setup_trainer_mesh(trainer) -> None:
    """``trainer.mesh`` from ``--mesh_dp`` (None without a process group),
    its device (the mesh's rank device unless one was given) and its
    logger (rank 0's writes the log file)."""
    trainer.mesh = maybe_mesh(trainer.cfg.mesh_dp, trainer.cfg.mesh_tp, trainer.device)
    if trainer.mesh is not None and trainer.device is None:
        trainer.device = trainer.mesh.device
    trainer.device = resolve_device(trainer.device)
    trainer.logger = setup_logger(output_dir=trainer.cfg.output_dir,
                                  is_main_process=is_primary(trainer.mesh))


def per_host_batch_size(cfg: RunConfig, mesh) -> int:
    """This rank's dp row's share of the global batch
    ``train_batch_size(world)``, per_gpu x every rank as the JAX package's
    is per_gpu x every device (visitron_tpu/train/finetune.py:115-116)."""
    if mesh is None:
        return cfg.train_batch_size(1)
    return cfg.train_batch_size(mesh.world) // mesh.dp


def params_to(tree, device):
    """A nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclass
class ViewpointTrainer:
    cfg: RunConfig
    ws: Workspace
    device: object = None  # None: the card

    def __post_init__(self):
        refuse_pretrain_axes(self.cfg)
        setup_trainer_mesh(self)
        self.agent = ViewpointAgent(
            self.ws.bert_config,
            self.ws.runtime,
            feature_dim=self.cfg.lstm_img_feature_dim,
            episode_len=self.cfg.episode_len,
            aemb=self.cfg.aemb,
            rnn_dim=self.cfg.rnn_dim,
            encoder_hidden_size=self.cfg.encoder_hidden_size,
            dropout=self.cfg.dropout,
            learning_rate=self.cfg.learning_rate,
            max_grad_norm=self.cfg.agent_max_grad_norm,
            bf16_adam_moments=self.cfg.bf16_adam_moments,
            seed=self.cfg.seed,
            temperature=self.cfg.temperature,
            device=self.device,
            zero1=self.cfg.zero1 and self.mesh is not None,
            mesh=self.mesh,
        )
        self.dp = self.agent.dp
        self.ckpt = CheckpointManager(self.cfg.output_dir,
                                      async_save=self.cfg.async_checkpoints)
        self.preempted = False

    def _instances(self, splits):
        return viewpoint_instances(self.cfg, self.ws, splits, self.logger)

    def _batcher(self, instances, batch_size, mesh=None):
        return nav_batcher(self.cfg, self.ws, instances, batch_size, mesh)

    def train(self, state=None, resume: bool = False, profile_steps: int = 0) -> dict:
        """Train loop.  ``state`` (default: the agent's ``init_state``, then
        ``_pretrained_params``) is where training starts; ``resume``
        restores the latest checkpoint's params and optimizer state and
        replays the batch schedule to it; ``profile_steps`` writes a
        torch.profiler trace of that many steps, from the second on, into
        <output_dir>/profile."""
        cfg = self.cfg
        batch_size = per_host_batch_size(cfg, self.mesh)
        instances = self._instances(["train"])
        self.logger.info("training on %d instances, batch %d, %d iterations",
                         len(instances), batch_size, cfg.num_iterations)
        batcher = self._batcher(instances, batch_size, self.mesh)
        rl = cfg.feedback_method == "rl"
        if state is None:
            # Pretrained weights go into the full parameters, which the
            # state then places (a tp rank keeps its blocks).
            params = self._pretrained_params(self.agent.init_params(with_critic=rl))
            state = self.agent.init_state(with_critic=rl, params=params)
        start_it = 0
        if resume:
            state, start_it = restore_latest(self.ckpt, state, self.logger, self.dp)
            batcher.skip_batches(start_it)
        student = cfg.feedback_method != "teacher"
        if rl:
            step = self.agent.rl_train_step_fn()
        elif student:
            step = self.agent.sample_train_step_fn(cfg.feedback_method)
        else:
            step = self.agent.train_step_fn()
        batches = batcher.train_batches(cfg.num_iterations - start_it,
                                        episode_len=None if student else cfg.episode_len)
        if student:
            batches = (batcher.with_sample_teacher(b) for b in batches)
        state, self.preempted = run_loop(self, step, batches, state, start_it,
                                         profile_steps=profile_steps)
        return state

    def _pretrained_params(self, params: dict) -> dict:
        """Full (single-device layout) ``params`` with the dialog encoder's
        BERT from a pretraining checkpoint of the port or from Oscar /
        HuggingFace ``pytorch_model.bin`` weights (train.py:40 +
        --no_pretrained_model parity, params.py:61-66); ``params`` itself
        where there are none."""
        cfg = self.cfg
        if cfg.no_pretrained_model or not cfg.model_name_or_path:
            return params
        if not os.path.exists(cfg.model_name_or_path):
            self.logger.warning("model_name_or_path %s not found; training from scratch",
                                cfg.model_name_or_path)
            return params
        params = dict(params)
        if is_pretrain_checkpoint(cfg.model_name_or_path):
            # The ablation chain: pretraining (run.py pretrain) -> nav
            # fine-tune, the reference's checkpoint-30000 hand-off.
            params["encoder"] = graft_pretrain_checkpoint_into_encoder(
                params["encoder"], cfg.model_name_or_path)
            self.logger.info("loaded pretraining checkpoint from %s", cfg.model_name_or_path)
        else:
            params["encoder"] = graft_bert_into_encoder(
                params["encoder"], cfg.model_name_or_path, self.ws.bert_config)
            self.logger.info("loaded Oscar/BERT weights from %s", cfg.model_name_or_path)
        if self.mesh is not None:  # every rank starts from rank 0's weights
            params = replicate_state(self.mesh, params)
        return params

    def _checkpoint_params(self, step: int) -> dict:
        """A checkpoint's params as saved (an RL checkpoint's critic
        included; rollouts read the encoder and decoder only), on the
        trainer's device."""
        return params_to(self.ckpt.restore_raw(step), self.device)

    def test_submission(self, state=None, split: str = "test") -> str:
        """Roll out ``split`` from the latest checkpoint (or ``state``) and
        write the EvalAI submission JSON (train.py:367-499 parity; cyclic-path
        avoidance on)."""
        cfg = self.cfg
        if state is None:
            latest = self.ckpt.latest()
            params = (self._checkpoint_params(latest) if latest is not None
                      else self.agent.init_params())
        else:
            params = state["params"]
        instances = self._instances([split])
        batcher = self._batcher(instances, cfg.per_gpu_eval_batch_size)
        results = self.agent.test(params, batcher.eval_batches(), feedback="argmax",
                                  submit=True)
        path = os.path.join(cfg.output_dir, f"submission_{split}.json")
        self.agent.write_results(path)
        self.logger.info("wrote %d trajectories to %s", len(results), path)
        return path

    def val(self, steps=None, splits=("val_seen", "val_unseen")) -> dict:
        """{(checkpoint step, split): Evaluator summary with the loss} for
        ``steps`` (default: every completed checkpoint, or the initial
        parameters when there is none); writes preds_{split}_{step}.json and
        val.csv."""
        cfg = self.cfg
        steps = steps if steps is not None else (self.ckpt.steps() or [None])
        metrics = MetricsLogger(cfg.output_dir, "val")
        out = {}
        # Val data is checkpoint-independent: build and tokenize once a split.
        split_assets = {}
        for split in splits:
            instances = self._instances([split])
            split_assets[split] = (instances,
                                   self._batcher(instances, cfg.per_gpu_eval_batch_size))
        eval_loss = self.agent.eval_loss_fn(use_dropout=True)
        for ckpt_step in steps:
            params = (self.agent.init_params() if ckpt_step is None
                      else self._checkpoint_params(ckpt_step))
            for split in splits:
                instances, batcher = split_assets[split]
                # Loss pass: teacher-forced with dropout (train.py:318-320),
                # its streams seeded from cfg.seed for each split.
                rng = DropoutRng(
                    masks=torch.Generator(device=self.device).manual_seed(cfg.seed),
                    seeds=torch.Generator().manual_seed(cfg.seed))
                losses = [eval_loss(params, batch, rng)
                          for batch in batcher.eval_batches(episode_len=cfg.episode_len)]
                loss = float(torch.stack(losses).mean()) if losses else 0.0
                # Argmax rollout pass.
                results = self.agent.test(params, batcher.eval_batches(), feedback="argmax",
                                          submit=cfg.submit)
                self.agent.write_results(os.path.join(
                    cfg.output_dir, f"preds_{split}_{ckpt_step}.json"))
                gt = [it.raw for it in instances if it.raw.get("end_panos")]
                evaluator = Evaluator(gt, self.ws.graphs, path_type=cfg.path_type)
                scored = {k: v for k, v in results.items() if k in evaluator.instr_ids}
                summary, _ = evaluator.score_results(scored)
                summary["loss"] = loss
                self.logger.info("ckpt %s %s: %s", ckpt_step, split, summary)
                metrics.log(summary, step=ckpt_step or 0, prefix=f"{split}/")
                out[(ckpt_step, split)] = summary
        metrics.close()
        return out
