"""Viewpoint fine-tuning trainer and validation
(visitron_tpu/train/finetune.py: ``ViewpointTrainer``; reference train.py).

``train()`` runs the agent's train steps over the shuffled episode batches
of ``NavEpisodeBatcher``, with ``feedback_method`` choosing the step as in
the JAX trainer: ``teacher`` the teacher-forced ``train_step_fn``, ``rl``
the advantage actor-critic ``rl_train_step_fn`` (the critic in the state),
every other strategy the student-forced ``sample_train_step_fn(feedback)``
over ``with_sample_teacher`` batches.  Losses stay on the device until the
logging boundary, where one stacked read-back averages them and
``check_finite`` guards against divergence; checkpoints are written every
``saving_steps`` and at the last iteration, and on SIGTERM the trainer
saves the current iteration and stops with ``preempted`` set.

``val()``: per checkpoint and split, (a) the teacher-forced loss with
dropout on (allow_cheat parity, train.py:318-320), (b) the argmax rollout,
written as predictions in the EvalAI format and scored by the
``Evaluator`` (train.py:326-348).  ``test_submission()`` writes the
submission of a split from the latest checkpoint.

Everything runs on the trainer's device (``device=None``: the card), the
workspace's.  Device meshes, ZeRO-1 and ``--aug_data`` are not ported
(ROADMAP items 10 and 7) and raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from visitron_torch._device import resolve_device
from visitron_torch.agents import ViewpointAgent
from visitron_torch.agents.batcher import NavEpisodeBatcher
from visitron_torch.config import RunConfig, refuse_unported_hardware
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.evaluation import Evaluator
from visitron_torch.models.layers import DropoutRng
from visitron_torch.models.oscar_import import (graft_pretrain_checkpoint_into_encoder,
                                                is_pretrain_checkpoint)
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.logging import MetricsLogger, check_finite, setup_logger
from visitron_torch.train.preemption import PreemptionGuard
from visitron_torch.train.workspace import Workspace

# The synthetic (--debug) world's task data: the JAX package's counts, and a
# test split after them (the draws of the other splits stay the same), so
# that --test_only has a split to roll out.
SYNTHETIC_COUNTS = {"train": 12, "val_seen": 4, "val_unseen": 4, "test": 4}


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
        refuse_unported_hardware(self.cfg)
        self.device = resolve_device(self.device)
        self.logger = setup_logger(output_dir=self.cfg.output_dir)
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
        )
        self.ckpt = CheckpointManager(self.cfg.output_dir,
                                      async_save=self.cfg.async_checkpoints)
        self.preempted = False
        self._synth_root = None

    def _instances(self, splits):
        if self.cfg.aug_data and "train" in splits:
            raise NotImplementedError(
                "--aug_data: speaker augmentation is not ported yet (ROADMAP item 7)")
        if self.ws.synthetic is not None:
            if self._synth_root is None:
                root = os.path.join(self.cfg.output_dir, "synthetic_task_data")
                self.ws.synthetic.write_task_data(root, counts=SYNTHETIC_COUNTS)
                self._synth_root = root
            root = self._synth_root
        else:
            root = self.cfg.data_root
        return build_nav_instances(
            root, splits, self.ws.tokenizer,
            path_type=self.cfg.path_type,
            add_ndh=self.cfg.add_ndh_data, add_r2r=self.cfg.add_r2r_data,
            add_r4r=self.cfg.add_r4r_data, add_rxr=self.cfg.add_rxr_data,
            oscar_setting=self.cfg.oscar_setting, tar_back=self.cfg.tar_back,
            max_seq_length=self.cfg.max_seq_length)

    def _batcher(self, instances, batch_size):
        return NavEpisodeBatcher(
            instances, self.ws.runtime, batch_size=batch_size,
            path_type=self.cfg.path_type, seed=self.cfg.seed,
            length_sort_window=self.cfg.length_sort_window)

    def train(self, state=None, resume: bool = False, profile_steps: int = 0) -> dict:
        """Train loop.  ``state`` (default: the agent's ``init_state``, then
        ``_maybe_load_pretrained``) is where training starts; ``resume``
        restores the latest checkpoint's params and optimizer state and
        replays the batch schedule to it; ``profile_steps`` writes a
        torch.profiler trace of that many steps, from the second on, into
        <output_dir>/profile."""
        cfg = self.cfg
        batch_size = cfg.train_batch_size(1)
        instances = self._instances(["train"])
        self.logger.info("training on %d instances, batch %d, %d iterations",
                         len(instances), batch_size, cfg.num_iterations)
        batcher = self._batcher(instances, batch_size)
        rl = cfg.feedback_method == "rl"
        if state is None:
            state = self.agent.init_state(with_critic=rl)
            state = self._maybe_load_pretrained(state)
        start_it = 0
        if resume and self.ckpt.latest() is not None:
            start_it = self.ckpt.latest()
            restored = self.ckpt.restore(
                start_it, {"params": state["params"], "opt_state": state["opt_state"]})
            state = {**state, **restored}
            batcher.skip_batches(start_it)
            self.logger.info("resumed from checkpoint-%d", start_it)
        student = cfg.feedback_method != "teacher"
        if rl:
            step = self.agent.rl_train_step_fn()
        elif student:
            step = self.agent.sample_train_step_fn(cfg.feedback_method)
        else:
            step = self.agent.train_step_fn()
        metrics = MetricsLogger(cfg.output_dir, "train")
        losses, aux = [], None
        episode_len = None if student else cfg.episode_len
        profiler = None
        with PreemptionGuard() as guard:
            for i, batch in enumerate(batcher.train_batches(cfg.num_iterations - start_it,
                                                            episode_len=episode_len)):
                if student:
                    batch = batcher.with_sample_teacher(batch)
                it = start_it + i + 1
                if profile_steps and i == 1:  # the first step warms up
                    profiler = self._start_profiler()
                state, out = step(state, batch)
                loss, aux = out if isinstance(out, tuple) else (out, None)
                if profiler is not None and i == profile_steps:
                    self._stop_profiler(profiler)
                    profiler = None
                # The loss stays on the device until the logging boundary: a
                # read-back per step would stall the host on the device.
                losses.append(loss)
                if it % cfg.logging_steps == 0:
                    self._log(metrics, it, losses, aux)
                    losses.clear()
                saved = it % cfg.saving_steps == 0 or it == cfg.num_iterations
                if saved:
                    self.ckpt.save(it, state["params"], state["opt_state"])
                if guard.should_stop(it):
                    if not saved:
                        self.ckpt.save(it, state["params"], state["opt_state"], wait=True)
                    self.logger.info("termination signal: saved checkpoint-%d, stopping "
                                     "(restart with --resume)", it)
                    break
        if profiler is not None:
            self._stop_profiler(profiler)
        self.ckpt.wait_until_finished()
        metrics.close()
        # A SIGTERM grace window cannot afford the val sweep: run.py checks
        # this flag and returns right after the preemption checkpoint.
        self.preempted = guard.stop
        return state

    def _log(self, metrics: MetricsLogger, it: int, losses: list, aux: dict | None) -> None:
        """One read-back of the mean loss since the last boundary and the
        last step's aux values; checked, logged and written to train.csv."""
        names = sorted(aux or {})
        vals = torch.stack([torch.stack(losses).mean()]
                           + [aux[k].float() for k in names]).tolist()
        avg = check_finite(vals[0], it, self.logger)
        extra = dict(zip(names, vals[1:]))
        self.logger.info("iter %d loss %.4f %s", it, avg, extra or "")
        metrics.log({"loss": avg, **extra}, step=it)

    def _start_profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        profiler.stop()
        out = os.path.join(self.cfg.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, "trace.json"))

    def _maybe_load_pretrained(self, state: dict) -> dict:
        """Initialise the dialog encoder's BERT from a pretraining checkpoint
        (train.py:40 + --no_pretrained_model parity, params.py:61-66)."""
        cfg = self.cfg
        if cfg.no_pretrained_model or not cfg.model_name_or_path:
            return state
        if not os.path.exists(cfg.model_name_or_path):
            self.logger.warning("model_name_or_path %s not found; training from scratch",
                                cfg.model_name_or_path)
            return state
        if not is_pretrain_checkpoint(cfg.model_name_or_path):
            raise NotImplementedError(
                f"{cfg.model_name_or_path} is not a visitron_torch pretraining checkpoint; "
                "the import of Oscar / HuggingFace weights is not ported yet "
                "(ROADMAP item 4)")
        # The ablation chain: pretraining (run.py pretrain) -> nav fine-tune,
        # the reference's checkpoint-30000 hand-off.
        params = dict(state["params"])
        params["encoder"] = graft_pretrain_checkpoint_into_encoder(
            params["encoder"], cfg.model_name_or_path)
        self.logger.info("loaded pretraining checkpoint from %s", cfg.model_name_or_path)
        return {**state, "params": params}

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
