"""Question-asking classifier trainer and per-checkpoint validation
(visitron_tpu/train/classifier.py; reference
tasks/viewpoint_select/train_classifier.py).

``init_state`` starts from a fine-tuned navigation run: ``--model_name_or_path``
names the port's viewpoint output directory, whose latest checkpoint gives
the encoder and the decoder wherever a name exists on both sides; the
question head keeps its fresh init (train_classifier.py:45-47,129,
classifier/agent.py:699-711).  ``train`` runs epochs of shuffled full
batches (a numpy generator seeded with ``cfg.seed``, replayed on resume),
with CSV logging at the logging boundary, checkpoints and the preemption
guard; ``val`` logs the classification metrics (accuracy, F1, balanced
accuracy, MCC) of every checkpoint on the val splits
(train_classifier.py:179-184,352-370).

Everything runs on the trainer's device (``device=None``: the card).  In a
process group the training is data-parallel over its ranks: each rank takes
its strided shard of the instances and its per-host batch of the global
``train_batch_size(world)`` (visitron_tpu/train/classifier.py:123-125), and
runs every other rank's shuffle as a shadow, so its rows carry the encode
events of the global batch; rank 0 writes the checkpoints and logs and runs
the validation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from visitron_torch.agents.classifier import ClassifierAgent
from visitron_torch.config import RunConfig, refuse_pretrain_axes
from visitron_torch.data.classifier_dataset import build_classifier_instances
from visitron_torch.parallel.mesh import host_shard_info, replicate_state
from visitron_torch.train.checkpoint import CheckpointManager, place_like
from visitron_torch.train.finetune import per_host_batch_size, setup_trainer_mesh
from visitron_torch.train.logging import MetricsLogger
from visitron_torch.train.loop import restore_latest, run_loop
from visitron_torch.train.workspace import Workspace


@dataclass
class ClassifierTrainer:
    cfg: RunConfig
    ws: Workspace
    device: object = None  # None: the card

    def __post_init__(self):
        refuse_pretrain_axes(self.cfg)
        setup_trainer_mesh(self)
        self.agent = ClassifierAgent(
            self.ws.bert_config, self.ws.runtime,
            feature_dim=self.cfg.lstm_img_feature_dim,
            episode_len=self.cfg.episode_len, aemb=self.cfg.aemb,
            rnn_dim=self.cfg.rnn_dim,
            encoder_hidden_size=self.cfg.encoder_hidden_size,
            dropout=self.cfg.dropout, learning_rate=self.cfg.learning_rate,
            pos_weight=self.cfg.question_asking_class_weight,
            only_finetune_classifier=self.cfg.only_finetune_classifier,
            bf16_adam_moments=self.cfg.bf16_adam_moments,
            seed=self.cfg.seed, device=self.device, mesh=self.mesh)
        self.dp = self.agent.dp
        self.ckpt = CheckpointManager(self.cfg.output_dir,
                                      async_save=self.cfg.async_checkpoints)
        self.preempted = False

    def _instances(self, splits):
        return build_classifier_instances(
            self.ws.task_data_root(self.cfg.output_dir), splits, self.ws.tokenizer,
            oscar_setting=self.cfg.oscar_setting, tar_back=self.cfg.tar_back,
            max_seq_length=self.cfg.max_seq_length)

    def init_state(self) -> dict:
        """The agent's fresh state, then the encoder and the shared decoder
        weights from the latest checkpoint of the navigation run at
        ``--model_name_or_path`` (train_classifier.py:129), and the
        optimizer state rebuilt over them."""
        params = self.agent.init_params()
        nav_dir = self.cfg.model_name_or_path
        latest = None
        if nav_dir and not os.path.isdir(nav_dir):
            self.logger.warning("nav checkpoint dir %s not found; classifier starts from "
                                "scratch", nav_dir)
        elif nav_dir:
            latest = CheckpointManager(nav_dir).latest()
            if latest is None:
                self.logger.warning("no checkpoint-* under %s; starting from scratch",
                                    nav_dir)
        if latest is not None:
            nav_params = CheckpointManager(nav_dir).restore_raw(latest)
            params = dict(params)
            params["encoder"] = place_like(nav_params["encoder"], params["encoder"],
                                           "encoder")
            params = self.agent.load_nav_decoder(params, nav_params["decoder"])
            if self.mesh is not None:  # every rank starts from rank 0's weights
                params = replicate_state(self.mesh, params)
            self.logger.info("initialized from nav checkpoint-%d at %s", latest, nav_dir)
        return self.agent.init_state(params=params)

    def train(self, state=None, resume: bool = False) -> dict:
        """Epochs of shuffled full batches until ``num_iterations``, from
        ``state`` (default: :meth:`init_state`); ``resume`` restores the
        latest checkpoint and replays the shuffles to it, so the resumed run
        sees the batches an uninterrupted one would."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        start_it = 0
        if resume:
            state, start_it = restore_latest(self.ckpt, state, self.logger, self.dp)
        bs = max(per_host_batch_size(cfg, self.mesh), 1)
        host_id, num_hosts = host_shard_info(self.mesh)
        instances = self._instances(["train"])
        shards = [instances[h::num_hosts] for h in range(num_hosts)]
        self.logger.info("classifier: %d instances, per-host batch %d, %d iterations",
                         len(shards[host_id]), bs, cfg.num_iterations)
        if min(len(sh) for sh in shards) < bs:
            # The epoch loop takes full batches only: fewer instances than a
            # batch would make no progress.
            raise ValueError(f"classifier: {min(len(sh) for sh in shards)} instances in a "
                             f"host's shard < batch size {bs}; lower "
                             "--per_gpu_train_batch_size or add data")
        # Every host's shuffle stream (the others' as shadows): a rank's rows
        # carry the encode events of the global batch.
        takes = zip(*(self._takes(len(sh), bs, start_it) for sh in shards))
        batches = (self.agent.prepare_batch(
            [shards[host_id][j] for j in take[host_id]],
            event_items=None if num_hosts == 1 else
            [shards[h][j] for h in range(num_hosts) for j in take[h]]) for take in takes)
        state, self.preempted = run_loop(self, self.agent.train_step_fn(), batches, state,
                                         start_it)
        return state

    def _takes(self, n: int, bs: int, start_it: int):
        """Index lists of full batches into a shard of ``n`` instances, epoch
        after epoch, each epoch a shuffle of a numpy generator seeded with
        ``cfg.seed``; the first ``start_it`` batches are skipped (their
        shuffles replayed)."""
        order = np.arange(n)
        rng = np.random.default_rng(self.cfg.seed)
        starts = range(0, n - bs + 1, bs)
        for _ in range(start_it // len(starts)):
            rng.shuffle(order)
        skip = start_it % len(starts)
        while True:
            rng.shuffle(order)
            for start in starts[skip:]:
                yield order[start:start + bs].copy()
            skip = 0

    def _eval_batches(self, instances):
        """Prepared batches of ``per_gpu_eval_batch_size`` full batches (all
        the instances in one batch when there are fewer)."""
        bs = self.cfg.per_gpu_eval_batch_size
        out = [self.agent.prepare_batch(instances[start:start + bs])
               for start in range(0, len(instances) - bs + 1, bs)]
        if not out and instances:
            out.append(self.agent.prepare_batch(instances))
        return out

    def val(self, steps=None, splits=("val_seen", "val_unseen")) -> dict:
        """{(checkpoint step, split): classification metrics with the loss}
        for ``steps`` (default: every completed checkpoint, or the initial
        parameters when there is none); a split without data is skipped;
        writes val.csv."""
        cfg = self.cfg
        steps = steps if steps is not None else (self.ckpt.steps() or [None])
        metrics = MetricsLogger(cfg.output_dir, "val")
        out = {}
        split_batches = {}
        for split in splits:
            try:
                split_batches[split] = self._eval_batches(self._instances([split]))
            except FileNotFoundError:
                continue
        template = self.agent.init_params()
        for ckpt_step in steps:
            params = template if ckpt_step is None else self.ckpt.restore(
                ckpt_step, {"params": template})["params"]
            for split, batches in split_batches.items():
                if not batches:
                    continue
                m = self.agent.evaluate(params, batches)
                self.logger.info("ckpt %s %s: %s", ckpt_step, split, m)
                metrics.log(m, step=ckpt_step or 0, prefix=f"{split}/")
                out[(ckpt_step, split)] = m
        metrics.close()
        return out
