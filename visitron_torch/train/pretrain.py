"""Multimodal pretraining trainer on one device
(visitron_tpu/train/pretrain.py:PretrainTrainer).

One step: the host batch goes to the device, ``PretrainModel`` runs with
every training dropout active, ``pretrain_loss`` sums the MLM (through the
fused CE kernel K3), next-action and region-token losses, autograd takes the
gradients (the attention backward K4b or K1b, the LayerNorm backward K2b and
the CE backward K3b run there), and AdamW with the warmup schedule and a
global-norm clip of 1.0 updates the parameters.

``params`` is a flat ``{state-dict name: tensor}`` dict, applied to the model
with ``torch.func.functional_call``; :meth:`PretrainTrainer.init_state`
draws it from a seed, or ``visitron_torch.convert.convert_pretrain_params``
carries the JAX package's across.

Under a ``mesh`` (``parallel.make_mesh``, ``make_sp_mesh``,
``make_cp_mesh``) each rank feeds the rows of its dp index of the global
batch: the loss divides by the counts of the global batch (one all-reduce
of the three label counts), the gradients and the logged bundle are summed
over the ranks that shard the data in flat buckets, the attention kernels'
dropout seed is folded by the mesh coordinates and the hidden-dropout
generator seeded per dp index (and per token block under sp and cp).  The
config goes through ``config_for_mesh``: under tp each rank holds its
blocks of the four split kernels of every layer (the model's
``ParallelDense``), under sp and cp its block of the joint sequence, whose
labels it takes (the MLM and token losses on its tokens; the next-action
loss on the rank that holds [CLS]).  ``zero1`` shards the optimizer state,
``fsdp`` the parameters, gradients and optimizer state over dp
(``parallel.DataParallel``).  Initial parameters, checkpoints and
evaluation use the single-device layout and model (``eval_model``).

:func:`pretrain_loop` is ``run pretrain``'s epoch loop
(visitron_tpu/run.py:97-323) through ``train/loop.py``: the examples of
``generate_pretrain_examples``, AdamW with warmup over ``num_epochs x
steps_per_epoch``, resume (params, optimizer state, the epoch-keyed shuffle
and the completed batches of the epoch in progress; the dynamic-masking
stream restarts from the seed, as in the JAX package), a checkpoint each
epoch and on SIGTERM, and the per-dataset ``val_seen`` / ``val_unseen``
sweeps (rank 0's, on the gathered parameters); each rank takes its strided
share of every epoch (``epoch_batches(host_id, num_hosts)``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from visitron_torch._device import resolve_device
from visitron_torch.data.features import RegionFeatureStore
from visitron_torch.data.pretrain_dataset import PretrainDataset
from visitron_torch.models.bert import BertConfig, config_for_mesh
from visitron_torch.models.layers import DropoutRng, init_module_params
from visitron_torch.models.pretrain import PretrainModel, pretrain_loss
from visitron_torch.parallel.mesh import (DataParallel, host_shard_info, is_primary,
                                          jax_axis_orders, make_cp_mesh, make_pp_mesh,
                                          make_sp_mesh, maybe_mesh, shard_params_rules,
                                          token_range)
from visitron_torch.pipelines.pretrain_datagen import generate_pretrain_examples
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_torch.train.logging import MetricsLogger, check_finite, setup_logger
from visitron_torch.train.loop import EpochEnd, restore_latest, run_loop
from visitron_torch.train.optim import (adamw_with_warmup, apply_updates, tree_leaves,
                                        tree_unflatten)
from visitron_torch.utils import tracing

BATCH_KEYS = ("input_ids", "token_type_ids", "attention_mask", "labels", "token_labels",
              "img_feats", "img_location_embeddings", "next_action")


def batch_to_device(host_batch: dict, device) -> dict:
    """A host batch of numpy arrays as device tensors: integers as int64,
    floats as fp32.  Counts its calls and the bytes each copy carries to the
    device, the converted tensors' (``batch_to_device.calls``, ``.bytes``):
    a blocking copy converts the dtype on the host, before the transfer."""
    out = {}
    with tracing.span(tracing.BATCH_TO_DEVICE):
        for key in BATCH_KEYS:
            a = np.asarray(host_batch[key])
            dtype = torch.float32 if a.dtype.kind == "f" else torch.int64
            out[key] = torch.as_tensor(a).to(device=device, dtype=dtype)
            batch_to_device.bytes += out[key].nbytes
    batch_to_device.calls += 1
    return out


batch_to_device.bytes = 0
batch_to_device.calls = 0


@dataclass
class PretrainTrainer:
    cfg: BertConfig
    learning_rate: float = 5e-5
    warmup_steps: int = 0
    total_steps: int = 20000
    schedule: str = "linear"
    weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    bf16_adam_moments: bool = False
    zero1: bool = False
    fsdp: bool = False
    mesh: Any = None
    seed: int = 42
    device: Any = None  # None: the card
    model: PretrainModel = field(init=False)

    def __post_init__(self):
        if self.mesh is not None and self.device is None:
            self.device = self.mesh.device
        self.device = resolve_device(self.device)
        # zero1 / fsdp shard over a mesh's ranks; without one they change
        # nothing (the JAX trainer's one-device mesh shards nothing either).
        self.dp = (None if self.mesh is None else
                   DataParallel(self.mesh, zero1=self.zero1, fsdp=self.fsdp))
        self.cfg = config_for_mesh(self.cfg, self.mesh)
        self.model = PretrainModel(self.cfg).to(self.device)
        # The single-device model: initial parameters and evaluation.  Its
        # own parameters are never read (functional_call), so it holds none.
        plain = self.cfg.without_mesh()
        if plain == self.cfg:
            self.eval_model = self.model
        else:
            with torch.device("meta"):
                self.eval_model = PretrainModel(plain)
        self.optimizer = adamw_with_warmup(
            self.learning_rate, self.warmup_steps, self.total_steps, self.schedule,
            self.weight_decay, self.adam_epsilon, self.max_grad_norm,
            bf16_moments=self.bf16_adam_moments,
            norm=None if self.dp is None else self.dp.global_norm)

    # -- initialization ------------------------------------------------------
    def init_params(self, seed: int | None = None) -> dict:
        """Fresh parameters from a CPU generator (the same weights on every
        device for a seed): normal(0.02) for BERT's Denses and embeddings,
        ones / zeros for the LayerNorms, zero biases."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        return init_module_params(self.eval_model, g, self.device)

    def init_state(self, params: dict | None = None) -> dict:
        """Training state: ``params`` (default :meth:`init_params` at the
        trainer's seed; full tensors, the same on every rank), ``opt_state``
        and ``rng``, the dropout generators (masks on the device, kernel
        seeds on the CPU, seeded with seed + 1; under a mesh the masks'
        seed is folded by the dp index, and by the token block under sp
        and cp, the kernel seeds by the mesh coordinates,
        ``Mesh.kernel_seed``).  The shapes come from the config (the JAX
        trainer traces its model on a sample batch instead).  Under tp the state
        holds this rank's blocks of the split kernels, under ``zero1`` /
        ``fsdp`` its dp shards."""
        if params is None:
            params = self.init_params()
        fold = 0 if self.mesh is None else self.mesh.fold_seed(0)
        rng = DropoutRng(
            masks=torch.Generator(device=self.device).manual_seed(self.seed + 1 + fold),
            seeds=torch.Generator().manual_seed(self.seed + 1),
            seed_offset=0 if self.mesh is None else self.mesh.kernel_seed(0))
        if self.dp is None:
            return {"params": params, "opt_state": self.optimizer.init(params), "rng": rng}
        self.dp.plan(params, jax_axis_orders(self.eval_model),
                     shard_params_rules(self.model))
        params, opt_state = self.dp.place(params, self.optimizer)
        return {"params": params, "opt_state": opt_state, "rng": rng}

    # -- the step ---------------------------------------------------------------
    def to_device(self, host_batch: dict) -> dict:
        return batch_to_device(host_batch, self.device)

    def rank_labels(self, batch: dict) -> tuple:
        """(labels, token_labels, whether this rank counts the next-action
        labels) of a device batch: the columns of this rank's tokens of the
        joint sequence under an sp or cp mesh (the next-action rows are
        counted by the rank that holds [CLS]), the first S columns
        otherwise."""
        s = batch["input_ids"].shape[1] + batch["img_feats"].shape[1]
        mesh = self.cfg.token_mesh
        lo, hi = token_range(mesh, s)
        first = mesh is None or mesh.axis_index == 0
        return batch["labels"][:, :s][:, lo:hi], batch["token_labels"][:, :s][:, lo:hi], first

    def global_counts(self, batch: dict) -> dict:
        """The label counts of the global batch that the losses divide by:
        this rank's, summed over the ranks that shard the data in one
        all-reduce."""
        labels, token_labels, first = self.rank_labels(batch)
        nxt = torch.sum(batch["next_action"] != -1)
        local = torch.stack([torch.sum(labels != -1), nxt if first else torch.zeros_like(nxt),
                             torch.sum(token_labels != -1)])
        return dict(zip(("mlm", "next", "token"), self.dp.global_count(local)))

    def loss_bundle(self, params, batch: dict, rng: DropoutRng | None,
                    counts: dict | None = None, model=None) -> dict:
        """``pretrain_loss`` of a device batch; ``rng`` None is
        deterministic; ``counts``: the global label counts (None: the
        batch's own); ``model``: the module to apply (default the
        training model)."""
        model = self.model if model is None else model
        out = functional_call(
            model, params, (batch["input_ids"],),
            {"token_type_ids": batch["token_type_ids"],
             "attention_mask": batch["attention_mask"],
             "img_feats": batch["img_feats"],
             "img_location_embeddings": batch["img_location_embeddings"],
             "rng": rng}, strict=True)
        labels, token_labels = batch["labels"], batch["token_labels"]
        if model is self.model:
            labels, token_labels, _ = self.rank_labels(batch)
        return pretrain_loss(out, labels, batch["next_action"], token_labels,
                             cfg=self.cfg, counts=counts)

    def loss_and_grads(self, params, batch: dict, rng: DropoutRng | None,
                       counts: dict | None = None):
        """(bundle, grads) for a device batch; grads mirror ``params`` (zeros
        where a parameter takes no part, as in JAX)."""
        with tracing.span(tracing.FORWARD):
            leaves = tree_leaves(params)
            live = [p.detach().requires_grad_() for p in leaves]
            bundle = self.loss_bundle(tree_unflatten(params, live), batch, rng, counts)
        with tracing.span(tracing.BACKWARD):
            grads = torch.autograd.grad(bundle["loss"], live, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in bundle.items()}, tree_unflatten(params, grads)

    def raw_step_fn(self):
        """``step(state, device batch) -> (state, bundle)``: one training step
        with the dropouts active, the clip and AdamW."""

        def step(state, batch):
            if self.dp is None:
                bundle, grads = self.loss_and_grads(state["params"], batch, state["rng"])
                with tracing.span(tracing.OPTIMIZER):
                    updates, opt_state = self.optimizer.update(grads, state["opt_state"],
                                                               state["params"])
                    params = apply_updates(state["params"], updates)
                return {"params": params, "opt_state": opt_state,
                        "rng": state["rng"]}, bundle
            dp = self.dp
            bundle, grads = self.loss_and_grads(dp.full_params(state["params"]), batch,
                                                state["rng"], self.global_counts(batch))
            with tracing.span(tracing.GRAD_REDUCE):
                grads, bundle = dp.reduce(grads, bundle)
            with tracing.span(tracing.OPTIMIZER):
                params, opt_state = dp.update(self.optimizer, grads, state["opt_state"],
                                              state["params"], apply_updates)
            return {"params": params, "opt_state": opt_state, "rng": state["rng"]}, bundle

        return step

    def step_fn(self):
        """``run(state, host batch) -> (state, bundle)``."""
        step = self.raw_step_fn()

        def run(state, host_batch):
            return step(state, self.to_device(host_batch))

        return run

    def eval_fn(self):
        """``run(params, host batch) -> bundle``, deterministic, no gradient,
        on the single-device model (full parameters in the single-device
        layout; the batch's own counts)."""

        def run(params, host_batch):
            with torch.no_grad():
                return self.loss_bundle(params, self.to_device(host_batch), None,
                                        model=self.eval_model)

        return run

    # -- loops -------------------------------------------------------------------
    def train_epoch(self, state, dataset, batch_size: int, log_every: int = 50,
                    logger=None) -> tuple[dict, list[dict]]:
        """One epoch of ``batch_size`` batches (per rank under a mesh: its
        strided share)."""
        step = self.step_fn()
        history = []
        host_id, num_hosts = host_shard_info(self.mesh)
        for i, batch in enumerate(dataset.epoch_batches(batch_size, host_id=host_id,
                                                        num_hosts=num_hosts)):
            state, bundle = step(state, batch)
            if (i + 1) % log_every == 0:
                metrics = {k: float(v) for k, v in bundle.items()}
                history.append(metrics)
                if logger is not None:
                    logger.log(metrics)
        return state, history

    def evaluate(self, params, dataset, batch_size: int) -> dict[str, float]:
        ev = self.eval_fn()
        sums: dict[str, float] = {}
        n = 0
        for batch in dataset.epoch_batches(batch_size, shuffle=False):
            for k, v in ev(params, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}


def _region_store(cfg, ws):
    """(task-data root, region store, detector classes) of a run: the
    synthetic world's under --debug, else the configured files."""
    if ws.synthetic is not None:
        root = os.path.join(cfg.output_dir, "synthetic_task_data")
        ws.synthetic.write_task_data(root)
        feats, tokens = ws.synthetic.region_features()
        store = RegionFeatureStore(feats, tokens)
        detector_classes = sorted({t for v in tokens.values() for t in v})
        if cfg.debug and "wall" not in detector_classes:
            # --debug substitutes constant "wall" region labels
            # (data_loader_pretrain.py:524-525); keep it classifiable.
            detector_classes.append("wall")
        return root, store, detector_classes
    store = RegionFeatureStore.from_pickle(cfg.region_feature_prefix)
    return (cfg.data_root, store,
            sorted({t for v in store.region_tokens.values() for t in v}))


def _fetch(bundle: dict) -> dict:
    """A step's loss bundle on the host, in one read-back."""
    names = sorted(bundle)
    return dict(zip(names, torch.stack([bundle[k].float() for k in names]).tolist()))


def pretrain_mesh(cfg, device=None):
    """The pretraining mesh of the run's flags, as visitron_tpu/run.py:
    172-200 selects it: (dp, pp) with ``--mesh_pp`` > 1 (the ranks of one
    host: torchrun's ``LOCAL_WORLD_SIZE`` must be its ``WORLD_SIZE``, as
    the JAX package's pipeline is single-host), (dp, sp) with ``--mesh_sp``
    > 1, (dp, cp) with ``--mesh_cp`` > 1, else (dp, tp)
    (``parallel.maybe_mesh``: None without a process group)."""
    for axis, make in (("pp", make_pp_mesh), ("sp", make_sp_mesh), ("cp", make_cp_mesh)):
        size = getattr(cfg, f"mesh_{axis}")
        if size > 1:
            if not torch.distributed.is_initialized():
                n = max(cfg.mesh_dp, 1) * size
                raise ValueError(f"--mesh_{axis} {size} needs {n} ranks: launch with "
                                 f"python -m torch.distributed.run --nproc_per_node {n}")
            local, world = os.environ.get("LOCAL_WORLD_SIZE"), os.environ.get("WORLD_SIZE")
            if axis == "pp" and local is not None and local != world:
                raise ValueError(f"--mesh_pp runs on one host: torchrun gives this host "
                                 f"{local} of {world} ranks; combine several hosts with "
                                 "--mesh_dp instead")
            return make(cfg.mesh_dp or None, size, device)
    return maybe_mesh(cfg.mesh_dp, cfg.mesh_tp, device)


def pretrain_loop(cfg, ws, device=None) -> dict:
    """``run pretrain`` over the workspace ``ws`` on ``device`` (None: the
    card), over the ranks of the process group if there is one
    (:func:`pretrain_mesh`: ``--mesh_dp``, ``--mesh_tp``, ``--mesh_sp``,
    ``--mesh_cp``, ``--mesh_pp``; ``--zero1``, ``--fsdp``); returns the
    final training state (this rank's blocks and shards under tp,
    ``--zero1`` / ``--fsdp``, its stage block under pp).

    Under ``--mesh_pp`` the ``parallel.pipeline.PipelinePretrainTrainer`` trains,
    as in visitron_tpu/run.py:172-256: the global batch is
    ``per_gpu_train_batch_size`` x the world (the JAX package's device
    count), each dp row's ``--pipeline_microbatches`` (0: the largest m <=
    min(4 pp, the row's rows) that divides them), checkpoints hold the
    parameters in the single-device layout and the optimizer state in the
    trainer's (``--resume`` needs the same ``--mesh_pp``), and every rank
    runs the pipelined validation."""
    mesh = pretrain_mesh(cfg, device)
    pipeline = mesh is not None and mesh.axis == "pp"
    device = resolve_device(mesh.device if mesh is not None and device is None else device)
    primary = is_primary(mesh)
    logger = setup_logger(output_dir=cfg.output_dir, is_main_process=primary)
    tables = {s: ws.runtime.tables[s] for s in ws.graphs}
    root, store, detector_classes = _region_store(cfg, ws)

    def make_dataset(splits, only=None):
        """A PretrainDataset over ``splits``; ``only`` restricts it to one
        source dataset (lowercase name) for the per-dataset validation
        sweeps (pretrain.py:301-420)."""
        records = []
        for ds, flag in (("NDH", cfg.add_ndh_data), ("R2R", cfg.add_r2r_data),
                         ("R4R", cfg.add_r4r_data), ("RxR", cfg.add_rxr_data)):
            if not flag or (only is not None and ds.lower() != only):
                continue
            if ds == "RxR" and splits != ["train"]:
                continue  # RxR ships train-guide annotations only
            try:
                records += generate_pretrain_examples(root, splits, ds, ws.graphs, tables)
            except FileNotFoundError:
                if splits == ["train"]:
                    raise
        if not records:
            return None
        # Tokenize-once cache across epochs and runs (utils_data.py:241-284);
        # skipped in --debug, whose synthetic data is written anew each run.
        cache = None if cfg.debug else os.path.join(
            cfg.output_dir, f"pretrain_cache_{only or 'all'}_{'_'.join(splits)}.pkl")
        return PretrainDataset(
            records, ws.tokenizer, region_store=store,
            detector_classes=detector_classes,
            masked_token_prediction=cfg.masked_token_prediction,
            no_action_grounding=cfg.no_action_grounding,
            mlm_probability=cfg.mlm_probability,
            max_seq_length=cfg.max_seq_length,
            max_img_seq_length=cfg.max_img_seq_length,
            region_feat_dim=cfg.img_feature_dim,
            oscar_setting=cfg.oscar_setting, tar_back=cfg.tar_back,
            debug=cfg.debug, seed=cfg.seed, cache_path=cache)

    dataset = make_dataset(["train"])
    world = 1 if mesh is None else mesh.world
    batch_size = cfg.train_batch_size(world)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    bert = ws.bert_config.replace(detector_classes=len(detector_classes))
    common = dict(learning_rate=cfg.learning_rate, warmup_steps=cfg.warmup_steps,
                  total_steps=cfg.num_epochs * steps_per_epoch, schedule=cfg.scheduler,
                  weight_decay=cfg.weight_decay, adam_epsilon=cfg.adam_epsilon,
                  max_grad_norm=cfg.max_grad_norm,
                  bf16_adam_moments=cfg.bf16_adam_moments, seed=cfg.seed, device=device)
    if pipeline:
        from visitron_torch.parallel.pipeline import (PipelinePretrainTrainer,
                                                      default_microbatches)

        microbatches = (cfg.pipeline_microbatches
                        or default_microbatches(mesh.size, batch_size // mesh.dp))
        trainer = PipelinePretrainTrainer(bert, mesh, num_microbatches=microbatches,
                                          **common)
    else:
        trainer = PretrainTrainer(bert, zero1=cfg.zero1, fsdp=cfg.fsdp, mesh=mesh,
                                  **common)
    # The JAX trainer traces its model on a sample batch, which draws from
    # the dataset's masking stream; drawing it here keeps the batches the
    # same.
    dataset.batch(range(min(batch_size, len(dataset))))
    state = trainer.init_state()
    loop = SimpleNamespace(cfg=cfg, logger=logger, device=trainer.device, dp=trainer.dp,
                           ckpt=CheckpointManager(cfg.output_dir,
                                                  async_save=cfg.async_checkpoints))
    metrics = MetricsLogger(cfg.output_dir, "train", is_main_process=primary)
    it, start_epoch, skip = 0, 0, 0
    if cfg.resume:
        # Checkpoints land per epoch (and on preemption, mid-epoch); resume
        # restores the params and the optimizer state (the schedule's
        # position is its count), re-aligns the epoch-keyed shuffle and skips
        # the completed part of the epoch in progress.
        state, it = restore_latest(loop.ckpt, state, logger, trainer.dp)
        start_epoch = min(it // steps_per_epoch, cfg.num_epochs)
        skip = it - start_epoch * steps_per_epoch
        if it:
            logger.info("resumed from checkpoint-%d (epoch %d, skipping %d completed "
                        "batches)", it, start_epoch, skip)
    dataset.set_epoch(start_epoch)
    host_id, num_hosts = host_shard_info(mesh)
    epoch_now = [start_epoch]

    def batches():
        left = skip
        for epoch in range(start_epoch, cfg.num_epochs):
            epoch_now[0] = epoch
            # Each rank takes its strided share of the epoch (the per-host
            # batch of the global one).
            for batch in dataset.epoch_batches(batch_size // num_hosts, host_id=host_id,
                                               num_hosts=num_hosts):
                if left:
                    left -= 1
                    continue
                yield batch
            yield EpochEnd(epoch)

    def log(it, bundles):
        vals = _fetch(bundles[-1])
        check_finite(vals["loss"], it, logger)
        logger.info("epoch %d iter %d %s", epoch_now[0], it, vals)
        metrics.log(vals, step=it)

    def validate(epoch, it, state):
        # Per-epoch, per-dataset validation, logged as {ds}_{split}/...
        # (pretrain.py:301-579); RxR has no val split.  Rank 0 runs the
        # mesh-free eval path over the whole split; under pp every rank
        # runs the pipelined one.
        if pipeline:
            params = state
        else:
            params = (trainer.dp.single_device_params(state["params"]) if trainer.dp
                      else state["params"])
            if not primary:
                return
        for ds_name, flag in (("ndh", cfg.add_ndh_data), ("r2r", cfg.add_r2r_data),
                              ("r4r", cfg.add_r4r_data)):
            if not flag:
                continue
            for split in ("val_seen", "val_unseen"):
                val_ds = make_dataset([split], only=ds_name)
                if val_ds is None or len(val_ds) < batch_size:
                    continue
                vals = trainer.evaluate(params, val_ds, batch_size)
                if primary:
                    logger.info("epoch %d %s_%s %s", epoch, ds_name, split, vals)
                    metrics.log(vals, step=it, prefix=f"{ds_name}_{split}/")

    state, _ = run_loop(loop, trainer.raw_step_fn(), (
        b if isinstance(b, EpochEnd) else trainer.to_device(b) for b in batches()),
        state, it, log=log, on_epoch_end=validate, limit=None, metrics=metrics)
    return state
