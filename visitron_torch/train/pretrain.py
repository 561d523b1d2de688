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
carries the JAX package's across.  The JAX trainer's device mesh, ZeRO-1
and FSDP are not ported: a mesh, ``zero1`` or ``fsdp`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from visitron_torch._device import resolve_device
from visitron_torch.models.bert import BertConfig
from visitron_torch.models.layers import DropoutRng, init_module_params
from visitron_torch.models.pretrain import PretrainModel, pretrain_loss
from visitron_torch.train.optim import (adamw_with_warmup, apply_updates, tree_leaves,
                                        tree_unflatten)

BATCH_KEYS = ("input_ids", "token_type_ids", "attention_mask", "labels", "token_labels",
              "img_feats", "img_location_embeddings", "next_action")


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
        if self.mesh is not None or self.zero1 or self.fsdp:
            raise NotImplementedError("device meshes, ZeRO-1 and FSDP are not ported yet")
        self.device = resolve_device(self.device)
        self.model = PretrainModel(self.cfg).to(self.device)
        self.optimizer = adamw_with_warmup(
            self.learning_rate, self.warmup_steps, self.total_steps, self.schedule,
            self.weight_decay, self.adam_epsilon, self.max_grad_norm,
            bf16_moments=self.bf16_adam_moments)

    # -- initialization ------------------------------------------------------
    def init_params(self, seed: int | None = None) -> dict:
        """Fresh parameters from a CPU generator (the same weights on every
        device for a seed): normal(0.02) for BERT's Denses and embeddings,
        ones / zeros for the LayerNorms, zero biases."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        return init_module_params(self.model, g, self.device)

    def init_state(self) -> dict:
        """Training state: ``params`` (:meth:`init_params` at the trainer's
        seed), ``opt_state`` and ``rng``, the dropout generators (masks on
        the device, kernel seeds on the CPU, seeded with seed + 1).  The
        shapes come from the config (the JAX trainer traces its model on a
        sample batch instead)."""
        params = self.init_params()
        rng = DropoutRng(
            masks=torch.Generator(device=self.device).manual_seed(self.seed + 1),
            seeds=torch.Generator().manual_seed(self.seed + 1))
        return {"params": params, "opt_state": self.optimizer.init(params), "rng": rng}

    # -- the step ---------------------------------------------------------------
    def to_device(self, host_batch: dict) -> dict:
        """A host batch of numpy arrays as device tensors: integers as int64,
        floats as fp32."""
        out = {}
        for key in BATCH_KEYS:
            a = np.asarray(host_batch[key])
            dtype = torch.float32 if a.dtype.kind == "f" else torch.int64
            out[key] = torch.as_tensor(a).to(device=self.device, dtype=dtype)
        return out

    def loss_bundle(self, params, batch: dict, rng: DropoutRng | None) -> dict:
        """``pretrain_loss`` of a device batch; ``rng`` None is deterministic."""
        out = functional_call(
            self.model, params, (batch["input_ids"],),
            {"token_type_ids": batch["token_type_ids"],
             "attention_mask": batch["attention_mask"],
             "img_feats": batch["img_feats"],
             "img_location_embeddings": batch["img_location_embeddings"],
             "rng": rng}, strict=True)
        return pretrain_loss(out, batch["labels"], batch["next_action"],
                             batch["token_labels"], cfg=self.cfg)

    def loss_and_grads(self, params, batch: dict, rng: DropoutRng | None):
        """(bundle, grads) for a device batch; grads mirror ``params`` (zeros
        where a parameter takes no part, as in JAX)."""
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        bundle = self.loss_bundle(tree_unflatten(params, live), batch, rng)
        grads = torch.autograd.grad(bundle["loss"], live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return {k: v.detach() for k, v in bundle.items()}, tree_unflatten(params, grads)

    def raw_step_fn(self):
        """``step(state, device batch) -> (state, bundle)``: one training step
        with the dropouts active, the clip and AdamW."""

        def step(state, batch):
            bundle, grads = self.loss_and_grads(state["params"], batch, state["rng"])
            updates, opt_state = self.optimizer.update(grads, state["opt_state"],
                                                       state["params"])
            params = apply_updates(state["params"], updates)
            return {"params": params, "opt_state": opt_state, "rng": state["rng"]}, bundle

        return step

    def step_fn(self):
        """``run(state, host batch) -> (state, bundle)``."""
        step = self.raw_step_fn()

        def run(state, host_batch):
            return step(state, self.to_device(host_batch))

        return run

    def eval_fn(self):
        """``run(params, host batch) -> bundle``, deterministic, no gradient."""

        def run(params, host_batch):
            with torch.no_grad():
                return self.loss_bundle(params, self.to_device(host_batch), None)

        return run

    # -- loops -------------------------------------------------------------------
    def train_epoch(self, state, dataset, batch_size: int, log_every: int = 50,
                    logger=None) -> tuple[dict, list[dict]]:
        step = self.step_fn()
        history = []
        for i, batch in enumerate(dataset.epoch_batches(batch_size)):
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
