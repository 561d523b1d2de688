"""GPipe pipeline parallelism (the ``pp`` mesh axis) for pretraining
(visitron_tpu/parallel/pipeline.py).

The transformer stack is cut into ``pp`` contiguous stages, one a rank of a
pp row of the (dp, pp) mesh (``parallel.make_pp_mesh``), and each rank's
rows of the batch into ``num_microbatches`` microbatches that flow through
the stages.  The JAX package writes the schedule as one SPMD ``lax.scan``
over ``M + pp - 1`` steps whose ``ppermute`` moves every rank's block at
every step, computing finite garbage in the bubble and masking it.  Here
each rank is a process that runs an explicit schedule:

  * forward: the first stage embeds its rows (the embeddings run there
    only) and feeds the microbatches through its layers one after the
    other; every other stage receives each microbatch from the previous one
    (:func:`~visitron_torch.parallel.mesh.recv_prev`), applies its layers
    and sends the result on (``send_next``); each rank keeps every
    microbatch's stage input and output;
  * loss: the last stage joins its outputs into the (b_local, T, H)
    sequence of its rows and runs the heads (the pooled [CLS] passed
    explicitly) and ``pretrain_loss`` (through K3) on the whole local
    batch, as the JAX trainer does, then takes the sequence's gradient;
  * backward: the microbatches in reverse order, each stage output
    backpropagated with the gradient the next stage sends
    (``recv_next``; the last stage's own), the stage input's gradient
    sent to the previous stage (``send_prev``); the first stage then
    backpropagates its embeddings once.

A rank computes nothing in the bubble: it waits in a receive.  Every stage
runs the hand-written kernels through their wrappers, as the single-device
encoder runs them (``BertEncoder.forward``: K1 packed at S <= 512, K4 at
S 768, K5 with ``use_flash_attention``; K2 for every LayerNorm; K3 for the
MLM loss on the last stage).

Layout: ``params`` is ``{"rest": ..., "stages": ...}``.  ``rest`` holds the
flat parameters of ``PretrainModel`` outside its encoder (embeddings,
pooler, heads), replicated on every rank; ``stages`` stacks each encoder
layer's parameter on a leading L axis (``split_pretrain_params``, the JAX
layout), and a rank holds its contiguous L/pp block (``stage_block``, the
JAX ``P("pp")``).  The optimizer state is in the same layout, the stage
moments rank-local.  Checkpoints hold the parameters in the single-device
layout (``merge_pretrain_params`` of the gathered blocks) and the optimizer
state in the trainer's, its stage moments gathered (``StageLayout``), so a
one-process ``PretrainTrainer`` loads the parameters and ``--resume`` needs
the same ``--mesh_pp``.

Semantics (the JAX trainer's ``_loss_bundle`` / ``_reduce_bundle`` /
``_sharded_grad_fn``): the loss is each dp shard's masked means, and the
logged bundle the last stage's, meaned over dp; the ``rest`` gradients are
summed over the pp row (the tied MLM decoder gives the word embeddings a
gradient on the first stage and on the last) and meaned over dp, the stage
gradients meaned over dp; the clip's global norm counts each ``rest`` leaf
once and every stage block once.  Bubble fraction ``(pp - 1) / (M + pp -
1)``; ``num_microbatches`` defaults to 4 pp.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.func import functional_call

from visitron_torch._device import resolve_device
from visitron_torch.models.bert import BertConfig, BertEncoder
from visitron_torch.models.layers import DropoutRng, init_module_params
from visitron_torch.models.pretrain import PretrainModel, pretrain_loss
from visitron_torch.ops.masking import make_attention_bias
from visitron_torch.parallel.mesh import (Mesh, _map_moments, all_gather, all_reduce_sum,
                                          recv_next, recv_prev, send_next, send_prev,
                                          shard_batch)
from visitron_torch.train.optim import adamw_with_warmup, apply_updates, tree_leaves
from visitron_torch.train.pretrain import batch_to_device

ENCODER = "bert.encoder."
# The keys of pretrain_loss's bundle with every label kind.
BUNDLE_KEYS = ("action_accuracy", "loss", "mask_loss", "next_loss", "token_accuracy",
               "token_loss", "words_accuracy")


# -- parameter layout -------------------------------------------------------------------

def split_pretrain_params(params: dict) -> tuple[dict, dict]:
    """Single-device ``PretrainModel`` params -> (rest, stages): ``rest``
    every parameter outside the encoder, ``stages`` {layer parameter name:
    the L layers' tensors stacked on a leading axis}."""
    rest, layers = {}, {}
    for name, t in params.items():
        if not name.startswith(ENCODER):
            rest[name] = t
            continue
        layer, leaf = name[len(ENCODER):].split(".", 1)
        layers.setdefault(int(layer[len("layer_"):]), {})[leaf] = t
    if sorted(layers) != list(range(len(layers))) or not layers:
        raise ValueError(f"the encoder's layers are {sorted(layers)}")
    stages = {leaf: torch.stack([layers[i][leaf] for i in range(len(layers))])
              for leaf in layers[0]}
    return rest, stages


def merge_pretrain_params(rest: dict, stages: dict) -> dict:
    """(rest, stages) -> the single-device layout (each layer's tensors new,
    not views of the stacked ones)."""
    out = dict(rest)
    num_layers = next(iter(stages.values())).shape[0]
    for i in range(num_layers):
        for leaf, t in stages.items():
            out[f"{ENCODER}layer_{i}.{leaf}"] = t[i].clone()
    return out


def stage_block(stages: dict, mesh: Mesh) -> dict:
    """This rank's contiguous block of L/pp layers of full stacked
    ``stages`` (new tensors)."""
    pp = _pp(mesh)
    num_layers = next(iter(stages.values())).shape[0]
    if num_layers % pp:
        raise ValueError(f"{num_layers} layers do not split over pp={pp}")
    n, a = num_layers // pp, mesh.axis_index
    return {k: v[a * n:(a + 1) * n].clone() for k, v in stages.items()}


def gather_stages(block: dict, mesh: Mesh) -> dict:
    """The full stacked stages whose blocks the ranks of this pp row hold
    (every rank of the row takes part; one all-gather per dtype)."""
    if _pp(mesh) == 1:
        return block
    names = sorted(block)
    full = all_gather([block[k].contiguous() for k in names], [0] * len(names), mesh, "axis")
    return dict(zip(names, full))


def _pp(mesh: Mesh) -> int:
    if mesh.axis not in ("pp", None):
        raise ValueError(f"the pipeline needs a (dp, pp) mesh, got a {mesh.axis} axis")
    return mesh.size if mesh.axis == "pp" else 1


@dataclass
class StageLayout:
    """The checkpoint layout of a pipeline trainer's state, the part
    ``parallel.DataParallel`` plays for the other trainers in
    ``train/loop.py``: ``gather`` gives the single-device parameters and
    the optimizer state with the stage moments gathered (every rank takes
    part), ``shard`` this rank's blocks of them."""

    mesh: Mesh

    def single_device_params(self, params: dict) -> dict:
        return merge_pretrain_params(params["rest"], gather_stages(params["stages"],
                                                                   self.mesh))

    def gather(self, params: dict, opt_state) -> tuple[dict, object]:
        opt_state = map_stage_moments(opt_state, params,
                                      lambda s: gather_stages(s, self.mesh))
        return self.single_device_params(params), opt_state

    def shard(self, params: dict, opt_state) -> tuple[dict, object]:
        rest, stages = split_pretrain_params(params)
        opt_state = map_stage_moments(opt_state, {"rest": rest, "stages": stages},
                                      lambda s: stage_block(s, self.mesh))
        return {"rest": rest, "stages": stage_block(stages, self.mesh)}, opt_state


def map_stage_moments(opt_state, params: dict, fn):
    """``opt_state`` with ``fn(stages)`` in place of the stage part of each
    moment (a sub-tree in ``params``' {"rest", "stages"} layout)."""
    return _map_moments(opt_state, params, lambda m: {**m, "stages": fn(m["stages"])}
                        if "stages" in m else m)


# -- the stages ---------------------------------------------------------------------------

class _Ends(PretrainModel):
    """``PretrainModel`` without encoder layers: the embeddings that feed
    the first stage (``part`` "embed": ``embed_joint`` of a device batch)
    and the heads that read the last one's sequence (``part`` "heads",
    with the pooled [CLS] computed here: the port's ``heads`` reads a
    missing ``pooled`` as a rank without [CLS])."""

    def forward(self, part: str, x, rng: DropoutRng | None = None):
        if part == "embed":
            return self.bert.embed_joint(
                x["input_ids"], token_type_ids=x["token_type_ids"],
                attention_mask=x["attention_mask"], img_feats=x["img_feats"],
                img_location_embeddings=x["img_location_embeddings"], rng=rng)
        return self.heads(x, pooled=self.bert.pooler(x))


def _stage_apply(stage: BertEncoder, stage_params: dict, hidden, bias,
                 rng: DropoutRng | None):
    """Apply this rank's layer block to one microbatch: ``stage`` is a
    one-layer ``BertEncoder`` (on the meta device), applied to the i-th
    slice of each stacked leaf for each of the block's layers, so each
    layer runs as ``BertEncoder.forward`` runs it (its attention dispatch,
    ``remat``, its dropouts from ``rng``)."""
    num_local = next(iter(stage_params.values())).shape[0]
    for i in range(num_local):
        layer = {f"layer_0.{k}": v[i] for k, v in stage_params.items()}
        hidden = functional_call(stage, layer, (hidden, bias), {"rng": rng}, strict=True)
    return hidden


# -- the trainer ----------------------------------------------------------------------------

def default_microbatches(pp: int, per_shard: int) -> int:
    """The microbatches of a dp row's ``per_shard`` rows without
    ``--pipeline_microbatches`` (visitron_tpu/run.py:216-219): the largest
    m <= min(4 pp, per_shard) that divides them."""
    return max(m for m in range(1, min(4 * pp, per_shard) + 1) if per_shard % m == 0)


@dataclass
class PipelinePretrainTrainer:
    """Pretraining over a (dp, pp) mesh of processes.

    The peer of ``train.PretrainTrainer`` for a pipeline-sharded stack;
    parameters interchange through ``split_pretrain_params`` /
    ``merge_pretrain_params`` (``checkpoint_params``).  A step takes this
    rank's dp rows of the global batch (``parallel.shard_batch``); the
    ranks of a pp row take the same rows.  ``num_microbatches`` (default 4
    pp) must divide them; pp must divide the layers."""

    cfg: BertConfig
    mesh: Mesh
    num_microbatches: int | None = None
    learning_rate: float = 5e-5
    warmup_steps: int = 0
    total_steps: int = 20000
    schedule: str = "linear"
    weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    bf16_adam_moments: bool = False
    seed: int = 42
    device: object = None  # None: the mesh's
    dp: StageLayout = field(init=False)

    def __post_init__(self):
        if not isinstance(self.mesh, Mesh):
            raise TypeError(f"the pipeline trainer needs a parallel.Mesh, got "
                            f"{type(self.mesh).__name__}")
        self.pp = _pp(self.mesh)
        cfg = self.cfg
        if cfg.num_hidden_layers % self.pp:
            raise ValueError(f"{cfg.num_hidden_layers} layers not divisible by "
                             f"pp={self.pp}")
        if cfg.without_mesh() != cfg:
            raise ValueError("the pipeline's stages run whole layers: the config "
                             "carries no tp, sp or cp mesh")
        if self.num_microbatches is None:
            self.num_microbatches = 4 * self.pp
        self.device = resolve_device(self.mesh.device if self.device is None else self.device)
        self.first, self.last = self.mesh.axis_index == 0, self.mesh.axis_index == self.pp - 1
        with torch.device("meta"):
            # Shapes and initial draws (the single-device model), the
            # embeddings and heads, one layer of a stage: none holds memory.
            self.model = PretrainModel(cfg)
            self.ends = _Ends(cfg.replace(num_hidden_layers=0))
            self.stage = BertEncoder(cfg.replace(num_hidden_layers=1))
        self.dp = StageLayout(self.mesh)
        self.optimizer = adamw_with_warmup(
            self.learning_rate, self.warmup_steps, self.total_steps, self.schedule,
            self.weight_decay, self.adam_epsilon, self.max_grad_norm,
            bf16_moments=self.bf16_adam_moments, norm=self.global_norm)

    # -- state ----------------------------------------------------------------------
    def init_params(self, seed: int | None = None) -> dict:
        """Single-device parameters from a CPU generator:
        ``PretrainTrainer.init_params``'s draws for the same seed."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        return init_module_params(self.model, g, self.device)

    def init_state(self, params: dict | None = None) -> dict:
        return self.state_from_params(self.init_params() if params is None else params)

    def state_from_params(self, params: dict) -> dict:
        """The training state of single-device ``params`` (the same on
        every rank): this rank's stage block, the optimizer state over it,
        the dropout generators."""
        rest, stages = split_pretrain_params(params)
        pp_params = {"rest": rest, "stages": stage_block(stages, self.mesh)}
        return {"params": pp_params, "opt_state": self.optimizer.init(pp_params),
                "rng": self.dropout_rng()}

    def dropout_rng(self) -> DropoutRng:
        """This rank's dropout generators: masks seeded with seed + 1 + the
        mesh fold (dp index and stage, ``Mesh.fold_seed``), kernel seeds
        drawn from seed + 1 plus ``Mesh.kernel_seed``'s fold."""
        return DropoutRng(
            masks=torch.Generator(device=self.device).manual_seed(
                self.seed + 1 + self.mesh.fold_seed(0)),
            seeds=torch.Generator().manual_seed(self.seed + 1),
            seed_offset=self.mesh.kernel_seed(0))

    def checkpoint_params(self, state: dict) -> dict:
        """The single-device layout of the state's parameters (every rank
        of the row takes part)."""
        return self.dp.single_device_params(state["params"])

    # -- the schedule ---------------------------------------------------------------
    def to_device(self, host_batch: dict) -> dict:
        return batch_to_device(host_batch, self.device)

    def _microbatch_rows(self, batch: dict) -> int:
        b = batch["input_ids"].shape[0]
        if b % self.num_microbatches:
            raise ValueError(f"per-dp-shard batch {b} not divisible by "
                             f"num_microbatches={self.num_microbatches}")
        return b // self.num_microbatches

    def _forward(self, params: dict, batch: dict, rng: DropoutRng | None):
        """The forward schedule on a device batch (this rank's rows): (the
        microbatches' stage inputs, their outputs, the embeddings (first
        stage) or None)."""
        cfg, mesh, mb = self.cfg, self.mesh, self._microbatch_rows(batch)
        train = torch.is_grad_enabled()
        shape = (mb, batch["input_ids"].shape[1] + batch["img_feats"].shape[1],
                 cfg.hidden_size)
        emb = None
        if self.first:
            emb, bias = functional_call(self.ends, params["rest"], ("embed", batch),
                                        {"rng": rng}, strict=True)
            ins = [x.detach().requires_grad_(train) for x in emb.split(mb)]
        else:
            bias = make_attention_bias(batch["attention_mask"])[:, 0, 0, :].contiguous()
            ins = []
        outs = []
        for m in range(self.num_microbatches):
            if not self.first:
                ins.append(recv_prev(shape, cfg.dtype, mesh).requires_grad_(train))
            y = _stage_apply(self.stage, params["stages"], ins[m], bias[m * mb:(m + 1) * mb],
                             rng)
            if not self.last:
                send_next(y, mesh)
            outs.append(y)
        return ins, outs, emb

    def _heads_bundle(self, params: dict, batch: dict, seq):
        out = functional_call(self.ends, params["rest"], ("heads", seq), strict=True)
        bundle = pretrain_loss(out, batch["labels"], batch["next_action"],
                               batch["token_labels"], cfg=self.cfg)
        if tuple(sorted(bundle)) != BUNDLE_KEYS:
            raise RuntimeError(f"pretrain_loss gave {sorted(bundle)}")
        return bundle

    def _reduce(self, bundle: dict | None, grads: list) -> tuple[dict, list]:
        """(the bundle of the last stage meaned over dp, ``grads`` summed over
        the world and meaned over dp) in one all-reduce."""
        vals = [(bundle[k].detach().float() if bundle is not None else
                 torch.zeros((), device=self.device)).reshape(1) for k in BUNDLE_KEYS]
        out = all_reduce_sum(grads + vals, self.mesh, "world")
        dp = self.mesh.dp
        mean = ({k: (v / dp).reshape(()) for k, v in zip(BUNDLE_KEYS, out[len(grads):])})
        return mean, [g / dp for g in out[:len(grads)]] if dp > 1 else out[:len(grads)]

    def loss_and_grads(self, params: dict, batch: dict, rng: DropoutRng | None):
        """(bundle, grads) of one step on a device batch (this rank's rows):
        the bundle of the last stage meaned over dp; the gradients in the
        params' layout, ``rest`` summed over the pp row, both meaned over
        dp."""
        rest = {k: v.detach().requires_grad_() for k, v in params["rest"].items()}
        stages = {k: v.detach().requires_grad_() for k, v in params["stages"].items()}
        live = {"rest": rest, "stages": stages}
        ins, outs, emb = self._forward(live, batch, rng)
        bundle = None
        if self.last:
            seq = torch.cat([y.detach() for y in outs]).requires_grad_()
            bundle = self._heads_bundle(live, batch, seq)
            bundle["loss"].backward()
            d_outs = list(seq.grad.split(ins[0].shape[0]))
            del seq
        for m in reversed(range(self.num_microbatches)):
            g = d_outs[m] if self.last else recv_next(outs[m].shape, outs[m].dtype,
                                                      self.mesh)
            torch.autograd.backward(outs[m], g)
            outs[m] = None  # this microbatch's graph goes
            if not self.first:
                send_prev(ins[m].grad, self.mesh)
        if self.first:
            torch.autograd.backward(emb, torch.cat([x.grad for x in ins]))
        grads = {part: {k: torch.zeros_like(v) if v.grad is None else v.grad
                        for k, v in leaves.items()} for part, leaves in live.items()}
        names = sorted(grads["rest"])
        bundle, rest_g = self._reduce(bundle, [grads["rest"][k] for k in names])
        grads["rest"] = dict(zip(names, rest_g))
        if self.mesh.dp > 1:
            names = sorted(grads["stages"])
            summed = all_reduce_sum([grads["stages"][k] for k in names], self.mesh, "dp")
            grads["stages"] = {k: g / self.mesh.dp for k, g in zip(names, summed)}
        return bundle, grads

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The clip's global norm of reduced gradients: each ``rest`` leaf
        once (they agree on every rank), every stage block once (their
        squares summed over the pp row)."""
        def sq(leaves):
            return torch.sum(torch.stack(torch._foreach_norm(leaves)).float() ** 2)

        stage_sq = sq(tree_leaves(grads["stages"]))
        if self.pp > 1:
            stage_sq = all_reduce_sum([stage_sq], self.mesh, "axis")[0]
        return torch.sqrt(sq(tree_leaves(grads["rest"])) + stage_sq)

    # -- steps --------------------------------------------------------------------
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
        """``run(state, host batch of this rank's rows) -> (state, bundle)``."""
        step = self.raw_step_fn()
        return lambda state, host_batch: step(state, self.to_device(host_batch))

    def eval_fn(self):
        """``run(params or state, host batch of this rank's rows) -> bundle``:
        the pipelined forward without dropout or backward, the last stage's
        bundle meaned over dp (every rank takes part)."""

        def run(params_or_state, host_batch):
            params = params_or_state.get("params", params_or_state)
            batch = self.to_device(host_batch)
            with torch.no_grad():
                _, outs, _ = self._forward(params, batch, None)
                bundle = (self._heads_bundle(params, batch, torch.cat(outs))
                          if self.last else None)
                return self._reduce(bundle, [])[0]

        return run

    def evaluate(self, params_or_state, dataset, batch_size: int) -> dict[str, float]:
        """Mean metrics over a dataset's ``batch_size`` batches, each sharded
        over dp (every rank takes part)."""
        ev = self.eval_fn()
        sums: dict[str, float] = {}
        n = 0
        for batch in dataset.epoch_batches(batch_size, shuffle=False):
            for k, v in ev(params_or_state, shard_batch(self.mesh, batch)).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}
