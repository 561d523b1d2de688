"""Viewpoint-selection navigation agent: the NDH serving rollout and the
fine-tuning train steps, teacher-forced, student-forced and RL
(visitron_tpu/agents/viewpoint.py; reference tasks/viewpoint_select/
agent.py:49-63, 358-472, 509-515).

``test(params, batches, feedback="argmax", generator=None)`` is the serving
entry point, for every feedback strategy of ``decoding.select_action``:

  * without ``submit`` each batch is one device rollout: the dialog is
    encoded once (BERT + LSTM), then a Python loop of ``episode_len``
    decode/act steps runs on the device, with actions and transitions
    computed there from the NavRuntime tables; the host reads the
    trajectory back once per batch;
  * with ``submit`` the host stays in the loop (one read-back per step) to
    mask candidates that lead to already visited viewpoints
    (agent.py:397-402).

``params`` are ``{"encoder": {name: tensor}, "decoder": {name: tensor}}``
(plus ``"critic"`` for RL), applied to the agent's modules with
``torch.func.functional_call``; make them with
:meth:`ViewpointAgent.init_params` or carry the JAX package's across with
``visitron_torch.convert.convert_agent_params``.  The rollout runs under
``torch.inference_mode``.

The training entry points take ``state`` from :meth:`ViewpointAgent.init_state`
(params, the optimizer state, the dropout generators ``rng`` and the
sampling generator ``sampler``) and a batch of
``NavEpisodeBatcher.train_batches``; each trims the batch to its bucket,
runs the encoder and ``episode_len`` decoder steps with every dropout
active, takes the gradients with ``torch.autograd.grad`` (the BERT
attention and LayerNorms backward through their kernels K1b and K2b), clips
them and applies Adam:

  * ``train_step_fn()``: teacher forcing along the precomputed teacher
    episode (batches from ``train_batches(n, episode_len=...)``);
  * ``sample_train_step_fn(feedback="sample")``: student forcing (the
    reference's default ``--feedback_method sample``): the agent follows its
    own actions while each step is supervised by the shortest-path teacher
    at the state it reached, found on the device from per-item next-hop
    columns (batches through ``NavEpisodeBatcher.with_sample_teacher``);
  * ``rl_train_step_fn()``: advantage actor-critic over a sampled episode
    (``init_state(with_critic=True)``).

The T-step decode loops of the sampled and RL losses read nothing back to
the host.

Under a ``mesh`` (``parallel.make_mesh(dp, tp)``; the JAX agent's
``mesh``) each rank steps on the rows of its dp index of the global batch
(``NavEpisodeBatcher(host_id, num_hosts)`` trims them to the global length
bucket): every loss divides by the counts of the global batch (the per-step
active counts, one all-reduce a step), the gradients and the logged loss
and aux values are summed over dp in flat buckets, the attention kernels'
dropout seed is folded by the mesh coordinates and the hidden-dropout and
sampling generators are seeded per dp index.  Under tp (``config_for_mesh``)
the encoder's BERT holds this rank's blocks of the four split kernels of
every layer and the rest of the agent is replicated over the tp ranks,
which draw the same masks and samples; evaluation and serving run the
mesh-free twin ``eval_encoder`` on the single-device layout.  ``zero1``
shards the Adam moments over dp (``parallel.DataParallel``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from visitron_torch import geometry as geo
from visitron_torch._device import resolve_device
from visitron_torch.agents.batcher import trim_to_bucket
from visitron_torch.agents import decoding
from visitron_torch.agents.decoding import select_action
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.models import AttnDecoderLSTM, BertConfig, Critic, OscarEncoder
from visitron_torch.models.bert import config_for_mesh
from visitron_torch.models.layers import DropoutRng, init_module_params
from visitron_torch.ops.masking import NEG_INF
from visitron_torch.parallel.mesh import (DataParallel, jax_axis_orders,
                                          shard_params_rules)
from visitron_torch.train.optim import (agent_optimizer, apply_updates, tree_leaves,
                                        tree_unflatten)
from visitron_torch.utils import tracing


def gather_step_inputs(rt: NavRuntime, cur_row, view):
    """Device-side assembly of one step's decoder inputs from packed tables.

    cur_row, view: (B,) int64.  Returns (a_t (B,4), f_t (B,36,D+4),
    cand_feat (B,K+1,D+4), cand_mask (B,K+1) True at invalid slots).
    """
    pano = rt.feats[cur_row]  # (B, 36, D)
    f_t = torch.cat([pano, rt.pano_af[view]], dim=-1)
    a_t = rt.view_af[view]  # (B, 4) camera angle feature
    pts = rt.point[cur_row]  # (B, K)
    cand_vis = torch.take_along_dim(pano, pts[:, :, None], dim=1)  # (B, K, D)
    # The base heading is rounded to the feature dtype, as in the JAX package;
    # the increment is rounded on the host (a device constant would be a copy).
    inc = float(torch.tensor(geo.ANGLE_INC, dtype=f_t.dtype))
    base_heading = (view % geo.HEADINGS_PER_ROW).to(f_t.dtype) * inc
    ch = rt.heading[cur_row] - base_heading[:, None]
    ce = rt.elev[cur_row]
    cand_af = torch.stack([torch.sin(ch), torch.cos(ch), torch.sin(ce),
                           torch.cos(ce)], dim=-1)
    cand = torch.cat([cand_vis, cand_af.to(f_t.dtype)], dim=-1)
    # Stop slot (zero feature) appended; slots beyond count+stop are masked
    # (agent.py:202-217, utils.py:340-347).
    stop = torch.zeros((cand.shape[0], 1, cand.shape[2]), dtype=cand.dtype,
                       device=cand.device)
    cand_feat = torch.cat([cand, stop], dim=1)  # (B, K+1, D+4)
    k1 = cand_feat.shape[1]
    counts = rt.count[cur_row]
    cand_mask = torch.arange(k1, device=counts.device)[None, :] > counts[:, None]
    return a_t, f_t, cand_feat, cand_mask


class DialogAgent:
    """What the agents that encode a dialog with ``OscarEncoder`` and train
    with an optax-style optimizer share: the device check, fresh parameters
    and dropout generators, batch trimming, the encoder call, gradients and
    the optimizer step.  Subclasses have ``runtime``, ``seed`` and
    ``device`` fields and set ``encoder``, ``decoder`` and ``optimizer``."""

    def _resolve_device(self) -> None:
        """``device`` resolved (None: the mesh's device, else the card); the
        runtime's tables must live on the same kind of device.  Under a
        ``mesh``, ``dp`` carries the step's collectives (``zero1`` where the
        agent has it), and ``cfg`` goes through ``config_for_mesh``."""
        mesh = getattr(self, "mesh", None)
        if getattr(mesh, "tokens_sharded", False):
            raise ValueError(f"{type(self).__name__} runs on a (dp, tp) mesh; sequence "
                             "and context parallelism are for pretraining")
        if hasattr(self, "cfg"):
            self.cfg = config_for_mesh(self.cfg, mesh)
        if mesh is not None and self.device is None:
            self.device = mesh.device
        self.device = resolve_device(self.device)
        if self.runtime.device.type != self.device.type:
            raise ValueError(f"runtime tables are on {self.runtime.device}, "
                             f"the agent on {self.device}")
        self.dp = None
        if mesh is not None:
            self.dp = DataParallel(mesh, zero1=getattr(self, "zero1", False))

    def _clip_norm(self):
        """The optimizer clip's norm: the dp step's (over every rank's
        shards under ZeRO-1), None (the plain norm) without a mesh."""
        return None if self.dp is None else self.dp.global_norm

    def _make_encoder(self, **kw) -> None:
        """``encoder`` (OscarEncoder over ``cfg``) and ``eval_encoder``, its
        mesh-free twin over the single-device layout (the encoder itself
        without tp; under tp it holds no parameters of its own)."""
        self.encoder = OscarEncoder(self.cfg, **kw).to(self.device).eval()
        if self.cfg.tp_mesh is None:
            self.eval_encoder = self.encoder
        else:
            with torch.device("meta"):
                self.eval_encoder = OscarEncoder(self.cfg.without_mesh(), **kw).eval()

    def _eval_kw(self) -> dict:
        """The keyword an evaluation path passes to :meth:`encode` (or a
        loss that calls it): ``encoder=eval_encoder`` under tp, nothing where
        the two encoders are one."""
        return {} if self.eval_encoder is self.encoder else {"encoder": self.eval_encoder}

    def _plain(self, part: str):
        """The single-device module of a parameter part."""
        if part == "encoder":
            return getattr(self, "eval_encoder", self.encoder)
        return getattr(self, part)

    def _rank_seed(self, seed: int) -> int:
        """``seed`` folded by the dp index under a mesh (each dp row draws
        its own dropout masks and samples; the ranks of a tp row, whose
        activations are replicated, draw the same), ``seed`` itself
        otherwise."""
        return seed if self.dp is None else self.dp.mesh.fold_seed(seed)

    def _count_sum(self):
        """What a training step's losses pass their counts through: the sum
        over the ranks under a mesh (the global batch's counts), None (this
        batch's own) otherwise."""
        return None if self.dp is None else self.dp.global_count

    def _train_state(self, params: dict, **extra) -> dict:
        """{params, opt_state, **extra} from full parameters: under ZeRO-1
        the optimizer state holds this rank's shards."""
        if self.dp is None:
            return {"params": params, "opt_state": self.optimizer.init(params), **extra}
        self.dp.plan(params, {part: jax_axis_orders(self._plain(part)) for part in params},
                     {part: shard_params_rules(getattr(self, part)) for part in params})
        params, opt_state = self.dp.place(params, self.optimizer)
        return {"params": params, "opt_state": opt_state, **extra}

    def init_params(self, seed: int | None = None, parts=("encoder", "decoder")) -> dict:
        """Fresh parameters of ``parts`` from a CPU ``torch.Generator`` (so
        the same seed gives the same weights on every device), with the flax
        initialisers' distributions: normal(0.02) for BERT, U(+-1/sqrt(H))
        for LSTMs, lecun_normal for the other Dense kernels, zero biases."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        return {part: init_module_params(self._plain(part), g, self.device)
                for part in parts}

    def dropout_rng(self) -> DropoutRng:
        """A training pass's dropout generators: masks on the agent's
        device, kernel seeds on the CPU, both seeded with seed + 1; under a
        mesh the masks' seed is folded by the dp index and the kernel seeds
        by the mesh coordinates (``Mesh.kernel_seed``)."""
        return DropoutRng(
            masks=torch.Generator(device=self.device).manual_seed(
                self._rank_seed(self.seed + 1)),
            seeds=torch.Generator().manual_seed(self.seed + 1),
            seed_offset=0 if self.dp is None else self.dp.mesh.kernel_seed(0))

    @staticmethod
    def trim_batch(batch: dict, bucket: int = 128) -> dict:
        """Trim dialog arrays to the batch's max length rounded up to a
        ``bucket`` multiple (padded keys are masked and the LSTM freezes at
        pads, so the result is unchanged)."""
        return trim_to_bucket(batch, int(batch["lengths"].max()), bucket)

    def train_trim(self, batch: dict) -> dict:
        """A training batch trimmed to its bucket; under a mesh of several
        ranks the batcher has trimmed it to the global bucket already (every
        rank's rows in the same shapes, as in the JAX package)."""
        if self.dp is not None and self.dp.mesh.dp > 1:
            return batch
        return self.trim_batch(batch)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64).to(self.device)

    def encode(self, params, batch: dict, rng: DropoutRng | None = None, encoder=None):
        """(ctx, h0, c0, ctx_mask) for a trimmed batch; ``rng`` turns the
        encoder's dropouts on; ``encoder``: the module (default the training
        encoder; the evaluation paths pass ``eval_encoder``)."""
        with tracing.span(tracing.ENCODER):
            ids, segs = self._index(batch["ids"]), self._index(batch["segs"])
            lengths = self._index(batch["lengths"])
            encoder = self.encoder if encoder is None else encoder
            ctx, h, c = functional_call(encoder, params["encoder"], (ids, lengths),
                                        {"token_type_ids": segs, "rng": rng}, strict=True)
        ctx_mask = torch.arange(ids.shape[1], device=self.device)[None, :] >= lengths[:, None]
        return ctx, h, c, ctx_mask

    @staticmethod
    def value_and_grads(params, loss_fn, labels=None):
        """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)``; grads
        mirror ``params`` (zeros where a parameter takes no part, as in JAX).
        ``labels`` (a "train" or "freeze" string per parameter, in
        ``params``' nesting) holds the "freeze" parameters constant: their
        gradient is None, and autograd does no work for them."""
        leaves = tree_leaves(params)
        frozen = ([False] * len(leaves) if labels is None
                  else [label == "freeze" for label in tree_leaves(labels)])
        live = [p.detach() if f else p.detach().requires_grad_()
                for p, f in zip(leaves, frozen)]
        loss, aux = loss_fn(tree_unflatten(params, live))
        with tracing.span(tracing.BACKWARD):
            found = iter(torch.autograd.grad(
                loss, [p for p, f in zip(live, frozen) if not f], allow_unused=True))
            grads = []
            for p, f in zip(leaves, frozen):
                g = None if f else next(found)
                grads.append(torch.zeros_like(p) if g is None and not f else g)
        return loss.detach(), aux, tree_unflatten(params, grads)

    def apply_grads(self, state: dict, grads, logged: dict | None = None):
        """(``state`` after the global-norm clip and one Adam step,
        ``logged``: 0-d tensors, the loss and aux values).  Under a mesh the
        gradients and ``logged`` are first summed over the ranks (one flat
        all-reduce), and the update is ZeRO-1's where the agent shards its
        optimizer state."""
        logged = logged or {}
        if self.dp is None:
            with tracing.span(tracing.OPTIMIZER):
                updates, opt_state = self.optimizer.update(grads, state["opt_state"],
                                                           state["params"])
                params = apply_updates(state["params"], updates)
            return {**state, "params": params, "opt_state": opt_state}, logged
        with tracing.span(tracing.GRAD_REDUCE):
            grads, logged = self.dp.reduce(grads, logged)
        with tracing.span(tracing.OPTIMIZER):
            params, opt_state = self.dp.update(self.optimizer, grads, state["opt_state"],
                                               state["params"], apply_updates)
        return {**state, "params": params, "opt_state": opt_state}, logged

    def write_results(self, path: str) -> None:
        """``self.results`` ({inst_idx: trajectory}) as the EvalAI JSON."""
        output = [{"inst_idx": k, "trajectory": v} for k, v in self.results.items()]
        with open(path, "w") as f:
            json.dump(output, f)


@dataclass
class ViewpointAgent(DialogAgent):
    cfg: BertConfig
    runtime: NavRuntime
    feature_dim: int  # scene feature dim D (without angle feat)
    episode_len: int = 10
    angle_feat_size: int = 4
    aemb: int = 64
    rnn_dim: int = 512
    encoder_hidden_size: int = 512
    dropout: float = 0.5
    learning_rate: float = 5e-5
    optimizer_kind: str = "adam"
    max_grad_norm: float = 40.0
    bf16_adam_moments: bool = False  # store Adam mu/nu in bf16
    temperature: float = 1.0  # temperature / penalty feedback scaling
    seed: int = 88
    device: object = None  # None: the mesh's device, else the card
    zero1: bool = False  # shard the optimizer state over the mesh's ranks
    mesh: object = None  # a dp parallel.Mesh: data-parallel training

    def __post_init__(self):
        self._resolve_device()
        self._make_encoder(hidden_size=self.encoder_hidden_size,
                           decoder_hidden_size=self.rnn_dim, dropout_ratio=self.dropout)
        self.decoder = AttnDecoderLSTM(
            angle_feat_size=self.angle_feat_size, embedding_size=self.aemb,
            hidden_size=self.rnn_dim,
            feature_size=self.feature_dim + self.angle_feat_size,
            ctx_size=self.encoder_hidden_size,
            dropout_ratio=self.dropout).to(self.device).eval()
        self.critic = Critic(hidden_size=self.rnn_dim,
                             dropout_ratio=self.dropout).to(self.device).eval()
        self.optimizer = agent_optimizer(self.learning_rate, self.optimizer_kind,
                                         self.max_grad_norm,
                                         bf16_moments=self.bf16_adam_moments,
                                         norm=self._clip_norm())
        self.results: dict = {}

    # -- parameters ----------------------------------------------------------
    def init_params(self, seed: int | None = None, with_critic: bool = False) -> dict:
        """Fresh parameters (DialogAgent.init_params); ``with_critic``: also
        the RL value head."""
        return super().init_params(seed, ("encoder", "decoder")
                                   + (("critic",) if with_critic else ()))

    def init_state(self, with_critic: bool = False, params: dict | None = None) -> dict:
        """Training state: ``params`` (:meth:`init_params` at the agent's
        seed; ``with_critic`` adds the value head RL fine-tuning needs),
        ``opt_state``, ``rng``, the dropout generators (masks on the agent's
        device, kernel seeds on the CPU, both seeded with seed + 1), and
        ``sampler``, the generator of the sampled actions (on the agent's
        device, seed + 2); under a mesh the device generators' seeds are
        folded by the rank, and under ``zero1`` the optimizer state holds
        this rank's shards.  ``params``: full parameters to start from
        instead (the same on every rank)."""
        if params is None:
            params = self.init_params(with_critic=with_critic)
        sampler = torch.Generator(device=self.device).manual_seed(
            self._rank_seed(self.seed + 2))
        return self._train_state(params, rng=self.dropout_rng(), sampler=sampler)

    def decode_step(self, params, h1, c, ctx, ctx_mask, cur_row, view,
                    visited_mask=None, rng: DropoutRng | None = None):
        """One decoder step from the runtime tables; returns (masked logit,
        h_tilde, c_new).  ``rng`` turns the decoder's dropouts on."""
        a_t, f_t, cand_feat, cand_mask = gather_step_inputs(self.runtime, cur_row, view)
        _, c_new, logit, h_tilde = functional_call(
            self.decoder, params["decoder"],
            (a_t, f_t, cand_feat, h1, c, ctx, ctx_mask), {"rng": rng}, strict=True)
        if visited_mask is not None:
            cand_mask = cand_mask | visited_mask
        return logit.masked_fill(cand_mask, NEG_INF), h_tilde, c_new

    # -- teacher-forced training ------------------------------------------------
    def episode_loss(self, params, batch: dict, rng: DropoutRng | None = None,
                     count_sum=None, encoder=None):
        """Mean teacher-forced loss of a trimmed batch with teacher arrays
        (agent.py:406-412, 469-472): the encoder, then T decoder steps fed
        the teacher's states; each step's masked CE is averaged over its
        active items (n = max(sum(active), 1)), and the loss is the sum of
        the step losses over T.  ``rng`` None: no dropout.  ``count_sum``
        (:meth:`_count_sum`) takes the active counts to the global batch's;
        None: this batch's.  ``encoder``: as :meth:`encode`'s."""
        ctx, h1, c, ctx_mask = self.encode(params, batch, rng, encoder)
        return self.teacher_forced_loss(params, batch, ctx, h1, c, ctx_mask, rng,
                                        count_sum)

    def teacher_forced_loss(self, params, batch: dict, ctx, h1, c, ctx_mask,
                            rng: DropoutRng | None = None, count_sum=None):
        """The decoder half of :meth:`episode_loss`: T teacher-forced steps
        from the encoder's outputs, and the mean of the step losses."""
        cur_row, view = self._index(batch["cur_row"]), self._index(batch["view"])
        teacher = self._index(batch["teacher"])
        active = torch.as_tensor(np.asarray(batch["active"], bool)).to(self.device)
        t_len = cur_row.shape[1]
        counts = active.float().sum(0)
        if count_sum is not None:  # each step's active count over the global batch
            counts = count_sum(counts)
        loss = torch.zeros((), device=self.device)
        with tracing.span(tracing.DECODER):
            for t in range(t_len):
                logit, h1, c = self.decode_step(params, h1, c, ctx, ctx_mask,
                                                cur_row[:, t], view[:, t], rng=rng)
                act = active[:, t]
                ce = F.cross_entropy(logit.float(), torch.where(act, teacher[:, t], 0),
                                     reduction="none")
                loss = loss + torch.sum(ce * act.float()) / torch.clamp(counts[t], min=1.0)
        return loss / t_len

    def loss_and_grads(self, params, batch: dict, rng: DropoutRng | None,
                       count_sum=None):
        """(loss, grads) of :meth:`episode_loss` for a trimmed batch."""
        loss, _, grads = self.value_and_grads(
            params, lambda p: (self.episode_loss(p, batch, rng, count_sum), None))
        return loss, grads

    def train_step_fn(self):
        """``run(state, batch) -> (state, loss)``: one teacher-forced step
        with every dropout active, the global-norm clip and Adam."""

        def run(state, batch):
            batch = self.train_trim(batch)
            loss, grads = self.loss_and_grads(state["params"], batch, state["rng"],
                                              self._count_sum())
            state, logged = self.apply_grads(state, grads, {"loss": loss})
            return state, logged["loss"]

        return run

    # -- student-forced and RL training -----------------------------------------
    def sample_inputs(self, batch: dict) -> dict:
        """The device tensors a sampled or RL episode reads: the start rows
        and views, the goal rows, the teacher and distance columns and scan
        offsets of ``NavEpisodeBatcher.with_sample_teacher``, and the item
        index."""
        if "teacher_col" not in batch:
            raise KeyError("a sampled or RL episode needs the batch's teacher columns: "
                           "pass it through NavEpisodeBatcher.with_sample_teacher")
        out = {k: self._index(batch[k]) for k in ("start_rows", "start_views",
                                                  "goal_rows", "teacher_col",
                                                  "scan_offset")}
        out["dist_col"] = torch.as_tensor(np.asarray(batch["dist_col"], np.float32)
                                          ).to(self.device)
        out["item"] = torch.arange(out["start_rows"].shape[0], device=self.device)
        return out

    def teacher_slot(self, d: dict, cur_row, counts):
        """The shortest-path teacher at ``cur_row``, on the device: the slot
        of the candidate that is the next hop toward the goal (the first
        match; none, e.g. unreachable: slot 0, as jnp.argmax gives), the
        stop slot ``counts`` at the goal."""
        t_next = d["teacher_col"][d["item"], cur_row - d["scan_offset"]]
        match = (self.runtime.nbr[cur_row] == t_next[:, None]).to(torch.int32)
        return torch.where(cur_row == d["goal_rows"], counts, torch.argmax(match, dim=-1))

    def move(self, cur_row, view, ended, a, counts):
        """One transition on the device: items that have not ended and did
        not choose a stop slot (a >= count) move to candidate ``a``.
        Returns (row, view, stop)."""
        rt = self.runtime
        stop = a >= counts
        moved = ~ended & ~stop
        safe_a = torch.clamp(a, max=rt.max_candidates - 1)
        return (torch.where(moved, rt.nbr[cur_row, safe_a], cur_row),
                torch.where(moved, rt.point[cur_row, safe_a], view), stop)

    def sampled_episode_loss(self, params, batch: dict, rng: DropoutRng | None,
                             gen: torch.Generator | None, feedback: str = "sample",
                             count_sum=None):
        """Student-forced loss of a trimmed batch with teacher columns
        (reference feedback='sample' training, agent.py:406-425): the
        encoder, then :meth:`decode_sampled`.  ``rng`` None: no dropout;
        ``gen`` draws the sampled actions."""
        ctx, h1, c, ctx_mask = self.encode(params, batch, rng)
        return self.decode_sampled(params, self.sample_inputs(batch), ctx, h1, c,
                                   ctx_mask, rng, gen, feedback, count_sum)

    def decode_sampled(self, params, d: dict, ctx, h1, c, ctx_mask,
                       rng: DropoutRng | None, gen: torch.Generator | None,
                       feedback: str = "sample", count_sum=None):
        """The decoder half of :meth:`sampled_episode_loss` from the
        encoder's outputs and :meth:`sample_inputs`: ``episode_len`` steps,
        each a masked CE against the on-device teacher averaged over the
        items that have not ended, then the action of ``feedback`` and the
        transition; the loss is the sum of the step losses over T.
        ``count_sum`` as in :meth:`episode_loss`."""
        rt = self.runtime
        cur_row, view = d["start_rows"], d["start_views"]
        b = cur_row.shape[0]
        slots = torch.arange(rt.max_candidates + 1, device=self.device)
        ended = torch.zeros(b, dtype=torch.bool, device=self.device)
        taken = torch.zeros((b, slots.numel()), dtype=torch.bool, device=self.device)
        sums, n_active = [], []
        with tracing.span(tracing.DECODER):
            for _ in range(self.episode_len):
                logit, h1, c = self.decode_step(params, h1, c, ctx, ctx_mask, cur_row, view,
                                                rng=rng)
                logit = logit.float()
                counts = rt.count[cur_row]
                teacher = self.teacher_slot(d, cur_row, counts)
                active = (~ended).float()
                ce = F.cross_entropy(logit, teacher, reduction="none")
                sums.append(torch.sum(ce * active))
                n_active.append(active.sum())
                a = select_action(feedback, logit.detach(), gen, target=teacher,
                                  temperature=self.temperature, taken_mask=taken)
                taken = taken | (slots[None, :] == a[:, None])
                cur_row, view, stop = self.move(cur_row, view, ended, a, counts)
                ended = ended | stop
        n_active = torch.stack(n_active)
        if count_sum is not None:  # the global batch's (one all-reduce of T counts)
            n_active = count_sum(n_active)
        loss = torch.zeros((), device=self.device)
        for t, total in enumerate(sums):
            loss = loss + total / torch.clamp(n_active[t], min=1.0)
        return loss / self.episode_len

    def sample_train_step_fn(self, feedback: str = "sample"):
        """``run(state, batch) -> (state, loss)``: one student-forced step
        (actions by ``feedback``: sample, argmax, topk, nucleus, temperature,
        penalty or teacher) with every dropout active, the global-norm clip
        and Adam."""
        if feedback not in decoding.FEEDBACK_OPTIONS:
            raise ValueError(f"invalid feedback option {feedback!r}")

        def run(state, batch):
            batch = self.train_trim(batch)
            count_sum = self._count_sum()
            loss, _, grads = self.value_and_grads(state["params"], lambda p: (
                self.sampled_episode_loss(p, batch, state["rng"], state["sampler"],
                                          feedback, count_sum), None))
            state, logged = self.apply_grads(state, grads, {"loss": loss})
            return state, logged["loss"]

        return run

    def rl_episode_loss(self, params, batch: dict, rng: DropoutRng | None,
                        gen: torch.Generator | None, **opts):
        """Advantage actor-critic loss of a trimmed batch with teacher
        columns: the encoder, then :meth:`decode_rl` (``opts``: its gamma,
        ml_weight, entropy_weight, success_margin, success_bonus,
        count_sum).  Returns (total, aux)."""
        if "critic" not in params:
            raise KeyError("RL needs the critic's parameters: init_state(with_critic=True)")
        ctx, h1, c, ctx_mask = self.encode(params, batch, rng)
        return self.decode_rl(params, self.sample_inputs(batch), ctx, h1, c, ctx_mask,
                              rng, gen, **opts)

    def decode_rl(self, params, d: dict, ctx, h1, c, ctx_mask, rng: DropoutRng | None,
                  gen: torch.Generator | None, gamma: float = 0.9,
                  ml_weight: float = 0.05, entropy_weight: float = 0.01,
                  success_margin: float = 3.0, success_bonus: float = 3.0, count_sum=None):
        """The decoder half of :meth:`rl_episode_loss` (an extension beyond
        the reference, whose Critic ships unwired): ``episode_len`` steps,
        each drawing its action from the policy (``decoding.categorical``),
        with reward = progress toward the goal d_cur - d_new, or
        +-``success_bonus`` on the first stop (+ within ``success_margin``
        metres of the goal), for the items that have not ended.  Discounted
        returns at ``gamma``; total = policy loss (advantage from the critic
        on h_tilde, detached) + 0.5 critic loss - ``entropy_weight`` entropy
        + ``ml_weight`` teacher CE, each averaged over the active steps
        (``count_sum`` as in :meth:`episode_loss`).  ``aux``: policy_loss, critic_loss, entropy, ml_loss, mean_return
        (detached device scalars)."""
        rt = self.runtime
        cur_row, view = d["start_rows"], d["start_views"]
        b = cur_row.shape[0]
        slots = torch.arange(rt.max_candidates + 1, device=self.device)
        ended = torch.zeros(b, dtype=torch.bool, device=self.device)
        steps = []
        with tracing.span(tracing.DECODER):
            for _ in range(self.episode_len):
                logit, h1, c = self.decode_step(params, h1, c, ctx, ctx_mask, cur_row, view,
                                                rng=rng)
                logit = logit.float()
                counts = rt.count[cur_row]
                teacher = self.teacher_slot(d, cur_row, counts)
                logp_all = F.log_softmax(logit, dim=-1)
                # The product is masked, not only its inputs: no NaN reaches a
                # gradient through the masked slots.
                plogp = (logp_all.exp() * logp_all).masked_fill(
                    slots[None, :] > counts[:, None], 0.0)
                entropy = -torch.sum(plogp, dim=-1)
                a = decoding.categorical(logit.detach(), gen)
                logp = torch.gather(logp_all, 1, a[:, None])[:, 0]
                value = functional_call(self.critic, params["critic"], (h1.float(),),
                                        {"rng": rng}, strict=True)
                ce = F.cross_entropy(logit, teacher, reduction="none")
                active = (~ended).float()
                new_row, view, stop = self.move(cur_row, view, ended, a, counts)
                d_cur = d["dist_col"][d["item"], cur_row - d["scan_offset"]]
                d_new = d["dist_col"][d["item"], new_row - d["scan_offset"]]
                bonus = success_bonus * (2.0 * (d_cur < success_margin).float() - 1.0)
                reward = torch.where(~ended & stop, bonus, d_cur - d_new) * active
                steps.append((logp, value, reward, active, entropy, ce))
                cur_row, ended = new_row, ended | stop
        logp, value, reward, active, entropy, ce = (torch.stack(x) for x in zip(*steps))
        # Discounted returns by a reverse loop: R_t = r_t + gamma R_{t+1}.
        ret, returns = torch.zeros(b, device=self.device), []
        for r in reward.flip(0):
            ret = r + gamma * ret
            returns.append(ret)
        returns = torch.stack(returns[::-1])
        n = active.sum()
        n = torch.clamp(n if count_sum is None else count_sum(n), min=1.0)
        adv = (returns - value).detach()
        policy_loss = -torch.sum(logp * adv * active) / n
        critic_loss = torch.sum((returns - value) ** 2 * active) / n
        ent = torch.sum(entropy * active) / n
        ml = torch.sum(ce * active) / n
        total = policy_loss + 0.5 * critic_loss - entropy_weight * ent + ml_weight * ml
        aux = {"policy_loss": policy_loss, "critic_loss": critic_loss, "entropy": ent,
               "ml_loss": ml, "mean_return": torch.sum(returns * active) / n}
        return total, {k: v.detach() for k, v in aux.items()}

    def rl_train_step_fn(self, gamma: float = 0.9, ml_weight: float = 0.05,
                         entropy_weight: float = 0.01):
        """``run(state, batch) -> (state, (loss, aux))``: one A2C step with
        every dropout active, the global-norm clip and Adam (``state`` from
        ``init_state(with_critic=True)``)."""

        def run(state, batch):
            batch = self.train_trim(batch)
            count_sum = self._count_sum()
            loss, aux, grads = self.value_and_grads(state["params"], lambda p: (
                self.rl_episode_loss(p, batch, state["rng"], state["sampler"],
                                     gamma=gamma, ml_weight=ml_weight,
                                     entropy_weight=entropy_weight, count_sum=count_sum)))
            state, logged = self.apply_grads(state, grads, {"loss": loss, **aux})
            return state, (logged.pop("loss"), logged)

        return run

    def eval_loss_fn(self, use_dropout: bool = False):
        """Teacher-forced validation loss, no gradient (test(use_dropout,
        feedback='teacher') parity, train.py:318-320): ``run(params, batch,
        rng=None)``; ``use_dropout`` needs the ``rng``."""

        def run(params, batch, rng: DropoutRng | None = None):
            if use_dropout and rng is None:
                raise ValueError("eval_loss_fn(use_dropout=True) needs an rng")
            with torch.no_grad():
                return self.episode_loss(params, self.trim_batch(batch),
                                         rng if use_dropout else None,
                                         **self._eval_kw())

        return run

    # -- student-forced rollout --------------------------------------------------
    def device_rollout(self, params, batch: dict, feedback: str = "argmax",
                       generator: torch.Generator | None = None):
        """Encode + ``episode_len`` decode/act steps, all on the device, with
        no host read-back; ``generator`` draws the sampled actions.  Returns
        (rows, views, moved, logits) tensors of shape (B, T) (logits
        (B, T, K+1)) for a trimmed batch."""
        ctx, h1, c, ctx_mask = self.encode(params, batch, **self._eval_kw())
        return self.decode_rollout(params, ctx, h1, c, ctx_mask,
                                   self._index(batch["start_rows"]),
                                   self._index(batch["start_views"]), feedback, generator)

    def decode_rollout(self, params, ctx, h1, c, ctx_mask, cur_row, view,
                       feedback: str = "argmax", generator: torch.Generator | None = None):
        """The decoder half of :meth:`device_rollout`: ``episode_len``
        decode/act steps from the encoder's outputs and the start rows and
        views, already on the device."""
        rt = self.runtime
        b = ctx.shape[0]
        slots = torch.arange(rt.max_candidates + 1, device=self.device)
        ended = torch.zeros(b, dtype=torch.bool, device=self.device)
        taken = torch.zeros((b, slots.numel()), dtype=torch.bool, device=self.device)
        rows, views, moved_all, logits = [], [], [], []
        for _ in range(self.episode_len):
            logit, h1, c = self.decode_step(params, h1, c, ctx, ctx_mask, cur_row, view)
            a = select_action(feedback, logit, generator, temperature=self.temperature,
                              taken_mask=taken)
            taken = taken | (slots[None, :] == a[:, None])
            nxt_row, view, stop = self.move(cur_row, view, ended, a, rt.count[cur_row])
            moved_all.append(~ended & ~stop)
            cur_row, ended = nxt_row, ended | stop
            rows.append(cur_row)
            views.append(view)
            logits.append(logit)
        return (torch.stack(rows, 1), torch.stack(views, 1),
                torch.stack(moved_all, 1), torch.stack(logits, 1))

    def rollout_student_on_device(self, params, batch: dict, feedback: str = "argmax",
                                  generator: torch.Generator | None = None):
        """Trajectory rollout with ONE host read-back per batch."""
        rt = self.runtime
        batch = self.trim_batch(batch)
        rows, views, moved, _ = self.device_rollout(params, batch, feedback, generator)
        rows, views, moved = rows.cpu().numpy(), views.cpu().numpy(), moved.cpu().numpy()
        traj = []
        for i in range(rows.shape[0]):
            scan, vp = rt.row_to_id(int(batch["start_rows"][i]))
            v0 = int(batch["start_views"][i])
            path = [(vp, geo.heading_of_view(v0), geo.elevation_of_view(v0))]
            for t in range(rows.shape[1]):
                if moved[i, t]:
                    scan, vp = rt.row_to_id(int(rows[i, t]))
                    path.append((vp, geo.heading_of_view(int(views[i, t])),
                                 geo.elevation_of_view(int(views[i, t]))))
            traj.append({"inst_idx": batch["inst_idx"][i], "path": path})
        return traj

    def rollout_student(self, params, batch: dict, feedback: str = "argmax",
                        generator: torch.Generator | None = None, submit: bool = False):
        """Student-forced episode with the host in the loop; returns
        trajectories [(viewpointId, heading, elevation)] starting at the start
        pose (agent.py:358-365,429-445).  ``submit`` masks candidates leading
        to visited viewpoints (agent.py:397-402)."""
        rt = self.runtime
        batch = self.trim_batch(batch)
        ctx, h1, c, ctx_mask = self.encode(params, batch, **self._eval_kw())
        b = len(batch["scans"])
        rows = np.asarray(batch["start_rows"], np.int32).copy()
        views = np.asarray(batch["start_views"], np.int32).copy()
        ended = np.zeros(b, bool)
        k1 = rt.max_candidates + 1
        visited_rows = [set([int(r)]) for r in rows]
        taken = np.zeros((b, k1), bool)
        traj = []
        for i in range(b):
            scan, vp = rt.row_to_id(int(rows[i]))
            traj.append({
                "inst_idx": batch["inst_idx"][i],
                "path": [(vp, geo.heading_of_view(int(views[i])),
                          geo.elevation_of_view(int(views[i])))],
            })
        for _ in range(self.episode_len):
            visited_mask = np.zeros((b, k1), bool)
            if submit:
                for i in range(b):
                    cand_rows = rt.nbr_h[rows[i]]
                    for slot in range(rt.max_candidates):
                        if cand_rows[slot] in visited_rows[i]:
                            visited_mask[i, slot] = True
            logit, h1, c = self.decode_step(
                params, h1, c, ctx, ctx_mask, self._index(rows), self._index(views),
                torch.as_tensor(visited_mask).to(self.device))
            a = select_action(feedback, logit, generator, temperature=self.temperature,
                              taken_mask=torch.as_tensor(taken).to(self.device)).cpu().numpy()
            taken[np.arange(b), np.minimum(a, k1 - 1)] = True
            for i in range(b):
                if ended[i]:
                    continue
                if a[i] >= rt.count_h[rows[i]]:  # stop slot
                    ended[i] = True
                    continue
                rows[i], views[i] = rt.step_to(int(rows[i]), int(a[i]))
                visited_rows[i].add(int(rows[i]))
                scan, vp = rt.row_to_id(int(rows[i]))
                traj[i]["path"].append(
                    (vp, geo.heading_of_view(int(views[i])),
                     geo.elevation_of_view(int(views[i]))))
            if ended.all():
                break
        return traj

    # -- test loop (loop-until-repeat parity, agent.py:49-63) ---------------------
    def test(self, params, batches, feedback: str = "argmax",
             generator: torch.Generator | None = None, submit: bool = False) -> dict:
        """{inst_idx: trajectory} of the student rollouts of ``batches``
        until an instance repeats; ``generator`` (None: one on the agent's
        device seeded with 1) draws the actions of the sampling strategies."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        self.results = {}
        looped = False
        with torch.inference_mode():
            for batch in batches:
                if submit:
                    trajs = self.rollout_student(params, batch, feedback, generator,
                                                 submit=True)
                else:
                    trajs = self.rollout_student_on_device(params, batch, feedback,
                                                           generator)
                for traj in trajs:
                    if traj["inst_idx"] in self.results:
                        looped = True
                    else:
                        self.results[traj["inst_idx"]] = traj["path"]
                if looped:
                    break
        return self.results
