"""Viewpoint-selection navigation agent: the NDH serving rollout and the
teacher-forced fine-tuning train step (visitron_tpu/agents/viewpoint.py;
reference tasks/viewpoint_select/agent.py:49-63, 358-472, 509-515).

``test(params, batches, feedback="argmax")`` is the serving entry point:

  * without ``submit`` each batch is one device rollout: the dialog is
    encoded once (BERT + LSTM), then a Python loop of ``episode_len``
    decode/act steps runs on the device, with actions and transitions
    computed there from the NavRuntime tables; the host reads the
    trajectory back once per batch;
  * with ``submit`` the host stays in the loop (one read-back per step) to
    mask candidates that lead to already visited viewpoints
    (agent.py:397-402).

``params`` are ``{"encoder": {name: tensor}, "decoder": {name: tensor}}``,
applied to the agent's modules with ``torch.func.functional_call``; make
them with :meth:`ViewpointAgent.init_params` or carry the JAX package's
across with ``visitron_torch.convert.convert_agent_params``.  The rollout
runs under ``torch.inference_mode``.

``train_step_fn()`` is the training entry point, driven over
``NavEpisodeBatcher.train_batches(n, episode_len=...)``: ``run(state, batch)
-> (state, loss)`` with ``state`` from :meth:`ViewpointAgent.init_state`
(params, the optimizer state and the dropout generators).  One step trims
the batch to its bucket, runs the encoder and ``episode_len`` teacher-forced
decoder steps with every dropout active, takes the gradients with
``torch.autograd.grad`` (the BERT attention and LayerNorms backward through
their kernels K1b and K2b), clips them and applies Adam.  The student-forced
and RL losses are not ported yet.
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
from visitron_torch.agents.decoding import select_action
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.models import AttnDecoderLSTM, BertConfig, OscarEncoder
from visitron_torch.models.layers import DropoutRng, init_module_params
from visitron_torch.ops.masking import NEG_INF
from visitron_torch.train.optim import (agent_optimizer, apply_updates, tree_leaves,
                                        tree_unflatten)


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
    # The base heading is rounded to the feature dtype, as in the JAX package.
    inc = torch.tensor(geo.ANGLE_INC, dtype=f_t.dtype, device=f_t.device)
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


@dataclass
class ViewpointAgent:
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
    seed: int = 88
    device: object = None  # None: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.runtime.device.type != self.device.type:
            raise ValueError(f"runtime tables are on {self.runtime.device}, "
                             f"the agent on {self.device}")
        self.encoder = OscarEncoder(
            self.cfg, hidden_size=self.encoder_hidden_size,
            decoder_hidden_size=self.rnn_dim,
            dropout_ratio=self.dropout).to(self.device).eval()
        self.decoder = AttnDecoderLSTM(
            angle_feat_size=self.angle_feat_size, embedding_size=self.aemb,
            hidden_size=self.rnn_dim,
            feature_size=self.feature_dim + self.angle_feat_size,
            ctx_size=self.encoder_hidden_size,
            dropout_ratio=self.dropout).to(self.device).eval()
        self.optimizer = agent_optimizer(self.learning_rate, self.optimizer_kind,
                                         self.max_grad_norm,
                                         bf16_moments=self.bf16_adam_moments)
        self.results: dict = {}

    # -- parameters ----------------------------------------------------------
    def init_params(self, seed: int | None = None) -> dict:
        """Fresh parameters from a CPU ``torch.Generator`` (so the same seed
        gives the same weights on every device), with the flax initialisers'
        distributions: normal(0.02) for BERT, U(+-1/sqrt(H)) for LSTMs,
        lecun_normal for the other Dense kernels, zero biases."""
        g = torch.Generator().manual_seed(self.seed if seed is None else seed)
        return {"encoder": init_module_params(self.encoder, g, self.device),
                "decoder": init_module_params(self.decoder, g, self.device)}

    def init_state(self) -> dict:
        """Training state: ``params`` (:meth:`init_params` at the agent's
        seed), ``opt_state`` and ``rng``, the dropout generators (masks on
        the agent's device, kernel seeds on the CPU, both seeded with
        seed + 1)."""
        params = self.init_params()
        rng = DropoutRng(
            masks=torch.Generator(device=self.device).manual_seed(self.seed + 1),
            seeds=torch.Generator().manual_seed(self.seed + 1))
        return {"params": params, "opt_state": self.optimizer.init(params), "rng": rng}

    # -- shared pieces ---------------------------------------------------------
    @staticmethod
    def trim_batch(batch: dict, bucket: int = 128) -> dict:
        """Trim dialog arrays to the batch's max length rounded up to a
        ``bucket`` multiple (padded keys are masked and the LSTM freezes at
        pads, so the result is unchanged)."""
        return trim_to_bucket(batch, int(batch["lengths"].max()), bucket)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64).to(self.device)

    def encode(self, params, batch: dict, rng: DropoutRng | None = None):
        """(ctx, h0, c0, ctx_mask) for a trimmed batch; ``rng`` turns the
        encoder's dropouts on."""
        ids, segs = self._index(batch["ids"]), self._index(batch["segs"])
        lengths = self._index(batch["lengths"])
        ctx, h, c = functional_call(self.encoder, params["encoder"], (ids, lengths),
                                    {"token_type_ids": segs, "rng": rng}, strict=True)
        ctx_mask = torch.arange(ids.shape[1], device=self.device)[None, :] >= lengths[:, None]
        return ctx, h, c, ctx_mask

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
    def episode_loss(self, params, batch: dict, rng: DropoutRng | None = None):
        """Mean teacher-forced loss of a trimmed batch with teacher arrays
        (agent.py:406-412, 469-472): the encoder, then T decoder steps fed
        the teacher's states; each step's masked CE is averaged over its
        active items (n = max(sum(active), 1)), and the loss is the sum of
        the step losses over T.  ``rng`` None: no dropout."""
        ctx, h1, c, ctx_mask = self.encode(params, batch, rng)
        return self.teacher_forced_loss(params, batch, ctx, h1, c, ctx_mask, rng)

    def teacher_forced_loss(self, params, batch: dict, ctx, h1, c, ctx_mask,
                            rng: DropoutRng | None = None):
        """The decoder half of :meth:`episode_loss`: T teacher-forced steps
        from the encoder's outputs, and the mean of the step losses."""
        cur_row, view = self._index(batch["cur_row"]), self._index(batch["view"])
        teacher = self._index(batch["teacher"])
        active = torch.as_tensor(np.asarray(batch["active"], bool)).to(self.device)
        t_len = cur_row.shape[1]
        loss = torch.zeros((), device=self.device)
        for t in range(t_len):
            logit, h1, c = self.decode_step(params, h1, c, ctx, ctx_mask,
                                            cur_row[:, t], view[:, t], rng=rng)
            act = active[:, t]
            ce = F.cross_entropy(logit.float(), torch.where(act, teacher[:, t], 0),
                                 reduction="none")
            weight = act.float()
            loss = loss + torch.sum(ce * weight) / torch.clamp(weight.sum(), min=1.0)
        return loss / t_len

    def loss_and_grads(self, params, batch: dict, rng: DropoutRng | None):
        """(loss, grads) of :meth:`episode_loss` for a trimmed batch; grads
        mirror ``params`` (zeros where a parameter takes no part, as in JAX)."""
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = self.episode_loss(tree_unflatten(params, live), batch, rng)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    def train_step_fn(self):
        """``run(state, batch) -> (state, loss)``: one teacher-forced step
        with every dropout active, the global-norm clip and Adam."""

        def run(state, batch):
            batch = self.trim_batch(batch)
            loss, grads = self.loss_and_grads(state["params"], batch, state["rng"])
            updates, opt_state = self.optimizer.update(grads, state["opt_state"],
                                                       state["params"])
            params = apply_updates(state["params"], updates)
            return {"params": params, "opt_state": opt_state, "rng": state["rng"]}, loss

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
                                         rng if use_dropout else None)

        return run

    # -- student-forced rollout --------------------------------------------------
    def device_rollout(self, params, batch: dict, feedback: str = "argmax"):
        """Encode + ``episode_len`` decode/act steps, all on the device, with
        no host read-back.  Returns (rows, views, moved, logits) tensors of
        shape (B, T) (logits (B, T, K+1)) for a trimmed batch."""
        rt = self.runtime
        ctx, h1, c, ctx_mask = self.encode(params, batch)
        b = ctx.shape[0]
        cur_row = self._index(batch["start_rows"])
        view = self._index(batch["start_views"])
        ended = torch.zeros(b, dtype=torch.bool, device=self.device)
        rows, views, moved_all, logits = [], [], [], []
        for _ in range(self.episode_len):
            logit, h1, c = self.decode_step(params, h1, c, ctx, ctx_mask, cur_row, view)
            a = select_action(feedback, logit)
            stop = a >= rt.count[cur_row]
            moved = ~ended & ~stop
            safe_a = torch.clamp(a, max=rt.max_candidates - 1)
            nxt_row = rt.nbr[cur_row, safe_a]
            nxt_view = rt.point[cur_row, safe_a]
            cur_row = torch.where(moved, nxt_row, cur_row)
            view = torch.where(moved, nxt_view, view)
            ended = ended | stop
            rows.append(cur_row)
            views.append(view)
            moved_all.append(moved)
            logits.append(logit)
        return (torch.stack(rows, 1), torch.stack(views, 1),
                torch.stack(moved_all, 1), torch.stack(logits, 1))

    def rollout_student_on_device(self, params, batch: dict, feedback: str = "argmax"):
        """Trajectory rollout with ONE host read-back per batch."""
        rt = self.runtime
        batch = self.trim_batch(batch)
        rows, views, moved, _ = self.device_rollout(params, batch, feedback)
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
                        submit: bool = False):
        """Student-forced episode with the host in the loop; returns
        trajectories [(viewpointId, heading, elevation)] starting at the start
        pose (agent.py:358-365,429-445).  ``submit`` masks candidates leading
        to visited viewpoints (agent.py:397-402)."""
        rt = self.runtime
        batch = self.trim_batch(batch)
        ctx, h1, c, ctx_mask = self.encode(params, batch)
        b = len(batch["scans"])
        rows = np.asarray(batch["start_rows"], np.int32).copy()
        views = np.asarray(batch["start_views"], np.int32).copy()
        ended = np.zeros(b, bool)
        k1 = rt.max_candidates + 1
        visited_rows = [set([int(r)]) for r in rows]
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
            a = select_action(feedback, logit).cpu().numpy()
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
             submit: bool = False) -> dict:
        self.results = {}
        looped = False
        with torch.inference_mode():
            for batch in batches:
                if submit:
                    trajs = self.rollout_student(params, batch, feedback=feedback,
                                                 submit=True)
                else:
                    trajs = self.rollout_student_on_device(params, batch,
                                                           feedback=feedback)
                for traj in trajs:
                    if traj["inst_idx"] in self.results:
                        looped = True
                    else:
                        self.results[traj["inst_idx"]] = traj["path"]
                if looped:
                    break
        return self.results

    def write_results(self, path: str) -> None:
        output = [{"inst_idx": k, "trajectory": v} for k, v in self.results.items()]
        with open(path, "w") as f:
            json.dump(output, f)
