"""Viewpoint-selection navigation agent: the NDH serving rollout
(visitron_tpu/agents/viewpoint.py; reference tasks/viewpoint_select/
agent.py:49-63, 358-445).

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
across with ``visitron_torch.convert.convert_agent_params``.  Nothing runs
through autograd: the rollout runs under ``torch.inference_mode``.
Training (teacher forcing, losses, the optimizer) is not ported yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from visitron_torch import geometry as geo
from visitron_torch._device import resolve_device
from visitron_torch.agents.batcher import trim_to_bucket
from visitron_torch.agents.decoding import select_action
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.models import AttnDecoderLSTM, BertConfig, OscarEncoder
from visitron_torch.models.layers import init_module_params
from visitron_torch.ops.masking import NEG_INF


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
    seed: int = 88
    device: object = None  # None: the card

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.runtime.device.type != self.device.type:
            raise ValueError(f"runtime tables are on {self.runtime.device}, "
                             f"the agent on {self.device}")
        self.encoder = OscarEncoder(
            self.cfg, hidden_size=self.encoder_hidden_size,
            decoder_hidden_size=self.rnn_dim).to(self.device).eval()
        self.decoder = AttnDecoderLSTM(
            angle_feat_size=self.angle_feat_size, embedding_size=self.aemb,
            hidden_size=self.rnn_dim,
            feature_size=self.feature_dim + self.angle_feat_size,
            ctx_size=self.encoder_hidden_size).to(self.device).eval()
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

    # -- shared pieces ---------------------------------------------------------
    @staticmethod
    def trim_batch(batch: dict, bucket: int = 128) -> dict:
        """Trim dialog arrays to the batch's max length rounded up to a
        ``bucket`` multiple (padded keys are masked and the LSTM freezes at
        pads, so the result is unchanged)."""
        return trim_to_bucket(batch, int(batch["lengths"].max()), bucket)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int64).to(self.device)

    def encode(self, params, batch: dict):
        """(ctx, h0, c0, ctx_mask) for a trimmed batch."""
        ids, segs = self._index(batch["ids"]), self._index(batch["segs"])
        lengths = self._index(batch["lengths"])
        ctx, h, c = functional_call(self.encoder, params["encoder"], (ids, lengths),
                                    {"token_type_ids": segs}, strict=True)
        ctx_mask = torch.arange(ids.shape[1], device=self.device)[None, :] >= lengths[:, None]
        return ctx, h, c, ctx_mask

    def decode_step(self, params, h1, c, ctx, ctx_mask, cur_row, view,
                    visited_mask=None):
        """One decoder step from the runtime tables; returns (masked logit,
        h_tilde, c_new)."""
        a_t, f_t, cand_feat, cand_mask = gather_step_inputs(self.runtime, cur_row, view)
        _, c_new, logit, h_tilde = functional_call(
            self.decoder, params["decoder"],
            (a_t, f_t, cand_feat, h1, c, ctx, ctx_mask), strict=True)
        if visited_mask is not None:
            cand_mask = cand_mask | visited_mask
        return logit.masked_fill(cand_mask, NEG_INF), h_tilde, c_new

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
