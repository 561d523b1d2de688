"""The NDH viewpoint agent in plain PyTorch: the world's candidates and
teacher worked out again from the benchmark's graphs, the Oscar encoder
(BERT, masked LSTM, decoder initial state), the AttnDecoderLSTM step, the
teacher-forced loss with its gradients, and the logits of a rollout along
given actions.  Imports nothing of the program.

Candidates.  From viewpoint u a neighbour n is seen at the view (of the 36:
12 headings x elevations -30/0/+30 degrees) whose camera direction is
angularly nearest to n among the views that hold n within half the
horizontal field of view; its features are that view's scene features and
[sin, cos] of its heading relative to the camera's base heading and of its
elevation.  A stop slot of zeros follows the neighbours.  The order of the
slots does not change the loss or a served action's logit, so the reference
keeps its own (neighbour index).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.core import (NEG_INF, Prec, Streams, bert, bert_plan, drop, key_bias,
                                      lstm, lstm_cell, text_embeddings)

VIEWS, PER_ROW = 36, 12
INC = math.pi / 6.0
VFOV, IMAGE_W, IMAGE_H = math.radians(60), 640, 480


def hfov() -> float:
    return 2.0 * math.atan(math.tan(VFOV / 2.0) * IMAGE_W / IMAGE_H)


def angle_feature(heading, elevation) -> np.ndarray:
    heading, elevation = np.asarray(heading, np.float64), np.asarray(elevation, np.float64)
    return np.stack([np.sin(heading), np.cos(heading), np.sin(elevation),
                     np.cos(elevation)], -1)


def view_heading(v):
    return (np.asarray(v) % PER_ROW) * INC


def view_elevation(v):
    return (np.asarray(v) // PER_ROW - 1) * INC


def start_view(heading: float) -> int:
    """The view a start heading snaps to, at elevation 0 (row 1)."""
    return PER_ROW + int(round(heading / INC)) % PER_ROW


class Candidates:
    """Per global row: neighbour rows, their best views, headings and
    elevations, padded to ``width`` slots."""

    def __init__(self, world):
        half = hfov() / 2.0 + 1e-9
        views = np.arange(VIEWS)
        cam_h, cam_e = view_heading(views), view_elevation(views)
        rows = []
        for si, sc in enumerate(world.scans):
            off = int(world.offsets[si])
            for u in range(len(sc.viewpoints)):
                nbrs = np.flatnonzero(sc.adjacency[u])
                d = sc.positions[nbrs] - sc.positions[u]
                head = (np.pi / 2.0 - np.arctan2(d[:, 1], d[:, 0])) % (2 * np.pi)
                elev = np.arctan2(d[:, 2], np.hypot(d[:, 0], d[:, 1]))
                rel_h = (head[:, None] - cam_h[None, :] + np.pi) % (2 * np.pi) - np.pi
                rel_e = elev[:, None] - cam_e[None, :]
                ang = np.where(np.abs(rel_h) <= half, np.hypot(rel_h, rel_e), np.inf)
                rows.append((nbrs + off, np.argmin(ang, 1), head, elev))
        self.width = max(len(r[0]) for r in rows)
        n = len(rows)
        self.count = np.array([len(r[0]) for r in rows])
        self.nbr = np.full((n, self.width), -1, np.int64)
        self.point = np.zeros((n, self.width), np.int64)
        self.heading = np.zeros((n, self.width))
        self.elev = np.zeros((n, self.width))
        for i, (nb, pt, hd, el) in enumerate(rows):
            k = len(nb)
            self.nbr[i, :k], self.point[i, :k], self.heading[i, :k], self.elev[i, :k] = nb, pt, hd, el

    def slot(self, row: int, target: int) -> int:
        """The slot of neighbour ``target`` of ``row``; -1 if it is none."""
        hit = np.flatnonzero(self.nbr[row, :self.count[row]] == target)
        return int(hit[0]) if len(hit) else -1


def teacher(world, cands: Candidates, ep, steps: int):
    """The teacher-forced episode of ``ep`` along shortest paths to its goal:
    (rows, views, slots, active), each (steps,); slot ``count`` is stop."""
    sc, off = world.scans[ep.scan], int(world.offsets[ep.scan])
    goal = ep.path[-1]
    u, view = ep.path[0], start_view(ep.heading)
    rows, views, slots, active = [], [], [], []
    ended = False
    for _ in range(steps):
        rows.append(off + u)
        views.append(view)
        if ended:
            slots.append(0)
            active.append(False)
            continue
        active.append(True)
        if u == goal:
            slots.append(int(cands.count[off + u]))
            ended = True
            continue
        nxt = int(sc.pred[goal, u])
        s = cands.slot(off + u, off + nxt)
        slots.append(s)
        view = int(cands.point[off + u, s])
        u = nxt
    return rows, views, slots, active


def step_inputs(table, cands: Candidates, rows, views, device):
    """(action angle feature (B, 4), panorama (B, 36, D + 4), candidates
    (B, W + 1, D + 4), invalid-slot mask (B, W + 1)) in float32."""
    rows_np, views_np = np.asarray(rows), np.asarray(views)
    pano = table[torch.as_tensor(rows_np, device=device)].float()
    base = view_heading(views_np)
    pano_af = angle_feature(view_heading(np.arange(VIEWS))[None, :] - base[:, None],
                            view_elevation(np.arange(VIEWS))[None, :].repeat(len(rows_np), 0))
    f_t = torch.cat([pano, torch.as_tensor(pano_af, dtype=torch.float32, device=device)], -1)
    a_t = torch.as_tensor(angle_feature(base, view_elevation(views_np)), dtype=torch.float32,
                          device=device)
    pt = torch.as_tensor(cands.point[rows_np], device=device)
    vis = torch.take_along_dim(pano, pt[:, :, None], 1)
    caf = angle_feature(cands.heading[rows_np] - base[:, None], cands.elev[rows_np])
    cand = torch.cat([vis, torch.as_tensor(caf, dtype=torch.float32, device=device)], -1)
    count = torch.as_tensor(cands.count[rows_np], device=device)
    k = torch.arange(cands.width, device=device)[None, :]
    cand = torch.where((k < count[:, None])[..., None], cand, 0.0)
    cand = torch.cat([cand, torch.zeros_like(cand[:, :1])], 1)
    invalid = torch.arange(cands.width + 1, device=device)[None, :] > count[:, None]
    return a_t, f_t, cand, invalid


def soft_dot(P, pre, h, context, prec: Prec, mask=None, tilde=True):
    """SoftDotAttention: (h_tilde or the attended context, logits)."""
    target = prec.linear(h, P[pre + "linear_in.weight"])
    logit = prec.mm(context, target[:, :, None])[:, :, 0]
    if mask is not None:
        logit = logit.masked_fill(mask, NEG_INF)
    attn = torch.softmax(logit, -1)
    weighted = prec.mm(attn[:, None, :], context)[:, 0]
    if tilde:
        return torch.tanh(prec.linear(torch.cat([weighted, h], -1),
                                      P[pre + "linear_out.weight"])), logit
    return weighted, logit


def decode_step(P, a_t, f_t, cand, h, c, ctx, ctx_mask, keeps, rate, prec: Prec):
    """One AttnDecoderLSTM step: (candidate logits, h_tilde, c_new);
    ``keeps`` the step's four dropout masks (or Nones)."""
    ka, kh, k1, kt = keeps
    a = drop(torch.tanh(prec.linear(a_t, P["decoder/embedding.weight"],
                                    P["decoder/embedding.bias"])), ka, rate)
    feat, _ = soft_dot(P, "decoder/feat_att_layer.", drop(h, kh, rate), f_t, prec, tilde=False)
    h1, c1 = lstm_cell(P, "decoder/lstm.", torch.cat([a, feat], -1), h, c, prec)
    h_tilde, _ = soft_dot(P, "decoder/attention_layer.", drop(h1, k1, rate), ctx, prec,
                          mask=ctx_mask)
    _, logit = soft_dot(P, "decoder/candidate_att_layer.", drop(h_tilde, kt, rate), cand,
                        prec, tilde=False)
    return logit, h_tilde, c1


def encode(P, ids, segs, lengths, plan, ctx_keep, lo, hi, cfg, agent, prec: Prec):
    """(ctx, h0, c0, ctx_mask) of rows lo:hi: BERT, the masked LSTM over its
    output, tanh(Dense(h_T)) and c_T."""
    pre = "encoder/bert.bert."
    emb = text_embeddings(P, pre, ids, segs, plan, lo, hi, cfg)
    valid = torch.arange(ids.shape[1], device=ids.device)[None, :] < lengths[:, None]
    seq = bert(P, pre, emb, key_bias(valid), plan, lo, hi, cfg, prec)
    ctx, (h_t, c_t) = lstm(P, "encoder/lstm.fwd.", seq, lengths, prec)
    h0 = torch.tanh(prec.linear(h_t, P["encoder/encoder_lstm2decoder_ht.weight"],
                                P["encoder/encoder_lstm2decoder_ht.bias"]))
    ctx = drop(ctx, None if ctx_keep is None else ctx_keep[lo:hi], agent["dropout"])
    return ctx, h0, c_t, ~valid


def dialog(episodes, device, bucket: int = 128):
    """(ids, segs, lengths) of episodes, trimmed to the longest rounded up to
    ``bucket``."""
    lengths = np.array([e.length for e in episodes])
    s = min(len(episodes[0].token_ids), -(-int(lengths.max()) // bucket) * bucket)
    ids = np.stack([e.token_ids[:s] for e in episodes]).astype(np.int64)
    segs = np.stack([e.segment_ids[:s] for e in episodes]).astype(np.int64)
    return tuple(torch.as_tensor(a, device=device) for a in (ids, segs, lengths))


def train_loss_grads(P, episodes, world, cands, table, steps, cfg, agent, seed, prec: Prec,
                     block: int, streams: Streams | None = None):
    """(loss, grads, row losses) of one teacher-forced step on ``episodes``
    with every dropout the program applies (``seed``: the agent's; None:
    none), the batch in blocks of ``block`` rows; ``P`` {"part/name": fp32
    leaf}; the row losses (rows, steps) float64, each active step's
    cross-entropy, NaN where the episode has ended."""
    device = table.device
    ids, segs, lengths = dialog(episodes, device)
    b, s = ids.shape
    st = streams or Streams(seed, device)
    rate = agent["dropout"]
    plan = bert_plan(st, b, s, cfg)
    ctx_keep = st.mask((b, s, agent["encoder_hidden_size"]), rate)
    dec_keeps = [tuple(st.mask(shape, rate) for shape in
                       ((b, agent["aemb"]), (b, agent["rnn_dim"]), (b, agent["rnn_dim"]),
                        (b, agent["rnn_dim"]))) for _ in range(steps)]
    eps = [teacher(world, cands, e, steps) for e in episodes]
    rows, views, slots, active = (np.array([e[i] for e in eps]) for i in range(4))
    counts = np.maximum(active.sum(0), 1.0)
    leaves = {k: v.detach().requires_grad_() for k, v in P.items()}
    grads = {k: torch.zeros_like(v) for k, v in P.items()}
    total = 0.0
    rows_ce = np.full((b, steps), np.nan)
    for lo in range(0, b, block):
        hi = min(b, lo + block)
        ctx, h, c, ctx_mask = encode(leaves, ids[lo:hi], segs[lo:hi], lengths[lo:hi], plan,
                                     ctx_keep, lo, hi, cfg, agent, prec)
        loss = torch.zeros((), device=device)
        for t in range(steps):
            a_t, f_t, cand, invalid = step_inputs(table, cands, rows[lo:hi, t], views[lo:hi, t],
                                                  device)
            keeps = tuple(None if k is None else k[lo:hi] for k in dec_keeps[t])
            logit, h, c = decode_step(leaves, a_t, f_t, cand, h, c, ctx, ctx_mask, keeps,
                                      rate, prec)
            logit = logit.masked_fill(invalid, NEG_INF)
            act = torch.as_tensor(active[lo:hi, t], device=device)
            tgt = torch.as_tensor(np.where(active[lo:hi, t], slots[lo:hi, t], 0), device=device)
            ce = F.cross_entropy(logit, tgt, reduction="none")
            rows_ce[lo:hi, t] = np.where(active[lo:hi, t], ce.detach().double().cpu().numpy(),
                                         np.nan)
            loss = loss + (ce * act).sum() / float(counts[t])
        loss = loss / steps
        used = [k for k in leaves if leaves[k].requires_grad]
        got = torch.autograd.grad(loss, [leaves[k] for k in used], allow_unused=True)
        for k, g in zip(used, got):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads, rows_ce


def walk(world, cands: Candidates, ep, actions, steps: int):
    """(rows, views, served slots) of the steps that ``ep`` serves when
    driven along ``actions`` (per step the row moved to, -1 for stop), at
    most ``steps``; a row that is no neighbour is served as slot -1 and ends
    the episode."""
    row, view = int(world.offsets[ep.scan]) + ep.path[0], start_view(ep.heading)
    rows, views, slots = [], [], []
    for target in actions[:steps]:
        n = int(cands.count[row])
        slot = n if target == -1 else cands.slot(row, target)
        rows.append(row)
        views.append(view)
        slots.append(slot)
        if target == -1 or slot < 0:
            break
        view, row = int(cands.point[row, slot]), target
    return rows, views, slots


@torch.no_grad()
def step_from(P, table, cands: Candidates, rows, views, h, c, ctx, ctx_mask, prec: Prec):
    """One decoder step without dropout at ``rows`` / ``views`` from the
    given recurrent state (h, c) and encoder context (``ctx_mask`` True at
    padding): (candidate logits (B, W + 1), h_tilde, c_new), float32."""
    a_t, f_t, cand, _ = step_inputs(table, cands, rows, views, table.device)
    return decode_step(P, a_t, f_t, cand, h.float(), c.float(), ctx.float(), ctx_mask,
                       (None,) * 4, 0.0, prec)


@torch.no_grad()
def rollout(P, episodes, walks, cands, table, cfg, agent, prec: Prec, block: int):
    """Each episode driven along its walk (:func:`walk`'s rows and views)
    from the reference's own encoder and recurrent state, with no dropout:
    per episode a dict of its served steps' candidate logits (valid slots, a
    float64 numpy vector each), the states carried into them (``h``,
    ``c``: (n, H) each), and its encoder context and mask."""
    device = table.device
    ids, segs, lengths = dialog(episodes, device)
    plan = bert_plan(Streams(None, device), ids.shape[0], ids.shape[1], cfg)
    out = []
    for lo in range(0, len(episodes), block):
        hi = min(len(episodes), lo + block)
        ctx, h, c, ctx_mask = encode(P, ids[lo:hi], segs[lo:hi], lengths[lo:hi], plan, None,
                                     lo, hi, cfg, agent, prec)
        block_walks = walks[lo:hi]
        recs = [{"logits": [], "h": [], "c": [], "ctx": ctx[i], "ctx_mask": ctx_mask[i]}
                for i in range(hi - lo)]
        for t in range(max(len(w[0]) for w in block_walks)):
            # An episode that has ended repeats its last pose, unrecorded.
            at = [min(t, len(w[0]) - 1) for w in block_walks]
            rows = [w[0][k] for w, k in zip(block_walks, at)]
            views = [w[1][k] for w, k in zip(block_walks, at)]
            a_t, f_t, cand, _ = step_inputs(table, cands, rows, views, device)
            logit, h_new, c_new = decode_step(P, a_t, f_t, cand, h, c, ctx, ctx_mask,
                                              (None,) * 4, 0.0, prec)
            logit = logit.double().cpu().numpy()
            for i, (w, r) in enumerate(zip(block_walks, recs)):
                if t < len(w[0]):
                    r["logits"].append(logit[i, :int(cands.count[rows[i]]) + 1])
                    r["h"].append(h[i])
                    r["c"].append(c[i])
            h, c = h_new, c_new
        for r in recs:
            r["h"], r["c"] = torch.stack(r["h"]), torch.stack(r["c"])
        out.extend(recs)
    return out
