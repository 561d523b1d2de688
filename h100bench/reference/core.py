"""Plain PyTorch building blocks of the reference: products in a chosen
precision, the dropout streams of a training step, LayerNorm, BERT and the
masked LSTM.  Imports nothing of the program.

Precision.  ``Prec("fp32")`` runs every product in float32 with TF32 off.
``Prec("fp8")`` is the control: every product's operands (and, in the
backward, the incoming gradient) are rounded to float8 e4m3 with one scale a
tensor (its largest magnitude to 448), the accumulation in float32, all
other arithmetic in float32: the step below the configuration's bfloat16.

Dropout.  A training step of the program draws its hidden-dropout masks
with ``torch.rand(shape, generator) >= rate`` from one device generator and
its attention kernels' seeds with ``torch.randint(0, 2**31 - 1)`` from one
CPU generator, both seeded with the trainer's seed + 1, in the order its
modules run.  :class:`Streams` draws the same, in that order, from the same
seeds, so the reference applies the same masks; the attention keep mask is
the kernels' position hash (a frozen copy of the program's plain twin).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9
E4M3_MAX = 448.0


def set_fp32_math() -> None:
    """Float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _to_e4m3(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _to_e4m3(a), _to_e4m3(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _to_e4m3(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # Undo broadcasting over leading dimensions.
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class Prec:
    """The products of one reference pass: ``"fp32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def mm(self, a, b):
        if self.kind == "fp8":
            return _Fp8Matmul.apply(a.float(), b.float())
        return torch.matmul(a.float(), b.float())

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b


# -- the attention kernels' position-hash dropout (frozen copy) --------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash_keep(seed: int, batch0: int, batch: int, heads: int, rows: int, cols: int,
              rate: float, device) -> torch.Tensor:
    """(batch, heads, rows, cols) keep mask of rows ``batch0``.. of a batch:
    murmur3's finaliser of the (query, key) position, seeded per head with
    seed ^ (head_id * 0xC2B2AE3D), head_id = b * heads + h; kept where the
    hash >= rate * 2**32."""
    bh = torch.arange(batch0 * heads, (batch0 + batch) * heads, device=device,
                      dtype=torch.int64).reshape(batch, heads)
    seed_u = (int(seed) & _M32) ^ _mul32(bh & _M32, 0xC2B2AE3D)
    r = torch.arange(rows, dtype=torch.int64, device=device)
    c = torch.arange(cols, dtype=torch.int64, device=device)
    x = _mul32(r, 0x9E3779B1)[:, None] ^ _mul32(c, 0x85EBCA77)[None, :]
    x = x ^ seed_u[..., None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= min(int(rate * 4294967296.0), 4294967295)


class Streams:
    """The dropout draws of one program step, in the program's order:
    ``mask(shape, rate)`` a hidden-dropout keep mask, ``seed()`` an attention
    kernel's seed.  ``seed`` is the trainer's seed (the generators take
    seed + 1); None draws nothing (no dropout)."""

    def __init__(self, seed: int | None, device):
        self.on, self.device = seed is not None, device
        if self.on:
            self.masks = torch.Generator(device=device).manual_seed(seed + 1)
            self.seeds = torch.Generator().manual_seed(seed + 1)

    def mask(self, shape, rate: float):
        if not self.on or rate == 0.0:
            return None
        return torch.rand(shape, generator=self.masks, device=self.device) >= rate

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.seeds))


def drop(x, keep, rate: float):
    return x if keep is None else x * keep.to(x.dtype) / (1.0 - rate)


def layer_norm(x, g, b, eps: float):
    """flax's fast-variance LayerNorm in float32."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


# -- BERT ----------------------------------------------------------------------

def bert_plan(st: Streams, batch: int, seq: int, cfg: dict, text: int | None = None,
              img: int = 0) -> dict:
    """The step's BERT draws in the program's order: the text embeddings'
    mask, the image embeddings' (``img`` slots), then per layer the
    attention seed and the two output masks."""
    h, p = cfg["hidden_size"], cfg["hidden_dropout_prob"]
    text = seq if text is None else text
    plan = {"emb": st.mask((batch, text, h), p),
            "img": st.mask((batch, img, h), p) if img else None, "layers": []}
    attn = cfg["attention_probs_dropout_prob"] > 0.0 and st.on
    for _ in range(cfg["num_hidden_layers"]):
        seed = st.seed() if attn else None
        plan["layers"].append((seed, st.mask((batch, seq, h), p), st.mask((batch, seq, h), p)))
    return plan


def _rows(keep, lo: int, hi: int):
    return None if keep is None else keep[lo:hi]


def bert(P: dict, pre: str, emb, key_bias, plan: dict, lo: int, hi: int, cfg: dict,
         prec: Prec):
    """The transformer stack on rows lo:hi of the step's batch; ``emb`` the
    (hi - lo, S, H) embeddings after their dropout, ``key_bias`` (hi - lo, S)."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    d, eps = h // heads, cfg["layer_norm_eps"]
    p, pa = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
    b, s = emb.shape[:2]
    x = emb
    for i, (seed, keep_a, keep_o) in enumerate(plan["layers"]):
        L = f"{pre}encoder.layer_{i}."
        qkv = prec.linear(x, P[L + "attention.qkv.weight"], P[L + "attention.qkv.bias"])
        q, k, v = (t.unflatten(-1, (heads, d)).transpose(1, 2) for t in qkv.split(h, -1))
        scores = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(d) + key_bias[:, None, None, :]
        probs = torch.softmax(scores, -1)
        if seed is not None:
            keep = hash_keep(seed, lo, b, heads, s, s, pa, x.device)
            probs = torch.where(keep, probs, 0.0) / (1.0 - pa)
        ctx = prec.mm(probs, v).transpose(1, 2).flatten(2)
        attn = prec.linear(ctx, P[L + "attention_output.weight"], P[L + "attention_output.bias"])
        x = layer_norm(drop(attn, _rows(keep_a, lo, hi), p) + x,
                       P[L + "attention_layer_norm.weight"], P[L + "attention_layer_norm.bias"], eps)
        inter = F.gelu(prec.linear(x, P[L + "intermediate.weight"], P[L + "intermediate.bias"]))
        out = prec.linear(inter, P[L + "output.weight"], P[L + "output.bias"])
        x = layer_norm(drop(out, _rows(keep_o, lo, hi), p) + x,
                       P[L + "output_layer_norm.weight"], P[L + "output_layer_norm.bias"], eps)
    return x


def text_embeddings(P: dict, pre: str, ids, segs, plan: dict, lo: int, hi: int, cfg: dict):
    """Word + position + token-type embeddings, LayerNorm, dropout."""
    pos = torch.arange(ids.shape[1], device=ids.device)
    e = (P[pre + "word_embeddings.weight"][ids] + P[pre + "embeddings.position_embeddings.weight"][pos]
         + P[pre + "embeddings.token_type_embeddings.weight"][segs])
    e = layer_norm(e, P[pre + "embeddings.layer_norm.weight"],
                   P[pre + "embeddings.layer_norm.bias"], cfg["layer_norm_eps"])
    return drop(e, _rows(plan["emb"], lo, hi), cfg["hidden_dropout_prob"])


def key_bias(valid) -> torch.Tensor:
    """(B, S) additive key bias: 0 where ``valid``, -1e9 elsewhere."""
    return (1.0 - valid.float()) * NEG_INF


# -- masked LSTM -----------------------------------------------------------------

def lstm(P: dict, pre: str, x, lengths, prec: Prec):
    """A unidirectional LSTM over (B, T, I) that freezes its state past each
    row's length: (outputs zero at pads, (h_last, c_last))."""
    b, t, _ = x.shape
    hid = P[pre + "wh"].shape[1]
    gx = prec.linear(x, P[pre + "wi"], P[pre + "bi"] + P[pre + "bh"])
    wh_t = P[pre + "wh"].t()
    h = torch.zeros(b, hid, device=x.device)
    c = torch.zeros(b, hid, device=x.device)
    valid = (torch.arange(t, device=x.device)[None, :] < lengths[:, None]).float()
    ys = []
    for i in range(t):
        gates = gx[:, i] + prec.mm(h, wh_t)
        gi, gf, gg, go = gates.chunk(4, -1)
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        m = valid[:, i, None]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        ys.append(h * m)
    return torch.stack(ys, 1), (h, c)


def lstm_cell(P: dict, pre: str, x, h, c, prec: Prec):
    gates = (prec.linear(x, P[pre + "wi"], P[pre + "bi"])
             + prec.linear(h, P[pre + "wh"], P[pre + "bh"]))
    gi, gf, gg, go = gates.chunk(4, -1)
    c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    return torch.sigmoid(go) * torch.tanh(c_new), c_new
