"""Packed fused self-attention (K1): the Hopper kernels' wrappers (forward
K1f and backward K1b), their plain PyTorch twins, the autograd Function that
joins them, the (B, H, S, D) ``multi_head_attention`` core and the
position-hash dropout helpers.

Counterpart of visitron_tpu/ops/attention.py: ``fused_attention_packed``
(Pallas ``_fused_packed_fwd_kernel`` and, through its custom VJP,
``_fused_packed_bwd_kernel``), ``multi_head_attention`` and ``_keep_mask`` /
``_threshold`` / ``_mix_seed``.  The kernels live in ``csrc/attention.cu``.

Dropout on the attention probabilities is a counter-based hash of the
absolute (query, key) position inside each head (murmur3 finaliser), seeded
with ``seed ^ (head_id * 0xC2B2AE3D)`` where head_id = b*H + h.  A value is
kept when the hash is >= ``_threshold(rate)``, and kept values are scaled by
1/(1 - rate).  The masks equal the JAX package's bit for bit.

``fused_attention_packed`` takes the plain twins only for tensors on the CPU.
For a CUDA tensor it launches the kernels or raises; there is no fallback.
When a gradient is needed it records ``_PackedAttention``, whose forward also
keeps the lse and whose backward runs K1b (``fused_attention_packed_bwd``).
The twins compute in fp32, or in fp64 for fp64 inputs (gradcheck).
"""

from __future__ import annotations

import torch

from visitron_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The twins' arithmetic type: fp32 for bf16/fp32, fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def multi_head_attention(q, k, v, bias=None, dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None):
    """q: (B, H, Q, D); k/v: (B, H, K, D); bias: broadcastable to (B, H, Q, K).

    Softmax in fp32; probabilities cast to v's dtype.  ``dropout_rate`` > 0
    drops probabilities with a Bernoulli draw from ``generator`` (torch
    semantics, scaled by 1/(1 - rate)); it cannot reproduce jax.random's bits.
    """
    depth = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / (depth ** 0.5)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout_rate > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_rate
        probs = probs * keep.to(v.dtype) / (1.0 - dropout_rate)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


# -- position-hash dropout ---------------------------------------------------
#
# The hash is uint32 arithmetic.  PyTorch's uint32 support on the CPU is thin,
# so the twin holds uint32 values in int64 and masks to 32 bits after every
# step.  The product of two 32-bit values does not fit a signed int64, so
# ``_mul32`` splits the constant into 16-bit halves: no partial product
# exceeds 2**48, and the low 32 bits are exact.

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding uint32 values."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _keep_mask(seed_u32, row0: int, col0: int, shape, threshold: int,
               device=None) -> torch.Tensor:
    """Keep mask of the (rows, cols) block at (row0, col0) of a head.

    ``seed_u32``: an int or an int64 tensor of per-head seeds (any leading
    shape); the result has shape ``seed.shape + shape``."""
    seed = torch.as_tensor(seed_u32, dtype=torch.int64, device=device) & _M32
    r = (torch.arange(shape[0], dtype=torch.int64, device=seed.device) + row0) & _M32
    c = (torch.arange(shape[1], dtype=torch.int64, device=seed.device) + col0) & _M32
    x = _mul32(r, 0x9E3779B1)[:, None] ^ _mul32(c, 0x85EBCA77)[None, :]
    x = x ^ seed[..., None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= threshold


def _threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def _mix_seed(seed: int, bh) -> torch.Tensor:
    """Per-head seed: seed ^ (head_id * 0xC2B2AE3D) in uint32."""
    bh = torch.as_tensor(bh, dtype=torch.int64) & _M32
    return (int(seed) & _M32) ^ _mul32(bh, 0xC2B2AE3D)


# -- K1: packed fused attention ----------------------------------------------

def _split_heads(t, num_heads: int, dtype):
    b, s, hd = t.shape
    return t.reshape(b, s, num_heads, hd // num_heads).permute(0, 2, 1, 3).to(dtype)


def _merge_heads(t, dtype):
    b, h, s, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * d).to(dtype)


def _head_keep_mask(seed, b: int, h: int, s: int, rate: float, device):
    """(B, H, S, S) keep mask of every head, head id b*H + h."""
    bh = torch.arange(b * h, device=device).reshape(b, h)
    return _keep_mask(_mix_seed(seed, bh).to(device), 0, 0, (s, s), _threshold(rate))


def fused_attention_packed_reference(q, k, v, key_bias, num_heads: int,
                                     seed=None, rate: float = 0.0,
                                     need_lse: bool = False):
    """Plain twin of the packed kernel: (B, S, H*D) q/k/v, (B, S) key bias.

    The TPU kernel's math, one head at a time in full rows: fp32 scores,
    p = exp(s - max), a = p * (1/l), hash dropout, a cast to v's dtype, fp32
    PV product, output in q's dtype; ``need_lse`` adds (B*H, S) fp32 lse."""
    b, s, hd = q.shape
    h = num_heads
    d = hd // h
    ct = _compute_dtype(q.dtype)
    scores = torch.matmul(_split_heads(q, h, ct),
                          _split_heads(k, h, ct).transpose(-1, -2)) * (1.0 / (d ** 0.5))
    scores = scores + key_bias.to(ct)[:, None, None, :]
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    a = p * (1.0 / l)[..., None]
    if rate > 0.0:
        keep = _head_keep_mask(seed, b, h, s, rate, q.device)
        a = torch.where(keep, a, 0.0) * (1.0 / (1.0 - rate))
    a = a.to(v.dtype).to(ct)
    out = _merge_heads(torch.matmul(a, _split_heads(v, h, ct)), q.dtype)
    if need_lse:
        return out, (m + torch.log(l)).reshape(b * h, s)
    return out


def fused_attention_packed_bwd_reference(q, k, v, key_bias, dout, lse,
                                         num_heads: int, seed=None,
                                         rate: float = 0.0):
    """Plain twin of the backward kernel: (dq, dk, dv) in q's dtype from the
    forward's inputs, the output gradient ``dout`` and the lse.

    The TPU kernel's formula line for line (_fused_packed_bwd_kernel), one
    head at a time in full rows: a = exp(s - lse), dp = dO v^T, the mask and
    the 1/(1-r) scale on a_eff and da, dv = a_eff^T dO, D_i = sum(a_eff dp),
    ds = a (da - D_i) scale cast to q's dtype, dq = ds k, dk = ds^T q."""
    b, s, hd = q.shape
    h = num_heads
    d = hd // h
    ct = _compute_dtype(q.dtype)
    sm_scale = 1.0 / (d ** 0.5)
    qh, kh, vh, doh = (_split_heads(t, h, ct) for t in (q, k, v, dout))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    scores = scores + key_bias.to(ct)[:, None, None, :]
    a = torch.exp(scores - lse.reshape(b, h, s, 1).to(ct))
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    if rate > 0.0:
        keep = _head_keep_mask(seed, b, h, s, rate, q.device)
        inv_keep = 1.0 / (1.0 - rate)
        a_eff = torch.where(keep, a, 0.0) * inv_keep
        da = torch.where(keep, dp, 0.0) * inv_keep
    else:
        a_eff, da = a, dp
    dv = torch.matmul(a_eff.to(dout.dtype).to(ct).transpose(-1, -2), doh)
    d_i = torch.sum(a_eff * dp, dim=-1, keepdim=True)
    ds = (a * (da - d_i) * sm_scale).to(q.dtype).to(ct)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_merge_heads(t, q.dtype) for t in (dq, dk, dv))


def _check_cuda(q, k, v, key_bias, num_heads: int, rate: float) -> int:
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_packed: unsupported device {q.device}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_attention_packed: q, k, v must share one "
                         "(B, S, H*D) shape")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused_attention_packed: dtype {q.dtype} not supported "
                         "(fp32 or bf16, the same for q, k, v)")
    b, s, hd = q.shape
    if hd % num_heads:
        raise ValueError(f"fused_attention_packed: {hd} not divisible by {num_heads} heads")
    d = hd // num_heads
    if d not in (64, 128):
        raise ValueError(f"fused_attention_packed: head dim {d} not in (64, 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"fused_attention_packed: {name} must be on "
                             f"{q.device} with a contiguous last dim")
        # The bf16 kernel reads rows as 16-byte vectors.
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or t.stride(0) % 8
                                          or t.stride(1) % 8):
            raise ValueError(f"fused_attention_packed: bf16 {name} needs a 16-byte "
                             "aligned base and row strides that are multiples of 8")
    if (key_bias.dtype != torch.float32 or key_bias.shape != (b, s)
            or not key_bias.is_contiguous() or key_bias.device != q.device):
        raise ValueError("fused_attention_packed: key_bias must be a contiguous "
                         f"fp32 ({b}, {s}) tensor on {q.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"fused_attention_packed: rate {rate} not in [0, 1)")
    return d


def _forward(q, k, v, key_bias, num_heads: int, seed, rate: float,
             need_lse: bool):
    """K1f, or its twin for CPU tensors; returns (out, lse or None)."""
    if q.device.type == "cpu":
        if need_lse:
            return fused_attention_packed_reference(q, k, v, key_bias, num_heads,
                                                    seed, rate, need_lse=True)
        return fused_attention_packed_reference(q, k, v, key_bias, num_heads,
                                                seed, rate), None
    d = _check_cuda(q, k, v, key_bias, num_heads, rate)
    lib = _build.load()
    b, s, hd = q.shape
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * num_heads, s), dtype=torch.float32, device=q.device)
           if need_lse else None)
    err = lib.vt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, s, num_heads, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), _DTYPE_CODES[q.dtype],
        0 if seed is None else int(seed) & _M32, _threshold(rate),
        1.0 / (1.0 - rate), int(rate > 0.0), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fused_attention_packed")
    fused_attention_packed.launches += 1
    return out, lse


class _PackedAttention(torch.autograd.Function):
    """K1f forward with the lse kept; K1b backward.  Saves q, k, v (views of
    the caller's tensors), the key bias and the lse; the seed and rate ride
    on ctx.  The key bias gets no gradient
    (_fused_packed_bwd_rule returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, num_heads, seed, rate):
        out, lse = _forward(q, k, v, key_bias, num_heads, seed, rate, need_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, lse)
        ctx.num_heads, ctx.seed, ctx.rate = num_heads, seed, rate
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_bias, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_packed_bwd(
            q, k, v, key_bias, dout.contiguous(), lse, ctx.num_heads, ctx.seed,
            ctx.rate)
        return dq, dk, dv, None, None, None, None


def fused_attention_packed(q, k, v, key_bias, num_heads: int, seed=None,
                           rate: float = 0.0, need_lse: bool = False):
    """Self-attention on packed (B, S, H*D) q/k/v with a (B, S) additive key
    bias; returns (B, S, H*D) in q's dtype, and (B*H, S) fp32 lse when
    ``need_lse``.  q/k/v may be strided views (e.g. of one fused QKV
    projection) as long as their last dim is contiguous.  Differentiable in
    q, k and v (K1b)."""
    if rate > 0.0 and seed is None:
        raise ValueError(
            "fused_attention_packed: rate > 0 requires an explicit seed")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _PackedAttention.apply(q, k, v, key_bias, num_heads, seed, rate)
    else:
        out, lse = _forward(q, k, v, key_bias, num_heads, seed, rate, need_lse)
    return (out, lse) if need_lse else out


fused_attention_packed.launches = 0


def fused_attention_packed_bwd(q, k, v, key_bias, dout, lse, num_heads: int,
                               seed=None, rate: float = 0.0):
    """(dq, dk, dv) of :func:`fused_attention_packed`, contiguous (B, S, H*D)
    in q's dtype, from the forward's inputs, the output gradient ``dout`` and
    the forward's lse.  CPU tensors take
    :func:`fused_attention_packed_bwd_reference`; CUDA tensors launch K1b
    (two kernels: dq with D_i, then dk/dv) or raise."""
    if rate > 0.0 and seed is None:
        raise ValueError(
            "fused_attention_packed_bwd: rate > 0 requires an explicit seed")
    if q.device.type == "cpu":
        return fused_attention_packed_bwd_reference(q, k, v, key_bias, dout, lse,
                                                    num_heads, seed, rate)
    d = _check_cuda(q, k, v, key_bias, num_heads, rate)
    b, s, hd = q.shape
    if (dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device
            or not dout.is_contiguous() or dout.data_ptr() % 16):
        raise ValueError("fused_attention_packed_bwd: dout must be a contiguous, "
                         f"16-byte aligned {tuple(q.shape)} {q.dtype} tensor on "
                         f"{q.device}")
    if (lse.shape != (b * num_heads, s) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("fused_attention_packed_bwd: lse must be a contiguous "
                         f"fp32 ({b * num_heads}, {s}) tensor on {q.device}")
    lib = _build.load()
    dq, dk, dv = (torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b * num_heads, s), dtype=torch.float32, device=q.device)
    err = lib.vt_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        b, s, num_heads, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), _DTYPE_CODES[q.dtype],
        0 if seed is None else int(seed) & _M32, _threshold(rate),
        1.0 / (1.0 - rate), int(rate > 0.0), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fused_attention_packed_bwd")
    fused_attention_packed_bwd.launches += 1
    return dq, dk, dv


fused_attention_packed_bwd.launches = 0
