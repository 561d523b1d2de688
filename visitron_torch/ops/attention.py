"""Attention: the Hopper kernels' wrappers for fused self-attention on the
packed layout (K1: forward K1f, backward K1b) and on the (B, H, S, D) layout
(K4: forward K4f, backward K4b), and for the blockwise flash attention of
long joint sequences (K5: forward K5f, backward K5b); their plain PyTorch
twins, the autograd Functions that join them, the shape gates, the
(B, H, S, D) ``multi_head_attention`` core and the position-hash dropout
helpers.

Counterpart of visitron_tpu/ops/attention.py: ``fused_attention_packed``
(Pallas ``_fused_packed_fwd_kernel`` and, through its custom VJP,
``_fused_packed_bwd_kernel``), ``fused_attention`` (``_fused_fwd_kernel`` /
``_fused_bwd_kernel``), ``flash_attention`` (``_fwd_kernel`` and, through
``_flash_bwd_rule``, ``_bwd_dkv_kernel`` / ``_bwd_dq_kernel``),
``attention_supports_fused`` / ``attention_supports_flash`` (without their
backend test), ``multi_head_attention`` and ``_keep_mask`` / ``_threshold``
/ ``_mix_seed``.  One set of CUDA kernels in ``csrc/attention.cu`` serves
every layout: each operand is read through its own (batch, head, sequence)
strides, and the query and key lengths are separate.  K1, K4 and K5 have
their own C entries, wrappers and launch counters.

Dropout on the attention probabilities is a counter-based hash of the
absolute (query, key) position inside each head (murmur3 finaliser), seeded
with ``seed ^ (head_id * 0xC2B2AE3D)`` where head_id = b*H + h in both
layouts.  A value is kept when the hash is >= ``_threshold(rate)``, and kept
values are scaled by 1/(1 - rate).  The masks equal the JAX package's bit
for bit.

The wrappers take the plain twins only for tensors on the CPU.  For a CUDA
tensor they launch the kernels or raise; there is no fallback.  When a
gradient is needed they record ``_PackedAttention`` / ``_Attention`` /
``_FlashAttention``, whose forward also keeps the lse and whose backward
runs K1b / K4b / K5b (K5 at rate 0 recomputes through the plain
``multi_head_attention`` instead, as ``_flash_bwd_rule`` does through XLA).
The twins compute in fp32, or in fp64 for fp64 inputs (gradcheck).
"""

from __future__ import annotations

import ctypes

import torch

from visitron_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The twins' arithmetic type: fp32 for bf16/fp32, fp64 for fp64."""
    return torch.promote_types(dtype, torch.float32)


def multi_head_attention(q, k, v, bias=None, dropout_rate: float = 0.0,
                         generator: torch.Generator | None = None,
                         head_block: tuple[int, int] | None = None):
    """q: (B, H, Q, D); k/v: (B, H, K, D); bias: broadcastable to (B, H, Q, K).

    Softmax in fp32; probabilities cast to v's dtype.  ``dropout_rate`` > 0
    drops probabilities with a Bernoulli draw from ``generator`` (torch
    semantics, scaled by 1/(1 - rate)); it cannot reproduce jax.random's bits.
    ``head_block`` (h0, heads): q's H heads are heads h0.. of a model's
    ``heads``; the draw covers all of them and keeps q's, so a rank of a
    tensor-parallel row drops what one device would.
    """
    depth = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / (depth ** 0.5)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout_rate > 0.0:
        shape = probs.shape if head_block is None else (
            probs.shape[0], head_block[1], *probs.shape[2:])
        keep = torch.rand(shape, generator=generator,
                          device=probs.device) >= dropout_rate
        if head_block is not None:
            keep = keep[:, head_block[0]:head_block[0] + probs.shape[1]]
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


# -- twins on (B, H, S, D) ----------------------------------------------------

def _split_heads(t, num_heads: int):
    """(B, S, H*D) -> a (B, H, S, D) view."""
    return t.unflatten(-1, (num_heads, t.shape[-1] // num_heads)).transpose(1, 2)


def _merge_heads(t):
    """(B, H, S, D) -> (B, S, H*D)."""
    return t.transpose(1, 2).flatten(2)


def _head_keep_mask(seed, b: int, h: int, s: int, rate: float, device,
                    cols: int | None = None):
    """(B, H, S, cols) keep mask of every head (cols = S by default), head
    id b*H + h."""
    bh = torch.arange(b * h, device=device).reshape(b, h)
    return _keep_mask(_mix_seed(seed, bh).to(device), 0, 0,
                      (s, s if cols is None else cols), _threshold(rate))


def fused_attention_reference(q, k, v, key_bias, seed=None, rate: float = 0.0,
                              need_lse: bool = False):
    """Plain twin of the fused kernels on (B, H, S, D) q/k/v with a (B, S)
    key bias (visitron_tpu/ops/attention.py:_fused_fwd_kernel).

    The TPU kernel's math, one head at a time in full rows: fp32 scores,
    p = exp(s - max), a = p * (1/l), hash dropout (head id b*H + h), a cast to
    v's dtype, fp32 PV product, output in q's dtype; ``need_lse`` adds
    (B*H, S) fp32 lse."""
    b, h, s, d = q.shape
    ct = _compute_dtype(q.dtype)
    scores = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * (1.0 / (d ** 0.5))
    scores = scores + key_bias.to(ct)[:, None, None, :]
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    a = p * (1.0 / l)[..., None]
    if rate > 0.0:
        keep = _head_keep_mask(seed, b, h, s, rate, q.device)
        a = torch.where(keep, a, 0.0) * (1.0 / (1.0 - rate))
    a = a.to(v.dtype).to(ct)
    out = torch.matmul(a, v.to(ct)).to(q.dtype)
    if need_lse:
        return out, (m + torch.log(l)).reshape(b * h, s)
    return out


def fused_attention_bwd_reference(q, k, v, key_bias, dout, lse, seed=None,
                                  rate: float = 0.0):
    """Plain twin of the backward kernels on (B, H, S, D): (dq, dk, dv) in
    q's dtype from the forward's inputs, the output gradient ``dout`` and the
    lse.

    The TPU kernel's formula line for line (_fused_bwd_kernel), one head at a
    time in full rows: a = exp(s - lse), dp = dO v^T, the mask and the
    1/(1-r) scale on a_eff and da, dv = a_eff^T dO, D_i = sum(a_eff dp),
    ds = a (da - D_i) scale cast to q's dtype, dq = ds k, dk = ds^T q."""
    b, h, s, d = q.shape
    ct = _compute_dtype(q.dtype)
    sm_scale = 1.0 / (d ** 0.5)
    qh, kh, vh, doh = (t.to(ct) for t in (q, k, v, dout))
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
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def fused_attention_packed_reference(q, k, v, key_bias, num_heads: int,
                                     seed=None, rate: float = 0.0,
                                     need_lse: bool = False):
    """Plain twin of the packed kernel: (B, S, H*D) q/k/v, (B, S) key bias;
    :func:`fused_attention_reference` on the heads."""
    res = fused_attention_reference(*(_split_heads(t, num_heads) for t in (q, k, v)),
                                    key_bias, seed, rate, need_lse)
    if need_lse:
        return _merge_heads(res[0]), res[1]
    return _merge_heads(res)


def fused_attention_packed_bwd_reference(q, k, v, key_bias, dout, lse,
                                         num_heads: int, seed=None,
                                         rate: float = 0.0):
    """Plain twin of the packed backward: (dq, dk, dv) as (B, S, H*D);
    :func:`fused_attention_bwd_reference` on the heads."""
    grads = fused_attention_bwd_reference(
        *(_split_heads(t, num_heads) for t in (q, k, v)), key_bias,
        _split_heads(dout, num_heads), lse, seed, rate)
    return tuple(_merge_heads(t) for t in grads)


def flash_attention_reference(q, k, v, key_bias, seed=None, rate: float = 0.0,
                              need_lse: bool = False):
    """Plain twin of the flash forward on q (B, H, Q, D) and k, v (B, H, K, D)
    with a (B, K) key bias (visitron_tpu/ops/attention.py:_fwd_kernel).

    The TPU kernel's math in full rows: fp32 scores s = q k^T / sqrt(D) +
    bias, p = exp(s - max) unnormalised, hash dropout at the absolute (q, k)
    coordinates (head id b*H + h) with the 1/(1 - rate) scale, p cast to v's
    dtype, fp32 PV product, out = acc * (1/l) in q's dtype, where l sums
    every p before the dropout and l == 0 counts as 1; ``need_lse`` adds
    (B*H, Q) fp32 lse = max + log(l)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    ct = _compute_dtype(q.dtype)
    scores = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * (1.0 / (d ** 0.5))
    scores = scores + key_bias.to(ct)[:, None, None, :]
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    l = torch.where(l == 0.0, 1.0, l)
    if rate > 0.0:
        keep = _head_keep_mask(seed, b, h, sq, rate, q.device, cols=sk)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - rate))
    acc = torch.matmul(p.to(v.dtype).to(ct), v.to(ct))
    out = (acc * (1.0 / l)[..., None]).to(q.dtype)
    if need_lse:
        return out, (m + torch.log(l)).reshape(b * h, sq)
    return out


def flash_attention_bwd_reference(q, k, v, key_bias, out, dout, lse, seed=None,
                                  rate: float = 0.0):
    """Plain twin of the flash backward: (dq, dk, dv) in q's dtype from the
    forward's inputs, its output ``out``, the output gradient ``dout`` and
    the lse (visitron_tpu/ops/attention.py:_bwd_dkv_kernel, _bwd_dq_kernel).

    The TPU kernels' formula in full rows: di = rowsum(out * dout) in fp32
    from the rounded output (as _flash_bwd_rule computes it), a = exp(s -
    lse), dpe = dout v^T, a_eff and da masked and scaled by 1/(1 - rate),
    dv = a_eff.astype(dtype)^T dout, ds = (a (da - di) scale).astype(dtype),
    dq = ds k, dk = ds^T q."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    ct = _compute_dtype(q.dtype)
    sm_scale = 1.0 / (d ** 0.5)
    qh, kh, vh, doh = (t.to(ct) for t in (q, k, v, dout))
    di = torch.sum(out.to(ct) * doh, dim=-1, keepdim=True)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale
    scores = scores + key_bias.to(ct)[:, None, None, :]
    a = torch.exp(scores - lse.reshape(b, h, sq, 1).to(ct))
    dpe = torch.matmul(doh, vh.transpose(-1, -2))
    if rate > 0.0:
        keep = _head_keep_mask(seed, b, h, sq, rate, q.device, cols=sk)
        inv_keep = 1.0 / (1.0 - rate)
        a_eff = torch.where(keep, a, 0.0) * inv_keep
        da = torch.where(keep, dpe, 0.0) * inv_keep
    else:
        a_eff, da = a, dpe
    dv = torch.matmul(a_eff.to(dout.dtype).to(ct).transpose(-1, -2), doh)
    ds = (a * (da - di) * sm_scale).to(q.dtype).to(ct)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


# -- the kernels' launches ------------------------------------------------------
#
# Every layout reaches one set of kernels through its own C entries.  Every
# operand goes in as a (B, H, S, D) view with D contiguous; the C side reads
# each through its own (batch, head, sequence) strides.  Outputs are
# allocated (B, S, H, D) contiguous: the packed (B, S, H*D) result itself, or,
# for K4 and K5, a buffer whose (B, H, S, D) view is returned, so merging the
# heads back is free.

def _check_cuda(name: str, q4, k4, v4, key_bias, rate: float,
                cross: bool = False) -> None:
    """Raise on what the kernels do not take; q4 is (B, H, Q, D) and k4/v4
    (B, H, K, D), with K == Q unless ``cross`` (K5)."""
    if q4.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q4.device}")
    if q4.dtype not in _DTYPE_CODES or k4.dtype != q4.dtype or v4.dtype != q4.dtype:
        raise ValueError(f"{name}: dtype {q4.dtype} not supported "
                         "(fp32 or bf16, the same for q, k, v)")
    b, h, _, d = q4.shape
    if d not in (64, 128):
        raise ValueError(f"{name}: head dim {d} not in (64, 128)")
    if k4.ndim != 4 or (k4.shape[:2], k4.shape[3]) != ((b, h), d) or (
            not cross and k4.shape != q4.shape):
        raise ValueError(f"{name}: k {tuple(k4.shape)} does not match q "
                         f"{tuple(q4.shape)}")
    for tname, t, like in (("q", q4, q4), ("k", k4, k4), ("v", v4, k4)):
        _check_operand(name, tname, t, like)
    sk = k4.shape[2]
    if (key_bias.dtype != torch.float32 or key_bias.shape != (b, sk)
            or not key_bias.is_contiguous() or key_bias.device != q4.device):
        raise ValueError(f"{name}: key_bias must be a contiguous "
                         f"fp32 ({b}, {sk}) tensor on {q4.device}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: rate {rate} not in [0, 1)")


def _check_operand(name: str, tname: str, t, like) -> None:
    """``t`` must have ``like``'s shape and device and a contiguous last dim."""
    if t.shape != like.shape or t.device != like.device or t.stride(-1) != 1:
        raise ValueError(f"{name}: {tname} must be a {tuple(like.shape)} tensor on "
                         f"{like.device} with a contiguous last dim")
    # The bf16 kernels read rows as 16-byte vectors.
    if t.dtype == torch.bfloat16 and not _vector_aligned(t):
        raise ValueError(f"{name}: bf16 {tname} needs a 16-byte aligned base and "
                         "batch/head/row strides that are multiples of 8")


def _check_rows(name: str, tname: str, t, rows: tuple, device) -> None:
    """A per-row fp32 statistic (lse, di) must be contiguous ``rows``."""
    if (t.shape != rows or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name}: {tname} must be a contiguous fp32 {rows} tensor "
                         f"on {device}")


def _vector_aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


def _strides(q4, k4, v4, out4=None, dout4=None, dq4=None, dk4=None, dv4=None):
    """The C entries' stride array: (batch, head, sequence) of q, k, v, out,
    dout, dq, dk, dv, in that order (zeros for an operand not passed)."""
    views = (q4, k4, v4, out4, dout4, dq4, dk4, dv4)
    flat = [st for t in views for st in (t.stride()[:3] if t is not None else (0, 0, 0))]
    return (ctypes.c_longlong * 24)(*flat)


def _tail_args(q4, seed, rate: float) -> tuple:
    """The C entries' trailing arguments: dtype code, seed, keep threshold,
    1/(1 - rate), dropout on, softmax scale and the current stream."""
    return (_DTYPE_CODES[q4.dtype], 0 if seed is None else int(seed) & _M32,
            _threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
            1.0 / (q4.shape[-1] ** 0.5), torch.cuda.current_stream(q4.device).cuda_stream)


def _launch_fwd(name: str, q4, k4, v4, key_bias, out4, lse, seed, rate: float) -> None:
    b, h, s, d = q4.shape
    err = _build.load().vt_attention_fwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), key_bias.data_ptr(),
        out4.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h, d,
        _strides(q4, k4, v4, out4), *_tail_args(q4, seed, rate))
    _build.check(err, name)


def _launch_bwd(name: str, q4, k4, v4, key_bias, dout4, lse, dq4, dk4, dv4,
                seed, rate: float) -> None:
    b, h, s, d = q4.shape
    _check_rows(name, "lse", lse, (b * h, s), q4.device)
    if dout4.dtype != q4.dtype:
        raise ValueError(f"{name}: dout must be {q4.dtype}")
    _check_operand(name, "dout", dout4, q4)
    delta = torch.empty((b * h, s), dtype=torch.float32, device=q4.device)
    err = _build.load().vt_attention_bwd(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), key_bias.data_ptr(),
        dout4.data_ptr(), lse.data_ptr(), dq4.data_ptr(), dk4.data_ptr(),
        dv4.data_ptr(), delta.data_ptr(), b, s, h, d,
        _strides(q4, k4, v4, dout4=dout4, dq4=dq4, dk4=dk4, dv4=dv4),
        *_tail_args(q4, seed, rate))
    _build.check(err, name)


def _bshd_buffers(q4, n: int):
    """``n`` uninitialised (B, S, H, D) buffers, each as its (B, H, S, D) view."""
    b, h, s, d = q4.shape
    return [torch.empty((b, s, h, d), dtype=q4.dtype, device=q4.device).transpose(1, 2)
            for _ in range(n)]


def _kernel_dout(dout):
    """The output gradient as autograd hands it back, copied only where the
    kernels cannot read it in place."""
    ok = dout.stride(-1) == 1 and (dout.dtype != torch.bfloat16 or _vector_aligned(dout))
    return dout if ok else dout.contiguous()


# -- K1: packed fused attention ----------------------------------------------

def _check_packed(q, k, v, num_heads: int) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_attention_packed: q, k, v must share one "
                         "(B, S, H*D) shape")
    if q.shape[-1] % num_heads:
        raise ValueError(f"fused_attention_packed: {q.shape[-1]} not divisible by "
                         f"{num_heads} heads")


def _forward(q, k, v, key_bias, num_heads: int, seed, rate: float,
             need_lse: bool):
    """K1f, or its twin for CPU tensors; returns (out, lse or None)."""
    if q.device.type == "cpu":
        if need_lse:
            return fused_attention_packed_reference(q, k, v, key_bias, num_heads,
                                                    seed, rate, need_lse=True)
        return fused_attention_packed_reference(q, k, v, key_bias, num_heads,
                                                seed, rate), None
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_packed: unsupported device {q.device}")
    _check_packed(q, k, v, num_heads)
    q4, k4, v4 = (_split_heads(t, num_heads) for t in (q, k, v))
    _check_cuda("fused_attention_packed", q4, k4, v4, key_bias, rate)
    b, h, s, _ = q4.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, s), dtype=torch.float32, device=q.device)
           if need_lse else None)
    _launch_fwd("fused_attention_packed", q4, k4, v4, key_bias,
                _split_heads(out, num_heads), lse, seed, rate)
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
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_packed_bwd: unsupported device {q.device}")
    _check_packed(q, k, v, num_heads)
    if dout.shape != q.shape:
        raise ValueError(f"fused_attention_packed_bwd: dout must be {tuple(q.shape)}")
    q4, k4, v4, dout4 = (_split_heads(t, num_heads) for t in (q, k, v, dout))
    _check_cuda("fused_attention_packed_bwd", q4, k4, v4, key_bias, rate)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _launch_bwd("fused_attention_packed_bwd", q4, k4, v4, key_bias, dout4, lse,
                *(_split_heads(t, num_heads) for t in (dq, dk, dv)), seed, rate)
    fused_attention_packed_bwd.launches += 1
    return dq, dk, dv


fused_attention_packed_bwd.launches = 0


# -- K4: fused attention on (B, H, S, D) -----------------------------------------

def _forward4(q, k, v, key_bias, seed, rate: float, need_lse: bool):
    """K4f, or its twin for CPU tensors; returns (out, lse or None)."""
    if q.device.type == "cpu":
        if need_lse:
            return fused_attention_reference(q, k, v, key_bias, seed, rate, True)
        return fused_attention_reference(q, k, v, key_bias, seed, rate), None
    if q.ndim != 4:
        raise ValueError("fused_attention: q, k, v must be (B, H, S, D)")
    _check_cuda("fused_attention", q, k, v, key_bias, rate)
    b, h, s, _ = q.shape
    (out,) = _bshd_buffers(q, 1)
    lse = (torch.empty((b * h, s), dtype=torch.float32, device=q.device)
           if need_lse else None)
    _launch_fwd("fused_attention", q, k, v, key_bias, out, lse, seed, rate)
    fused_attention.launches += 1
    return out, lse


class _Attention(torch.autograd.Function):
    """K4f forward with the lse (B*H, S) kept; K4b backward.  Saves q, k, v
    (views of the caller's tensors), the key bias and the lse; the key bias
    gets no gradient (_fused_bwd_rule returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, rate):
        out, lse = _forward4(q, k, v, key_bias, seed, rate, need_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, lse)
        ctx.seed, ctx.rate = seed, rate
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, key_bias, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, key_bias, _kernel_dout(dout), lse,
                                         ctx.seed, ctx.rate)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, key_bias, seed=None, rate: float = 0.0,
                    need_lse: bool = False):
    """Self-attention on (B, H, S, D) q/k/v with a (B, S) additive key bias
    (visitron_tpu/ops/attention.py:fused_attention, K4); returns (B, H, S, D)
    in q's dtype (on the card a view of a (B, S, H, D) buffer) and, when
    ``need_lse``, (B*H, S) fp32 lse.  q/k/v may be strided views, e.g. of the
    fused QKV projection, with a contiguous last dim.  Differentiable in q,
    k and v (K4b)."""
    if rate > 0.0 and seed is None:
        raise ValueError("fused_attention: rate > 0 requires an explicit seed")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out, lse = _Attention.apply(q, k, v, key_bias, seed, rate)
    else:
        out, lse = _forward4(q, k, v, key_bias, seed, rate, need_lse)
    return (out, lse) if need_lse else out


fused_attention.launches = 0


def fused_attention_bwd(q, k, v, key_bias, dout, lse, seed=None, rate: float = 0.0):
    """(dq, dk, dv) of :func:`fused_attention` as (B, H, S, D) in q's dtype
    (on the card views of (B, S, H, D) buffers), from the forward's inputs,
    the output gradient ``dout`` and the forward's lse.  CPU tensors take
    :func:`fused_attention_bwd_reference`; CUDA tensors launch K4b (the
    dq and dk/dv kernels of K1b, through the operands' strides) or raise."""
    if rate > 0.0 and seed is None:
        raise ValueError("fused_attention_bwd: rate > 0 requires an explicit seed")
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, key_bias, dout, lse, seed, rate)
    if q.ndim != 4:
        raise ValueError("fused_attention_bwd: q, k, v must be (B, H, S, D)")
    _check_cuda("fused_attention_bwd", q, k, v, key_bias, rate)
    dq, dk, dv = _bshd_buffers(q, 3)
    _launch_bwd("fused_attention_bwd", q, k, v, key_bias, dout, lse, dq, dk, dv,
                seed, rate)
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


# -- K5: flash attention on (B, H, Q, D) x (B, H, K, D) ---------------------------

def _check_flash_shape(name: str, q, k, v) -> None:
    """The flash function's contract on every device, as the JAX package
    states it: q (B, H, Q, D), k and v (B, H, K, D), Q and K multiples of
    128, D 64 or 128 (its gate, attention_supports_flash)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or (
            k.shape[:2], k.shape[3]) != (q.shape[:2], q.shape[3]):
        raise ValueError(f"{name}: q must be (B, H, Q, D) and k, v (B, H, K, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not attention_supports_flash(q.shape[2], k.shape[2], q.shape[3]):
        raise ValueError(f"{name}: Q {q.shape[2]} and K {k.shape[2]} must be "
                         f"multiples of 128 and the head dim {q.shape[3]} 64 or 128")


def _flash_forward(q, k, v, key_bias, seed, rate: float, need_lse: bool):
    """K5f, or its twin for CPU tensors; returns (out, lse or None)."""
    if q.device.type == "cpu":
        if need_lse:
            return flash_attention_reference(q, k, v, key_bias, seed, rate, True)
        return flash_attention_reference(q, k, v, key_bias, seed, rate), None
    _check_cuda("flash_attention", q, k, v, key_bias, rate, cross=True)
    b, h, sq, d = q.shape
    (out,) = _bshd_buffers(q, 1)
    lse = (torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    err = _build.load().vt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, k.shape[2], h, d,
        _strides(q, k, v, out), *_tail_args(q, seed, rate))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """K5f forward with the lse (B*H, Q) kept; the backward of
    _flash_bwd_rule: at rate 0 the plain ``multi_head_attention`` recomputed
    under autograd (the rule's XLA recompute), else K5b.  Saves q, k, v
    (views of the caller's tensors), the key bias, the output and the lse;
    the key bias gets no gradient (the rule returns zeros for it)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, rate):
        out, lse = _flash_forward(q, k, v, key_bias, seed, rate, need_lse=True)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.seed, ctx.rate = seed, rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        if ctx.rate == 0.0:
            with torch.enable_grad():
                live = [t.detach().requires_grad_() for t in (q, k, v)]
                ref = multi_head_attention(*live, bias=key_bias[:, None, None, :])
                dq, dk, dv = torch.autograd.grad(ref, live, dout)
        else:
            # Past the public wrapper's checks (the twins take any shape).
            dq, dk, dv = _flash_backward(q, k, v, key_bias, out, _kernel_dout(dout), lse,
                                         ctx.seed, ctx.rate)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, key_bias, seed=None, rate: float = 0.0):
    """Blockwise attention of q (B, H, Q, D) against k, v (B, H, K, D) with a
    (B, K) additive key bias and the position-hash dropout at ``rate``
    (visitron_tpu/ops/attention.py:flash_attention, K5): the long-context
    path, Q and K of any multiple of 128 on the card.  Returns (B, H, Q, D)
    in q's dtype (on the card a view of a (B, Q, H, D) buffer).  q/k/v may be
    strided views, e.g. of the fused QKV projection, with a contiguous last
    dim.  Differentiable in q, k and v (K5b, or at rate 0 the plain
    recompute)."""
    if rate > 0.0 and seed is None:
        raise ValueError(
            "flash_attention: rate > 0 requires an explicit seed (varied per "
            "step and layer); a constant one would reuse one dropout mask")
    _check_flash_shape("flash_attention", q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_bias, seed, rate)
    return _flash_forward(q, k, v, key_bias, seed, rate, need_lse=False)[0]


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, key_bias, out, dout, lse, seed=None,
                        rate: float = 0.0):
    """(dq, dk, dv) of :func:`flash_attention` in q's dtype (on the card
    views of (B, S, H, D) buffers), from the forward's inputs, its output
    ``out``, the output gradient ``dout`` and the forward's (B*H, Q) lse.
    CPU tensors take :func:`flash_attention_bwd_reference`; CUDA tensors
    launch K5b (a pre-pass writing di = rowsum(out * dout) in fp32, the rule's
    XLA reduction, then a dq kernel over query tiles and a dk/dv kernel over
    key tiles, both reading di) or raise."""
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention_bwd: rate > 0 requires an explicit seed")
    _check_flash_shape("flash_attention_bwd", q, k, v)
    return _flash_backward(q, k, v, key_bias, out, dout, lse, seed, rate)


flash_attention_bwd.launches = 0


def _flash_backward(q, k, v, key_bias, out, dout, lse, seed, rate: float):
    """K5b, or its twin for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, key_bias, out, dout, lse, seed,
                                             rate)
    name = "flash_attention_bwd"
    _check_cuda(name, q, k, v, key_bias, rate, cross=True)
    b, h, sq, d = q.shape
    _check_rows(name, "lse", lse, (b * h, sq), q.device)
    for tname, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} must be {q.dtype}")
        _check_operand(name, tname, t, q)
    di = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    (dq,) = _bshd_buffers(q, 1)
    dk, dv = _bshd_buffers(k, 2)
    err = _build.load().vt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), out.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, k.shape[2], h, d,
        _strides(q, k, v, out, dout, dq, dk, dv), *_tail_args(q, seed, rate))
    _build.check(err, name)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def attention_supports_fused(q_len: int, k_len: int, head_dim: int) -> bool:
    """The fused kernels' shape gate (visitron_tpu/ops/attention.py:
    attention_supports_fused without its backend test): self-attention,
    128 <= S <= 768, S a multiple of 128, head dim 64 or 128."""
    return (q_len == k_len and 128 <= q_len <= 768 and q_len % 128 == 0
            and head_dim in (64, 128))


def attention_supports_flash(q_len: int, k_len: int, head_dim: int) -> bool:
    """The flash kernels' shape gate (attention_supports_flash without its
    backend test): Q and K multiples of 128, head dim 64 or 128.  Where the
    fused gate refuses a shape (S > 768) and ``use_flash_attention`` is set,
    BertSelfAttention runs K5 through :func:`flash_attention`."""
    return q_len % 128 == 0 and k_len % 128 == 0 and head_dim in (64, 128)
