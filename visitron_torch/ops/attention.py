"""Packed fused self-attention forward (K1): the Hopper kernel's wrapper, its
plain PyTorch twin, the (B, H, S, D) ``multi_head_attention`` core and the
position-hash dropout helpers.

Counterpart of visitron_tpu/ops/attention.py: ``fused_attention_packed``
(Pallas ``_fused_packed_fwd_kernel``), ``multi_head_attention`` and
``_keep_mask`` / ``_threshold`` / ``_mix_seed``.  The kernel lives in
``csrc/attention.cu``.

Dropout on the attention probabilities is a counter-based hash of the
absolute (query, key) position inside each head (murmur3 finaliser), seeded
with ``seed ^ (head_id * 0xC2B2AE3D)`` where head_id = b*H + h.  A value is
kept when the hash is >= ``_threshold(rate)``, and kept values are scaled by
1/(1 - rate).  The masks equal the JAX package's bit for bit.

``fused_attention_packed`` takes the plain twin only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from visitron_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


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

    def split(t):
        return t.reshape(b, s, h, d).permute(0, 2, 1, 3).float()

    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) * (1.0 / (d ** 0.5))
    scores = scores + key_bias.float()[:, None, None, :]
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    a = p * (1.0 / l)[..., None]
    if rate > 0.0:
        bh = torch.arange(b * h, device=q.device).reshape(b, h)
        keep = _keep_mask(_mix_seed(seed, bh).to(q.device), 0, 0, (s, s),
                          _threshold(rate))
        a = torch.where(keep, a, 0.0) * (1.0 / (1.0 - rate))
    a = a.to(v.dtype).float()
    out = torch.matmul(a, split(v)).permute(0, 2, 1, 3).reshape(b, s, hd)
    out = out.to(q.dtype)
    if need_lse:
        return out, (m + torch.log(l)).reshape(b * h, s)
    return out


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
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "fused_attention_packed: the backward kernel is not ported yet")
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


def fused_attention_packed(q, k, v, key_bias, num_heads: int, seed=None,
                           rate: float = 0.0, need_lse: bool = False):
    """Self-attention on packed (B, S, H*D) q/k/v with a (B, S) additive key
    bias; returns (B, S, H*D) in q's dtype, and (B*H, S) fp32 lse when
    ``need_lse``.  q/k/v may be strided views (e.g. of one fused QKV
    projection) as long as their last dim is contiguous."""
    if rate > 0.0 and seed is None:
        raise ValueError(
            "fused_attention_packed: rate > 0 requires an explicit seed")
    if q.device.type == "cpu":
        return fused_attention_packed_reference(q, k, v, key_bias, num_heads,
                                                seed, rate, need_lse)
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
    return (out, lse) if need_lse else out


fused_attention_packed.launches = 0
