"""Fused residual-add + LayerNorm (K2): the Hopper kernels' wrappers
(forward K2f and backward K2b), their plain PyTorch twins and the autograd
Function that joins them.

Counterpart of visitron_tpu/ops/layernorm.py (the Pallas ``_fwd_res_kernel``
/ ``_fwd_kernel`` and, through its custom VJP, ``_bwd_res_kernel`` /
``_bwd_kernel``).  The kernels live in ``csrc/layernorm.cu``.  The math:
h = x [+ residual] in fp32, fast variance mean(h^2) - mean(h)^2 clamped at 0,
y = (h - mu) * rsqrt(var + eps) * gamma + beta, output in x's dtype.  The
backward saves x, the residual and gamma, not h: it recomputes h and the row
statistics in fp32, and returns dh for both x and the residual.

Under a mesh (visitron_tpu/ops/layernorm.py:fused_add_layernorm_mesh) a
rank's K2f and K2b run on its local rows: its dp rows, and its tokens under
sp or cp.  The dgamma / dbeta partials are then summed with the other
gradients over every axis that shards the rows (``parallel.DataParallel``:
dp, and sp or cp), never over tp, whose ranks hold the same rows.

``fused_add_layernorm`` takes the plain twins only for tensors on the CPU.
For a CUDA tensor it launches the kernels or raises; there is no fallback.
The twins compute in fp32, or in fp64 for fp64 inputs (gradcheck).
"""

from __future__ import annotations

import torch

from visitron_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stats(x, residual):
    """h = x [+ residual] in the compute dtype, its mean and 1/std terms."""
    h = x.to(torch.promote_types(x.dtype, torch.float32))
    if residual is not None:
        h = h + residual.to(h.dtype)
    mu = h.mean(dim=-1, keepdim=True)
    var = torch.clamp((h * h).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return h, mu, var


def layernorm_reference(x, residual, gamma, beta, eps: float):
    """Plain twin (flax fast-variance semantics), fp32 math, x.dtype output."""
    h, mu, var = _stats(x, residual)
    y = (h - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(h.dtype) + beta.to(h.dtype)).to(x.dtype)


def layernorm_bwd_reference(dy, x, residual, gamma, eps: float):
    """Plain twin of the backward kernel (_bwd_core): (dh, dgamma, dbeta).
    dh, the gradient of x and of the residual, is in dy's dtype; dgamma and
    dbeta are summed over every row in the compute dtype."""
    h, mu, var = _stats(x, residual)
    rstd = torch.rsqrt(var + eps)
    xhat = (h - mu) * rstd
    d = dy.to(h.dtype)
    g = d * gamma.to(h.dtype)
    s1 = g.mean(dim=-1, keepdim=True)
    s2 = (g * xhat).mean(dim=-1, keepdim=True)
    dh = ((g - s1 - xhat * s2) * rstd).to(dy.dtype)
    hidden = x.shape[-1]
    return (dh, (d * xhat).reshape(-1, hidden).sum(dim=0),
            d.reshape(-1, hidden).sum(dim=0))


def _check_cuda(x, residual, gamma, beta=None) -> None:
    """Refuse what the kernels do not take.  The device comes last, so that
    the shape checks also speak for tensors on another device."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_add_layernorm: dtype {x.dtype} not supported")
    hidden = x.shape[-1]
    if hidden % 8 or hidden > 4096:
        raise ValueError(f"fused_add_layernorm: hidden {hidden} must be a "
                         "multiple of 8 and at most 4096")
    tensors = [("x", x)]
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError("fused_add_layernorm: residual must match x in "
                             "shape and dtype")
        tensors.append(("residual", residual))
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p is None:
            continue
        if p.dtype != torch.float32 or p.shape != (hidden,):
            raise ValueError(f"fused_add_layernorm: {name} must be fp32 ({hidden},)")
        tensors.append((name, p))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"fused_add_layernorm: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_add_layernorm: {name} must be contiguous "
                             "and 16-byte aligned")
    if x.device.type != "cuda":
        raise ValueError(f"fused_add_layernorm: unsupported device {x.device}")


def _forward(x, residual, gamma, beta, eps: float):
    """K2f, or its twin for CPU tensors."""
    if x.device.type == "cpu":
        return layernorm_reference(x, residual, gamma, beta, eps)
    _check_cuda(x, residual, gamma, beta)
    lib = _build.load()
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    err = lib.vt_layernorm_fwd(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), rows, hidden,
        float(eps), _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_add_layernorm")
    fused_add_layernorm.launches += 1
    return y


class _AddLayerNorm(torch.autograd.Function):
    """K2f forward, K2b backward.  Saves x, the residual and gamma (h and the
    statistics are recomputed, as the TPU kernels do); the gradient of x is
    also the residual's."""

    @staticmethod
    def forward(ctx, x, residual, gamma, beta, eps):
        ctx.save_for_backward(x, residual, gamma)
        ctx.eps = eps
        return _forward(x, residual, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, residual, gamma = ctx.saved_tensors
        dh, dgamma, dbeta = fused_add_layernorm_bwd(dy.contiguous(), x, residual,
                                                    gamma, ctx.eps)
        return dh, (None if residual is None else dh), dgamma, dbeta, None


def fused_add_layernorm(x, residual, gamma, beta, eps: float = 1e-12):
    """``LayerNorm(x + residual)`` (residual may be None) over the last dim;
    output in x's dtype.  CPU tensors take :func:`layernorm_reference`.
    Differentiable in x, the residual, gamma and beta (K2b)."""
    inputs = (x, residual, gamma, beta)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return _AddLayerNorm.apply(x, residual, gamma, beta, eps)
    return _forward(x, residual, gamma, beta, eps)


fused_add_layernorm.launches = 0


def fused_add_layernorm_bwd(dy, x, residual, gamma, eps: float = 1e-12):
    """(dh, dgamma, dbeta) of :func:`fused_add_layernorm`: dh (the gradient
    of x and of the residual) in dy's dtype, dgamma and dbeta in fp32.  CPU
    tensors take :func:`layernorm_bwd_reference`; CUDA tensors launch K2b,
    whose row kernel writes one fp32 partial row of dgamma and dbeta per
    block into a scratch that the library sizes, and whose second kernel sums
    them in a fixed order."""
    if x.device.type == "cpu":
        return layernorm_bwd_reference(dy, x, residual, gamma, eps)
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError("fused_add_layernorm_bwd: dy must match x in shape, "
                         "dtype and device, contiguous and 16-byte aligned")
    _check_cuda(x, residual, gamma)
    lib = _build.load()
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    code = _DTYPE_CODES[x.dtype]
    n_scratch = lib.vt_layernorm_bwd_scratch(rows, hidden, code, residual is not None)
    if n_scratch < 0:
        raise RuntimeError(f"fused_add_layernorm_bwd: CUDA error {-n_scratch} "
                           "sizing the scratch")
    dh = torch.empty_like(dy)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    sums = torch.empty((2, hidden), dtype=torch.float32, device=x.device)
    err = lib.vt_layernorm_bwd(
        dy.data_ptr(), x.data_ptr(), None if residual is None else residual.data_ptr(),
        gamma.data_ptr(), dh.data_ptr(), scratch.data_ptr(), sums.data_ptr(),
        rows, hidden, float(eps), n_scratch, code,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_add_layernorm_bwd")
    fused_add_layernorm_bwd.launches += 1
    return dh, sums[0], sums[1]


fused_add_layernorm_bwd.launches = 0
