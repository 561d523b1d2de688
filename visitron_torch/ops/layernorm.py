"""Fused residual-add + LayerNorm forward (K2): the Hopper kernel's wrapper
and its plain PyTorch twin.

Counterpart of visitron_tpu/ops/layernorm.py (the Pallas ``_fwd_res_kernel``
/ ``_fwd_kernel``).  The kernel lives in ``csrc/layernorm.cu``.  The math:
h = x [+ residual] in fp32, fast variance mean(h^2) - mean(h)^2 clamped at 0,
y = (h - mu) * rsqrt(var + eps) * gamma + beta, output in x's dtype.

``fused_add_layernorm`` takes the plain twin only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises; there is no fallback.
The backward kernel is not ported yet, so a call that would need a gradient
raises.
"""

from __future__ import annotations

import torch

from visitron_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layernorm_reference(x, residual, gamma, beta, eps: float):
    """Plain twin (flax fast-variance semantics), fp32 math, x.dtype output."""
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    mu = h.mean(dim=-1, keepdim=True)
    var = torch.clamp((h * h).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    y = (h - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _check_cuda(x, residual, gamma, beta) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_add_layernorm: unsupported device {x.device}")
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
        if p.dtype != torch.float32 or p.shape != (hidden,):
            raise ValueError(f"fused_add_layernorm: {name} must be fp32 ({hidden},)")
        tensors.append((name, p))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"fused_add_layernorm: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_add_layernorm: {name} must be contiguous "
                             "and 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "fused_add_layernorm: the backward kernel is not ported yet")


def fused_add_layernorm(x, residual, gamma, beta, eps: float = 1e-12):
    """``LayerNorm(x + residual)`` (residual may be None) over the last dim;
    output in x's dtype.  CPU tensors take :func:`layernorm_reference`."""
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


fused_add_layernorm.launches = 0
