"""Fused masked softmax cross-entropy over a large vocabulary (K3): the
Hopper kernels' wrappers (forward K3f, backward K3b), their plain PyTorch
twins and the autograd Function that joins them.

Counterpart of visitron_tpu/ops/crossentropy.py (``fused_masked_softmax_ce``
and its Pallas ``_fwd_kernel`` / ``_bwd_kernel``).  The kernels live in
``csrc/crossentropy.cu``.  They compute the per-row CE straight from the
logits in their own dtype (bf16 on the card) with fp32 math, keeping only a
per-row logsumexp for the backward, so no fp32 copy of the (R, V) logits is
ever made.  A row whose label lies outside [0, V), the ignore label -1
included, gives CE 0 and a zero gradient.  The caller takes the mean over
its valid rows.

The port needs no counterpart of ``ce_supports``: the CUDA kernels take any
R and any V.  ``fused_masked_softmax_ce`` takes the plain twins only for
tensors on the CPU; for a CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import torch

from visitron_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _valid(labels, vocab: int):
    return (labels >= 0) & (labels < vocab)


def masked_softmax_ce_reference(logits, labels):
    """Plain twin of K3f: (ce, lse), both (R,) fp32 (fp64 for fp64 logits),
    from (R, V) logits and (R,) integer labels; ce is 0 where the label is
    outside [0, V)."""
    ct = torch.promote_types(logits.dtype, torch.float32)
    x = logits.to(ct)
    vocab = x.shape[-1]
    lse = torch.logsumexp(x, dim=-1)
    valid = _valid(labels, vocab)
    z = torch.gather(x, 1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
    return torch.where(valid, lse - z, 0.0), lse


def masked_softmax_ce_bwd_reference(logits, labels, lse, g):
    """Plain twin of K3b: dlogits = g * valid * (exp(x - lse) - onehot), in
    the logits' dtype, from the per-row cotangent ``g`` (R,)."""
    ct = torch.promote_types(logits.dtype, torch.float32)
    x = logits.to(ct)
    vocab = x.shape[-1]
    valid = _valid(labels, vocab)
    probs = torch.exp(x - lse.to(ct)[:, None])
    onehot = torch.zeros_like(probs).scatter_(
        1, torch.where(valid, labels, 0).long()[:, None], 1.0)
    gv = g.to(ct) * valid.to(ct)
    return (gv[:, None] * (probs - onehot)).to(logits.dtype)


def _check_cuda(name: str, logits, labels) -> None:
    if logits.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {logits.device}")
    if logits.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {logits.dtype} not supported (fp32 or bf16)")
    if logits.ndim != 2 or not logits.is_contiguous() or logits.shape[0] == 0:
        raise ValueError(f"{name}: logits must be a contiguous, non-empty (R, V) tensor")
    if logits.data_ptr() % 16:
        raise ValueError(f"{name}: logits must start on a 16-byte boundary")
    if (labels.shape != logits.shape[:1] or labels.dtype != torch.int64
            or not labels.is_contiguous() or labels.device != logits.device):
        raise ValueError(f"{name}: labels must be a contiguous int64 "
                         f"({logits.shape[0]},) tensor on {logits.device}")


def _forward(logits, labels):
    """K3f, or its twin for CPU tensors: (ce, lse)."""
    if logits.device.type == "cpu":
        return masked_softmax_ce_reference(logits, labels)
    _check_cuda("fused_masked_softmax_ce", logits, labels)
    rows, vocab = logits.shape
    ce = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    err = _build.load().vt_ce_fwd(
        logits.data_ptr(), labels.data_ptr(), ce.data_ptr(), lse.data_ptr(), rows,
        vocab, _DTYPE_CODES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(err, "fused_masked_softmax_ce")
    fused_masked_softmax_ce.launches += 1
    return ce, lse


class _MaskedCE(torch.autograd.Function):
    """K3f forward; K3b backward from the saved logits, labels and lse."""

    @staticmethod
    def forward(ctx, logits, labels):
        ce, lse = _forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return ce

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return fused_masked_softmax_ce_bwd(logits, labels, lse,
                                           g.float().contiguous()), None


def fused_masked_softmax_ce(logits, labels, ignore_id: int = -1):
    """Per-row softmax CE (R,) fp32 of ``logits`` (R, V) against ``labels``
    (R,), fp32 math from the stored dtype; rows whose label lies outside
    [0, V) give CE 0 and zero gradient.  ``ignore_id`` must be negative.
    Differentiable in the logits (K3b)."""
    if ignore_id >= 0:
        raise ValueError("fused_masked_softmax_ce: ignore_id must be negative "
                         "(the kernels treat every label outside [0, V) as ignored)")
    labels = labels.reshape(-1).long()
    if torch.is_grad_enabled() and logits.requires_grad:
        return _MaskedCE.apply(logits, labels)
    return _forward(logits, labels)[0]


fused_masked_softmax_ce.launches = 0


def fused_masked_softmax_ce_bwd(logits, labels, lse, g):
    """dlogits of :func:`fused_masked_softmax_ce` in the logits' dtype, from
    the forward's logits, labels and lse and the per-row fp32 cotangent
    ``g``.  CPU tensors take :func:`masked_softmax_ce_bwd_reference`; CUDA
    tensors launch K3b, which writes every element, or raise."""
    if logits.device.type == "cpu":
        return masked_softmax_ce_bwd_reference(logits, labels, lse, g)
    _check_cuda("fused_masked_softmax_ce_bwd", logits, labels)
    rows, vocab = logits.shape
    for name, t in (("lse", lse), ("g", g)):
        if (t.shape != (rows,) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != logits.device):
            raise ValueError(f"fused_masked_softmax_ce_bwd: {name} must be a "
                             f"contiguous fp32 ({rows},) tensor on {logits.device}")
    dx = torch.empty_like(logits)
    err = _build.load().vt_ce_bwd(
        logits.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), rows, vocab, _DTYPE_CODES[logits.dtype],
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(err, "fused_masked_softmax_ce_bwd")
    fused_masked_softmax_ce_bwd.launches += 1
    return dx


fused_masked_softmax_ce_bwd.launches = 0
