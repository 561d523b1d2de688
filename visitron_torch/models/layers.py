"""Parameter-holding building blocks shared by the models, and their
initialisers.

``Dense`` and ``Embed`` mirror flax's ``nn.Dense`` / ``nn.Embed`` as the JAX
package uses them: fp32 parameters, and an optional computation dtype to
which inputs AND parameters are cast on every call (flax ``dtype=``).
Without one, the inputs and parameters are promoted to a common dtype, as
flax does for a Dense with no dtype.

Each block can draw its own initial parameters from a ``torch.Generator``
with the distributions of the flax initialisers the JAX package uses
(``initial_params``); :func:`init_module_params` collects them for a whole
module tree in a fixed order.

:func:`dropout` is flax ``nn.Dropout`` with an explicit generator;
:class:`DropoutRng` carries one training pass's generators through the
modules (``rng=None`` is the deterministic pass).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax's default Dense kernel init: variance_scaling(1, fan_in,
    truncated_normal), i.e. a normal truncated at +-2 std, rescaled so that
    the truncated distribution has variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
    return t


class Dense(nn.Module):
    """y = x W^T + b with W stored as (out, in) in fp32.

    ``dtype``: computation dtype (flax ``Dense(dtype=...)``); None promotes.
    ``init_std``: normal(0, init_std) kernel init (BERT); None means flax's
    default lecun_normal."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype | None = None, init_std: float | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def initial_params(self, g: torch.Generator) -> dict:
        out_f, in_f = self.weight.shape
        if self.init_std is None:
            # flax kernels are (in, out): draw in that layout, store transposed.
            w = _lecun_normal((in_f, out_f), in_f, g).T.contiguous()
        else:
            w = torch.empty(in_f, out_f).normal_(0.0, self.init_std, generator=g)
            w = w.T.contiguous()
        out = {"weight": w}
        if self.bias is not None:
            out["bias"] = torch.zeros(out_f)
        return out


class _PadRows(torch.autograd.Function):
    """``t`` (n, ...) -> (n + pad, ...) in ``dtype``, the pad rows ``value``:
    one copy, which is also the cast; the backward hands the gradient's
    first n rows back in ``t``'s dtype."""

    @staticmethod
    def forward(ctx, t, pad, value, dtype):
        n = t.shape[0]
        ctx.n, ctx.dtype = n, t.dtype
        out = t.new_empty((n + pad, *t.shape[1:]), dtype=dtype)
        out[:n].copy_(t)
        out[n:].fill_(value)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[:ctx.n].to(ctx.dtype), None, None, None


def pad_to_8(t: torch.Tensor, value: float = 0.0, dtype=None) -> torch.Tensor:
    """``t`` cast to ``dtype`` (default its own) with its first dimension
    rounded up to a multiple of 8, the new rows ``value``; ``t.to(dtype)``
    where the size is a multiple of 8 already.  The pretraining heads' one
    rule for their widths (:func:`aligned_linear`, ``PretrainModel.heads``)."""
    dtype = dtype or t.dtype
    pad = -t.shape[0] % 8
    return _PadRows.apply(t, pad, value, dtype) if pad else t.to(dtype)


def aligned_linear(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.linear`` in ``x``'s dtype, run at the output width n rounded up
    to a multiple of 8 and returned at that width: (..., n8), the pad
    columns zero.

    A bf16 product whose output width is not a multiple of 8 has rows that
    start off a 16-byte boundary, and cuBLAS then runs it, and the two
    products of its backward, on unaligned (``align1``) SM75 CUTLASS
    kernels at a sixth of the rate it gives aligned widths on an H100.  So
    the weight's rows (and the bias) are padded with zeros here, in the
    call and in the one copy that casts them (:func:`pad_to_8`): the
    parameters keep their shapes, and the pad's backward slices their
    gradients back to them.  A caller takes the first n columns (a view)
    where it needs the product itself.  ``.padded`` counts the products run
    at a padded width."""
    w = pad_to_8(weight, dtype=x.dtype)
    if w.shape[0] > weight.shape[0]:
        aligned_linear.padded += 1
    return F.linear(x, w, None if bias is None else pad_to_8(bias, dtype=x.dtype))


aligned_linear.padded = 0


class Embed(nn.Module):
    """Embedding table (num, features) in fp32; rows are cast to ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype | None = None,
                 init_std: float = 0.02):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, features))
        self.dtype = dtype
        self.init_std = init_std

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # F.embedding: the same rows as weight[ids], with a dense
        # embedding backward instead of index_put_ accumulation.
        rows = F.embedding(ids, self.weight)
        return rows if self.dtype is None else rows.to(self.dtype)

    def initial_params(self, g: torch.Generator) -> dict:
        return {"weight": torch.empty(self.weight.shape).normal_(
            0.0, self.init_std, generator=g)}


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None = None,
            deterministic: bool = True) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics: keep each value with probability
    1 - rate and scale kept values by 1/(1 - rate); the identity when
    ``deterministic`` or rate is 0.  The mask is drawn with ``torch.rand``
    from ``generator``, which lives on x's device (``F.dropout`` takes no
    generator).  flax's streams cannot be reproduced, so only the
    distribution matches the JAX package."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


@dataclass
class DropoutRng:
    """The randomness of one training step's dropouts: ``masks`` draws the
    hidden-dropout masks on the activations' device; ``seeds`` (a CPU
    generator, so drawing needs no device sync) draws the int32 seeds of the
    attention kernels' hash dropout, plus ``seed_offset``: a rank's fold
    under a mesh (``parallel.Mesh.kernel_seed`` of 0: dp_index x 1000003 +
    axis_index x 7919, as the JAX mesh wrappers fold their coordinates; a
    pp stage's own seeds, its microbatches drawing one after the other; 0
    under cp, whose ring hashes absolute coordinates), 0 on one device.
    Modules take ``rng=None`` for the deterministic (serving) pass."""

    masks: torch.Generator
    seeds: torch.Generator
    seed_offset: int = 0

    def seed(self) -> int:
        """A seed in [0, 2**31 - 1), as jax.random.randint draws it
        (visitron_tpu/models/bert.py:350-352), plus ``seed_offset`` (the
        kernels read its low 32 bits)."""
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.seeds)) + self.seed_offset


def maybe_drop(x: torch.Tensor, rate: float, rng: DropoutRng | None) -> torch.Tensor:
    """Dropout at ``rate`` in a training pass (``rng`` given), else x."""
    return x if rng is None else dropout(x, rate, rng.masks, deterministic=False)


def init_module_params(module: nn.Module, g: torch.Generator, device=None) -> dict:
    """{parameter name: fresh tensor on ``device``} for every parameter of
    ``module``, drawn block by block in registration order."""
    out = {}
    for prefix, m in module.named_modules():
        if hasattr(m, "initial_params"):
            for name, t in m.initial_params(g).items():
                out[f"{prefix}.{name}" if prefix else name] = t.to(device)
    missing = {n for n, _ in module.named_parameters()} - set(out)
    if missing:
        raise RuntimeError(f"no initialiser for parameters {sorted(missing)}")
    return out
