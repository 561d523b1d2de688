"""The agents' optimizer (visitron_tpu/train/optim.py:agent_optimizer) as
plain functions on nested dicts of tensors, with optax's semantics rather
than torch.optim's defaults:

  * ``clip_by_global_norm``: g stays as it is when ||g|| < max_norm and
    becomes g * (max_norm / ||g||) otherwise (no ``+ 1e-6`` as in
    ``clip_grad_norm_``); the choice is made on the device, without a sync;
  * ``scale_by_adam``: b1 0.9, b2 0.999, eps 1e-8 and optax's eps_root 0;
    moments mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu; bias
    correction from the incremented count; update mu_hat / (sqrt(nu_hat) + eps);
  * ``scale_by_adam_lowp``: the same update with both moments stored in
    bf16 and all arithmetic in fp32;
  * ``scale_by_learning_rate``: times -lr; ``apply_updates``: p + u.

A transformation is an ``(init, update)`` pair as in optax:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``chain`` composes them.  The elementwise work uses PyTorch's
``_foreach`` list operations, so a step issues a few launches per operation
instead of a few per parameter.  rmsprop, sgd and adamax are not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves: list):
    """A nested dict shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def global_norm(leaves: list) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a device scalar."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(grads, state, params=None):
        leaves = tree_leaves(grads)
        g_norm = global_norm(leaves)
        # g when ||g|| < max_norm (times exactly 1), else g * (max / ||g||).
        factor = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
        return tree_unflatten(grads, torch._foreach_mul(leaves, factor)), state

    return GradientTransformation(init, update)


def _bias_correction(decay: float, count: int) -> float:
    # In float32, as optax computes 1 - decay**count for an int32 count.
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        leaves = tree_leaves(params)
        zeros = [torch.zeros_like(p) for p in leaves]
        return {"count": 0, "mu": tree_unflatten(params, zeros),
                "nu": tree_unflatten(params, [torch.zeros_like(p) for p in leaves])}

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        mu = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(tree_leaves(state["mu"]), b1))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(tree_leaves(state["nu"]), b2))
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        return tree_unflatten(grads, upd), {"count": count,
                                            "mu": tree_unflatten(grads, mu),
                                            "nu": tree_unflatten(grads, nu)}

    return GradientTransformation(init, update)


def scale_by_adam_lowp(b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8) -> GradientTransformation:
    """Adam with both moments stored in bf16; the EMA update, bias
    correction and sqrt in fp32 (scale_by_adam_lowp in the JAX package)."""
    moment_dtype = torch.bfloat16

    def init(params):
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": tree_unflatten(params, [torch.zeros_like(p, dtype=moment_dtype)
                                              for p in leaves]),
                "nu": tree_unflatten(params, [torch.zeros_like(p, dtype=moment_dtype)
                                              for p in leaves])}

    def update(grads, state, params=None):
        g = [t.float() for t in tree_leaves(grads)]
        count = state["count"] + 1
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        m32 = torch._foreach_mul([m.float() for m in tree_leaves(state["mu"])], b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1.0 - b1))
        v32 = torch._foreach_mul([v.float() for v in tree_leaves(state["nu"])], b2)
        torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g, 1.0 - b2), g))
        den = torch._foreach_sqrt(torch._foreach_div(v32, bc2))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(torch._foreach_div(m32, bc1), den)
        dtypes = [t.dtype for t in tree_leaves(grads)]
        return (tree_unflatten(grads, [u.to(dt) for u, dt in zip(upd, dtypes)]),
                {"count": count,
                 "mu": tree_unflatten(grads, [m.to(moment_dtype) for m in m32]),
                 "nu": tree_unflatten(grads, [v.to(moment_dtype) for v in v32])})

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(grads, state, params=None):
        return tree_unflatten(grads, torch._foreach_mul(tree_leaves(grads), -lr)), state

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params + updates, in each parameter's dtype (optax.apply_updates)."""
    p = tree_leaves(params)
    new = torch._foreach_add(p, [u.to(t.dtype) for u, t in zip(tree_leaves(updates), p)])
    return tree_unflatten(params, new)


def agent_optimizer(lr: float, kind: str = "adam", max_grad_norm: float = 40.0,
                    bf16_moments: bool = False) -> GradientTransformation:
    """Fine-tuning optimizer: clip by global norm (40), then Adam at ``lr``
    (agent.py:129,514-515)."""
    if kind in ("rms", "sgd", "adamax"):
        raise NotImplementedError(f"optimizer {kind!r} is not ported yet")
    if kind != "adam":
        raise ValueError(f"unknown optimizer {kind}")
    core = scale_by_adam_lowp() if bf16_moments else scale_by_adam()
    return chain(clip_by_global_norm(max_grad_norm), core, scale_by_learning_rate(lr))
