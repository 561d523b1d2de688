"""The optimizers of visitron_tpu/train/optim.py (``agent_optimizer`` for
the agents, ``adamw_with_warmup`` and ``make_schedule`` for pretraining) as
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
  * ``add_decayed_weights``: u + weight_decay * p (decoupled weight decay,
    before the learning rate, as in ``optax.adamw``);
  * ``scale_by_learning_rate``: times -lr, where lr may be a schedule of the
    step count; a schedule is evaluated at the count BEFORE the step, so a
    warmup from 0 gives lr 0 on the first step (optax's
    ``scale_by_schedule``); ``apply_updates``: p + u;
  * ``make_schedule``: optax's ``join_schedules`` of two
    ``linear_schedule``s (warmup then linear decay or constant), in float32;
  * ``scale_by_rms`` (``optax.rmsprop``'s defaults): decay 0.9, eps 1e-8
    inside the square root, initial scale 0, no bias correction:
    nu = (1 - decay) g^2 + decay nu, update g / sqrt(nu + eps);
  * ``scale_by_adamax`` (``optax.adamax``): b1 0.9, b2 0.999, eps 1e-8;
    mu = (1 - b1) g + b1 mu, nu = max(|g| + eps, b2 nu), update
    (mu / (1 - b1^count)) / nu;
  * sgd: the learning rate alone (``optax.sgd`` without momentum);
  * ``multi_transform`` (``optax.multi_transform``): each label's
    transformation sees only the parameters of that label, as if the others
    did not exist (a clip's norm covers that label's gradients alone, an
    Adam keeps moments for its leaves alone); ``set_to_zero``: no
    updates (None, which ``apply_updates`` skips), no state.

A transformation is an ``(init, update)`` pair as in optax:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``chain`` composes them.  The elementwise work uses PyTorch's
``_foreach`` list operations, so a step issues a few launches per operation
instead of a few per parameter.
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


def clip_by_global_norm(max_norm: float, norm: Callable | None = None
                        ) -> GradientTransformation:
    """``norm``: the global norm of a gradient tree (default
    :func:`global_norm` of its leaves; a step under a mesh whose leaves are
    blocks passes ``DataParallel.global_norm``, the norm over every rank's)."""

    def init(params):
        return {}

    def update(grads, state, params=None):
        leaves = tree_leaves(grads)
        g_norm = global_norm(leaves) if norm is None else norm(grads)
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


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_rms with its defaults (initial scale 0, eps inside the
    square root, no bias correction)."""

    def init(params):
        return {"nu": tree_unflatten(params, [torch.zeros_like(p)
                                              for p in tree_leaves(params)])}

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - decay)
        torch._foreach_add_(nu, torch._foreach_mul(tree_leaves(state["nu"]), decay))
        den = torch._foreach_add(nu, eps)
        torch._foreach_sqrt_(den)
        return tree_unflatten(grads, torch._foreach_div(g, den)), {
            "nu": tree_unflatten(grads, nu)}

    return GradientTransformation(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adamax: the first moment with its bias correction over
    an exponentially weighted infinity norm (which needs none)."""

    def init(params):
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": tree_unflatten(params, [torch.zeros_like(p) for p in leaves]),
                "nu": tree_unflatten(params, [torch.zeros_like(p) for p in leaves])}

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        mu = torch._foreach_mul(g, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(tree_leaves(state["mu"]), b1))
        abs_g = torch._foreach_abs(g)
        torch._foreach_add_(abs_g, eps)
        nu = torch._foreach_maximum(abs_g, torch._foreach_mul(tree_leaves(state["nu"]), b2))
        count = state["count"] + 1
        upd = torch._foreach_div(torch._foreach_div(mu, _bias_correction(b1, count)), nu)
        return tree_unflatten(grads, upd), {"count": count,
                                            "mu": tree_unflatten(grads, mu),
                                            "nu": tree_unflatten(grads, nu)}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def init(params):
        return {}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        out = torch._foreach_add(tree_leaves(grads), tree_leaves(params),
                                 alpha=weight_decay)
        return tree_unflatten(grads, out), state

    return GradientTransformation(init, update)


def scale_by_learning_rate(lr) -> GradientTransformation:
    """Times -lr; ``lr`` is a float or a schedule (count -> float), which is
    read at the step count before the update and counted up after it."""
    if not callable(lr):
        def init(params):
            return {}

        def update(grads, state, params=None):
            return tree_unflatten(grads, torch._foreach_mul(tree_leaves(grads), -lr)), state

        return GradientTransformation(init, update)

    def init_sched(params):
        return {"count": 0}

    def update_sched(grads, state, params=None):
        step = -float(lr(state["count"]))
        return (tree_unflatten(grads, torch._foreach_mul(tree_leaves(grads), step)),
                {"count": state["count"] + 1})

    return GradientTransformation(init_sched, update_sched)


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule in float32: init_value -> end_value over
    ``transition_steps`` counts, then end_value."""
    if transition_steps <= 0:
        return lambda count: np.float32(init_value)

    def schedule(count: int):
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1.0) - c / np.float32(transition_steps)
        return np.float32(init_value - end_value) * frac + np.float32(end_value)

    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: schedule i+1 takes over at boundary i, counted
    from there."""

    def schedule(count: int):
        out = schedules[0](count)
        for boundary, nxt in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = nxt(count - boundary)
        return out

    return schedule


def make_schedule(lr: float, warmup_steps: int, total_steps: int, kind: str = "linear"):
    """The pretraining schedules (WarmupConstant / WarmupLinear parity): a
    linear warmup from 0 over max(warmup_steps, 1) counts, then ``lr``
    (constant) or a linear decay to 0 over the remaining steps (linear)."""
    warm = max(warmup_steps, 1)
    if kind == "constant":
        return join_schedules([linear_schedule(0.0, lr, warm),
                               lambda count: np.float32(lr)], [warm])
    if kind == "linear":
        return join_schedules([linear_schedule(0.0, lr, warm),
                               linear_schedule(lr, 0.0, max(total_steps - warmup_steps, 1))],
                              [warm])
    raise ValueError(f"unknown schedule {kind}")


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


def set_to_zero() -> GradientTransformation:
    """No updates (optax.set_to_zero): the parameters it sees stay.  Their
    updates are None rather than zero tensors, and :func:`apply_updates`
    leaves a parameter with a None update as it is; their gradients may be
    None too."""

    def init(params):
        return {}

    def update(grads, state, params=None):
        return tree_unflatten(grads, [None] * len(tree_leaves(grads))), state

    return GradientTransformation(init, update)


def _select(tree, labels, label):
    """The leaves of ``tree`` whose label is ``label``, in its nesting
    (sub-dicts left empty are dropped)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            sub = _select(value, labels[key], label)
            if sub:
                out[key] = sub
        elif labels[key] == label:
            out[key] = value
    return out


def _merge(tree, labels, parts: dict):
    """``tree``'s nesting with each leaf taken from ``parts[its label]``."""
    return {key: _merge(value, labels[key], {k: v.get(key, {}) for k, v in parts.items()})
            if isinstance(value, dict) else parts[labels[key]][key]
            for key, value in tree.items()}


def multi_transform(transforms: dict, param_labels) -> GradientTransformation:
    """optax.multi_transform: ``param_labels(params)`` gives each leaf a
    label (a nested dict of strings in ``params``' nesting); the
    transformation of each label updates that label's leaves alone.  The
    state is ``{"inner_states": {label: that transformation's state}}``."""

    def init(params):
        labels = param_labels(params)
        return {"inner_states": {k: t.init(_select(params, labels, k))
                                 for k, t in transforms.items()}}

    def update(grads, state, params=None):
        labels = param_labels(grads)
        updates, inner = {}, {}
        for k, t in transforms.items():
            sub_params = None if params is None else _select(params, labels, k)
            updates[k], inner[k] = t.update(_select(grads, labels, k),
                                            state["inner_states"][k], sub_params)
        return _merge(grads, labels, updates), {"inner_states": inner}

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params + updates, in each parameter's dtype (optax.apply_updates); a
    parameter whose update is None (``set_to_zero``'s) is kept as it is."""
    p, u = tree_leaves(params), tree_leaves(updates)
    moved = [i for i, x in enumerate(u) if x is not None]
    new = list(p)
    if moved:
        sums = torch._foreach_add([p[i] for i in moved], [u[i].to(p[i].dtype) for i in moved])
        for i, v in zip(moved, sums):
            new[i] = v
    return tree_unflatten(params, new)


def agent_optimizer(lr: float, kind: str = "adam", max_grad_norm: float = 40.0,
                    bf16_moments: bool = False,
                    norm: Callable | None = None) -> GradientTransformation:
    """Fine-tuning optimizer: clip by global norm (40), then Adam at ``lr``
    (agent.py:129,514-515), or optax's rmsprop, sgd or adamax at ``lr``
    (utils.py:430-446).  ``bf16_moments`` applies to Adam only, as in the
    JAX package; ``norm``: the clip's (:func:`clip_by_global_norm`)."""
    cores = {"adam": scale_by_adam_lowp() if bf16_moments else scale_by_adam(),
             "rms": scale_by_rms(), "adamax": scale_by_adamax()}
    if kind == "sgd":
        return chain(clip_by_global_norm(max_grad_norm, norm), scale_by_learning_rate(lr))
    if kind not in cores:
        raise ValueError(f"unknown optimizer {kind}")
    return chain(clip_by_global_norm(max_grad_norm, norm), cores[kind],
                 scale_by_learning_rate(lr))


def adamw_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                      schedule: str = "linear", weight_decay: float = 0.0,
                      eps: float = 1e-8, max_grad_norm: float = 1.0,
                      bf16_moments: bool = False,
                      norm: Callable | None = None) -> GradientTransformation:
    """The pretraining optimizer (pretrain.py:128-139 + clip 1.0 parity):
    clip by global norm (``norm``: the clip's), Adam (moments in bf16 with
    ``bf16_moments``), decoupled weight decay, and the warmup schedule of
    :func:`make_schedule`.  A zero weight decay adds nothing (optax adds
    0 * p)."""
    sched = make_schedule(lr, warmup_steps, total_steps, schedule)
    core = [scale_by_adam_lowp(eps=eps) if bf16_moments else scale_by_adam(eps=eps)]
    if weight_decay:
        core.append(add_decayed_weights(weight_decay))
    return chain(clip_by_global_norm(max_grad_norm, norm), *core,
                 scale_by_learning_rate(sched))
