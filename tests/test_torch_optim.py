"""visitron_torch.train.optim against the JAX package's optax optimizer
(visitron_tpu/train/optim.py:agent_optimizer): three steps on a random
parameter tree, with the global-norm clip triggered and not, and with fp32
and bf16 Adam moments.  Inputs come from numpy seeds and go to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch.train import optim as topt
from visitron_tpu.train import optim as jopt

SHAPES = {"encoder": {"w": (7, 5), "b": (5,)}, "decoder": {"lstm": {"wh": (8, 3)}},
          "c": (3,)}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _leaves_np(tree):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("bf16_moments", [False, True])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])  # clip triggered / not
def test_agent_optimizer_matches_optax(max_norm, bf16_moments):
    rng = np.random.default_rng(0)
    lr = 1e-2
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, scale=s) for s in (1.0, 0.3, 2.0)]
    jo = jopt.agent_optimizer(lr, "adam", max_norm, bf16_moments=bf16_moments)
    to = topt.agent_optimizer(lr, "adam", max_norm, bf16_moments=bf16_moments)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        norm = np.sqrt(sum(float(np.sum(x * x)) for x in jax.tree_util.tree_leaves(g)))
        assert (norm >= max_norm) == (max_norm == 1.0)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tu, ts = to.update(_to_torch(g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    # Each step moves a parameter by at most ~lr; fp32 rounding of the
    # moments and of bf16 storage (one bf16 ulp, 2^-8 relative, can flip
    # where the fp32 values differ in the last bit) stays far below lr/10.
    tol = 1e-6 if not bf16_moments else lr * 1e-2
    for a, b in zip(_leaves_np(jp), _leaves_np(tp)):
        np.testing.assert_allclose(b, a, atol=tol, rtol=0)
    jadam = js[1][0]  # chain(clip, chain(adam, lr)): the adam state
    tadam = ts[1]
    assert int(jadam.count) == tadam["count"] == 3
    mom_tol = 1e-6 if not bf16_moments else 1e-2
    for name in ("mu", "nu"):
        for a, b in zip(_leaves_np(getattr(jadam, name)), _leaves_np(tadam[name])):
            np.testing.assert_allclose(b, a, atol=mom_tol, rtol=mom_tol)
        dtypes = {t.dtype for t in topt.tree_leaves(tadam[name])}
        assert dtypes == {torch.bfloat16 if bf16_moments else torch.float32}


def test_clip_by_global_norm_keeps_small_and_rescales_large():
    clip = topt.clip_by_global_norm(2.0)
    small = {"a": torch.tensor([0.6, 0.8])}  # norm 1
    out, _ = clip.update(small, clip.init(small))
    assert torch.equal(out["a"], small["a"])
    large = {"a": torch.tensor([3.0, 4.0]), "b": torch.zeros(3)}  # norm 5
    out, _ = clip.update(large, clip.init(large))
    torch.testing.assert_close(out["a"], torch.tensor([1.2, 1.6]))
    assert torch.equal(out["b"], torch.zeros(3))


def test_unported_optimizer_kinds_raise():
    for kind in ("rms", "sgd", "adamax"):
        with pytest.raises(NotImplementedError):
            topt.agent_optimizer(1e-3, kind)
    with pytest.raises(ValueError):
        topt.agent_optimizer(1e-3, "lamb")
