"""The plain twins of the fused masked softmax-CE kernels (K3f, K3b) against
the JAX package's Pallas kernels in interpret mode and their ``jax.grad``,
and the autograd Function around them.  Vocabularies of 4099 and 30525 (both
off the Pallas kernel's 2048-wide chunk), 48 rows (the Pallas row block needs
a multiple of 16), fp32 and bf16, with ignored rows and labels outside
[0, V).  Inputs come from numpy seeds and go to both.

Tolerances: fp32 CE and gradients 2e-5 abs + 1e-5 relative (summation
order); bf16 gradients within one bf16 ulp of the JAX value (both round the
same fp32 value to bf16, which may differ in its last fp32 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch.ops import crossentropy as tce
from visitron_tpu.ops import crossentropy as jce

ROWS = 48


def _inputs(vocab, seed):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((ROWS, vocab))).astype(np.float32)
    labels = rng.integers(0, vocab, ROWS).astype(np.int32)
    labels[::7] = -1            # ignored rows
    labels[5] = vocab           # outside [0, V): ignored too
    labels[11] = vocab + 17
    w = rng.random(ROWS).astype(np.float32)  # cotangent weights of the rows
    return x, labels, w


def _as(x, dtype):
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return j, t


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("vocab", [4099, 30525])
def test_k3_twins_match_pallas_interpret_and_jax_grad(vocab, dtype, one_thread):
    x, labels, w = _inputs(vocab, seed=vocab)
    jx, tx = _as(x, dtype)

    def jloss(x):
        ce = jce.fused_masked_softmax_ce(x, jnp.asarray(labels), interpret=True)
        return jnp.sum(ce * jnp.asarray(w)), ce

    (_, jce_rows), jgrad = jax.value_and_grad(jloss, has_aux=True)(jx)
    tx.requires_grad_()
    tce_rows = tce.fused_masked_softmax_ce(tx, torch.from_numpy(labels))
    (tgrad,) = torch.autograd.grad(torch.sum(tce_rows * torch.from_numpy(w)), tx)

    assert tce_rows.dtype == torch.float32 and tgrad.dtype == tx.dtype
    np.testing.assert_allclose(tce_rows.detach().numpy(), np.asarray(jce_rows),
                               atol=2e-5, rtol=1e-5)
    got = tgrad.float().numpy()
    want = np.asarray(jgrad.astype(jnp.float32))
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        # One bf16 ulp: 2^-7 relative at most (2^-8 above a power of two).
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-30).all()
    invalid = (labels < 0) | (labels >= vocab)
    assert (tce_rows.detach().numpy()[invalid] == 0.0).all()
    assert (got[invalid] == 0.0).all() and (want[invalid] == 0.0).all()


def test_k3_twin_lse_matches_pallas_interpret():
    x, labels, _ = _inputs(4099, seed=1)
    _, jlse = jce._call_fwd(jnp.asarray(x), jnp.asarray(labels).reshape(-1, 1), True)
    ce, lse = tce.masked_softmax_ce_reference(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0], atol=2e-5, rtol=1e-5)
    assert ce.shape == lse.shape == (ROWS,)


def test_k3_wrappers_take_twins_on_cpu_and_count_only_launches():
    x, labels, w = _inputs(300, seed=2)
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels).long()
    n = (tce.fused_masked_softmax_ce.launches, tce.fused_masked_softmax_ce_bwd.launches)
    ce = tce.fused_masked_softmax_ce(tx, tl)
    want, lse = tce.masked_softmax_ce_reference(tx, tl)
    assert torch.equal(ce, want)
    g = torch.from_numpy(w)
    assert torch.equal(tce.fused_masked_softmax_ce_bwd(tx, tl, lse, g),
                       tce.masked_softmax_ce_bwd_reference(tx, tl, lse, g))
    assert (tce.fused_masked_softmax_ce.launches,
            tce.fused_masked_softmax_ce_bwd.launches) == n
    with pytest.raises(ValueError, match="negative"):
        tce.fused_masked_softmax_ce(tx, tl, ignore_id=0)


def test_k3_autograd_function_gradcheck_fp64(one_thread):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 11))).requires_grad_()
    labels = torch.tensor([0, 10, -1, 3, 11, 5])
    assert torch.autograd.gradcheck(lambda x: tce.fused_masked_softmax_ce(x, labels), (x,))
