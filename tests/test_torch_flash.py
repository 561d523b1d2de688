"""The flash attention of visitron_torch (K5) against the JAX package's on
the CPU: the forward and backward twins against the Pallas flash kernels in
interpret mode (forward, lse, jax.grad through the dk/dv and dq kernels at
rate > 0), the port's rate-0 backward against jax.grad (which recomputes
through jnp there), an fp64 gradcheck of the autograd Function, the keep
mask shared with K4, and the wrappers' refusals.  Inputs come from numpy
seeds and go to both packages; tolerance 2e-5 absolute (fp32).

The CUDA kernels run only on the card: tests/test_torch_kernels.py holds
them against these twins there (``gpu`` tests), and chip_smoke.py does at
the long-context shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch.ops import attention as tatt
from visitron_tpu.ops import attention as jatt

NEG_INF = -1e9
ATOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors gain nothing from intra-op threads, and with several
    test workers per machine the threads only contend; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, h, sq, sk, d, seed):
    """q (B, H, Q, D), k/v (B, H, K, D), a (B, K) key bias with padded keys
    and an output cotangent, fp32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, sk, d)).astype(np.float32) for _ in range(2))
    keep = np.ones((b, sk), np.float32)
    keep[0, sk - 37:] = 0.0  # padded keys in the first item
    keep[1, 50:] = 0.0
    dout = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, (1.0 - keep) * NEG_INF, dout


def _jseed(seed):
    return None if seed is None else jnp.int32(seed)


LENGTHS = {"self": (256, 256), "cross": (128, 256)}


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.3, 1234)])
@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_k5_forward_twin_matches_pallas_interpret(case, rate, seed):
    sq, sk = LENGTHS[case]
    q, k, v, kb, _ = _inputs(2, 3, sq, sk, 64, seed=sq + sk)
    want = jatt.flash_attention(*map(jnp.asarray, (q, k, v, kb)), _jseed(seed), rate,
                                128, 128, True)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v, kb)), seed, rate)
    assert got.shape == (2, 3, sq, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_k5_lse_twin_matches_pallas_interpret(case):
    sq, sk = LENGTHS[case]
    q, k, v, kb, _ = _inputs(2, 3, sq, sk, 64, seed=7)
    want_out, want_lse = jatt._flash_forward(*map(jnp.asarray, (q, k, v, kb)),
                                             jnp.int32(5), 0.3, 128, 128, True,
                                             need_lse=True)
    got_out, got_lse = tatt.flash_attention_reference(*map(torch.from_numpy, (q, k, v, kb)),
                                                      5, 0.3, need_lse=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=ATOL, rtol=0)
    # The TPU kernel replicates each row's lse over 8 sublanes (layout only).
    assert got_lse.shape == (2 * 3, sq)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, 0], atol=ATOL,
                               rtol=0)


def _grads_both(q, k, v, kb, dout, seed, rate):
    """(dq, dk, dv) from jax.grad of the JAX flash_attention (interpret) and
    from the port's autograd, for the loss sum(out * dout)."""
    def jloss(q, k, v):
        out = jatt.flash_attention(q, k, v, jnp.asarray(kb), _jseed(seed), rate,
                                   128, 128, True)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    n = tatt.flash_attention_bwd.launches
    out = tatt.flash_attention(tq, tk, tv, torch.from_numpy(kb), seed, rate)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    assert tatt.flash_attention_bwd.launches == n  # CPU calls count nothing
    return got, want


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_k5_backward_twin_matches_jax_grad_of_pallas_kernels(case):
    """Rate 0.3: the JAX rule runs the Pallas dk/dv and dq kernels; the port
    runs _FlashAttention's backward, the K5b twin on the CPU."""
    sq, sk = LENGTHS[case]
    q, k, v, kb, dout = _inputs(2, 3, sq, sk, 64, seed=11)
    got, want = _grads_both(q, k, v, kb, dout, 4321, 0.3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=name)


def test_k5_backward_twin_called_directly_matches_autograd():
    q, k, v, kb, dout = (torch.from_numpy(a) for a in _inputs(2, 3, 128, 256, 64, 12))
    out, lse = tatt.flash_attention_reference(q, k, v, kb, 9, 0.3, need_lse=True)
    got = tatt.flash_attention_bwd(q, k, v, kb, out, dout, lse, 9, 0.3)
    live = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(tatt.flash_attention(*live, kb, 9, 0.3), live, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k5_rate0_backward_recomputes_like_jax():
    """At rate 0 both packages' backward recompute plain attention (the JAX
    rule through jnp, the port through multi_head_attention)."""
    q, k, v, kb, dout = _inputs(2, 3, 256, 256, 64, seed=13)
    got, want = _grads_both(q, k, v, kb, dout, None, 0.0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("rate,seed", [(0.2, 5), (0.0, None)])
def test_k5_autograd_function_gradcheck_fp64(rate, seed):
    # The Function's twins take any shape (the public wrapper holds the
    # gate): heads of 8, Q 12 against K 16, keep the numerical Jacobian small.
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 2, 12, 8))).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 16, 8))).requires_grad_()
            for _ in range(2))
    kb = torch.zeros(2, 16, dtype=torch.float64)
    kb[1, 11:] = NEG_INF
    assert torch.autograd.gradcheck(
        lambda q, k, v: tatt._FlashAttention.apply(q, k, v, kb, seed, rate), (q, k, v))


@pytest.mark.parametrize("seed", [0, 77, 2**31 - 1])
def test_k5_and_k4_twins_draw_the_same_keep_mask(seed):
    """One seed gives K5 and K4 one mask: with no padding and v the identity
    on the keys, each output row is the kept, rescaled probabilities, so the
    two twins' outputs agree, and both match the JAX flash kernel's mask."""
    b, h, s, rate = 2, 2, 128, 0.5
    rng = np.random.default_rng(seed % 1000)
    q, k = (torch.from_numpy(rng.standard_normal((b, h, s, 64)).astype(np.float32))
            for _ in range(2))
    v = torch.eye(s, 64).expand(b, h, s, 64).contiguous()
    kb = torch.zeros(b, s)
    flash = tatt.flash_attention_reference(q, k, v, kb, seed, rate)
    fused = tatt.fused_attention_reference(q, k, v, kb, seed, rate)
    np.testing.assert_allclose(flash.numpy(), fused.numpy(), atol=1e-6, rtol=1e-6)
    got = tatt._head_keep_mask(seed, b, h, s, rate, "cpu", cols=s)
    for bi in range(b):
        for hi in range(h):
            sj = jatt._mix_seed(jnp.asarray([seed], jnp.int32), bi * h + hi)
            want = np.asarray(jatt._keep_mask(sj, 0, 0, (s, s), jatt._threshold(rate)))
            np.testing.assert_array_equal(got[bi, hi].numpy(), want)
    # The first 64 columns of v are the identity: a dropped probability is 0.
    assert torch.equal(flash[..., :64] == 0, ~got[..., :64])


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, kb, dout = (torch.from_numpy(a) for a in _inputs(2, 3, 128, 256, 64, 14))
    with pytest.raises(ValueError, match="seed"):
        tatt.flash_attention(q, k, v, kb, None, 0.1)
    with pytest.raises(ValueError, match="seed"):
        tatt.flash_attention_bwd(q, k, v, kb, q, dout, None, None, 0.1)
    # The gate, on the CPU as well: lengths not multiples of 128, head dim 32.
    with pytest.raises(ValueError, match="multiples of 128"):
        tatt.flash_attention(q[:, :, :100], k, v, kb)
    with pytest.raises(ValueError, match="multiples of 128"):
        tatt.flash_attention(q[..., :32], k[..., :32], v[..., :32], kb)
    with pytest.raises(ValueError, match="multiples of 128"):
        tatt.flash_attention_bwd(q, k[:, :, :200], v[:, :, :200], kb[:, :200], q, dout,
                                 torch.zeros(6, 128))
    with pytest.raises(ValueError, match="B, H, K, D"):
        tatt.flash_attention(q, k, v[:, :, :128], kb)
    # Neither the CPU nor the card: the CUDA path's check refuses it.
    m = torch.empty(1, 2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention(m, m, m, torch.empty(1, 128, device="meta"))
    with pytest.raises(ValueError, match="device"):
        tatt.flash_attention_bwd(m, m, m, torch.empty(1, 128, device="meta"), m, m,
                                 torch.empty(2, 128, device="meta"))
    assert tatt.attention_supports_flash(512, 1024, 64)
    assert not tatt.attention_supports_flash(896, 900, 64)
