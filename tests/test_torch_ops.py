"""visitron_torch ops against the JAX package: the plain twins of the K1
(packed fused attention) and K2 (fused add+LayerNorm) kernels against the
Pallas kernels in interpret mode, the position-hash keep mask bit for bit,
and the masking helpers.  Inputs come from numpy seeds and go to both.

The CUDA kernels themselves run only on the card: tests/test_torch_kernels.py
holds them against the twins there (and chip_smoke.py does at the serving
shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch.ops import attention as tatt
from visitron_torch.ops import layernorm as tln
from visitron_torch.ops import masking as tmask
from visitron_tpu.ops import attention as jatt
from visitron_tpu.ops import layernorm as jln
from visitron_tpu.ops import masking as jmask

NEG_INF = -1e9


def _attention_inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32)
               for _ in range(3))
    keep = np.ones((b, s), np.float32)
    keep[0, s - 37:] = 0.0  # padded keys in the first item
    keep[1, 50:] = 0.0
    return q, k, v, (1.0 - keep) * NEG_INF


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 1234)])
@pytest.mark.parametrize("s", [128, 256])
def test_k1_twin_matches_pallas_interpret(s, rate, seed):
    b, h, d = 2, 4, 64
    q, k, v, kb = _attention_inputs(b, s, h, d, seed=s)
    want = jatt.fused_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(kb), h, seed, rate, True)
    got = tatt.fused_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(kb),
                                      h, seed, rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_k1_twin_lse_matches_pallas_interpret():
    b, h, d, s = 2, 4, 64, 128
    q, k, v, kb = _attention_inputs(b, s, h, d, seed=3)
    want_out, want_lse = jatt._fused_packed_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb), h,
        None, 0.0, True, need_lse=True)
    got_out, got_lse = tatt.fused_attention_packed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kb), h, need_lse=True)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=2e-5, rtol=0)
    # The TPU kernel replicates each row's lse over 8 sublanes (layout only).
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[:, 0, :],
                               atol=2e-5, rtol=0)


def test_k1_twin_reads_strided_qkv_views():
    """q/k/v as views of one fused projection give the same output as copies."""
    b, h, d, s = 2, 2, 64, 128
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
    kb = torch.zeros(b, s)
    q, k, v = qkv.split(h * d, dim=-1)
    got = tatt.fused_attention_packed(q, k, v, kb, h)
    want = tatt.fused_attention_packed(q.contiguous(), k.contiguous(), v.contiguous(), kb, h)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1234, -7, 2**31 - 1])
def test_keep_mask_bit_identical(seed):
    thr = jatt._threshold(0.1)
    assert thr == tatt._threshold(0.1)
    for bh in (0, 1, 5, 47, 1000):
        sj = jatt._mix_seed(jnp.asarray([seed], jnp.int32), bh)
        want = np.asarray(jatt._keep_mask(sj, 0, 0, (128, 256), thr))
        got = tatt._keep_mask(tatt._mix_seed(seed, bh), 0, 0, (128, 256), thr)
        np.testing.assert_array_equal(got.numpy(), want)
    # An offset block equals the same slice of the full mask.
    full = tatt._keep_mask(tatt._mix_seed(seed, 3), 0, 0, (256, 256), thr)
    part = tatt._keep_mask(tatt._mix_seed(seed, 3), 128, 64, (128, 64), thr)
    assert torch.equal(full[128:, 64:128], part)


def test_keep_mask_rate_and_batched_heads():
    seeds = tatt._mix_seed(99, torch.arange(6).reshape(2, 3))
    masks = tatt._keep_mask(seeds, 0, 0, (64, 64), tatt._threshold(0.25))
    assert masks.shape == (2, 3, 64, 64)
    assert abs(masks.float().mean().item() - 0.75) < 0.02
    one = tatt._keep_mask(tatt._mix_seed(99, 4), 0, 0, (64, 64), tatt._threshold(0.25))
    assert torch.equal(masks[1, 1], one)


def test_multi_head_attention_matches_jax():
    rng = np.random.default_rng(8)
    b, h, s, d = 2, 3, 40, 16
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = (np.arange(s)[None] < np.array([[40], [25]])).astype(np.int32)
    bias_j = jmask.make_attention_bias(jnp.asarray(mask))
    bias_t = tmask.make_attention_bias(torch.from_numpy(mask))
    np.testing.assert_array_equal(bias_t.numpy(), np.asarray(bias_j))
    want = jatt.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=bias_j)
    got = tatt.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), bias=bias_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_length2mask_matches_jax():
    lengths = np.array([1, 5, 7, 3], np.int32)
    want = np.asarray(jmask.length2mask(jnp.asarray(lengths), 7))
    np.testing.assert_array_equal(
        tmask.length2mask(torch.from_numpy(lengths), 7).numpy(), want)


@pytest.mark.parametrize("has_res", [True, False])
def test_k2_twin_matches_pallas_interpret(has_res):
    rng = np.random.default_rng(0)
    shape = (4, 64, 768)
    x = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) if has_res else None
    g = rng.standard_normal(768).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    want = jln.fused_add_layernorm(jnp.asarray(x), None if res is None else jnp.asarray(res),
                                   jnp.asarray(g), jnp.asarray(b), 1e-12, interpret=True)
    got = tln.fused_add_layernorm(torch.from_numpy(x),
                                  None if res is None else torch.from_numpy(res),
                                  torch.from_numpy(g), torch.from_numpy(b), 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_k2_twin_keeps_bf16_and_adds_in_fp32():
    """Kernel semantics: output in x's dtype, residual added in fp32."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    g, b = torch.ones(256), torch.zeros(256)
    y = tln.fused_add_layernorm(x.bfloat16(), res.bfloat16(), g, b, 1e-12)
    assert y.dtype == torch.bfloat16
    want = tln.layernorm_reference(x.bfloat16().float() + res.bfloat16().float(),
                                   None, g, b, 1e-12).bfloat16()
    assert torch.equal(y, want)


# -- backward twins (K1b, K2b) and the autograd Functions ------------------------

@pytest.fixture
def one_thread():
    """Tiny tensors gain nothing from intra-op threads, and with several
    test workers per machine the threads only contend; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 1234)])
@pytest.mark.parametrize("s", [128, 256])
def test_k1b_twin_matches_jax_grad_of_pallas_interpret(s, rate, seed):
    """Gradients of the port's fused_attention_packed (autograd Function ->
    K1b twin on the CPU) against jax.grad of the Pallas kernel pair."""
    import jax

    b, h, d = 2, 4, 64
    q, k, v, kb = _attention_inputs(b, s, h, d, seed=s + 1)
    dout = np.random.default_rng(s + 2).standard_normal((b, s, h * d)).astype(np.float32)

    def jloss(q, k, v):
        out = jatt.fused_attention_packed(q, k, v, jnp.asarray(kb), h, seed, rate, True)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.fused_attention_packed(tq, tk, tv, torch.from_numpy(kb), h, seed, rate)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("has_res", [True, False])
def test_k2b_twin_matches_jax_grad_of_pallas_interpret(has_res):
    import jax

    rng = np.random.default_rng(5)
    shape = (4, 64, 768)
    x = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(768).astype(np.float32)
    b = rng.standard_normal(768).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)

    def jloss(x, res, g, b):
        y = jln.fused_add_layernorm(x, res if has_res else None, g, b, 1e-12,
                                    interpret=True)
        return jnp.sum(y * jnp.asarray(dy))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, res, g, b)))
    tx, tr, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, res, g, b))
    y = tln.fused_add_layernorm(tx, tr if has_res else None, tg, tb, 1e-12)
    inputs = (tx, tr, tg, tb) if has_res else (tx, tg, tb)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    want = want if has_res else (want[0], want[2], want[3])
    for i, (gt, w) in enumerate(zip(got, want)):
        # dgamma/dbeta are sums over 256 rows (|value| ~ 25): fp32 summation
        # order adds up to ~1 ulp per row there, hence rtol 1e-6 on top.
        rtol = 1e-6 if gt.ndim == 1 else 0
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), atol=1e-5, rtol=rtol,
                                   err_msg=f"grad {i}")
    if has_res:
        assert torch.equal(got[0], got[1])  # dh is the gradient of x and of res


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.2, 5)])
def test_k1_autograd_function_gradcheck_fp64(rate, seed, one_thread):
    # The twin takes any head dim (the kernels only 64 and 128): heads of 8
    # keep the numerical Jacobian at 768 inputs.
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2 * 8))).requires_grad_()
               for _ in range(3))
    kb = torch.zeros(2, 16, dtype=torch.float64)
    kb[1, 11:] = NEG_INF
    assert torch.autograd.gradcheck(
        lambda q, k, v: tatt.fused_attention_packed(q, k, v, kb, 2, seed, rate), (q, k, v))


@pytest.mark.parametrize("has_res", [True, False])
def test_k2_autograd_function_gradcheck_fp64(has_res, one_thread):
    rng = np.random.default_rng(7)
    x, res = (torch.from_numpy(rng.standard_normal((3, 5, 16))).requires_grad_()
              for _ in range(2))
    g, b = (torch.from_numpy(rng.standard_normal(16)).requires_grad_() for _ in range(2))
    if has_res:
        fn, args = (lambda x, r, g, b: tln.fused_add_layernorm(x, r, g, b, 1e-5)), (x, res, g, b)
    else:
        fn, args = (lambda x, g, b: tln.fused_add_layernorm(x, None, g, b, 1e-5)), (x, g, b)
    assert torch.autograd.gradcheck(fn, args)


def test_bwd_wrappers_take_twins_on_cpu_and_count_only_launches():
    rng = np.random.default_rng(8)
    q, k, v, kb = (torch.from_numpy(a) for a in _attention_inputs(2, 128, 2, 64, 9))
    dout = torch.from_numpy(rng.standard_normal((2, 128, 128)).astype(np.float32))
    _, lse = tatt.fused_attention_packed(q, k, v, kb, 2, need_lse=True)
    n = tatt.fused_attention_packed_bwd.launches
    got = tatt.fused_attention_packed_bwd(q, k, v, kb, dout, lse, 2)
    want = tatt.fused_attention_packed_bwd_reference(q, k, v, kb, dout, lse, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    m = tln.fused_add_layernorm_bwd.launches
    got = tln.fused_add_layernorm_bwd(x, x, None, torch.ones(64))
    want = tln.layernorm_bwd_reference(x, x, None, torch.ones(64), 1e-12)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tatt.fused_attention_packed_bwd.launches, tln.fused_add_layernorm_bwd.launches) == (n, m)
    with pytest.raises(ValueError, match="seed"):
        tatt.fused_attention_packed_bwd(q, k, v, kb, dout, lse, 2, None, 0.1)
