"""visitron_torch's CUDA kernels against their plain twins, and the
wrappers' refusals.  Imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

The ``gpu`` tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they decide that inside a fixture.
"""

import pytest
import torch

from visitron_torch.ops import attention as tatt
from visitron_torch.ops import layernorm as tln

NEG_INF = -1e9


def test_wrappers_refuse_other_devices_and_missing_seed():
    q = torch.empty(1, 128, 128, device="meta")
    with pytest.raises(ValueError):
        tatt.fused_attention_packed(q, q, q, torch.empty(1, 128, device="meta"), 2)
    with pytest.raises(ValueError, match="seed"):
        tatt.fused_attention_packed(torch.zeros(1, 128, 128), torch.zeros(1, 128, 128),
                                    torch.zeros(1, 128, 128), torch.zeros(1, 128), 2,
                                    None, 0.1)
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError):
        tln.fused_add_layernorm(x, None, torch.ones(128), torch.zeros(128))


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_matches_twin_on_card(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s, h = 4, 200, 4
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    kb = torch.where(torch.arange(s, device=cuda)[None] < torch.tensor(
        [[200], [150], [64], [1]], device=cuda), 0.0, NEG_INF).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for rate, seed in ((0.0, None), (0.1, 77)):
        got = tatt.fused_attention_packed(q, k, v, kb, h, seed, rate)
        want = tatt.fused_attention_packed_reference(q, k, v, kb, h, seed, rate)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_twin_on_card(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(300, 768, generator=g, device=cuda).to(dtype)
    res = torch.randn(300, 768, generator=g, device=cuda).to(dtype)
    gamma = torch.randn(768, generator=g, device=cuda)
    beta = torch.randn(768, generator=g, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for r in (res, None):
        got = tln.fused_add_layernorm(x, r, gamma, beta)
        want = tln.layernorm_reference(x, r, gamma, beta, 1e-12)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernels_refuse_unsupported_cuda_tensors(cuda):
    q = torch.zeros(1, 128, 64, device=cuda)  # 2 heads of 32: not taken
    with pytest.raises(ValueError, match="head dim"):
        tatt.fused_attention_packed(q, q, q, torch.zeros(1, 128, device=cuda), 2)
    x = torch.zeros(4, 100, device=cuda)  # hidden not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        tln.fused_add_layernorm(x, None, torch.ones(100, device=cuda),
                                torch.zeros(100, device=cuda))
    base = torch.zeros(1, 128, 129, dtype=torch.bfloat16, device=cuda)
    q = base[..., 1:]  # one head of 128, rows 2 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        tatt.fused_attention_packed(q, q, q, torch.zeros(1, 128, device=cuda), 1)


def _grad_tol(dtype):
    # bf16: the kernels round a_eff and ds to bf16 where the twin does and
    # sum in another order, so an output may differ by about one bf16 ulp;
    # the limit is chip_smoke.py's GRAD_TOL, about twice the largest error
    # seen on an H100.
    return (1e-4, 1e-4) if dtype == torch.float32 else (8e-3, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1b_kernel_matches_twin_on_card(cuda, dtype, d):
    g = torch.Generator(device=cuda).manual_seed(2)
    b, s, h = 4, 200, 4
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    q, k, v = qkv.split(h * d, dim=-1)
    dout = torch.randn(b, s, h * d, generator=g, device=cuda).to(dtype)
    kb = torch.where(torch.arange(s, device=cuda)[None] < torch.tensor(
        [[200], [150], [64], [1]], device=cuda), 0.0, NEG_INF).float()
    atol, rtol = _grad_tol(dtype)
    for rate, seed in ((0.0, None), (0.1, 77)):
        _, lse = tatt.fused_attention_packed(q, k, v, kb, h, seed, rate, need_lse=True)
        got = tatt.fused_attention_packed_bwd(q, k, v, kb, dout, lse, h, seed, rate)
        want = tatt.fused_attention_packed_bwd_reference(q, k, v, kb, dout, lse, h,
                                                         seed, rate)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(x.float(), y.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name} rate {rate}: {m}")


@pytest.mark.gpu
def test_k1_autograd_on_card_counts_launches(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 128, 3 * 128, generator=g, device=cuda, requires_grad=True)
    kb = torch.zeros(2, 128, device=cuda)
    before = (tatt.fused_attention_packed.launches, tatt.fused_attention_packed_bwd.launches)
    out = tatt.fused_attention_packed(*qkv.split(128, dim=-1), kb, 2, 5, 0.1)
    (gq,) = torch.autograd.grad(out.square().sum(), qkv)
    assert (tatt.fused_attention_packed.launches - before[0],
            tatt.fused_attention_packed_bwd.launches - before[1]) == (1, 1)
    ref = qkv.detach().cpu().requires_grad_()
    want = tatt.fused_attention_packed(*ref.split(128, dim=-1), kb.cpu(), 2, 5, 0.1)
    (gw,) = torch.autograd.grad(want.square().sum(), ref)
    torch.testing.assert_close(gq.cpu(), gw, atol=1e-4, rtol=1e-4)


def _k2b_meta_inputs(hidden=768, dy_shape=None, dy_dtype=torch.float32):
    x = torch.empty(4, hidden, device="meta")
    dy = torch.empty(dy_shape or (4, hidden), dtype=dy_dtype, device="meta")
    return dy, x, None, torch.empty(hidden, device="meta")


@pytest.mark.parametrize("case, inputs, match", [
    ("hidden not a multiple of 8", _k2b_meta_inputs(hidden=100), "multiple of 8"),
    ("hidden above 4096", _k2b_meta_inputs(hidden=4104), "at most 4096"),
    ("dy of another shape", _k2b_meta_inputs(dy_shape=(4, 776)), "dy must match"),
    ("dy of another dtype", _k2b_meta_inputs(dy_dtype=torch.bfloat16), "dy must match"),
    ("neither CPU nor CUDA", _k2b_meta_inputs(), "unsupported device"),
])
def test_k2b_wrapper_refuses_what_the_kernel_does_not_take(case, inputs, match):
    with pytest.raises(ValueError, match=match):
        tln.fused_add_layernorm_bwd(*inputs)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 63, 65, 300, 12288])
@pytest.mark.parametrize("hidden", [768, 136, 1024, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2b_kernel_matches_twin_on_card(cuda, dtype, hidden, rows):
    # H <= 1024 takes the register path (H 136: 17 vectors, lanes left idle),
    # H 4096 the general path; R 1, 63, 65 and 300 leave blocks and warps
    # part-filled, R 12288 is the S 768 pretraining step's.
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype)
    res = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype)
    dy = torch.randn(rows, hidden, generator=g, device=cuda).to(dtype)
    gamma = torch.randn(hidden, generator=g, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for r in (res, None):
        got = tln.fused_add_layernorm_bwd(dy, x, r, gamma)
        want = tln.layernorm_bwd_reference(dy, x, r, gamma, 1e-12)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
        for x_, y_ in zip(got[1:], want[1:]):  # fp32 sums over the rows
            torch.testing.assert_close(x_, y_, atol=1e-3, rtol=1e-4)
        again = tln.fused_add_layernorm_bwd(dy, x, r, gamma)  # no atomics
        assert all(torch.equal(a, b) for a, b in zip(got, again))


# -- K3: fused masked softmax-CE ------------------------------------------------

def test_ce_wrapper_refuses_other_devices_and_ignore_ids():
    from visitron_torch.ops import crossentropy as tce

    x = torch.empty(4, 100, device="meta")
    with pytest.raises(ValueError):
        tce.fused_masked_softmax_ce(x, torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="negative"):
        tce.fused_masked_softmax_ce(torch.zeros(4, 100), torch.zeros(4), ignore_id=0)


def _ce_inputs(rows, vocab, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (3.0 * torch.randn(rows, vocab, generator=g, device=device)).to(dtype)
    labels = torch.randint(0, vocab, (rows,), generator=g, device=device)
    labels[::10] = -1          # ignored rows
    labels[3] = vocab          # out of range: ignored as well
    labels[7] = vocab + 1000
    return x, labels


@pytest.mark.gpu
@pytest.mark.parametrize("vocab", [30525, 4099, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_kernels_match_twins_on_card(cuda, dtype, vocab):
    from visitron_torch.ops import crossentropy as tce

    x, labels = _ce_inputs(200, vocab, dtype, cuda, seed=5)
    ce, lse = tce._forward(x, labels)
    want_ce, want_lse = tce.masked_softmax_ce_reference(x, labels)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ce, want_ce, atol=1e-4, rtol=1e-5)
    valid = (labels >= 0) & (labels < vocab)
    assert torch.equal(ce[~valid], torch.zeros_like(ce[~valid]))
    gcot = torch.rand(200, generator=torch.Generator(device=cuda).manual_seed(6),
                      device=cuda)
    got = tce.fused_masked_softmax_ce_bwd(x, labels, lse, gcot)
    want = tce.masked_softmax_ce_bwd_reference(x, labels, want_lse, gcot)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    # bf16: one ulp of the twin's bf16 value; fp32: exp's rounding.
    tol = (1e-6, 8e-3) if dtype == torch.bfloat16 else (1e-6, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0], rtol=tol[1])
    assert torch.equal(got[~valid].float(), torch.zeros_like(got[~valid].float()))


@pytest.mark.gpu
def test_k3_autograd_on_card_counts_launches(cuda):
    from visitron_torch.ops import crossentropy as tce

    x, labels = _ce_inputs(64, 30525, torch.bfloat16, cuda, seed=7)
    x.requires_grad_()
    before = (tce.fused_masked_softmax_ce.launches, tce.fused_masked_softmax_ce_bwd.launches)
    ce = tce.fused_masked_softmax_ce(x, labels)
    (gx,) = torch.autograd.grad(ce.sum() / 3.0, x)
    assert (tce.fused_masked_softmax_ce.launches - before[0],
            tce.fused_masked_softmax_ce_bwd.launches - before[1]) == (1, 1)
    ref = x.detach().cpu().requires_grad_()
    want = tce.fused_masked_softmax_ce(ref, labels.cpu())
    (gw,) = torch.autograd.grad(want.sum() / 3.0, ref)
    torch.testing.assert_close(ce.cpu(), want, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gx.cpu().float(), gw.float(), atol=1e-6, rtol=8e-3)


# -- K4: fused attention on (B, H, S, D) ---------------------------------------------

def _views4(qkv, h, d):
    return [t.unflatten(-1, (h, d)).transpose(1, 2) for t in qkv.split(h * d, dim=-1)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [768, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_kernels_match_twins_and_k1_on_card(cuda, dtype, s, d):
    g = torch.Generator(device=cuda).manual_seed(8)
    b, h = 3, 4
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
    dout = torch.randn(b, s, h * d, generator=g, device=cuda).to(dtype)
    kb = torch.where(torch.arange(s, device=cuda)[None] < torch.tensor(
        [[s], [s - 100], [1]], device=cuda), 0.0, NEG_INF).float()
    q4, k4, v4 = _views4(qkv, h, d)
    do4 = dout.unflatten(-1, (h, d)).transpose(1, 2)
    # The same operands as contiguous (B, H, S, D) tensors: other head strides.
    c4 = [t.contiguous() for t in (q4, k4, v4)]
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    gatol, grtol = _grad_tol(dtype)
    for rate, seed in ((0.0, None), (0.1, 99)):
        out, lse = tatt.fused_attention(q4, k4, v4, kb, seed, rate, need_lse=True)
        want, want_lse = tatt.fused_attention_reference(q4, k4, v4, kb, seed, rate, True)
        torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        # K4 on views of the packed projection, K4 on contiguous copies and
        # K1 on the packed layout run the same arithmetic: equal bit for bit.
        assert torch.equal(tatt.fused_attention(*c4, kb, seed, rate), out)
        packed = tatt.fused_attention_packed(*qkv.split(h * d, dim=-1), kb, h, seed, rate)
        assert torch.equal(packed, out.transpose(1, 2).flatten(2))
        grads = tatt.fused_attention_bwd(q4, k4, v4, kb, do4, lse, seed, rate)
        wants = tatt.fused_attention_bwd_reference(q4, k4, v4, kb, do4, lse, seed, rate)
        for name, x, y in zip(("dq", "dk", "dv"), grads, wants):
            torch.testing.assert_close(x.float(), y.float(), atol=gatol, rtol=grtol,
                                       msg=lambda m: f"{name} rate {rate}: {m}")
        grads_c = tatt.fused_attention_bwd(*c4, kb, do4.contiguous(), lse, seed, rate)
        assert all(torch.equal(x, y) for x, y in zip(grads, grads_c))


@pytest.mark.gpu
def test_k4_autograd_on_card_counts_launches(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    h, d = 2, 64
    qkv = torch.randn(2, 640, 3 * h * d, generator=g, device=cuda, requires_grad=True)
    kb = torch.zeros(2, 640, device=cuda)
    before = (tatt.fused_attention.launches, tatt.fused_attention_bwd.launches,
              tatt.fused_attention_packed.launches)
    out = tatt.fused_attention(*_views4(qkv, h, d), kb, 5, 0.1)
    (gq,) = torch.autograd.grad(out.transpose(1, 2).flatten(2).square().sum(), qkv)
    assert (tatt.fused_attention.launches - before[0],
            tatt.fused_attention_bwd.launches - before[1],
            tatt.fused_attention_packed.launches - before[2]) == (1, 1, 0)
    ref = qkv.detach().cpu().requires_grad_()
    want = tatt.fused_attention(*_views4(ref, h, d), kb.cpu(), 5, 0.1)
    (gw,) = torch.autograd.grad(want.transpose(1, 2).flatten(2).square().sum(), ref)
    torch.testing.assert_close(gq.cpu(), gw, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K1b", "K4b", "K5b"])
@pytest.mark.parametrize("rate,seed", [(0.1, 13), (0.0, None)])
def test_attention_backward_is_bit_identical_run_to_run_on_card(cuda, kernel, rate, seed):
    """No atomics: two launches on the same bf16 inputs give equal dq/dk/dv."""
    g = torch.Generator(device=cuda).manual_seed(12)
    b, s, h, d = 2, 384, 4, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(torch.bfloat16)
    dout = torch.randn(b, s, h * d, generator=g, device=cuda).to(torch.bfloat16)
    kb = torch.zeros(b, s, device=cuda)
    kb[1, 300:] = NEG_INF
    q4, k4, v4 = _views4(qkv, h, d)
    do4 = dout.unflatten(-1, (h, d)).transpose(1, 2)
    out, lse = tatt._flash_forward(q4, k4, v4, kb, seed, rate, need_lse=True)
    if kernel == "K1b":
        run = lambda: tatt.fused_attention_packed_bwd(  # noqa: E731
            *qkv.split(h * d, dim=-1), kb, dout, lse, h, seed, rate)
    elif kernel == "K4b":
        run = lambda: tatt.fused_attention_bwd(q4, k4, v4, kb, do4, lse, seed, rate)  # noqa: E731
    else:
        run = lambda: tatt.flash_attention_bwd(  # noqa: E731
            q4, k4, v4, kb, out, do4, lse, seed, rate)
    first, second = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


# -- K5: flash attention, Q and K lengths of their own ------------------------------

FLASH_LENGTHS = [(256, 256), (128, 384), (384, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", FLASH_LENGTHS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_kernels_match_twins_on_card(cuda, dtype, d, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(10)
    b, h = 3, 2
    # q/k/v as (B, H, S, D) views of packed projections, as the model has them.
    q = _views4(torch.randn(b, sq, 3 * h * d, generator=g, device=cuda).to(dtype), h, d)[0]
    _, k, v = _views4(torch.randn(b, sk, 3 * h * d, generator=g, device=cuda).to(dtype),
                      h, d)
    dout = torch.randn(b, h, sq, d, generator=g, device=cuda).to(dtype)
    kb = torch.where(torch.arange(sk, device=cuda)[None] < torch.tensor(
        [[sk], [sk - 100], [1]], device=cuda), 0.0, NEG_INF).float()
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    gatol, grtol = _grad_tol(dtype)
    for rate, seed in ((0.0, None), (0.1, 99)):
        out, lse = tatt._flash_forward(q, k, v, kb, seed, rate, need_lse=True)
        want, want_lse = tatt.flash_attention_reference(q, k, v, kb, seed, rate, True)
        assert out.shape == (b, h, sq, d)
        torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        assert torch.equal(tatt.flash_attention(q, k, v, kb, seed, rate), out)
        if sq == sk:  # one body with K4f: equal bit for bit on the same data
            assert torch.equal(tatt.fused_attention(q, k, v, kb, seed, rate), out)
        grads = tatt.flash_attention_bwd(q, k, v, kb, out, dout, lse, seed, rate)
        wants = tatt.flash_attention_bwd_reference(q, k, v, kb, out, dout, lse, seed, rate)
        for name, x, y in zip(("dq", "dk", "dv"), grads, wants):
            assert x.shape == y.shape
            torch.testing.assert_close(x.float(), y.float(), atol=gatol, rtol=grtol,
                                       msg=lambda m: f"{name} rate {rate}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("rate,seed", [(0.1, 5), (0.0, None)])
def test_k5_autograd_on_card_counts_launches(cuda, rate, seed):
    """K5f forward; K5b backward at rate > 0, the plain recompute at rate 0."""
    g = torch.Generator(device=cuda).manual_seed(11)
    h, d = 2, 64
    qkv = torch.randn(2, 1024, 3 * h * d, generator=g, device=cuda, requires_grad=True)
    kb = torch.zeros(2, 1024, device=cuda)
    kb[1, 1000:] = NEG_INF
    counters = (tatt.flash_attention, tatt.flash_attention_bwd, tatt.fused_attention,
                tatt.fused_attention_bwd)
    before = [c.launches for c in counters]
    out = tatt.flash_attention(*_views4(qkv, h, d), kb, seed, rate)
    (gq,) = torch.autograd.grad(out.transpose(1, 2).flatten(2).square().sum(), qkv)
    assert [c.launches - n for c, n in zip(counters, before)] == [1, int(rate > 0), 0, 0]
    ref = qkv.detach().cpu().requires_grad_()
    want = tatt.flash_attention(*_views4(ref, h, d), kb.cpu(), seed, rate)
    (gw,) = torch.autograd.grad(want.transpose(1, 2).flatten(2).square().sum(), ref)
    torch.testing.assert_close(gq.cpu(), gw, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_k5_refuses_unsupported_cuda_tensors(cuda):
    q = torch.zeros(1, 2, 256, 64, device=cuda)
    kb = torch.zeros(1, 256, device=cuda)
    with pytest.raises(ValueError, match="multiples of 128"):
        tatt.flash_attention(q[:, :, :200], q, q, kb)
    with pytest.raises(ValueError, match="key_bias"):
        tatt.flash_attention(q, q, q, kb[:, :128])
    with pytest.raises(ValueError, match="dtype"):
        tatt.flash_attention(q.half(), q.half(), q.half(), kb)
    base = torch.zeros(1, 2, 256, 72, dtype=torch.bfloat16, device=cuda)
    x = base[..., 4:68]  # rows 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        tatt.flash_attention(x, x, x, kb)


# -- the bf16 forward body (K1f, K4f and K5f share it) ------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("s", [200, 65, 1])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 31)])
def test_k1f_ragged_length_on_card(cuda, s, rate, seed):
    """Lengths that are no multiple of the 64-key tile: rows past S are
    zero-filled and their keys get a -inf bias; out and lse against the twin."""
    g = torch.Generator(device=cuda).manual_seed(14)
    b, h, d = 3, 4, 64
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(h * d, dim=-1)
    kb = torch.zeros(b, s, device=cuda)
    kb[1, s // 2 + 1:] = NEG_INF
    out, lse = tatt.fused_attention_packed(q, k, v, kb, h, seed, rate, need_lse=True)
    want, want_lse = tatt.fused_attention_packed_reference(q, k, v, kb, h, seed, rate,
                                                           need_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk", [(128, 384), (384, 128)])
@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 57)])
def test_k5f_query_and_key_lengths_differ_d128_on_card(cuda, sq, sk, rate, seed):
    g = torch.Generator(device=cuda).manual_seed(15)
    b, h, d = 2, 3, 128
    q = _views4(torch.randn(b, sq, 3 * h * d, generator=g, device=cuda).to(torch.bfloat16),
                h, d)[0]
    _, k, v = _views4(torch.randn(b, sk, 3 * h * d, generator=g, device=cuda).to(
        torch.bfloat16), h, d)
    kb = torch.zeros(b, sk, device=cuda)
    kb[1, sk - 40:] = NEG_INF
    out, lse = tatt._flash_forward(q, k, v, kb, seed, rate, need_lse=True)
    want, want_lse = tatt.flash_attention_reference(q, k, v, kb, seed, rate, True)
    assert out.shape == (b, h, sq, d) and lse.shape == (b * h, sq)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_k5f_equals_k4f_bit_for_bit_at_dropout_on_card(cuda, d):
    """One device body: K5f and K4f on the same data agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(16)
    b, s, h = 2, 768, 768 // d
    q, k, v = _views4(torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(
        torch.bfloat16), h, d)
    kb = torch.zeros(b, s, device=cuda)
    kb[0, 700:] = NEG_INF
    k5, lse5 = tatt._flash_forward(q, k, v, kb, 99, 0.1, need_lse=True)
    k4, lse4 = tatt.fused_attention(q, k, v, kb, 99, 0.1, need_lse=True)
    assert torch.equal(k5, k4) and torch.equal(lse5, lse4)


@pytest.mark.gpu
def test_speaker_step_and_greedy_batch_launch_no_kernel_on_card(cuda):
    """One speaker train step (every dropout and the feature dropout on)
    and one greedy batch on the card: finite, and no K1-K5 launch (the
    speaker has no BERT, and its word CE is a plain fp32 cross-entropy)."""
    import numpy as np

    from visitron_torch.agents import NavEpisodeBatcher, NavRuntime
    from visitron_torch.agents.speaker import SpeakerAgent
    from visitron_torch.data import (SceneFeatureTable, WordPieceTokenizer,
                                     build_nav_instances, build_wordpiece_vocab)
    from visitron_torch.ops import crossentropy as tce
    from visitron_torch.testing import SyntheticWorld
    from visitron_torch.testing.synthetic import _TARGETS, _WORDS

    world = SyntheticWorld(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)
    rt = NavRuntime.build(world.graphs, SceneFeatureTable.pack(
        world.graphs, world.scene_features(), vfov=60), device=cuda)
    tok = WordPieceTokenizer(build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)],
                                                   vocab_size=512))
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        instances = build_nav_instances(world.write_task_data(d), ["train"], tok,
                                        max_seq_length=64)
    sp = SpeakerAgent(rt, feature_dim=64, vocab_size=len(tok),
                      bos_id=tok.vocab[tok.cls_token], eos_id=tok.vocab[tok.sep_token],
                      pad_id=tok.pad_token_id, episode_len=6, max_words=16, hidden_size=32,
                      wemb=16, feat_dropout=0.3, movement_frame=True, device=cuda)
    text = {i.inst_idx: SpeakerAgent.instance_text(i) for i in instances}
    batch = next(NavEpisodeBatcher(instances, rt, batch_size=8).train_batches(1, 6))
    wrappers = [f for mod in (tatt, tce, tln) for f in vars(mod).values()
                if hasattr(f, "launches")]
    assert len(wrappers) == 10
    before = [f.launches for f in wrappers]
    state = sp.init_state()
    state, loss = sp.train_step_fn()(state, sp.attach_words(batch, tok, text))
    arrays = sp.walk_arrays(sp.sample_walks(np.random.default_rng(0), 8))
    ids = sp.generate_fn(0.0)(state["params"], arrays)
    assert torch.isfinite(loss) and ids.shape == (8, 16) and ids.device.type == "cuda"
    assert [f.launches for f in wrappers] == before
