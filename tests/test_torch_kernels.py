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


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [768, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2b_kernel_matches_twin_on_card(cuda, dtype, hidden):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(300, hidden, generator=g, device=cuda).to(dtype)
    res = torch.randn(300, hidden, generator=g, device=cuda).to(dtype)
    dy = torch.randn(300, hidden, generator=g, device=cuda).to(dtype)
    gamma = torch.randn(hidden, generator=g, device=cuda)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for r in (res, None):
        got = tln.fused_add_layernorm_bwd(dy, x, r, gamma)
        want = tln.layernorm_bwd_reference(dy, x, r, gamma, 1e-12)
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol, rtol=tol)
        for x_, y_ in zip(got[1:], want[1:]):  # sums over 300 rows
            torch.testing.assert_close(x_, y_, atol=1e-3, rtol=1e-4)
