"""The NDH step profile (visitron_torch.testing.nav_profile,
tools/torch_profile_nav_step.py) on the CPU: the kernel kinds are the
first-match kinds chip_smoke.py grouped the pretraining step's kernels by
before they moved here, the per-step sums of a fixed kernel list, and a
profile without a CUDA kernel (any profile on the CPU) raises."""

import pytest
import torch

from visitron_torch.testing import nav_profile

# chip_smoke.py's table as it stood before it moved into nav_profile.
OLD_KINDS = (("K1/K4/K5 attention", ("::attention_fwd", "::attention_bwd")),
             ("K3 softmax-CE", ("::ce_fwd", "::ce_bwd")),
             ("K2f add+LayerNorm", ("::add_layernorm_fwd",)),
             ("K2b add+LayerNorm backward", ("::add_layernorm_bwd",)),
             ("GEMM (cuBLAS/CUTLASS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
             ("host-to-device copies", ("Memcpy HtoD",)),
             ("optimizer (foreach)", ("foreach", "multi_tensor")),
             ("other elementwise / reductions", ("",)))
NAMES = {
    "void (anonymous namespace)::attention_fwd_wgmma<64>(__nv_bfloat16 const*)":
        "K1/K4/K5 attention",
    "void (anonymous namespace)::attention_bwd_dq_wgmma<64>(float*)": "K1/K4/K5 attention",
    "void (anonymous namespace)::attention_bwd_dkv_wgmma<64>(float*)": "K1/K4/K5 attention",
    "void (anonymous namespace)::attention_bwd_di<float, 64>(float const*)":
        "K1/K4/K5 attention",
    "void (anonymous namespace)::ce_fwd<__nv_bfloat16>(long long const*)": "K3 softmax-CE",
    "void (anonymous namespace)::ce_bwd<float>(float const*)": "K3 softmax-CE",
    "void (anonymous namespace)::add_layernorm_fwd<__nv_bfloat16>(int)":
        "K2f add+LayerNorm",
    "void (anonymous namespace)::add_layernorm_bwd_ring<__nv_bfloat16, 3>(int)":
        "K2b add+LayerNorm backward",
    "void (anonymous namespace)::add_layernorm_bwd_sum(float const*, float*, int)":
        "K2b add+LayerNorm backward",
    "nvjet_tst_128x64_64x8_1x2_h_bz_coopA_TNT": "GEMM (cuBLAS/CUTLASS)",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "GEMM (cuBLAS/CUTLASS)",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>(Params)":
        "GEMM (cuBLAS/CUTLASS)",
    "Memcpy HtoD (Pinned -> Device)": "host-to-device copies",
    "Memcpy DtoD (Device -> Device)": "other elementwise / reductions",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<Adam>()":
        "optimizer (foreach)",
    "void at::native::vectorized_elementwise_kernel<4, foreach_tensor_mul>()":
        "optimizer (foreach)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel>()":
        "other elementwise / reductions",
    "void at::native::reduce_kernel<512, 1, ReduceOp<float, sum>>()":
        "other elementwise / reductions",
    "void at::native::index_elementwise_kernel<128, 4>()": "other elementwise / reductions",
}


def _old_first_match(name: str) -> str:
    return next(k for k, keys in OLD_KINDS if any(key in name for key in keys))


@pytest.mark.parametrize("name", sorted(NAMES))
def test_kinds_are_chip_smokes_old_first_match_kinds(name):
    assert nav_profile.kind_of(name) == _old_first_match(name) == NAMES[name]


def test_kinds_table_is_chip_smokes():
    """One copy: chip_smoke.py's profiles group and read through nav_profile."""
    import chip_smoke

    assert nav_profile.KERNEL_KINDS == OLD_KINDS
    assert not hasattr(chip_smoke, "KERNEL_KINDS")
    assert chip_smoke.device_kernels is nav_profile.device_kernels


def test_summary_of_a_fixed_kernel_list():
    """Two steps of 1 K1f, 1 K1b (dq + dk/dv), 3 K2f, 3 K2b (rows + sum),
    a GEMM and a copy, 4 ms of wall."""
    step = [("x::attention_fwd_wgmma<64>", 100.0), ("x::attention_bwd_dq_wgmma<64>", 150.0),
            ("x::attention_bwd_dkv_wgmma<64>", 250.0)]
    step += [("x::add_layernorm_fwd<bf16>", 10.0)] * 3
    step += [("x::add_layernorm_bwd_ring<bf16, 3>", 20.0), ("x::add_layernorm_bwd_sum", 2.0)] * 3
    step += [("nvjet_gemm", 300.0), ("Memcpy HtoD (Pinned -> Device)", 4.0)]
    s = nav_profile.summarize(step * 2, steps=2, wall_s=4e-3, top=3)
    busy = sum(us for _, us in step)
    assert s["steps"] == 2 and s["ms_per_step"] == 2.0
    assert s["busy_ms_per_step"] == round(busy / 1e3, 4)
    assert s["idle_share"] == round(1 - 2 * busy / 4000, 4)
    assert s["kernels_per_step"] == len(step)
    assert s["launches_per_step"] == {"K1f/K4f/K5f": 1, "K1b/K4b/K5b": 1, "K2f": 3, "K2b": 3,
                                      "K3f": 0, "K3b": 0}
    assert s["groups_ms_per_step"] == {"K1/K4/K5 attention": 0.5,
                                       "GEMM (cuBLAS/CUTLASS)": 0.3,
                                       "K2b add+LayerNorm backward": 0.066,
                                       "K2f add+LayerNorm": 0.03,
                                       "host-to-device copies": 0.004}
    assert s["groups_kernels_per_step"]["K2b add+LayerNorm backward"] == 6
    assert list(s["top_ops_ms_per_step"]) == ["nvjet_gemm", "x::attention_bwd_dkv_wgmma<64>",
                                              "x::attention_bwd_dq_wgmma<64>"]


def test_a_profile_without_a_cuda_kernel_raises():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert nav_profile.device_kernels(prof) == []
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        nav_profile.summarize(nav_profile.device_kernels(prof), steps=1, wall_s=1.0)


def test_profile_steps_on_the_cpu_raises():
    """A step is run warm, then profiled ``steps`` times, and the profile,
    which holds no CUDA kernel on the CPU, is refused."""
    states = []

    def step(state, batch):
        states.append(state)
        return state + 1, (batch @ batch).sum()

    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        nav_profile.profile_steps(step, 0, torch.ones(8, 8), steps=2)
    assert states == [0, 1, 2]
