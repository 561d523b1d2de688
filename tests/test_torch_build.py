"""visitron_torch._build's reading of nvcc's ``-Xptxas -v`` output: the lines
it reports keep each kernel's resources and every performance warning (a
serialised ``wgmma`` batch must reach chip_smoke.py's build phase).  Needs
no nvcc: the output is a sample."""

import pytest

from visitron_torch import _build

ENTRY = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119attention_fwd_"
         "wgmmaILi64ELb1EEEvPK13__nv_bfloat16S3_S3_PKfPS1_PfiiiNS_11AttnStridesEjjff' "
         "for 'sm_90a'")
SPILLS = "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
REGISTERS = "ptxas info    : Used 128 registers, used 1 barriers, 424 bytes cmem[0]"
SERIALISED = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
              "instructions are serialized due to the presence of Extern calls in the "
              "function '_ZN12_GLOBAL__N_122attention_bwd_dq_wgmmaILi64ELb0EEEvPK13__nv_"
              "bfloat16S3_S3_PKfS3_S5_PS1_PfiiiiNS_11AttnStridesEjjff'.")
ACCUMULATORS = ("ptxas info    : (C7509) Potential Performance Loss: wgmma.mma_async "
                "instructions are serialized due to non wgmma instructions defining "
                "accumulator registers of a wgmma between start and end of the pipeline "
                "stage in the function 'f'.")
DROPPED = ("ptxas info    : 0 bytes gmem",
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_119attention_fwd",
           "nvcc warning : incompatible redefinition for option 'std', the last value "
           "of this option was used")


def test_ptxas_lines_keep_resources_and_drop_the_rest():
    text = "\n".join([DROPPED[0], ENTRY, DROPPED[1], SPILLS, REGISTERS, DROPPED[2]])
    assert _build.ptxas_lines(text) == [ENTRY.strip(), SPILLS.strip(), REGISTERS.strip()]


@pytest.mark.parametrize("warning", [SERIALISED, ACCUMULATORS,
                                     "ptxas info    : Potential Performance Loss: "
                                     "wgmma.mma_async instructions are serialized"])
def test_ptxas_lines_keep_performance_warnings(warning):
    text = "\n".join([ENTRY, warning, DROPPED[1], SPILLS, REGISTERS])
    got = _build.ptxas_lines(text)
    assert warning.strip() in got
    assert got == [ENTRY.strip(), warning.strip(), SPILLS.strip(), REGISTERS.strip()]


def test_ptxas_lines_do_not_take_other_numbers_for_codes():
    # "C7" only as a code of its own: not inside a mangled name or a count.
    line = "ptxas info    : Function properties for _Z3fooILC7512EEvv"
    assert _build.ptxas_lines(line) == []
