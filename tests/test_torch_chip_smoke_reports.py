"""The pure-Python report helpers of ``chip_smoke.py`` (the script itself needs a GPU): the
``nvcc -Xptxas -v`` digest, the SASS digest of the flash kernels and the projection GEMM, the
attention passes' shared-memory sizes and the kernel bounds and rates; phase 16's launch
counts, decode agreement and trace families; phase 17's ring visit count."""

import numpy as np
import pytest
import torch

import chip_smoke as cs

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe220attention_mma_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe220attention_mma_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Function properties for _ZN55_GLOBAL__N__ee72dafa_22_block_attention_fwd_cu_649abda015mma_gemm_kernelI13__nv_bfloat16S1_Li0ELi1ELi1EEEvNS_11MmaGemmArgsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem
"""


def test_ptxas_report_names_each_kernel_with_its_registers_and_spills():
    lines = cs.ptxas_report(PTXAS_LOG)
    assert len(lines) == 2
    assert lines[0].startswith("attention_mma_kernelILi64ELi64EE: 0 bytes stack frame")
    assert "0 bytes spill stores" in lines[0] and lines[0].endswith("Used 127 registers, used 1 barriers")
    assert lines[1].startswith("mma_gemm_kernel<bfloat16, bfloat16, NN, LN, residual>: 8 bytes stack")
    assert "4 bytes spill stores" in lines[1] and "16384 bytes smem" in lines[1]
    assert cs.ptxas_report("") == []


def test_pass_smem_report_fits_a_block():
    """Every size the attention passes ask for is under the 227 KB a block can have, and the
    bfloat16 forward at D<=64 stays under the 48 KB that needs no opt-in."""
    lines = cs.pass_smem_report()
    assert len(lines) == 4
    sizes = [int(tok.rstrip(",")) for ln in lines for tok in ln.split() if tok.rstrip(",").isdigit()]
    assert len(sizes) == 12 and max(sizes) <= 232448
    assert "forward 27648," in lines[0]  # (64 + 4 * 32) rows x 72 bf16


def test_fused_bound_is_bytes_in_bfloat16_and_operations_in_float32():
    args = (256, 197, 12, 64, False)
    for kernel in ("fused_attention_fwd", "fused_attention_bwd"):
        assert cs.fused_bound(kernel, *args, "bfloat16")[1] == "bytes"
        assert cs.fused_bound(kernel, *args, "float32")[1] == "operations"
    ms, _, flops = cs.fused_bound("fused_attention_fwd", *args, "float32")
    assert flops == 4 * 256 * 12 * 197 * 197 * 64 and abs(ms - 1e3 * flops / 67e12) < 1e-9


def test_phase3_holds_the_tile_edge_and_padded_head_cases():
    fused = {(s, d, causal) for _, _, s, _, d, causal in cs.FUSED_CASES}
    assert {(129, 64, True), (191, 64, False), (257, 64, False), (512, 32, False)} <= fused
    block_dims = {w // h for _, _, _, w, h, _ in cs.BLOCK_CASES}
    ln_dims = {w // h for _, _, _, w, h, _, _ in cs.LN_CASES}
    assert {80, 88} <= block_dims and {80, 88} <= ln_dims
    # the eleven TPU-kernel counterparts, the two int8 kernels, the card's JPEG resample and the
    # block backward's weight gradients
    assert len(cs.KERNELS) == 15


FLASH_DQ = ("_ZN57_GLOBAL__N__2b5bc54b_18_flash_attention_cu_e4f1a2b315flash_dq_kernelINS_7Tf32Ops"
            "ILi64EEEEvPKNT_1TES6_S6_S6_PKfS8_PS4_iiifi")
FLASH_DKV = ("_ZN57_GLOBAL__N__2b5bc54b_18_flash_attention_cu_e4f1a2b316flash_dkv_kernelINS_7"
             "Bf16OpsILi128EEEEvPKNT_1TES6_S6_S6_PKfS8_PS4_S9_iiifi")
FLASH_FWD = ("_ZN57_GLOBAL__N__2b5bc54b_18_flash_attention_cu_e4f1a2b316flash_fwd_kernelIfLi4EEvPKT_"
             "S3_S3_PS1_Pfiiifi")
GEMM_NT = ("_ZN59_GLOBAL__N__2b5bc54b_22_block_attention_bwd_cu_e4f1a2b315mma_gemm_kernelI13__nv_"
           "bfloat16fLi1ELi0ELi0EEEvNS_11MmaGemmArgsE")
GEMM_NN = ("_ZN59_GLOBAL__N__2b5bc54b_22_block_attention_bwd_cu_e4f1a2b315mma_gemm_kernelIffLi0ELi0E"
           "Li0EEEvNS_11MmaGemmArgsE")
GEMM_FWD_LN = ("_ZN59_GLOBAL__N__2b5bc54b_22_block_attention_fwd_cu_e4f1a2b315mma_gemm_kernelI13__nv_"
               "bfloat16S1_Li0ELi1ELi1EEEvNS_11MmaGemmArgsE")
GEMM_DW1 = ("_ZN50_GLOBAL__N__2b5bc54b_12_block_mlp_cu_e4f1a2b315mma_gemm_kernelIffLi2ELi3ELi0EEEv"
            "NS_11MmaGemmArgsE")
GEMM_DH = ("_ZN50_GLOBAL__N__2b5bc54b_12_block_mlp_cu_e4f1a2b315mma_gemm_kernelI13__nv_bfloat16S1_"
           "Li1ELi0ELi2EEEvNS_11MmaGemmArgsE")
GEMM_PROJ = ("_ZN50_GLOBAL__N__2b5bc54b_12_block_mlp_cu_e4f1a2b315mma_gemm_kernelI13__nv_bfloat16"
             "S1_Li0ELi0ELi3EEEvNS_11MmaGemmArgsE")


def test_kernel_label_writes_out_the_flash_operand_structs():
    assert cs.kernel_label(FLASH_DQ) == "flash_dq_kernel<Tf32Ops<64>>"
    assert cs.kernel_label("Function : " + FLASH_DKV) == "flash_dkv_kernel<Bf16Ops<128>>"
    assert cs.kernel_label(FLASH_FWD) == "flash_fwd_kernelIfLi4E"


def test_kernel_label_writes_out_the_gemm_types_and_form():
    """Types, form, load transform and store of each instantiation; a bf16 -> bf16 GEMM's
    second type is a back-reference in the mangled name."""
    assert cs.kernel_label(GEMM_NT) == "mma_gemm_kernel<bfloat16, float, NT, plain, round>"
    assert cs.kernel_label("Function : " + GEMM_NN) == (
        "mma_gemm_kernel<float, float, NN, plain, round>")
    assert cs.kernel_label(GEMM_FWD_LN) == (
        "mma_gemm_kernel<bfloat16, bfloat16, NN, LN, residual>")
    assert cs.kernel_label(GEMM_DW1) == "mma_gemm_kernel<float, float, TN, LN-b, round>"
    assert cs.kernel_label(GEMM_DH) == "mma_gemm_kernel<bfloat16, bfloat16, NT, plain, act'>"
    assert cs.kernel_label(GEMM_PROJ) == (
        "mma_gemm_kernel<bfloat16, bfloat16, NN, plain, bias-residual>")


def test_flash_hmma_report_names_the_tensor_core_forms():
    sass = "\n".join([
        f"\t\tFunction : {FLASH_DQ}",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        "        /*0110*/                   HMMA.1688.F32.TF32 R16, R8, R12, R16 ;",
        f"\t\tFunction : {FLASH_DKV}",
        "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        f"\t\tFunction : {FLASH_FWD}",
        "        /*0100*/                   FFMA R4, R8, R12, R4 ;",
        "\t\tFunction : _ZN51_GLOBAL__N__x_18_fused_attention_cu_de02afe220attention_mma_kernel"
        "ILi64EEEvv",
        "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        f"\t\tFunction : {GEMM_NN}",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    ])
    assert cs.hmma_report(sass) == [
        "flash_dkv_kernel<Bf16Ops<128>>: HMMA.16816.F32.BF16 x 1",
        "flash_dq_kernel<Tf32Ops<64>>: HMMA.1688.F32.TF32 x 2",
        "flash_fwd_kernelIfLi4E: no HMMA (CUDA cores)",
        "mma_gemm_kernel<float, float, NN, plain, round>: HMMA.1688.F32.TF32 x 1"]
    assert "1 *_mma_kernel functions" in cs.sass_report(sass)


def test_gemm_hmma_faults_name_each_instantiation_off_its_tensor_core_form():
    """Phase 2 fails on a projection-GEMM instantiation whose products are not all in its
    dtype's tensor-core form (bf16 m16n8k16, float32 TF32 m16n8k8) or that has none; the
    flash kernels are reported, not held to it."""
    ok = "\n".join([
        f"\t\tFunction : {GEMM_PROJ}",
        "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        f"\t\tFunction : {GEMM_DW1}",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        f"\t\tFunction : {FLASH_FWD}",
        "        /*0100*/                   FFMA R4, R8, R12, R4 ;",
    ])
    assert cs.gemm_hmma_faults(ok) == []
    bad = "\n".join([
        ok,
        f"\t\tFunction : {GEMM_NN}",
        "        /*0100*/                   FFMA R4, R8, R12, R4 ;",
        f"\t\tFunction : {GEMM_NT}",
        "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "        /*0110*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
    ])
    faults = cs.gemm_hmma_faults(bad)
    assert len(faults) == 2
    assert faults[0].startswith("mma_gemm_kernel<bfloat16, float, NT, plain, round>: ")
    assert faults[1] == "mma_gemm_kernel<float, float, NN, plain, round>: no HMMA"


# the bfloat16 wgmma flash kernels, as nvcc 12 mangles and cuobjdump prints them
WGMMA_FWD = ("_ZN51_GLOBAL__N__3c14b842_18_flash_attention_cu_3b8c1c3316flash_fwd_kernelINS_8"
             "WgmmaOpsILi64EEEEEvNT_4MapsEP13__nv_bfloat16Pfiiifi")
WGMMA_DKV = ("_ZN51_GLOBAL__N__3c14b842_18_flash_attention_cu_3b8c1c3316flash_dkv_kernelINS_8"
             "WgmmaOpsILi128EEEEEvNT_4MapsEPKfS6_P13__nv_bfloat16S8_iiifi")
WGMMA_DQ = ("_ZN51_GLOBAL__N__3c14b842_18_flash_attention_cu_3b8c1c3315flash_dq_kernelINS_8"
            "WgmmaOpsILi64EEEEEvNT_4MapsEPKfS6_P13__nv_bfloat16iiifi")


def test_flash_wgmma_faults_hold_the_bf16_forward_and_dkv_to_wgmma():
    """Phase 2 fails on a bfloat16 flash forward, dQ or dK/dV instantiation with an HMMA or
    without a GMMA, and when any of the three has no bfloat16 instantiation; the float32 forms
    keep their mma.sync (HMMA) and are not held to it."""
    assert cs.kernel_label(WGMMA_FWD) == "flash_fwd_kernel<WgmmaOps<64>>"
    assert cs.kernel_label("Function : " + WGMMA_DKV) == "flash_dkv_kernel<WgmmaOps<128>>"
    assert cs.kernel_label(WGMMA_DQ) == "flash_dq_kernel<WgmmaOps<64>>"
    ok = "\n".join([
        f"\t\tFunction : {WGMMA_FWD}",
        "        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "        /*0110*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;",
        f"\t\tFunction : {WGMMA_DKV}",
        "        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        f"\t\tFunction : {WGMMA_DQ}",
        "        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        f"\t\tFunction : {FLASH_DQ}",
        "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;",
        f"\t\tFunction : {FLASH_DKV}",  # dK/dV on Bf16Ops: not a WgmmaOps form, but bfloat16
        "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
    ])
    faults = cs.flash_wgmma_faults(ok)
    assert faults == ["flash_dkv_kernel<Bf16Ops<128>>: {'HMMA.16816.F32.BF16': 1}"]
    assert cs.flash_wgmma_faults(ok.rsplit("\t\tFunction", 1)[0]) == []
    assert "flash_fwd_kernel<WgmmaOps<64>>: HGMMA.64x128x16.F32.BF16 x 1, " \
           "HGMMA.64x64x16.F32.BF16 x 1" in cs.hmma_report(ok)
    mixed = "\n".join([
        f"\t\tFunction : {WGMMA_FWD}",
        "        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
        "        /*0110*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        f"\t\tFunction : {WGMMA_DKV}",
        "        /*0100*/                   FFMA R4, R8, R12, R4 ;",
    ])
    faults = cs.flash_wgmma_faults(mixed)
    assert len(faults) == 3 and faults[0].startswith("flash_dkv_kernel<WgmmaOps<128>>: no ")
    assert faults[1].startswith("flash_fwd_kernel<WgmmaOps<64>>: {") and "HMMA" in faults[1]
    assert faults[2] == "flash_dq_kernel: no bfloat16 instantiation"
    assert cs.flash_wgmma_faults(f"\t\tFunction : {FLASH_DQ}\n") == [
        "flash_fwd_kernel: no bfloat16 instantiation",
        "flash_dq_kernel: no bfloat16 instantiation",
        "flash_dkv_kernel: no bfloat16 instantiation"]
    # the bfloat16 dQ on mma.sync, as it ran before it moved onto wgmma, is a fault now
    dq_hmma = ok.replace(
        f"{WGMMA_DQ}\n        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
        "RZ, !UPT ;",
        f"{WGMMA_DQ}\n        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;")
    assert "flash_dq_kernel<WgmmaOps<64>>: {'HMMA.16816.F32.BF16': 1}" in cs.flash_wgmma_faults(
        dq_hmma)


# the bfloat16 fused forward, as nvcc 12 mangles and cuobjdump prints it
WGMMA_FUSED = ("_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe216fused_fwd_kernelINS_8"
               "FusedOpsILi{}ELi{}EEEEEvNS_9FusedMapsEiiifi")
FUSED_OPS = [(64, 128), (64, 112), (64, 96), (128, 64)]
# the fused backward's kernels of its own: bfloat16 dQ (head dim class, key tile) and dK/dV
# (head dim class) on wgmma, float32 dQ and dK/dV on 3xTF32
WGMMA_FUSED_DQ = ("_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe215fused_dq_kernelINS_10"
                  "FusedDqOpsILi{}ELi{}EEEEEvNS_12FusedBwdMapsEPfP13__nv_bfloat16iiiifi")
WGMMA_FUSED_DKV = ("_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe216fused_dkv_kernelINS_"
                   "11FusedDkvOpsILi{}EEEEEvNS_12FusedBwdMapsEPKfP13__nv_bfloat16S7_iiiifi")
# the float32 fused backward: the flash dQ and dK/dV kernels on Tf32Ops
TF32_FUSED = ("_ZN57_GLOBAL__N__2b5bc54b_18_flash_attention_cu_e4f1a2b3{}INS_7Tf32OpsILi{}EEEEv"
              "PKNT_1TES6_S6_S6_PKfS8_PS4_iiifi")
HGMMA = "        /*0100*/                   HGMMA.64x{}x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;"
TF32_HMMA = "        /*0200*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;"


def fused_bwd_sass(hmma_in=None, tf32_form=TF32_HMMA):
    """SASS of the fused backward's eight instantiations; ``hmma_in`` names a bfloat16 one that
    holds an mma.sync product beside its wgmma, ``tf32_form`` the float32 ones' product."""
    lines = []
    for dp, keys in ((64, 64), (128, 32)):
        name = WGMMA_FUSED_DQ.format(dp, keys)
        lines += [f"\t\tFunction : {name}", HGMMA.format(keys), HGMMA.format(dp)]
        if hmma_in == cs.kernel_label(name):
            lines.append("        /*0300*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;")
    for dp in (64, 128):
        lines += [f"\t\tFunction : {WGMMA_FUSED_DKV.format(dp)}", HGMMA.format(32),
                  HGMMA.format(dp)]
        for kernel in ("15flash_dq_kernel", "16flash_dkv_kernel"):
            lines += [f"\t\tFunction : {TF32_FUSED.format(kernel, dp)}", tf32_form]
    return "\n".join(lines)


def test_fused_wgmma_faults_hold_every_bf16_fused_forward_instantiation_to_wgmma():
    """Phase 2 fails on a bfloat16 fused-forward instantiation with an HMMA or without a GMMA,
    and on a build with fewer than its four instantiations (three key tiles at D <= 64, one
    above) beside the backward's five; the attention passes (the float32 forward core) are not
    held to it."""
    assert cs.kernel_label(WGMMA_FUSED.format(64, 112)) == "fused_fwd_kernel<FusedOps<64, 112>>"
    ok = "\n".join(
        [line for dp, keys in FUSED_OPS for line in (
            f"\t\tFunction : {WGMMA_FUSED.format(dp, keys)}",
            f"        /*0100*/                   HGMMA.64x{keys}x16.F32.BF16 R24, gdesc[UR4], RZ, "
            "!UPT ;",
            f"        /*0110*/                   HGMMA.64x{dp}x16.F32.BF16 R88, R152, gdesc[UR8], "
            "R88 ;")] + [fused_bwd_sass()])
    passes = "\n".join([ok, "\t\tFunction : _ZN51_GLOBAL__N__x_18_fused_attention_cu_de02afe220"
                         "attention_mma_kernelILi64EEEvv",
                         "        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"])
    assert cs.fused_wgmma_faults(passes) == []
    assert "fused_fwd_kernel<FusedOps<64, 112>>: HGMMA.64x112x16.F32.BF16 x 1, " \
           "HGMMA.64x64x16.F32.BF16 x 1" in cs.hmma_report(ok)
    # the mma.sync forward core in the fused forward's place is a fault
    bad = ok.replace("HGMMA.64x96x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT",
                     "HMMA.16816.F32.BF16 R4, R8, R12, R4")
    faults = cs.fused_wgmma_faults(bad)
    assert len(faults) == 1 and faults[0].startswith("fused_fwd_kernel<FusedOps<64, 96>>: {")
    assert "HMMA.16816.F32.BF16" in faults[0]
    no_tc = ok.replace("HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88",
                       "FFMA R88, R152, R8, R88").replace(
        "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT", "FFMA R24, R4, R8, R24")
    assert cs.fused_wgmma_faults(no_tc) == [
        "fused_fwd_kernel<FusedOps<64, 128>>: no tensor-core instructions"]
    short = ok.replace(f"\t\tFunction : {WGMMA_FUSED.format(128, 64)}", "\t\tFunction : other")
    assert cs.fused_wgmma_faults(short) == [
        "7 fused_fwd_kernel / fused_dq_kernel / fused_dkv_kernel instantiations in the SASS, "
        f"{cs.FUSED_WGMMA_INSTANTIATIONS} expected"]


def test_fused_wgmma_faults_hold_the_backward_to_wgmma_and_3xtf32():
    """Phase 2 holds every bfloat16 instantiation of the fused backward (dQ and dK/dV at each
    head dim class) to wgmma with no HMMA, and every float32 one (the flash dQ and dK/dV
    kernels on Tf32Ops) to HMMA.1688.F32.TF32 alone; a missing instantiation is a fault too."""
    fwd = "\n".join(f"\t\tFunction : {WGMMA_FUSED.format(dp, keys)}\n" + HGMMA.format(keys)
                    for dp, keys in FUSED_OPS)
    assert cs.kernel_label(WGMMA_FUSED_DQ.format(128, 32)) == (
        "fused_dq_kernel<FusedDqOps<128, 32>>")
    assert cs.kernel_label(WGMMA_FUSED_DKV.format(128)) == "fused_dkv_kernel<FusedDkvOps<128>>"
    assert cs.kernel_label(TF32_FUSED.format("16flash_dkv_kernel", 64)) == (
        "flash_dkv_kernel<Tf32Ops<64>>")
    assert cs.fused_wgmma_faults(fwd + "\n" + fused_bwd_sass()) == []
    report = cs.hmma_report(fused_bwd_sass())
    assert "flash_dq_kernel<Tf32Ops<128>>: HMMA.1688.F32.TF32 x 1" in report
    # an mma.sync product in a bfloat16 backward instantiation
    faults = cs.fused_wgmma_faults(fwd + "\n" + fused_bwd_sass(
        hmma_in="fused_dq_kernel<FusedDqOps<128, 32>>"))
    assert len(faults) == 1 and faults[0].startswith("fused_dq_kernel<FusedDqOps<128, 32>>: {")
    assert "HMMA.16816.F32.BF16" in faults[0]
    # float32 products off the tensor cores (CUDA-core FMAs), or on one TF32 product's form
    for form in ("        /*0200*/                   FFMA R4, R8, R12, R4 ;",
                 "        /*0200*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"):
        faults = cs.fused_wgmma_faults(fwd + "\n" + fused_bwd_sass(tf32_form=form))
        assert len(faults) == 4 and all("_kernel<Tf32Ops<" in f for f in faults)
    short = fused_bwd_sass().rsplit("\t\tFunction", 1)[0]
    assert cs.fused_wgmma_faults(fwd + "\n" + short) == [
        "3 flash_dq_kernel / flash_dkv_kernel instantiations in the SASS, "
        f"{cs.FUSED_TF32_INSTANTIATIONS} expected"]


def test_fused_backward_edge_cases_cross_the_new_tiles_in_both_dtypes():
    """Phase 3's edges of the fused backward: S one short of, at and one past the 128-row
    passes and each key or row tile, D = 32, 64 and 128, causal and not, B = 1 and 256; the
    float32 bound at the 3xTF32 ceiling with the CUDA cores' beside it."""
    cases = {(b, s, d, causal) for _, b, s, _, d, causal in cs.FUSED_BWD_EDGE_CASES}
    assert len(cases) == len(cs.FUSED_BWD_EDGE_CASES) == 120
    assert {s for _, s, _, _ in cases} == {128, 129, 191, 192, 193, 255, 256, 257, 511, 512}
    assert {d for _, _, d, _ in cases} == {32, 64, 128} and {b for b, *_ in cases} == {1, 256}
    assert {c for *_, c in cases} == {False, True}
    assert "fused_attention_bwd" in cs.TF32_KERNELS
    ms, by, flops = cs.fused_bound("fused_attention_bwd", 256, 197, 12, 64, False, "float32")
    assert by == "operations" and abs(ms - 1e3 * flops / (495e12 / 3)) < 1e-9
    assert "bound_cuda_cores_ms" in cs.rate_note("fused_attention_bwd", "float32", 3.0, ms, flops)


def test_fused_and_dq_edge_cases_cross_the_new_tiles():
    """Phase 3's bfloat16 edges of the two new kernels: the fused forward at S one short of, at
    and one past its 128-row passes and each key tile width it picks, D = 32, 64 and 128, causal
    and not, B = 1 and 256; dQ at Sq around its 128-row query tiles and Sk around its key tiles,
    Sq != Sk both ways, D = 80 and 88 among them."""
    fused = {(b, s, d, causal) for _, b, s, _, d, causal in cs.FUSED_EDGE_CASES}
    assert len(fused) == len(cs.FUSED_EDGE_CASES) == 120
    assert {s for _, s, _, _ in fused} == {128, 129, 191, 192, 193, 255, 256, 257, 511, 512}
    assert {d for _, _, d, _ in fused} == {32, 64, 128} and {b for b, *_ in fused} == {1, 256}
    dq = [(sq, sk, d) for _, _, sq, sk, _, d, _ in cs.DQ_EDGE_CASES]
    sqs = {sq for sq, _, _ in dq}
    assert {127, 129} <= sqs and {63, 65} <= sqs | {sk for _, sk, _ in dq}
    assert any(sq < sk for sq, sk, _ in dq) and any(sq > sk for sq, sk, _ in dq)
    assert {80, 88} <= {d for *_, d in dq}
    assert {causal for *_, causal in cs.DQ_EDGE_CASES} == {False, True}


# the fused MLP's bfloat16 GEMM, as nvcc 12 mangles and cuobjdump prints it
WGMMA_MLP = ("_ZN45_GLOBAL__N__032e4a30_12_block_mlp_cu_142b870417wgmma_gemm_kernelI13__nv_"
             "bfloat16{}EEv14CUtensorMap_stS2_NS_13WgmmaGemmArgsE")
WGMMA_MLP_ARGS = ["S1_Li0ELi1ELi4ELi128E", "S1_Li0ELi0ELi3ELi128E", "S1_Li0ELi0ELi0ELi128E",
                  "S1_Li1ELi0ELi2ELi128E", "fLi1ELi0ELi0ELi256E", "fLi2ELi2ELi0ELi256E",
                  "fLi2ELi3ELi0ELi256E"]


def test_mlp_wgmma_faults_hold_every_bf16_mlp_instantiation_to_wgmma():
    """Phase 2 fails on a bfloat16 fused-MLP GEMM instantiation with an HMMA or without a GMMA,
    and on a build with fewer than its seven instantiations; the float32 MLP's mma_gemm_kernel
    is not held to it (gemm_hmma_faults holds it to 3xTF32)."""
    assert cs.kernel_label(WGMMA_MLP.format("fLi2ELi3ELi0ELi256E")) == \
        "wgmma_gemm_kernel<bfloat16, float, TN, LN-b, round>"
    ok = "\n".join(
        line for args in WGMMA_MLP_ARGS for line in (
            f"\t\tFunction : {WGMMA_MLP.format(args)}",
            "        /*0100*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;"))
    with_f32 = "\n".join([ok, f"\t\tFunction : {GEMM_DW1}",
                          "        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;"])
    assert cs.mlp_wgmma_faults(with_f32) == [] and cs.gemm_hmma_faults(with_f32) == []
    assert "wgmma_gemm_kernel<bfloat16, bfloat16, NN, LN, round+act>: HGMMA.64x128x16.F32.BF16" \
           " x 1" in cs.hmma_report(ok)
    bad = ok.replace(f"{WGMMA_MLP.format('fLi2ELi2ELi0ELi256E')}\n        /*0100*/                   "
                     "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;",
                     f"{WGMMA_MLP.format('fLi2ELi2ELi0ELi256E')}\n        /*0100*/                   "
                     "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;")
    faults = cs.mlp_wgmma_faults(bad)
    assert faults == ["wgmma_gemm_kernel<bfloat16, float, TN, act, round>: "
                      "{'HMMA.16816.F32.BF16': 1}"]
    short = ok.rsplit("\t\tFunction", 1)[0]
    assert cs.mlp_wgmma_faults(short) == [
        f"6 wgmma_gemm_kernel instantiations in the SASS, {cs.MLP_WGMMA_INSTANTIATIONS} expected"]


def test_mlp_edge_cases_cross_the_wgmma_tiles_and_splits():
    """Phase 3's bfloat16 MLP edges: T one short of and one past the 128-row tiles and the
    64-row K-steps, T = 1, the widths and hidden sizes and both activations the issue names,
    and T around a weight-gradient split: one with a one-row last split, one with a split
    that holds no row (zeroed, not launched)."""
    import torch

    from multimodal_tpu_torch.ops import block_mlp as bm

    ts = {b * s for _, b, s, _, _, _ in cs.MLP_EDGE_CASES}
    assert {1, 63, 65, 127, 129} <= ts
    assert {w for *_, w, _, _ in cs.MLP_EDGE_CASES} == {128, 512, 768, 1024}
    assert {h for *_, h, _ in cs.MLP_EDGE_CASES} == {128, 3072}
    assert {a for *_, a in cs.MLP_EDGE_CASES} == {"quick_gelu", "gelu"}
    last_rows, empty = set(), False
    for _, b, s, w, hid, _ in cs.MLP_EDGE_CASES:
        t = b * s
        splits = bm._wgrad_splits(t, w, hid, torch.bfloat16)
        kps = -(-(-(-t // splits)) // 64) * 64
        used = -(-t // kps)
        last_rows.add(t - (used - 1) * kps)
        empty |= used < splits
    assert 1 in last_rows and empty


def test_flash_edge_cases_cross_the_wgmma_tiles():
    """Phase 3's bfloat16 edge cases: one short of and one past the 128-row blocks and their
    64-row halves, causal and not, at every head dim class."""
    shapes = {(s, d, causal) for _, _, s, sk, _, d, causal in cs.FLASH_EDGE_CASES if s == sk}
    assert len(cs.FLASH_EDGE_CASES) == len(shapes) == 40
    assert {s for s, _, _ in shapes} == {127, 129, 255, 257}
    assert {d for _, d, _ in shapes} == {8, 24, 64, 96, 128}


def test_flash_bound_and_rate():
    """B=8 S=2048 H=8 D=64 causal: dQ forms three products of 2 x pairs x D FLOPs (51.5
    GFLOP), dK/dV four, the forward two; all are bound by operations; the float32 trio's bound
    is taken at the 3xTF32 ceiling (495 / 3 TFLOP/s), the arithmetic it runs, and its lines
    give the CUDA-core bound beside it."""
    args = (8, 2048, 2048, 8, 64, True)
    flops = cs.flash_flops("flash_attention_dq", *args)
    assert abs(flops - 6 * 8 * 8 * 2048 * 2049 / 2 * 64) < 1
    assert cs.flash_flops("flash_attention_dkv", *args) == flops * 4 / 3
    for dtype, peak in (("float32", cs.PEAK_3XTF32), ("bfloat16", cs.PEAK_FLOPS["bfloat16"])):
        for kernel in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
            ms, by, f = cs.flash_bound(kernel, *args, dtype)
            assert by == "operations" and f == cs.flash_flops(kernel, *args)
            assert abs(ms - 1e3 * f / peak) < 1e-9
    assert abs(cs.flash_bound("flash_attention_fwd", *args, "float32")[0] - 0.2083) < 1e-4
    assert abs(cs.flash_bound("flash_attention_fwd", *args, "bfloat16")[0] - 0.0348) < 1e-4
    assert abs(cs.flash_bound("flash_attention_dq", *args, "float32")[0] - 0.3125) < 1e-4
    note = cs.rate_note("flash_attention_dq", "float32", 1.0, 0.5, flops)
    assert "tflops=51.6" in note and "of_bound=50.0%" in note
    assert "bound_cuda_cores_ms=0.7696" in note
    assert "cuda_core" not in cs.rate_note("flash_attention_dq", "bfloat16", 1.0, 0.5, flops)
    assert "cuda_core" in cs.rate_note("flash_attention_fwd", "float32", 1.0, 0.5, flops)


def test_block_backward_bound_and_rate():
    """ViT-B/32 vision S=50 W=768 B=256: seven projection-sized products and six core products,
    105.7 GFLOP of GEMMs and the attention beside them (bound 0.1128 ms in bfloat16); the
    float32 backward is bound at the 3xTF32 ceiling its GEMMs run at, with the CUDA-core bound
    in its note. So is the forward, whose GEMMs run 3xTF32 too."""
    args = (256, 50, 768, 12, False)
    ms, by, flops = cs.block_bound("block_attention_bwd", *args, "bfloat16")
    assert by == "operations" and abs(ms - 0.1128) < 1e-4
    assert abs(14 * 256 * 50 * 768 ** 2 - 105.7e9) < 0.1e9
    ms32, _, flops32 = cs.block_bound("block_attention_ln_bwd", *args, "float32")
    assert flops32 == flops and abs(ms32 - 1e3 * flops / cs.PEAK_3XTF32) < 1e-9
    assert "bound_cuda_cores_ms" in cs.rate_note("block_attention_bwd", "float32", 1.0, ms32, flops)
    assert "cuda_core" not in cs.rate_note("block_attention_bwd", "bfloat16", 1.0, ms, flops)
    ms_f, _, flops_f = cs.block_bound("block_attention_fwd", *args, "float32")
    assert flops_f == 8 * 12800 * 768 ** 2 + 4 * 256 * 12 * 2500 * 64
    assert abs(ms_f - 1e3 * flops_f / cs.PEAK_3XTF32) < 1e-9
    assert "bound_cuda_cores_ms" in cs.rate_note("block_attention_fwd", "float32", 1.0, ms_f,
                                                 flops_f)
    ms_ln, _, _ = cs.block_bound("block_attention_ln_fwd", *args, "float32")
    assert abs(ms_ln - 1e3 * flops_f / cs.PEAK_3XTF32) < 1e-9


def test_mlp_bound_and_rate():
    """ViT-B/16 T=256x197 W=768 H=3072: two products forward (238 GFLOP each), four backward.
    Both float32 kernels are bound at the 3xTF32 ceiling, their products' arithmetic (the
    forward at 2.884 ms, where the CUDA-core peak gives 7.1035), with the CUDA-core bound in
    their notes."""
    args = (256 * 197, 768, 3072)
    ms, by, flops = cs.mlp_bound("block_mlp_fwd", *args, "float32")
    assert by == "operations" and flops == 4 * 256 * 197 * 768 * 3072
    assert abs(ms - 1e3 * flops / cs.PEAK_3XTF32) < 1e-9 and abs(ms - 2.884) < 1e-3
    note = cs.rate_note("block_mlp_fwd", "float32", 14.0, ms, flops)
    assert "bound_cuda_cores_ms=7.1035" in note and "c_proj" not in note
    ms_b, _, flops_b = cs.mlp_bound("block_mlp_bwd", *args, "float32")
    assert flops_b == 2 * flops and abs(ms_b - 1e3 * flops_b / cs.PEAK_3XTF32) < 1e-9
    assert "bound_cuda_cores_ms" in cs.rate_note("block_mlp_bwd", "float32", 20.0, ms_b, flops_b)
    ms_bf, _, _ = cs.mlp_bound("block_mlp_bwd", *args, "bfloat16")
    assert abs(ms_bf - 0.9625) < 1e-4
    ms_ff, _, _ = cs.mlp_bound("block_mlp_fwd", *args, "bfloat16")
    assert abs(ms_ff - 0.4812) < 1e-4
    assert "cuda_core" not in cs.rate_note("block_mlp_fwd", "bfloat16", 1.0, ms_ff, flops)


def test_phase3_holds_the_flash_head_dims_and_the_text_towers_batch():
    flash = {(case, b, d) for case, b, _, _, _, d, _, _ in cs.FLASH_CASES}
    assert {("flash-D88", 2, 88), ("flash-D32", 2, 32), ("flash-B32", 32, 64)} <= flash
    timed = [case for case, *_, timed in cs.FLASH_CASES if timed]
    assert timed == ["flash-S2048", "flash-S4096", "flash-B32"]


def test_phase3_holds_the_variational_towers_shapes():
    """The variational ViT-B/32's towers: vision S=51 (CLS, 49 patches, the concentration
    token) and text S=78 causal, each timed at B=256 beside the library call and also at a
    ragged B=3; the kernel line still lists all eleven kernels, the two int8 ones and the
    others."""
    rows = {(case, b, s, w, h, causal) for case, b, s, w, h, causal in cs.BLOCK_CASES}
    assert {("vclip-vision", 256, 51, 768, 12, False), ("vclip-text", 256, 78, 512, 8, True),
            ("vclip-vision", 3, 51, 768, 12, False), ("vclip-text", 3, 78, 512, 8, True)} <= rows
    # the eleven TPU-kernel counterparts, the two int8 kernels, the card's JPEG resample and the
    # block backward's weight gradients
    assert len(cs.KERNELS) == 15


def test_variational_block_bounds():
    """S=78 causal counts the lower triangle's pairs; the projections' FLOPs grow with S."""
    ms, by, flops = cs.block_bound("block_attention_fwd", 256, 78, 512, 8, True, "bfloat16")
    assert by == "operations"
    assert flops == 8 * 256 * 78 * 512 ** 2 + 4 * 256 * 8 * (78 * 79 / 2) * 64
    _, _, flops51 = cs.block_bound("block_attention_bwd", 256, 51, 768, 12, False, "float32")
    assert flops51 == 14 * 256 * 51 * 768 ** 2 + 12 * 256 * 12 * 51 * 51 * 64


def test_phase10_runs_the_reference_recipes_loss():
    """scripts/train_vclip.sh: power_spherical, KL weight 100, B=128, lr 1e-3, wd 1e-8; the
    loss's own defaults for the samples, the variance term and the smoothing; the
    Riemannian mean gradient on."""
    assert cs.VCLIP_BATCH == 128
    assert cs.VCLIP_LOSS == dict(distribution_type="power_spherical", kl_weight=100.0,
                                 num_samples=20, var_reg_weight=0.1, label_smoothing=0.1,
                                 riemannian=True)
    assert cs.VCLIP_OPT == dict(schedule=1e-3, weight_decay=1e-8)
    assert "10. the variational ViT-B/32" in cs.__doc__
    assert cs.model_label("ViT-B-32") == "ViT-B-32"
    from multimodal_tpu_torch.models import VariationalConfig

    assert cs.model_label("ViT-B-32", variational=VariationalConfig(model_type="Gaussian")) == (
        "ViT-B-32 variational Gaussian")
    assert cs.model_label("ViT-B-16", block_mlp=True) == "ViT-B-16 block_mlp"


class _FakeLaunches:
    def __init__(self, counts):
        self.counts = dict(counts)

    def reset_launch_counts(self):
        self.counts = dict.fromkeys(self.counts, 0)

    def launch_counts(self):
        return dict(self.counts)


def test_launch_count_rule():
    """A main-path run is counted from a reset just before it to a read just after; every
    step must launch exactly the kernels it needs, each just that often, and nothing else."""
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    fake = _FakeLaunches(dict.fromkeys(cs.KERNELS, 7))
    tally = cs.Tally(fake)
    tally.start()
    assert set(fake.launch_counts().values()) == {0}
    fake.counts.update(need)
    step = tally.stop()
    assert tally.total["block_attention_fwd"] == 24 and tally.total["flash_attention_fwd"] == 0
    cs.check_launches([step], need, "run")
    for wrong in ({**step, "block_attention_bwd": 23}, {**step, "block_mlp_fwd": 1}):
        with pytest.raises(SystemExit):
            cs.check_launches([step, wrong], need, "run")


def test_without_a_card_the_script_fails_and_prints_no_result():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout and "FAIL" in proc.stdout


def test_phase3_holds_the_ln_fold_form_at_384px():
    """ViT-B/32's vision tower at 384 px: S = 12 * 12 + 1 = 145, W=768, H=12, timed at B=256
    (and a ragged B=3), not causal, with the residual."""
    rows = {(case, b, s, w, h, causal, res) for case, b, s, w, h, causal, res in cs.LN_CASES}
    assert {("ln-S145", 256, 145, 768, 12, False, True),
            ("ln-S145", 3, 145, 768, 12, False, True)} <= rows
    assert (cs.HIRES["force_image_size"] // 32) ** 2 + 1 == 145
    ms, by, flops = cs.block_bound("block_attention_ln_fwd", 256, 145, 768, 12, False, "bfloat16")
    assert by == "operations" and flops == 8 * 256 * 145 * 768 ** 2 + 4 * 256 * 12 * 145 ** 2 * 64


def test_phase11_configs():
    """LoRA r=8 alpha 16; the MoE tower's 8 experts, top-2, capacity factor 1.25 on every
    second block: 6 MoE blocks, 15 slots an expert for a 50-token image."""
    from multimodal_tpu_torch.models.moe import MoEMLP

    assert cs.LORA == dict(lora_rank=8, lora_alpha=16.0)
    assert cs.MOE_VISION == dict(moe_experts=8, moe_every=2, moe_top_k=2,
                                 moe_capacity_factor=1.25)
    assert sum(i % 2 == 1 for i in range(12)) == 6
    assert MoEMLP(768, 8, top_k=2, capacity_factor=1.25).capacity(50) == 15
    assert "11. the rest of the model family" in cs.__doc__
    assert cs.model_label("ViT-B-32", model_kw={"siglip": True}) == "ViT-B-32 siglip=True"


def test_routing_flip_rule():
    """d decisions that differ between the two paths widen the step's loss limit by d / (B S);
    with none it is phase 6's 1e-5."""
    import torch

    a = [torch.tensor([[[0, 1], [2, 3]]]), torch.tensor([[[4, 5], [6, 7]]])]
    b = [torch.tensor([[[0, 1], [3, 2]]]), torch.tensor([[[4, 5], [6, 7]]])]
    assert cs.routing_flips(a, a) == 0 and cs.routing_flips(a, b) == 2
    assert cs.moe_loss_limit(0, 12800) == 1e-5
    assert abs(cs.moe_loss_limit(3, 12800) - (1e-5 + 3 / 12800)) < 1e-15
    rec = cs.RoutingRecorder(torch)
    rec.layers = 2
    runs = [a + b, b + a]  # two steps of two layers each
    assert rec.flips(runs[0], runs[1], 0) == 2 and rec.flips(runs[0], runs[1], 1) == 2
    assert rec.flips(runs[0], runs[0], 1) == 0 and rec.decisions(runs[0], 0) == 8


def test_routing_recorder_reads_each_moe_layers_choices():
    """The recorder's hooks record, per forward of each MoE layer, the k rounds of choices the
    layer made, and leave the model as it was when detached."""
    import torch

    from multimodal_tpu_torch.models import create_model

    model = create_model("tiny-test-moe", device="cpu")
    rec = cs.RoutingRecorder(torch)
    rec.attach(model)
    images = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        model.encode_image(images)
        model.encode_image(images + 1)
    records = rec.detach()
    assert rec.layers == 1 and len(records) == 2 and records[0].shape == (2, 5, 1)
    assert rec.seq == 5
    with torch.no_grad():
        model.encode_image(images)
    assert len(rec.records) == 2  # detached: no more records


def test_siglip_bfloat16_rule():
    """The bfloat16 SigLIP run follows the float32 kernel path's losses step by step within
    2e-2 and falls below step 1 somewhere; a run that leaves the trajectory, or never falls,
    fails."""
    f32 = [10.1359, 7.928, 7.0474, 7.0606, 6.562, 10.5839]
    ok, worst = cs.siglip_tracks([10.1337, 7.9338, 7.0376, 7.0547, 6.5606, 10.5886], f32)
    assert ok and worst < 2e-3
    assert not cs.siglip_tracks([10.1337, 7.9338, 7.0376, 7.0547, 6.5606, 11.0], f32)[0]
    assert not cs.siglip_tracks([10.0, 10.2, 10.3], [10.0, 10.2, 10.3])[0]


def test_phase3_holds_the_int8_shapes_of_the_b32_step():
    """The row quantize at every activation and weight shape of the int8 ViT-B/32 step at
    B=256 and of phase 18's int8 ViT-L/14 step at its bfloat16 batch (each weight by rows, the
    backward's, and in the column form, the forward's), the int8 GEMM at each of the steps'
    four products in every store form and at the image projection; the kernels line names
    both kernels and what they replace."""
    b = cs.B_L14
    acts = {(r, c) for _, r, c, w in cs.QUANT_CASES if not w}
    assert acts == {(12800, 768), (12800, 3072), (19712, 512), (19712, 2048),
                    (b * 257, 1024), (b * 257, 4096), (b * 77, 768), (b * 77, 3072)}
    for form in ("rows", "columns"):
        weights = {(r, c) for _, r, c, w in cs.QUANT_CASES if w == form}
        assert weights == {(3072, 768), (768, 3072), (2048, 512), (512, 2048),
                           (1024, 4096), (4096, 1024)}
    products = {(m, k, n) for _, m, k, n in cs.GEMM_CASES}
    assert products == {(12800, 768, 3072), (12800, 3072, 768), (19712, 512, 2048),
                        (19712, 2048, 512), (b * 257, 1024, 4096), (b * 257, 4096, 1024),
                        (b * 77, 768, 3072), (b * 77, 3072, 768)}
    stores = {(bias, after) for _, bias, after, _ in cs.GEMM_STORES}
    assert stores == {(False, False), (True, False), (True, True)}
    assert [out for *_, after, out in cs.GEMM_STORES if after] == ["bfloat16"]
    assert cs.GEMM_PROJECTION[1:] == (256, 768, 512)
    assert "int8_rescale" not in cs.KERNELS
    for name, source in (("quantize_rows", "quant.cu"), ("int8_gemm", "int8_gemm.cu")):
        path, replaces, case = cs.KERNELS[name]
        assert path.endswith(source) and "multimodal_tpu/ops/quant.py" in replaces
        assert case in {c[0] for c in cs.QUANT_CASES + cs.GEMM_CASES}


def test_int8_kernel_bounds_are_bytes():
    """Each input read once and each output written once at 3.35 TB/s: a float32 quantize of
    [12800, 3072] moves 5 bytes an element and a scale a row; the column form of a [768, 3072]
    weight 5 bytes an element and a scale a column."""
    ms, by, ops = cs.quant_bound("quantize_rows", 12800 * 3072, 4, 1, 12800, 3072)
    assert by == "bytes" and ops == 4 * 12800 * 3072
    assert ms == pytest.approx(1e3 * (5 * 12800 * 3072 + 4 * 12800) / cs.PEAK_BYTES)
    ms, by, _ = cs.quant_bound("quantize_rows", 768 * 3072, 4, 1, 3072, 3072)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (5 * 768 * 3072 + 4 * 3072) / cs.PEAK_BYTES)


def test_int8_gemm_bound_is_the_dense_int8_rate_or_the_bytes():
    """2MNK operations at 1,979 TOP/s against the codes, scales and y moved once: c_fc's
    product in bfloat16 is bound by its operations, in float32 with a bias by its bytes."""
    m, k, n = 12800, 768, 3072
    ms, by, ops = cs.gemm_bound(m, k, n, 2)
    assert by == "operations" and ops == 2 * m * k * n
    assert ms == pytest.approx(1e3 * 2 * m * k * n / 1979e12)
    ms, by, _ = cs.gemm_bound(m, k, n, 4, bias=True)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (m * k + n * k + 4 * m * n + 4 * m + 8 * n) / cs.PEAK_BYTES)


def test_phase12_launches_and_limits():
    """48 dense layers a step (12 blocks a tower, 2 towers, c_fc and c_proj), each with 4 row
    quantizes and 2 int8 GEMMs; a limit widens by 3x the int8-vs-float distance and is phase
    6's without int8."""
    assert cs.INT8_NEED == {"block_attention_fwd": 24, "block_attention_bwd": 24,
                            "quantize_rows": 48 * 4, "int8_gemm": 48 * 2}
    assert cs.int8_limit(1e-4, 0.0) == 1e-4
    assert cs.int8_limit(1e-5, 2e-5) == pytest.approx(1e-5 + cs.INT8_SPREAD * 2e-5)
    order = [list(("A", "B"))[(i + i // 2) % 2] for i in range(2 * cs.AB_RUNS)]
    assert order[:4] == ["A", "B", "B", "A"] and order.count("A") == order.count("B")


def test_code_flips_counts_each_step_call_by_call():
    """The first run keeps every call's codes of its first two steps; the second counts the
    codes that differ, call by call, per step, and hands the module its function back."""
    import types

    import torch

    state = {"bump": 0}

    def quantize_rows(x, form="reciprocal"):
        codes = torch.round(x).to(torch.int8)
        codes[: state["bump"]] += 1
        return codes, torch.ones(x.shape[0])

    q = types.SimpleNamespace(quantize_rows=quantize_rows)
    flips = cs.CodeFlips(q, per_step=2)
    x = torch.zeros(4, 8)
    for bump in (0, 1):
        state["bump"] = bump
        flips.attach()
        for _ in range(5):  # 2 steps of 2 calls, then a third step, not kept
            q.quantize_rows(x)
        flips.detach()
        assert q.quantize_rows is quantize_rows
    assert flips.flips == [16, 16] and flips.codes == [64, 64]
    assert flips.share(0) == 0.25 and flips.kept == []


def test_phase13_drives_the_cli_flag_sets_and_counts_their_launches():
    """Phase 13 (c) runs the nine flag sets in process; the per-step launches it requires:
    24 + 24 block-attention launches a plain step, a feature-cached step at 4 micro-batches
    four no-grad forwards more, an int8 step phase 12's counts."""
    flags = {name: extra for name, extra, _ in cs.CLI_RUNS}
    assert flags["cloob"] == ["--loss", "cloob"]
    assert flags["align semantic"] == ["--loss", "align", "--nl_semantic_supervision"]
    assert "chunked" in flags["clip chunked"] and "--feature-cached-accum" in flags[
        "feature-cached accum 4"]
    assert ["--opt", "lamb"] == flags["lamb"] and ["--opt", "lars"] == flags["lars"]
    assert "--model-ema" in flags["ema + val"] and ["--precision", "int8"] == flags["int8"]
    need = {name: per_step for name, _, per_step in cs.CLI_RUNS}
    assert need["feature-cached accum 4"] == {"block_attention_fwd": 192,
                                              "block_attention_bwd": 96}
    assert need["int8"] is cs.INT8_NEED and need["clip"] is None
    assert cs.LOSS_ROWS ** 2 * 4 == 4 * 2**30 and cs.LOSS_ROWS * cs.LOSS_CHUNK * 4 < 2**28
    assert cs.CLI_BATCH % cs.CLI_MICRO == 0 and cs.CLI_BATCH % cs.CLI_CHUNK == 0


def test_rel_leaf_dist_floors_the_scale():
    import torch

    want = {"a": torch.tensor([1.0, -2.0]), "zero": torch.zeros(2)}
    got = {"a": torch.tensor([1.0, -2.002]), "zero": torch.tensor([1e-4, 0.0])}
    dist = cs.rel_leaf_dist(torch, got, want)
    assert abs(dist["a"] - 1e-3) < 1e-6
    assert abs(dist["zero"] - 1e-4 / 2e-3) < 1e-6  # floored at 1e-3 x the largest leaf


def test_phase14_data_helpers():
    """Phase 14's shard lists, per-image agreement and the resample bound."""
    import numpy as np

    pattern = cs.data_shards(cs.DATA_TRAIN, cs.DATA_REPEAT)
    assert pattern.count("::") == cs.DATA_REPEAT - 1 and pattern.startswith(cs.DATA_DIR)
    # resampled: each of 4 workers draws 16 // 4 shards of 128 samples -> 2 batches of 256
    shards = 2 * cs.DATA_REPEAT
    assert 4 * ((shards // 4) * 128 // cs.CLI_BATCH) == cs.DATA_STEPS
    assert cs.DATA_VAL_REPEAT * 64 == cs.CLI_BATCH  # one validation batch
    a = np.zeros((2, 4, 4, 3), np.uint8)
    b = a.copy()
    b[0, 0, 0, 0] = 12
    a[1] = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    b[1] = a[1] + 1
    (m0, c0), (m1, c1) = cs.image_agreement(b, a)
    assert m0 == 12 / 48 and c0 == 0.0  # a constant image against a non-constant one
    assert m1 == 1.0 and abs(c1 - 1.0) < 1e-12
    assert cs.image_agreement(a[:1], a[:1]) == [(0.0, 1.0)]
    ms, by = cs.resample_bound(taps=10, read_bytes=3.35e9, out_bytes=0)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    ms, by = cs.resample_bound(taps=10, read_bytes=3.35e9 - 1e6, out_bytes=1e6)
    assert by == "bytes" and abs(ms - 1.0) < 1e-9
    ms, by = cs.resample_bound(taps=int(67e12), read_bytes=0, out_bytes=0)
    assert by == "operations" and abs(ms - 2e3) < 1e-6
    assert cs.KERNELS["resample"][0].endswith("ops/csrc/resample.cu")
    assert [name for name, _ in cs.DATA_RUNS] == ["224", f"wire {cs.DATA_WIRE}", "224 aug"]


def test_resample_bound_counts_the_tapped_source_and_the_output_only():
    """The resample bound's bytes: each image's tapped rectangle (the rows and columns some
    output reads) read once and the uint8 output written once. A crop reads less than its
    whole image, a failed image nothing, and the plan's tables (non-zero here) stay out."""
    import numpy as np

    from multimodal_tpu_torch.ops import resample as rs

    dims = np.array([[100, 160], [50, 80], [40, 40]])
    sizes = dims[:, 0] * dims[:, 1] * 3
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    boxes = np.array([[20.5, 10.25, 120.0, 90.0],  # a train crop, downscaled to 32
                      [0.0, 0.0, 80.0, 50.0],  # the whole image
                      [0.0, 0.0, 40.0, 40.0]])  # not ok
    ok = np.array([True, True, False])
    size = 32
    host = rs.plan(dims, offsets, boxes, ok, size)

    def tapped(out, b0, b1, n):
        first, count, _ = rs.contribs(out, b0, b1, n)
        mask = np.zeros(n, bool)
        for f, c in zip(first, count):
            mask[f:f + c] = True
        return int(mask.sum())

    want = [tapped(size, b[1], b[3], h) * tapped(size, b[0], b[2], w) * 3
            for (h, w), b in zip(dims[:2], boxes[:2])]
    assert host["read_bytes"] == sum(want)
    assert want[0] < sizes[0]  # the crop reads part of its image
    assert want[1] == sizes[1]  # the whole box reads every pixel
    out_bytes = len(ok) * size * size * 3
    tables = cs.plan_table_bytes(host)
    assert tables == (8 * 3 * rs.DESC_FIELDS + 2 * 4 * 3 * size * 2
                      + 4 * (host["wx"].size + host["wy"].size)) and tables > 0
    ms, by = cs.resample_bound(host["taps"], host["read_bytes"], out_bytes)
    assert by == "bytes"
    assert abs(ms * 1e-3 * cs.PEAK_BYTES - (sum(want) + out_bytes)) < 1e-3


@pytest.mark.parametrize("flowers, need", [
    # zero-shot text 1 + 1 (+ 11) and images 4 + 1 (+ 1), COCO 1 + 3, the probe 4 + 4
    (True, {"block_attention_fwd": 12 * 31, "resample": 3}),
    (False, {"block_attention_fwd": 12 * 19, "resample": 2}),
])
def test_eval_only_need_counts_every_encode_and_jpeg_batch(flowers, need):
    sets = {"cifar10": "c", "imagenet_val": "f", "coco_retrieval": "k"}
    if flowers:
        sets["flowers"] = "fl"
    assert cs.eval_only_need(sets, 12, 12) == need
    # a tower's depth scales only its own encodes: 15 (or 14) image and 16 (or 5) text chunks
    want_image, want_text = (15, 16) if flowers else (14, 5)
    assert cs.eval_only_need(sets, 2, 0)["block_attention_fwd"] == 2 * want_image
    assert cs.eval_only_need(sets, 0, 3)["block_attention_fwd"] == 3 * want_text


def test_phase3_holds_the_caption_mappers_shapes():
    """The reference decoder's mapper (S=20 W=768 H=8, head dim 96) and the CLI decoder's
    (S=14 W=256 H=8, head dim 32), ragged at B=3 and timed at B=32, both shapes the block
    dispatch admits."""
    from multimodal_tpu_torch.ops.block_attention import block_attn_supported

    rows = {(case, b, s, w, h, causal) for case, b, s, w, h, causal in cs.BLOCK_CASES
            if case.startswith("caption")}
    assert rows == {("caption-mapper", 3, 20, 768, 8, False),
                    ("caption-mapper", 32, 20, 768, 8, False),
                    ("caption-cli", 3, 14, 256, 8, False), ("caption-cli", 32, 14, 256, 8, False)}
    assert all(block_attn_supported(b, s, w, h) for _, b, s, w, h, _ in rows)
    assert {w // h for _, _, _, w, h, _ in rows} == {96, 32}


@pytest.mark.parametrize("n, batch, need", [
    # 116 train images (one chunk), 12 held out; 3 epochs x 3 steps of 32; one decode batch
    (128, 256, {"block_attention_fwd": 12 * 2 + 2 * (9 + 1), "block_attention_bwd": 18,
                "resample": 2}),
    # 20 images: 8 held out, 12 to train (bs 12, one step an epoch); chunks of 8
    (20, 8, {"block_attention_fwd": 12 * (2 + 1) + 2 * (3 + 1), "block_attention_bwd": 6,
             "resample": 2}),
])
def test_caption_cli_need_counts_encodes_steps_and_decodes(n, batch, need):
    assert cs.caption_cli_need(n, 12, batch) == need


def test_decode_agreement_stops_at_each_rows_first_near_tie():
    logits = np.zeros((2, 4, 5))
    logits[:, :, 1] = 1.0  # a clear winner everywhere...
    logits[1, 2, 3] = 1.0 - 5e-5  # ...but row 1 at step 2, a near tie
    tokens = np.array([[1, 1, 1, 1], [1, 1, 3, 4]])
    plain = np.array([[1, 1, 1, 1], [1, 1, 1, 1]])
    assert cs.decode_agreement(tokens, plain, logits) == (True, [None, 2])
    tokens[0, 3] = 2  # row 0 has no tie, so a changed token is a disagreement
    assert cs.decode_agreement(tokens, plain, logits) == (False, [None, 2])


def test_profile_family_launches_sorts_the_trace_by_kernel_family():
    summary = {"launches": {
        "void (anonymous namespace)::attention_mma_kernel<64>(...)": 40,
        "void (anonymous namespace)::attention_f32_kernel<4>(...)": 8,
        "void (anonymous namespace)::attn_bwd_dq_mma_kernel<64, 64, true>(...)": 48,
        "void (anonymous namespace)::attn_bwd_dkv_mma_kernel<64, 32, false>(...)": 48,
        "void at::native::vectorized_elementwise_kernel<4, ...>": 7}}
    fam = cs.profile_family_launches(summary)
    assert cs.family_count(fam, "forward attention core") == 48
    assert cs.family_count(fam, "backward dQ") == 48
    assert cs.family_count(fam, "backward dK/dV") == 48
    assert cs.family_count(fam, "elementwise") == 7


def test_rel_err_is_the_largest_relative_difference():
    assert cs.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert abs(cs.rel_err([1.0, 2.0002], [1.0, 2.0]) - 1e-4) < 1e-12
    assert cs.rel_err(-3.0003, -3.0) == pytest.approx(1e-4, rel=1e-9)  # relative to want



@pytest.mark.parametrize("n,causal,want", [(4, False, 16), (4, True, 10), (1, True, 1),
                                           (2, False, 4), (2, True, 3)])
def test_ring_visits_counts_the_blocks_the_schedule_calls(n, causal, want):
    """Phase 17 (c)'s exact launch count of each flash kernel: every (query block, key block)
    pair, or causal those not wholly in the future, as the schedule walks them."""
    from multimodal_tpu_torch.ops import ring_attention as ra

    assert cs.ring_visits(n, causal) == want
    walked = sum(ra._visit(i, (i - t) % n, causal) is not None
                 for i in range(n) for t in range(n))
    assert walked == want


# the block kernels' bfloat16 GEMM instantiations (three operand sets), as nvcc 12 mangles them
WGMMA_BLOCK = ("_ZN55_GLOBAL__N__ee72dafa_22_block_attention_{}_cu_649abda017wgmma_gemm_kernelI13__"
               "nv_bfloat16{}EEvNS_9WgmmaMapsIXT5_EEENS_13WgmmaGemmArgsE")
WGMMA_BLOCK_ARGS = [("fwd", "S1_Li0ELi0ELi0ELi128ELi3E"), ("fwd", "S1_Li0ELi1ELi0ELi128ELi3E"),
                    ("fwd", "S1_Li0ELi0ELi1ELi128ELi3E"), ("bwd", "S1_Li0ELi0ELi0ELi128ELi3E"),
                    ("bwd", "S1_Li1ELi0ELi0ELi128ELi3E"), ("bwd", "fLi1ELi0ELi0ELi128ELi3E"),
                    ("bwd", "S1_Li2ELi0ELi5ELi256ELi4E")]  # the weight gradients: four sets
# the backward's dQ and dK/dV kernels in their block form (D class, [key tile,] 1, packed)
BLOCK_DQ = ("_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe215fused_dq_kernelINS_10"
            "FusedDqOpsILi{}ELi{}ELi{}ELi{}EEEEEvNS_12FusedBwdMapsEPfP13__nv_bfloat16iiiifi")
BLOCK_DKV = ("_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe216fused_dkv_kernelINS_11"
             "FusedDkvOpsILi{}ELi{}ELi{}EEEEEvNS_12FusedBwdMapsEPKfiiifi")


def block_sass(hmma_in=None, drop=None):
    """SASS of the block kernels' bfloat16 instantiations (the GEMM's six forms, the NN
    plain-round one in both sources; the dQ and dK/dV kernels' eight block-form ones), beside
    an MLP GEMM and the fused form's dQ; ``hmma_in`` names one that holds an mma.sync product,
    ``drop`` one left out of the build."""
    names = [WGMMA_BLOCK.format(src, args) for src, args in WGMMA_BLOCK_ARGS]
    for pack in (0, 1):
        names += [BLOCK_DQ.format(64, 64, 1, pack), BLOCK_DQ.format(128, 32, 1, pack),
                  BLOCK_DKV.format(64, 1, pack), BLOCK_DKV.format(128, 1, pack)]
    names += [WGMMA_MLP.format("S1_Li0ELi0ELi0ELi128ELi1E"), BLOCK_DQ.format(64, 64, 0, 0)]
    lines = []
    for name in names:
        if drop is not None and cs.kernel_label(name) == drop:
            continue
        lines += [f"\t\tFunction : {name}", HGMMA.format(128)]
        if hmma_in == cs.kernel_label(name):
            lines.append("        /*0300*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;")
    return "\n".join(lines)


def test_kernel_label_marks_the_block_gemms_and_forms():
    """A block kernel's GEMM (three operand sets) ends in ", x3", an MLP one does not; the dQ and
    dK/dV kernels' operand structs carry the form (1: block, 0: fused) and the packing."""
    assert cs.kernel_label(WGMMA_BLOCK.format("bwd", "fLi1ELi0ELi0ELi128ELi3E")) == (
        "wgmma_gemm_kernel<bfloat16, float, NT, plain, round, x3>")
    assert cs.kernel_label(WGMMA_BLOCK.format("fwd", "S1_Li0ELi0ELi1ELi128ELi3E")) == (
        "wgmma_gemm_kernel<bfloat16, bfloat16, NN, plain, residual, x3>")
    assert cs.kernel_label(WGMMA_MLP.format("S1_Li0ELi0ELi0ELi128ELi1E")) == (
        "wgmma_gemm_kernel<bfloat16, bfloat16, NN, plain, round>")
    assert cs.kernel_label(BLOCK_DQ.format(128, 32, 1, 1)) == (
        "fused_dq_kernel<FusedDqOps<128, 32, 1, 1>>")
    assert cs.kernel_label(BLOCK_DKV.format(64, 1, 0)) == "fused_dkv_kernel<FusedDkvOps<64, 1, 0>>"


def test_block_wgmma_faults_hold_every_bf16_block_instantiation_to_wgmma():
    """Phase 2 fails on a bfloat16 block-kernel instantiation (the GEMM with three operand sets
    or the weight gradients' four, the dQ or dK/dV kernel in its block form) with an HMMA or
    without a GMMA, and on a build with fewer than the six GEMM forms or the eight attention
    ones; the MLP's GEMM and the fused form's kernels are not counted there, nor the block GEMMs
    among the MLP's."""
    assert cs.block_wgmma_faults(block_sass()) == []
    assert cs.mlp_wgmma_faults(block_sass()) == [
        f"1 wgmma_gemm_kernel instantiations in the SASS, {cs.MLP_WGMMA_INSTANTIATIONS} expected"]
    bad = "wgmma_gemm_kernel<bfloat16, bfloat16, NT, plain, round, x3>"
    faults = cs.block_wgmma_faults(block_sass(hmma_in=bad))
    assert len(faults) == 1 and faults[0].startswith(bad + ": {") and "HMMA.16816" in faults[0]
    dq = "fused_dq_kernel<FusedDqOps<64, 64, 1, 1>>"
    assert cs.block_wgmma_faults(block_sass(hmma_in=dq))[0].startswith(dq + ": {")
    assert cs.block_wgmma_faults(block_sass(drop=dq)) == [
        f"7 block attention instantiations in the SASS, {cs.BLOCK_ATTENTION_INSTANTIATIONS} "
        "expected"]
    ln = "wgmma_gemm_kernel<bfloat16, bfloat16, NN, LN, round, x3>"
    assert cs.block_wgmma_faults(block_sass(drop=ln)) == [
        f"5 block GEMM instantiations in the SASS, {cs.BLOCK_GEMM_INSTANTIATIONS} expected"]
    wgrad = "wgmma_gemm_kernel<bfloat16, bfloat16, TN, plain, serial, x4>"
    assert cs.block_wgmma_faults(block_sass(drop=wgrad)) == [
        f"5 block GEMM instantiations in the SASS, {cs.BLOCK_GEMM_INSTANTIATIONS} expected"]
    assert cs.block_wgmma_faults(block_sass(hmma_in=wgrad))[0].startswith(wgrad + ": {")
    no_tc = block_sass().replace(f"{BLOCK_DKV.format(128, 1, 0)}\n{HGMMA.format(128)}",
                                 f"{BLOCK_DKV.format(128, 1, 0)}\n        /*0100*/  FFMA R4, R8 ;")
    assert cs.block_wgmma_faults(no_tc) == [
        "fused_dkv_kernel<FusedDkvOps<128, 1, 0>>: no tensor-core instructions"]


def test_block_edge_cases_cross_the_packed_passes_and_gemm_tiles():
    """Phase 3's bfloat16 block edges: S one short of, at and one past the 64-row warpgroups
    (two items a pass up to S = 64) and the 128-row passes, B = 1 and 3 (M = B*S ragged across
    the GEMMs' 128-row tiles), causal and not, D = 64, and D = 32 and 128 on both sides of the
    packing and at S = 320 (D = 128 streams its tiles past 192 rows or keys); every case a
    width the kernels take."""
    cases = {(b, s, w // h, causal) for _, b, s, w, h, causal in cs.BLOCK_EDGE_CASES}
    assert len(cases) == len(cs.BLOCK_EDGE_CASES) == 36
    assert {s for _, s, _, _ in cases} == {63, 64, 65, 127, 128, 129, 320}
    assert {(320, 128)} <= {(s, d) for _, s, d, _ in cases}
    assert {b for b, *_ in cases} == {1, 2, 3} and {c for *_, c in cases} == {False, True}
    assert {d for _, _, d, _ in cases} == {32, 64, 128}
    assert any(b * s % 128 for b, s, _, _ in cases)
    assert all(w % 128 == 0 and w % h == 0 for _, _, _, w, h, _ in cs.BLOCK_EDGE_CASES)


def test_kernel_label_marks_the_weight_gradient_gemm():
    """The weight-gradient kernel's instantiation (TN, four operand sets, the serial store) ends in
    ", x4"; ``gemm_sets`` reads 4 from its mangled and demangled names, and the step profiler
    puts it in a family of its own, apart from the MLP's TN weight gradients."""
    from multimodal_tpu_torch.ops._build import gemm_sets, gemm_signature
    from multimodal_tpu_torch.profile_step import family_of

    mangled = WGMMA_BLOCK.format("bwd", "S1_Li2ELi0ELi5ELi256ELi4E")
    assert cs.kernel_label(mangled) == (
        "wgmma_gemm_kernel<bfloat16, bfloat16, TN, plain, serial, x4>")
    demangled = ("void (anonymous namespace)::wgmma_gemm_kernel<__nv_bfloat16, __nv_bfloat16, 2, "
                 "0, 5, 256, 4>((anonymous namespace)::WgmmaMaps<4>, (anonymous namespace)::"
                 "WgmmaGemmArgs)")
    assert gemm_sets(mangled) == gemm_sets(demangled) == 4
    assert gemm_signature(demangled) == ("bfloat16", "bfloat16", "TN", "plain", "serial")
    assert family_of(demangled).startswith("block backward weight gradients")
    mlp = demangled.replace("__nv_bfloat16, 2, 0, 5, 256, 4", "float, 2, 2, 0, 256, 1")
    assert family_of(mlp).startswith("fused MLP weight gradients")


def test_phase3_holds_the_weight_gradient_kernel_at_every_block_shape():
    """The weight-gradient kernel's cases are the token rows and widths of every block case,
    both forms, once each; timed at B=256 (ViT-B/32's towers, the shared trunk, S=145 and S=197)
    and at the caption mappers' B=32; its kernels-line entry names the reference's XLA product
    and a timed case, and reports bfloat16 (float32 keeps torch.matmul)."""
    rows = {(b * s, w) for _, b, s, w in cs.WGRAD_CASES}
    assert {(256 * 50, 768), (256 * 77, 512), (256 * 77, 768), (256 * 197, 768),
            (256 * 145, 768), (32 * 20, 768), (32 * 14, 256)} <= rows
    assert len(set(cs.WGRAD_CASES)) == len(cs.WGRAD_CASES)
    assert {w for _, w in rows} == {w for *_, w, _, _ in cs.BLOCK_CASES} | {
        w for *_, w, _, _, _ in cs.LN_CASES}
    path, replaces, case = cs.KERNELS["block_attention_wgrad"]
    assert path.endswith("ops/csrc/block_attention_bwd.cu")
    assert replaces.startswith("not a TPU kernel") and "block_attention.py:454" in replaces
    assert case in {c for c, b, *_ in cs.WGRAD_CASES if b == 256}
    assert cs.KERNEL_DTYPES == {"block_attention_wgrad": "bfloat16"}


def test_wgrad_bound_counts_the_operands_once_and_the_running_sums():
    """8 T W^2 bf16 FLOPs at 989 TFLOP/s against the six bf16 operands read once, the four bf16
    gradients written once and the float32 running sums written and read between splits: ViT-B/32's
    vision call is bound by its operations; at T = 1 the bytes bind."""
    t, w = 256 * 50, 768
    ms, by, flops = cs.wgrad_bound(t, w, 3)
    assert by == "operations" and flops == 8 * t * w * w
    assert ms == pytest.approx(1e3 * flops / 989e12)
    ms1, by1, _ = cs.wgrad_bound(1, w, 1)
    assert by1 == "bytes"
    assert ms1 == pytest.approx(1e3 * (2 * 6 * w + 2 * 4 * w * w) / cs.PEAK_BYTES)
    ms3, _, _ = cs.wgrad_bound(1, w, 3)
    assert ms3 == pytest.approx(1e3 * (2 * 6 * w + 2 * 4 * w * w + 2 * 2 * 16 * w * w)
                                / cs.PEAK_BYTES)


def test_with_wgrad_adds_one_launch_per_block_backward():
    """A bfloat16 run's exact counts: one weight-gradient launch beside each block backward of
    either form, nothing added where no block backward runs."""
    assert cs.with_wgrad({"block_attention_fwd": 24, "block_attention_bwd": 24}) == {
        "block_attention_fwd": 24, "block_attention_bwd": 24, "block_attention_wgrad": 24}
    assert cs.with_wgrad({"block_attention_ln_bwd": 12, "block_attention_bwd": 12,
                          "block_mlp_bwd": 24})["block_attention_wgrad"] == 24
    assert cs.with_wgrad(cs.INT8_NEED)["block_attention_wgrad"] == 24
    fused = {"fused_attention_fwd": 12, "fused_attention_bwd": 12}
    assert cs.with_wgrad(fused) == fused


def test_phase18_launch_counts():
    """Per train step, from the shipped configs (``block_need``): ViT-L/14 24 LN-fold + 12
    non-LN forward and backward launches, H/14 32 + 24, g/14 40 + 24, ViT-L-16 16 + 16,
    ViT-S-16-128 12 non-LN (S=65 in both towers), ViT-B-16-512 and ViT-B-32-two-tower-16
    12 + 12; each encode its tower's layers; ViT-L/14 int8 72 dense layers (24 + 12 MLPs),
    4 quantizes and 2 GEMMs each, and ViT-B/32's as phase 12 holds it."""
    want = {"ViT-L-14": (24, 12), "ViT-H-14": (32, 24), "ViT-g-14": (40, 24),
            "ViT-L-16": (16, 16), "ViT-B-16-512": (12, 12), "ViT-B-32-two-tower-16": (12, 12)}
    for name, (lv, lt) in want.items():
        assert cs.block_need(name) == (
            {"block_attention_ln_fwd": lv, "block_attention_ln_bwd": lv,
             "block_attention_fwd": lt, "block_attention_bwd": lt},
            {"block_attention_ln_fwd": lv}, {"block_attention_fwd": lt}), name
    assert cs.block_need("ViT-S-16-128") == (
        {"block_attention_fwd": 12, "block_attention_bwd": 12}, {"block_attention_fwd": 6},
        {"block_attention_fwd": 6})
    assert cs.int8_need("ViT-L-14") == {**cs.block_need("ViT-L-14")[0],
                                        "quantize_rows": 72 * 4, "int8_gemm": 72 * 2}
    assert cs.int8_need("ViT-B-32") == cs.INT8_NEED
    assert [cs.LARGE_VITS[m]["moments"] for m in ("ViT-L-14", "ViT-H-14", "ViT-g-14")] == [
        "float32", "bfloat16", "bfloat16"]
    assert set(cs.OTHER_CONFIGS) == {"ViT-L-16", "ViT-S-16-128", "ViT-B-16-512",
                                     "ViT-B-32-two-tower-16"}


def test_phase3_times_phase18_shapes():
    """The LN-fold form at S=257 and W=1024 / 1280 / 1408, the non-LN form at S=77 W=1024 H=16
    causal, each at B=2 and at the batch phase 18 trains its model at, timed there; their
    weight-gradient cases follow."""
    timed = {("ln-S257", cs.B_L14, 1024), ("ln-D80", cs.B_H14, 1280), ("ln-D88", cs.B_G14, 1408)}
    ln = {(case, b, w) for case, b, s, w, h, causal, _ in cs.LN_CASES if s == 257 and h == 16}
    assert timed | {(c, 2, w) for c, _, w in timed} <= ln
    text = {b for case, b, s, w, h, causal in cs.BLOCK_CASES
            if (s, w, h, causal) == (77, 1024, 16, True)}
    assert text == {2, cs.B_H14, cs.B_G14}
    assert {(c, b) for c, b, _ in timed} | {("text-W1024", cs.B_H14), ("text-W1024", cs.B_G14)} \
        == cs.PHASE18_TIMED
    wgrad = {(case, b, w) for case, b, s, w in cs.WGRAD_CASES}
    assert {(f"wgrad-{c}", b, w) for c, b, w in timed} <= wgrad


class _Cuda:
    def __init__(self, total):
        self.total = total

    def mem_get_info(self):
        return 0, self.total


class _Torch:
    def __init__(self, total):
        self.cuda = _Cuda(total)


def test_largest_batch_reckons_from_the_comparison_and_fails_when_none_fits():
    """Static bytes are the float32 run's (16 a parameter), the per-sample bytes come from the
    float32 comparison's peak above its 24 a parameter (16 of state, the start's copy and step
    1's gradients); 15% to spare; none fitting fails."""
    gib, n = 2 ** 30, 10 ** 9
    peak = 24 * n + 8 * 2 * gib  # 2 GiB a sample at B=8
    # 16 GB static + 1.15 x 2 GiB x 24 = 70.1 GiB fits 80; 32 would need 88.5
    assert cs.largest_batch(_Torch(80 * gib), peak, n, 8, candidates=(8, 16, 24, 32, 48)) == 24
    with pytest.raises(SystemExit):
        cs.largest_batch(_Torch(20 * gib), peak, n, 8, candidates=(8, 16))


class _Model:
    cfg = None

    def parameters(self):
        return iter(())


def _fits_below(limit: int, runs: list, monkeypatch):
    """``kernel_path_run`` and ``train_steps`` of a card on which a batch above ``limit`` runs
    out of memory; ``runs`` records (what ran, its batch)."""

    def oom(n):
        if n > limit:
            raise torch.cuda.OutOfMemoryError(f"B={n}\nmore")

    def path_run(torch_, tally, card, name, dtype, n, steps, need, after=None, **kw):
        runs.append(("run", n))
        oom(n)
        after(_Model(), {"image": np.zeros((n, 1))})

    def steps(torch_, tally, model, data, n, count=True, state_dtype=None):
        runs.append(("step", data))
        oom(data)
        return {"peak": 0}

    monkeypatch.setattr(cs, "kernel_path_run", path_run)
    monkeypatch.setattr(cs, "train_steps", steps)
    monkeypatch.setattr(cs, "make_batch", lambda torch_, cfg, n: n)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def test_bf16_largest_run_proves_the_next_candidate_runs_out_of_memory(monkeypatch):
    """The run at the given batch, then one step at the next candidate up: where that step
    runs out of memory the batch stands; where it runs the run moves up; where the run runs
    out of memory it moves down, and a batch known to run out of memory is not tried again."""
    runs = []
    _fits_below(200, runs, monkeypatch)
    assert cs.bf16_largest_run(torch, None, "card", "m", 128, {}, {}) == 192
    assert runs == [("run", 128), ("step", 160), ("run", 160), ("step", 192), ("run", 192),
                    ("step", 224)]
    runs.clear()
    assert cs.bf16_largest_run(torch, None, "card", "m", 256, {}, {}) == 192
    assert runs == [("run", 256), ("run", 224), ("run", 192)]
    runs.clear()
    assert cs.bf16_largest_run(torch, None, "card", "m", 192, {}, {}, prove=False) == 192
    assert runs == [("run", 192)]
    runs.clear()
    _fits_below(4, runs, monkeypatch)
    with pytest.raises(SystemExit):
        cs.bf16_largest_run(torch, None, "card", "m", 8, {}, {})
