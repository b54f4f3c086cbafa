"""The pure-Python report helpers of ``chip_smoke.py`` (the script itself needs a GPU): the
``nvcc -Xptxas -v`` digest, the attention passes' shared-memory sizes and the kernel bounds."""

import chip_smoke as cs

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe220attention_mma_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__6719648f_18_fused_attention_cu_de02afe220attention_mma_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Function properties for _ZN55_GLOBAL__N__ee72dafa_22_block_attention_fwd_cu_649abda016gemm_bias_kernelI13__nv_bfloat16Lb1EEvPKT_NS_12GemmOperandsEiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16384 bytes smem
"""


def test_ptxas_report_names_each_kernel_with_its_registers_and_spills():
    lines = cs.ptxas_report(PTXAS_LOG)
    assert len(lines) == 2
    assert lines[0].startswith("attention_mma_kernelILi64ELi64EE: 0 bytes stack frame")
    assert "0 bytes spill stores" in lines[0] and lines[0].endswith("Used 127 registers, used 1 barriers")
    assert lines[1].startswith("gemm_bias_kernelI13__nv_bfloat16Lb1E: 8 bytes stack frame")
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
    ms, _ = cs.fused_bound("fused_attention_fwd", *args, "float32")
    assert abs(ms - 1e3 * 4 * 256 * 12 * 197 * 197 * 64 / 67e12) < 1e-9


def test_phase3_holds_the_tile_edge_and_padded_head_cases():
    fused = {(s, d, causal) for _, _, s, _, d, causal in cs.FUSED_CASES}
    assert {(129, 64, True), (191, 64, False), (257, 64, False), (512, 32, False)} <= fused
    block_dims = {w // h for _, _, _, w, h, _ in cs.BLOCK_CASES}
    ln_dims = {w // h for _, _, _, w, h, _, _ in cs.LN_CASES}
    assert {80, 88} <= block_dims and {80, 88} <= ln_dims
    assert len(cs.KERNELS) == 11
