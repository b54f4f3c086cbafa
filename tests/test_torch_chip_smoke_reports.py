"""The pure-Python report helpers of ``chip_smoke.py`` (the script itself needs a GPU): the
``nvcc -Xptxas -v`` digest, the SASS digest of the flash kernels and the projection GEMM, the
attention passes' shared-memory sizes and the kernel bounds and rates."""

import pytest

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
    assert len(cs.KERNELS) == 13  # the eleven TPU-kernel counterparts and the two int8 kernels


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
    ragged B=3; the kernel line still lists all eleven kernels, and the two int8 ones."""
    rows = {(case, b, s, w, h, causal) for case, b, s, w, h, causal in cs.BLOCK_CASES}
    assert {("vclip-vision", 256, 51, 768, 12, False), ("vclip-text", 256, 78, 512, 8, True),
            ("vclip-vision", 3, 51, 768, 12, False), ("vclip-text", 3, 78, 512, 8, True)} <= rows
    assert len(cs.KERNELS) == 13  # the eleven TPU-kernel counterparts and the two int8 kernels


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
    B=256 (the issue's table), the rescale at each product's output and the serving path's
    biased c_fc and its projection; the kernels line names both kernels and what they
    replace."""
    acts = {(r, c) for _, r, c, w in cs.QUANT_CASES if not w}
    assert acts == {(12800, 768), (12800, 3072), (19712, 512), (19712, 2048)}
    weights = {(r, c) for _, r, c, w in cs.QUANT_CASES if w}
    assert weights == {(3072, 768), (768, 3072), (2048, 512), (512, 2048)}
    outs = {(m, n) for _, m, _, n, _, _ in cs.RESCALE_CASES}
    assert {(12800, 3072), (12800, 768), (19712, 2048), (19712, 512), (256, 512)} <= outs
    assert any(bias for *_, bias, _ in cs.RESCALE_CASES)
    for name in ("quantize_rows", "int8_rescale"):
        source, replaces, case = cs.KERNELS[name]
        assert source.endswith("quant.cu") and "multimodal_tpu/ops/quant.py" in replaces
        assert case in {c[0] for c in cs.QUANT_CASES + cs.RESCALE_CASES}


def test_int8_kernel_bounds_are_bytes():
    """Each input read once and each output written once at 3.35 TB/s: a float32 quantize of
    [12800, 3072] moves 5 bytes an element and a scale a row; a float32 rescale 8 bytes an
    element and its two scale vectors."""
    ms, by, ops = cs.quant_bound("quantize_rows", 12800 * 3072, 4, 1, 12800, 3072)
    assert by == "bytes" and ops == 4 * 12800 * 3072
    assert ms == pytest.approx(1e3 * (5 * 12800 * 3072 + 4 * 12800) / cs.PEAK_BYTES)
    ms, by, _ = cs.quant_bound("int8_rescale", 12800 * 3072, 0, 4, 12800, 3072, bias=True)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (8 * 12800 * 3072 + 4 * 12800 + 8 * 3072) / cs.PEAK_BYTES)


def test_phase12_launches_and_limits():
    """48 dense layers a step (12 blocks a tower, 2 towers, c_fc and c_proj), each with 4 row
    quantizes and 2 rescales; a limit widens by 3x the int8-vs-float distance and is phase
    6's without int8."""
    assert cs.INT8_NEED == {"block_attention_fwd": 24, "block_attention_bwd": 24,
                            "quantize_rows": 48 * 4, "int8_rescale": 48 * 2}
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
