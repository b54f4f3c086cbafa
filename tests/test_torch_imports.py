"""Importing the PyTorch port never imports jax or the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import multimodal_tpu_torch.serving, multimodal_tpu_torch.models.clip\n"
        "import multimodal_tpu_torch.inference, multimodal_tpu_torch.ops._build\n"
        "import multimodal_tpu_torch.train, multimodal_tpu_torch.losses\n"
        "import multimodal_tpu_torch.train.engine, multimodal_tpu_torch.train.optimizer\n"
        "import multimodal_tpu_torch.train.schedules, multimodal_tpu_torch.losses.clip_loss\n"
        "import multimodal_tpu_torch.ops.attention, multimodal_tpu_torch.ops.block_attention\n"
        "import multimodal_tpu_torch.ops.fused_attention, multimodal_tpu_torch.ops.launches\n"
        "import multimodal_tpu_torch.models.checkpoint_interop\n"
        "import multimodal_tpu_torch.ops.flash_attention, multimodal_tpu_torch.models.layers\n"
        "import multimodal_tpu_torch.ops.block_mlp, multimodal_tpu_torch.profile_step\n"
        "import multimodal_tpu_torch.ops.sphere, multimodal_tpu_torch.ops.bessel\n"
        "import multimodal_tpu_torch.ops.draws, multimodal_tpu_torch.distributions\n"
        "import multimodal_tpu_torch.distributions.power_spherical\n"
        "import multimodal_tpu_torch.distributions.von_mises_fisher\n"
        "import multimodal_tpu_torch.distributions.normal\n"
        "import multimodal_tpu_torch.distributions.projected_normal\n"
        "import multimodal_tpu_torch.distributions.hyperspherical_uniform\n"
        "import multimodal_tpu_torch.losses.vclip_loss, multimodal_tpu_torch.models.factory\n"
        "import multimodal_tpu_torch.models.config, multimodal_tpu_torch.models.lora\n"
        "import multimodal_tpu_torch.models.moe, multimodal_tpu_torch.losses.siglip_loss\n"
        "import multimodal_tpu_torch.train.freeze\n"
        "import multimodal_tpu_torch.ops.quant, multimodal_tpu_torch.inference_quant\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'multimodal_tpu'))\n"
        "assert not leaked, leaked\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_profile_step_sorts_kernels_into_families():
    """The step profiler names every hand-written kernel's family before the library ones
    (a cuBLAS kernel also has 'gemm' in its name)."""
    from multimodal_tpu_torch.profile_step import family_of

    gemm = "void (anonymous namespace)::mma_gemm_kernel<{}>((anonymous namespace)::MmaGemmArgs)"
    cases = {
        gemm.format("float, float, 0, 1, 1"): "block forward GEMMs",
        gemm.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 1"): "block forward GEMMs",
        gemm.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 0"): "block backward GEMMs",
        gemm.format("__nv_bfloat16, float, 1, 0, 0"): "block backward GEMMs",
        gemm.format("float, float, 0, 1, 4"): "fused MLP forward c_fc",
        gemm.format("__nv_bfloat16, __nv_bfloat16, 1, 0, 2"): "fused MLP backward dh",
        gemm.format("float, float, 2, 3, 0"): "fused MLP weight gradients",
        gemm.format("__nv_bfloat16, float, 2, 2, 0"): "fused MLP weight gradients",
        "void (anonymous namespace)::attn_bwd_dq_mma_kernel<64, 64, true>(...)": "dQ pass",
        "void (anonymous namespace)::attn_bwd_dq_f32_kernel<4, false>(...)": "dQ pass",
        "void (anonymous namespace)::attn_bwd_dkv_mma_kernel<128, 32, false>(...)": "dK/dV pass",
        "void (anonymous namespace)::attn_bwd_dkv_f32_kernel<8>(...)": "dK/dV pass",
        "void (anonymous namespace)::attention_mma_kernel<64, 64>(...)":
            "forward attention core",
        "void (anonymous namespace)::attention_f32_kernel<4>(...)": "forward attention core",
        "void (anonymous namespace)::flash_fwd_kernel<float, 4>(...)": "flash attention forward",
        "void (anonymous namespace)::flash_dq_kernel<__nv_bfloat16, 8>(...)":
            "flash attention dQ",
        "void (anonymous namespace)::flash_dkv_kernel<float, 4>(...)": "flash attention dK/dV",
        "void (anonymous namespace)::ln_bwd_kernel<float, float>(...)": "LN-fold launches",
        gemm.format("float, float, 0, 0, 3"): "fused MLP forward c_proj",
        gemm.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 3"): "fused MLP forward c_proj",
        "void (anonymous namespace)::quantize_rows_kernel<float, true>(...)": "int8 row quantize",
        "void (anonymous namespace)::int8_rescale_kernel<__nv_bfloat16, false>(...)":
            "int8 rescale",
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8": "cuBLAS",
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": "cuBLAS",
        "void at::native::vectorized_elementwise_kernel<4, ...>": "elementwise",
        "void at::native::reduce_kernel<512, 1, ...>": "reductions",
        "something_new": "other",
    }
    for kernel, family in cases.items():
        assert family in family_of(kernel), (kernel, family_of(kernel))
