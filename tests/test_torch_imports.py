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
        "import multimodal_tpu_torch.ops.block_mlp, multimodal_tpu_torch.profile_step\n"
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

    cases = {
        "void (anonymous namespace)::gemm_bias_kernel<float, true>(...)": "projection GEMMs",
        "void (anonymous namespace)::gemm_nt_kernel<__nv_bfloat16, float>(...)": "gemm_nt_kernel",
        "void (anonymous namespace)::attn_bwd_dq_kernel<float, true>(...)": "dQ pass",
        "void (anonymous namespace)::attn_bwd_dkv_kernel<float, false>(...)": "dK/dV pass",
        "void (anonymous namespace)::attention_kernel<float>(...)": "forward attention core",
        "void (anonymous namespace)::ln_bwd_kernel<float, float>(...)": "LN-fold launches",
        "void (anonymous namespace)::mlp_proj_kernel<float>(...)": "fused MLP forward c_proj",
        "void (anonymous namespace)::mlp_nt_kernel<__nv_bfloat16, true>(...)":
            "fused MLP backward dh and dln",
        "void (anonymous namespace)::mlp_wgrad_kernel<float, false>(...)":
            "fused MLP weight gradients",
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8": "cuBLAS",
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": "cuBLAS",
        "void at::native::vectorized_elementwise_kernel<4, ...>": "elementwise",
        "void at::native::reduce_kernel<512, 1, ...>": "reductions",
        "something_new": "other",
    }
    for kernel, family in cases.items():
        assert family in family_of(kernel), (kernel, family_of(kernel))
