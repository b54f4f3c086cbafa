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
        "import multimodal_tpu_torch.bench_flash\n"
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
        "import multimodal_tpu_torch.losses.cloob_loss, multimodal_tpu_torch.losses.align_loss\n"
        "import multimodal_tpu_torch.losses.global_contrastive\n"
        "import multimodal_tpu_torch.data.semantic, multimodal_tpu_torch.data.synthetic\n"
        "import multimodal_tpu_torch.data.pipeline, multimodal_tpu_torch.data.datasets\n"
        "import multimodal_tpu_torch.train.checkpoints, multimodal_tpu_torch.train.logging_utils\n"
        "import multimodal_tpu_torch.train.params, multimodal_tpu_torch.train.run\n"
        "import multimodal_tpu_torch.eval.retrieval, multimodal_tpu_torch.eval.entropy\n"
        "import multimodal_tpu_torch.eval.separability\n"
        "import multimodal_tpu_torch.data.shards, multimodal_tpu_torch.data.augment\n"
        "import multimodal_tpu_torch.data.wds, multimodal_tpu_torch.data.resize\n"
        "import multimodal_tpu_torch.data.preprocess, multimodal_tpu_torch.data.bench_pipeline\n"
        "import multimodal_tpu_torch.native.bindings, multimodal_tpu_torch.ops.resample\n"
        "import multimodal_tpu_torch.eval, multimodal_tpu_torch.eval.metadata\n"
        "import multimodal_tpu_torch.eval.topk, multimodal_tpu_torch.eval.zero_shot\n"
        "import multimodal_tpu_torch.eval.linear_probe, multimodal_tpu_torch.data.eval_sets\n"
        "from multimodal_tpu_torch.serving import load_serving_weights\n"
        "from multimodal_tpu_torch.models import load_pretrained, read_orbax_params\n"
        "from multimodal_tpu_torch.data.semantic import HFSentenceEncoder\n"
        "from multimodal_tpu_torch.train.run import ZERO_SHOT_DATASETS, zero_shot_eval_all\n"
        "from multimodal_tpu_torch.train.run import retrieval_eval_all, linear_probe_eval\n"
        "import multimodal_tpu_torch.models.captioner, multimodal_tpu_torch.eval.captioning\n"
        "import multimodal_tpu_torch.models.llama_captioner, multimodal_tpu_torch.profiling\n"
        "import multimodal_tpu_torch.research, multimodal_tpu_torch.research.vmf_mixture\n"
        "import multimodal_tpu_torch.research.gmm_fit, multimodal_tpu_torch.research.projection\n"
        "import multimodal_tpu_torch.research.visualization\n"
        "import multimodal_tpu_torch.research.fit_mixture\n"
        "import multimodal_tpu_torch.research.loss_bench\n"
        "from multimodal_tpu_torch.train.run import captioning_eval\n"
        "from multimodal_tpu_torch.models import ClipCaptionModel, load_hf_gpt2\n"
        "from multimodal_tpu_torch.eval import CaptioningMetric, corpus_bleu\n"
        "import multimodal_tpu_torch.parallel, multimodal_tpu_torch.parallel.mesh\n"
        "import multimodal_tpu_torch.parallel.collectives, multimodal_tpu_torch.parallel.placement\n"
        "import multimodal_tpu_torch.parallel.fsdp, multimodal_tpu_torch.parallel.tp\n"
        "import multimodal_tpu_torch.parallel.compose, multimodal_tpu_torch.parallel.ep\n"
        "import multimodal_tpu_torch.parallel.offload, multimodal_tpu_torch.parallel.pp\n"
        "import multimodal_tpu_torch.ops.ring_attention\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # importing forms no process group\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'multimodal_tpu'))\n"
        "assert not leaked, leaked\n"
        "optional = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('transformers', 'tensorstore', 'scipy', 'sklearn', 'matplotlib', 'umap'))\n"
        "assert not optional, optional  # imported where they are used\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_without_jax():
    """The card script imports nothing of JAX or the JAX package (it reads only the names of
    the reference's kernel files, as strings)."""
    code = (
        "import sys, runpy\n"
        "mod = runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "assert 'phase_cli' in mod\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'multimodal_tpu'))\n"
        "assert not leaked, leaked\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_native_sources_are_the_ports_own():
    """The port's C++ includes nothing of the JAX package and is built from its own tree."""
    from multimodal_tpu_torch.native import bindings

    native = os.path.join(REPO, "multimodal_tpu_torch", "native")
    for name, (sources, _) in bindings.LIBRARIES.items():
        for src in sources + bindings.HEADERS:
            path = os.path.join(native, src)
            assert os.path.isfile(path), path
            text = open(path).read()
            assert "multimodal_tpu/" not in text.replace("multimodal_tpu_torch/", ""), src
    assert bindings.library_path("host").startswith(os.path.join(native, "_build_cache"))


def test_profile_step_sorts_kernels_into_families():
    """The step profiler names every hand-written kernel's family before the library ones
    (a cuBLAS kernel also has 'gemm' in its name)."""
    from multimodal_tpu_torch.profile_step import family_of

    gemm = "void (anonymous namespace)::mma_gemm_kernel<{}>((anonymous namespace)::MmaGemmArgs)"
    wgmma = ("void (anonymous namespace)::wgmma_gemm_kernel<{}>(CUtensorMap_st, CUtensorMap_st, "
             "(anonymous namespace)::WgmmaGemmArgs)")
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
        "void (anonymous namespace)::fused_dq_kernel<(anonymous namespace)::FusedDqOps<64, 32>>"
        "(...)": "fused attention backward dQ",
        "void (anonymous namespace)::flash_dq_kernel<(anonymous namespace)::Tf32Ops<64>>"
        "(...)": "in float32 also the fused backward's",
        "void (anonymous namespace)::fused_dkv_kernel<(anonymous namespace)::FusedDkvOps<64>>"
        "(...)": "fused attention backward dK/dV",
        "void (anonymous namespace)::flash_dkv_kernel<(anonymous namespace)::Tf32Ops<128>>"
        "(...)": "flash attention dK/dV",
        "void (anonymous namespace)::fused_delta_kernel(const float*, const float*, float*, long "
        "long, int, int, int)": "fused attention backward delta",
        "void (anonymous namespace)::attention_mma_kernel<64, 64>(...)":
            "forward attention core",
        "void (anonymous namespace)::attention_f32_kernel<4>(...)": "forward attention core",
        "void (anonymous namespace)::fused_fwd_kernel<(anonymous namespace)::FusedOps<64, 112>>"
        "(CUtensorMap_st, int, int, int, float, int)": "fused attention forward",
        "void (anonymous namespace)::flash_fwd_kernel<float, 4>(...)": "flash attention forward",
        "void (anonymous namespace)::flash_dq_kernel<__nv_bfloat16, 8>(...)":
            "flash attention dQ",
        "void (anonymous namespace)::flash_dkv_kernel<float, 4>(...)": "flash attention dK/dV",
        "void (anonymous namespace)::ln_bwd_kernel<float, float>(...)": "LN-fold launches",
        gemm.format("float, float, 0, 0, 3"): "fused MLP forward c_proj",
        gemm.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 3"): "fused MLP forward c_proj",
        wgmma.format("__nv_bfloat16, __nv_bfloat16, 0, 1, 4, 128"): "fused MLP forward c_fc",
        wgmma.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 3, 128"): "fused MLP forward c_proj",
        wgmma.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 0, 128"): "fused MLP forward c_proj",
        wgmma.format("__nv_bfloat16, __nv_bfloat16, 1, 0, 2, 128"): "fused MLP backward dh",
        wgmma.format("__nv_bfloat16, float, 1, 0, 0, 256"): "fused MLP backward dln",
        wgmma.format("__nv_bfloat16, float, 2, 2, 0, 256"): "fused MLP weight gradients",
        wgmma.format("__nv_bfloat16, float, 2, 3, 0, 256"): "fused MLP weight gradients",
        "void (anonymous namespace)::quantize_rows_kernel<float, 32, true>(...)":
            "int8 row quantize",
        "void (anonymous namespace)::quantize_columns_kernel<float, true>(...)":
            "int8 row quantize",
        "void (anonymous namespace)::int8_gemm_kernel<__nv_bfloat16, 2, true>(...)":
            "int8 GEMM",
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8": "cuBLAS",
        "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": "cuBLAS",
        "void at::native::vectorized_elementwise_kernel<4, ...>": "elementwise",
        "void at::native::reduce_kernel<512, 1, ...>": "reductions",
        "something_new": "other",
    }
    for kernel, family in cases.items():
        assert family in family_of(kernel), (kernel, family_of(kernel))
