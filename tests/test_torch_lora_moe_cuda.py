"""LoRA and MoE training on the card at ViT-B/32 width and a depth of 2 + 2 blocks: the
kernel path (every block's attention through the hand-written block kernels) against the
plain path (the same blocks through the kernels' plain versions) from the same start, two
float32 steps each with phase 6's optimizer (the fused AdamW, cosine schedule from 1e-3 with
100 warm-up steps, weight decay 0.1, clip 1.0). Limits: ``chip_smoke.py`` phase 6's (loss
1e-5 relative, grad norm 1e-4); for MoE a step whose expert choices differ between the paths
in d of its decisions holds its loss to 1e-5 + d / (B S) and its grad norm is not held (phase
11's rule). Every test needs a CUDA device and skips without one; nothing here imports JAX.

    python -m pytest tests/test_torch_lora_moe_cuda.py -m cuda
"""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_tpu_torch import paths
from multimodal_tpu_torch.models import add_model_config, create_model
from multimodal_tpu_torch.models.moe import MoEMLP, top_k_rounds
from multimodal_tpu_torch.train import (
    TrainState,
    finetune_mask,
    freeze_optimizer,
    make_optimizer,
    make_schedule,
    make_train_step,
)

B = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    with open(os.path.join(paths.CONFIG_DIR, "ViT-B-32.json")) as f:
        cfg = json.load(f)
    cfg["vision_cfg"]["layers"] = cfg["text_cfg"]["layers"] = 2
    add_model_config("ViT-B-32-depth2", cfg)
    moe = json.loads(json.dumps(cfg))
    moe["vision_cfg"].update(moe_experts=8, moe_every=2, moe_top_k=2, moe_capacity_factor=1.25)
    add_model_config("ViT-B-32-depth2-moe", moe)
    return torch.device("cuda")


@pytest.fixture
def plain_blocks(monkeypatch):
    """A switch that routes every block's attention to the kernels' plain versions."""
    from multimodal_tpu_torch.models import layers
    from multimodal_tpu_torch.ops import block_attention as ba

    def plain(x, *ws, heads, causal=False, ln_scale=None, ln_bias=None, residual=False):
        xn = ba.ln_rows(x, ln_scale, ln_bias, ba.LN_EPS) if ln_scale is not None else x
        out = ba.block_attention_reference(xn, *ws, heads=heads, causal=causal)
        return x + out if residual else out

    return lambda: monkeypatch.setattr(layers, "block_attention", plain)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (B, cfg.text.context_length))
    tokens[:, -1] = cfg.text.vocab_size - 1
    return {"image": torch.from_numpy(images).cuda(), "text": torch.from_numpy(tokens).cuda()}


def _steps(model, batch, freeze=None, steps=2):
    schedule = make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000)
    kw = dict(weight_decay=0.1, grad_clip_norm=1.0)
    if freeze:
        opt = freeze_optimizer(model, finetune_mask(model.named_parameters(), freeze), schedule,
                               **kw)
    else:
        opt = make_optimizer(model.named_parameters(), schedule, **kw)
    step, state = make_train_step(model, opt), TrainState.create(model, opt)
    return [{k: float(v) for k, v in step(state, batch).items()} for _ in range(steps)]


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.cuda
def test_cuda_lora_step_matches_the_plain_path(cuda_device, plain_blocks):
    model = create_model("ViT-B-32-depth2", lora_rank=8, lora_alpha=16.0)
    batch, start = _batch(model.cfg), {k: v.clone() for k, v in model.state_dict().items()}
    kernel = _steps(model, batch, freeze="lora")
    frozen = [n for n, t in finetune_mask(model.named_parameters(), "lora").items() if not t]
    for n in frozen:
        assert torch.equal(dict(model.named_parameters())[n], start[n]), n
    assert any(not torch.equal(p, start[n]) for n, p in model.named_parameters()
               if n.endswith("lora_b"))
    model.load_state_dict(start)
    plain_blocks()
    plain = _steps(model, batch, freeze="lora")
    for k, p in zip(kernel, plain):
        assert _rel(k["loss"], p["loss"]) <= 1e-5, (k, p)
        assert _rel(k["grad_norm"], p["grad_norm"]) <= 1e-4, (k, p)


@pytest.mark.cuda
def test_cuda_moe_step_matches_the_plain_path(cuda_device, plain_blocks):
    model = create_model("ViT-B-32-depth2-moe")
    moe = [m for m in model.modules() if isinstance(m, MoEMLP)]
    assert len(moe) == 1 and moe[0].capacity(50) == 15
    choices = []
    moe[0].register_forward_hook(lambda m, inp, _: choices.append(
        torch.stack(top_k_rounds(m.router_probs(inp[0]).detach(), m.top_k), -1)))
    batch, start = _batch(model.cfg), {k: v.clone() for k, v in model.state_dict().items()}
    kernel = _steps(model, batch)
    model.load_state_dict(start)
    plain_blocks()
    plain = _steps(model, batch)
    tokens = B * 50
    for i, (k, p) in enumerate(zip(kernel, plain)):
        flips = int((choices[i] != choices[2 + i]).sum())
        assert np.isfinite(k["moe_aux_loss"]) and 1.0 <= k["moe_aux_loss"] / 2 <= 8.0
        assert _rel(k["loss"], p["loss"]) <= 1e-5 + flips / tokens, (k, p, flips)
        if flips == 0:
            assert _rel(k["grad_norm"], p["grad_norm"]) <= 1e-4, (k, p)
