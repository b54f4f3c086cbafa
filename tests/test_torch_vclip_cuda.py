"""The variational CLIP on the card: the block-attention kernels at the variational
towers' shapes (vision S=51, text S=78 causal) against their plain versions, and one vclip
train step through the kernels against the plain path. Every test needs a CUDA device and
skips without one; nothing here imports JAX (the card's machine has none).

    python -m pytest tests/test_torch_vclip_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.models import create_model
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_train_step


def _batch(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (n, cfg.text.context_length))
    tokens[np.arange(n), rng.integers(1, cfg.text.context_length, n)] = cfg.text.vocab_size - 1
    return images, tokens


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,w,heads,causal", [(51, 768, 12, False), (78, 512, 8, True)])
def test_cuda_block_kernels_at_the_variational_shapes(cuda_device, s, w, heads, causal, dtype,
                                                      tol):
    """The block-attention forward and backward at the vision tower's S=51 and the text
    tower's S=78 causal, every output against the plain version."""
    from multimodal_tpu_torch.ops import block_attention as ba

    g = torch.Generator(device="cuda").manual_seed(s)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    x, dy = rnd(3, s, w).to(dtype), rnd(3, s, w).to(dtype)
    ws = []
    for _ in range(4):
        ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
    kw = dict(heads=heads, causal=causal)
    pairs = [((ba.block_attention(x, *ws, **kw),), (ba.block_attention_reference(x, *ws, **kw),)),
             (ba.block_attention_bwd(x, dy, *ws, **kw),
              ba.block_attention_bwd_reference(x, dy, *ws, **kw))]
    torch.cuda.synchronize()
    for got, want in pairs:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            err, ref = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
            assert torch.isfinite(a).all() and err <= tol * ref, (err, ref)


@pytest.mark.cuda
def test_cuda_vclip_step_through_the_kernels_matches_the_plain_path(cuda_device, monkeypatch):
    """One float32 vclip step on tiny (block attention at S=18 and S=33 causal) through the
    kernels and one from the same start and generator seed with the block operator's plain
    version: the same loss, and each kernel launched once per block."""
    from multimodal_tpu_torch.models import layers
    from multimodal_tpu_torch.ops import block_attention as ba
    from multimodal_tpu_torch.ops import launches

    def plain(x, *ws, heads, causal=False, ln_scale=None, ln_bias=None, residual=False):
        xn = ba.ln_rows(x, ln_scale, ln_bias, ba.LN_EPS) if ln_scale is not None else x
        out = ba.block_attention_reference(xn, *ws, heads=heads, causal=causal)
        return x + out if residual else out

    losses = []
    for route in ("kernels", "plain"):
        model = create_model("tiny", variational=True, device=cuda_device)
        opt = make_optimizer(model.named_parameters(), 1e-3)
        step = make_train_step(model, opt, loss_type="vclip", loss_kwargs=dict(
            kl_weight=100.0, riemannian=True))
        images, tokens = _batch(model.cfg)
        batch = {"image": torch.from_numpy(images).cuda(), "text": torch.from_numpy(tokens).cuda()}
        if route == "plain":
            monkeypatch.setattr(layers, "block_attention", plain)
        launches.reset_launch_counts()
        m = step(TrainState.create(model, opt), batch,
                 torch.Generator(device="cuda").manual_seed(0))
        counts = launches.launch_counts()
        losses.append(float(m["loss"]))
        want = 4 if route == "kernels" else 0
        assert counts["block_attention_fwd"] == counts["block_attention_bwd"] == want, counts
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]), losses
