"""Optimizer-state offload and ring attention on the card (``-m cuda``; imports no JAX).

* ``offload_opt_state``: between steps the fused AdamW's moments are pinned host tensors and
  the card holds none of them; three steps give the device step's metrics, parameters and
  moments bit for bit (the copies move the moments, the arithmetic is the same kernels'). On
  the CPU the offload refuses: it needs pinned host memory that a CUDA device copies from.
* ``ring_attention_blocks`` (the ring's schedule over 4 blocks of one sequence, every block a
  flash-kernel call) against one flash call over the whole sequence, forward and gradients,
  full and causal: float32 within 1e-4 x max|plain| (phase 3's float32 flash limit), bfloat16
  within 2e-2 x max|plain| (each block's output rounded to bfloat16 before the float32
  merge).
"""

import pytest
import torch

from multimodal_tpu_torch.models import create_model
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_offload_refuses_the_cpu():
    from multimodal_tpu_torch.parallel.offload import offload_optimizer_state

    model = create_model("tiny-test", device="cpu")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        offload_optimizer_state(make_optimizer(model.named_parameters(), 1e-3))


@pytest.mark.cuda
def test_offloaded_moments_live_on_the_host_and_the_step_is_unchanged():
    _cuda()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, generator=g),
             "text": torch.randint(1, 999, (8, 16), generator=g)}
    batch = {k: v.cuda() for k, v in batch.items()}
    runs = []
    for offload in (False, True):
        model = create_model("tiny-test", seed=0)
        opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50),
                             weight_decay=0.1, grad_clip_norm=1.0)
        step = make_train_step(model, opt, offload_opt_state=offload)
        state = TrainState.create(model, opt)
        metrics = [{k: v.item() for k, v in step(state, batch).items()} for _ in range(3)]
        torch.cuda.synchronize()
        moments = [t for slot in (opt.mu, opt.nu) for t in slot.values()]
        if offload:
            assert all(t.device.type == "cpu" and t.is_pinned() for t in moments)
        runs.append((metrics, {n: p.detach().clone() for n, p in model.named_parameters()},
                     {n: t.to("cuda") for n, t in opt.mu.items()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][n]), n
    for n, m in runs[0][2].items():
        assert torch.equal(m, runs[1][2][n]), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_on_the_flash_kernels(dtype, limit, causal):
    _cuda()
    from multimodal_tpu_torch.ops import launches
    from multimodal_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_tpu_torch.ops.ring_attention import ring_attention_blocks

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 1024, 4, 64, device="cuda", generator=g).to(dtype)
               .requires_grad_(True) for _ in range(3))
    ct = torch.randn(q.shape, device="cuda", generator=g).to(dtype)
    launches.reset_launch_counts()
    got = ring_attention_blocks(q, k, v, 4, causal=causal)
    g_got = torch.autograd.grad(got, (q, k, v), ct)
    counts = launches.launch_counts()
    visits = 10 if causal else 16  # 4 x 4 blocks, those wholly in the future skipped
    assert counts["flash_attention_fwd"] == visits
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == visits
    want = flash_attention(q, k, v, causal=causal)
    g_want = torch.autograd.grad(want, (q, k, v), ct)
    for a, b in zip((got, *g_got), (want, *g_want)):
        err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert err <= limit, err
