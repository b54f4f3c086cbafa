"""The port's training step against the JAX package's ``make_train_step`` (no mesh).

The same weights (seeded numpy values in the JAX tree, crossing ``export_torch_state_dict``
-> ``load_openai_state_dict``) and the same numpy batch (uint8 images, token ids) go through
two steps on each side: cosine schedule with warmup, weight decay 0.1 and an active
global-norm clip of 1.0. The JAX gradients come from a jitted ``jax.grad`` of its own
``make_loss_fn`` at the parameters each step starts from; they cross to the port's names
through the same layout transform as the weights. ``tiny`` runs the block-attention
operator (its plain backward here), ``tiny-test`` plain attention.

Tolerances, float32 on the CPU, where the two sides differ only in summation order:
loss and grad norm rtol 1e-5; every gradient leaf atol 1e-4 x max(1, max|leaf|) and rtol
1e-3 (the floor covers the attention key biases, zero in exact arithmetic, noise on both
sides); parameters after step 2 atol 2e-5, rtol 1e-5 (Adam's normalized update turns a
gradient difference of 1e-5 into an update difference well under the 5e-4 step size).
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.models import create_model, load_openai_state_dict
from multimodal_tpu_torch.models.checkpoint_interop import _openai_to_port
from multimodal_tpu_torch.train import (
    TrainState,
    make_optimizer,
    make_schedule,
    make_train_step,
)
from multimodal_tpu_torch.train.engine import _clamp_logit_scale, batch_images

torch.set_num_threads(1)

B = 8
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (B, cfg.text.context_length))
    tokens[np.arange(B), rng.integers(1, cfg.text.context_length, B)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


def _random_params(jm, seed=0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator (Flax's init is slow on
    the CPU): LN scales near 1, vectors ~0.02, tables and kernels at fan-in scale."""
    import jax

    from multimodal_tpu.models import init_params

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(2.6592)
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """Initial params, per-step metrics, per-step grads and final params of 2 JAX steps."""
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    jm = jax_create_model(name)
    params = jax.tree_util.tree_map(jnp.asarray, _random_params(jm))
    images, tokens = _batch(jm.cfg)
    batch = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = jax_train_step(jm, tx, loss_type="clip", donate=False)
    loss_fn = make_loss_fn(jm, "clip")
    grad_fn = jax.jit(jax.grad(lambda p: loss_fn(p, batch, rng)[0]))
    state = JaxState.create(params, tx)
    metrics, grads = [], []
    for _ in range(2):
        grads.append(grad_fn(state.params))
        state, m = step(state, batch, rng)
        metrics.append({k: float(m[k]) for k in ("loss", "logit_scale", "grad_norm")})
    return jm.cfg, params, metrics, grads, state.params


def _to_port_names(tree, cfg, model):
    from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict

    return _openai_to_port(export_torch_state_dict(tree, cfg), model)


@functools.lru_cache(maxsize=None)
def _port_run(name):
    from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict

    cfg, params, _, _, _ = _jax_run(name)
    model = load_openai_state_dict(create_model(name, device="cpu"), export_torch_state_dict(params, cfg))
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = make_train_step(model, opt)
    state = TrainState.create(model, opt)
    images, tokens = _batch(cfg)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}
    metrics, grads = [], []
    for _ in range(2):
        m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()})
    assert state.step == 2 and int(opt.count) == 2
    return model, metrics, grads


NAMES = ["tiny", "tiny-test"]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grad_norm_match_jax(name):
    _, _, want, _, _ = _jax_run(name)
    _, got, _ = _port_run(name)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(g["logit_scale"], w["logit_scale"], rtol=1e-6)
    assert got[0]["grad_norm"] > OPT["grad_clip_norm"]  # the clip is active


@pytest.mark.parametrize("name", NAMES)
def test_every_grad_leaf_matches_jax(name):
    cfg, _, _, want_grads, _ = _jax_run(name)
    model, _, got_grads = _port_run(name)
    for want_tree, got in zip(want_grads, got_grads):
        want = _to_port_names(want_tree, cfg, model)
        assert set(want) == set(got)
        for n, w in want.items():
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got[n], w, atol=1e-4 * scale, rtol=1e-3, err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_params_after_two_steps_match_jax(name):
    cfg, _, _, _, want_params = _jax_run(name)
    model, _, _ = _port_run(name)
    want = _to_port_names(want_params, cfg, model)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-5, rtol=1e-5, err_msg=n)


def test_block_attention_path_taken_on_tiny():
    """tiny's attention runs the BlockAttention Function, tiny-test's plain attention."""
    from multimodal_tpu_torch.ops.block_attention import block_attn_supported

    for name, want in (("tiny", True), ("tiny-test", False)):
        cfg = create_model(name, device="cpu").cfg
        s = (cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1
        assert block_attn_supported(B, s, cfg.vision.width, cfg.vision.heads) is want


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("use_shard_map", True), ("accum_steps", 2),
    ("feature_cached_accum", True), ("ema_decay", 0.999), ("offload_opt_state", True),
    ("wire_size", 128),
])
def test_left_out_options_raise(option, value):
    model = create_model("tiny-test", device="cpu")
    opt = make_optimizer(model.named_parameters(), 1e-3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(model, opt, **{option: value})


@pytest.mark.parametrize("kwargs", [{"loss_type": "cloob"},
                                    {"loss_kwargs": {"contrastive_impl": "chunked"}}])
def test_left_out_losses_raise(kwargs):
    model = create_model("tiny-test", device="cpu")
    opt = make_optimizer(model.named_parameters(), 1e-3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(model, opt, **kwargs)


def test_batch_images_normalizes_uint8_like_jax():
    from multimodal_tpu.data.preprocess import normalize_images

    cfg = create_model("tiny-test", device="cpu").cfg
    images, _ = _batch(cfg, seed=1)
    got = batch_images({"image": torch.from_numpy(images)}, create_model("tiny-test", device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(normalize_images(images)), atol=1e-6)
    floats = torch.randn(2, 32, 32, 3)
    assert batch_images({"image": floats}) is floats
    with pytest.raises(ValueError, match="expects 32px"):
        batch_images({"image": torch.zeros(2, 64, 64, 3, dtype=torch.uint8)},
                     create_model("tiny-test", device="cpu"))
    with pytest.raises(NotImplementedError, match="wire_size"):
        batch_images({"image": floats}, wire_size=16)


def test_logit_scale_clamp():
    model = create_model("tiny-test", device="cpu")
    for value, want in ((7.0, 4.6052), (-1.0, 0.0), (3.0, 3.0)):
        with torch.no_grad():
            model.logit_scale.fill_(value)
        _clamp_logit_scale(model)
        assert model.logit_scale.item() == pytest.approx(want)


def test_bf16_compute_sends_float32_grads_to_params():
    """A bfloat16 compute dtype trains float32 parameters: grads come back through .to()."""
    model = create_model("tiny", dtype=torch.bfloat16, device="cpu")
    assert not model.training  # create_model returns .eval(); the step calls .train()
    opt = make_optimizer(model.named_parameters(), make_schedule("const", 1e-3, 0, 10), **OPT)
    step = make_train_step(model, opt)
    state = TrainState.create(model, opt)
    images, tokens = _batch(model.cfg)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert "visual_transformer.resblocks.0.attn.query.kernel" in moved
    assert "text_transformer.resblocks.1.attn.out.kernel" in moved
