"""Scaled-cosine attention, the attentional pooler and mean pooling in the PyTorch port
against the JAX package: the modules alone (values and gradients) and ``CLIP`` with each of
the three options, weights crossing ``load_jax_params``.

Weights are seeded numpy values in the JAX tree. Tolerances, float32 on the CPU, where the
two sides differ only in summation order: module values and gradients within 1e-5 x the
largest value of the compared tensor (for a gradient leaf that is zero in exact arithmetic, of
1e-2 x the module's largest gradient); model features atol = rtol = 2e-4 (those of
tests/test_torch_block_options.py); one train step's loss and grad norm rtol 1e-5 and every
gradient leaf atol 1e-4 x max(1, max|leaf|), rtol 1e-3 (tests/test_torch_train_step.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.models.layers import AttentionalPooler as JaxPooler
from multimodal_tpu.models.layers import MultiHeadAttention as JaxMHA
from multimodal_tpu_torch.models import add_model_config, create_model, layers, load_jax_params
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step
from multimodal_tpu_torch.train.optimizer import wd_mask

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)
B = 4


def _cfg(shared=False, **vision) -> dict:
    """The configs of the JAX package's ``test_clip_pooling_modes``, one option each."""
    return {
        "embed_dim": 16,
        "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 32, "layers": 2, "heads": 2,
                       "n_queries": 4, "attn_pooler_heads": 2, **vision},
        "text_cfg": {"context_length": 12, "vocab_size": 64, "width": 32, "layers": 2,
                     "heads": 2},
        "share_trunk": shared,
    }


CONFIGS = {
    "pool-global-average": _cfg(global_average_pool=True),
    "pool-attentional": _cfg(attentional_pool=True),
    "pool-scaled-cosine": _cfg(scaled_cosine=True),
    "pool-scaled-cosine-shared": _cfg(True, scaled_cosine=True, attentional_pool=True),
}
for _name, _c in CONFIGS.items():  # the same dict in both registries
    add_model_config(_name, _c)
    jax_add_model_config(_name, _c)


def _random_tree(shapes, seed=0, clamped_head=False):
    """Seeded numpy values for a tree of shapes: LN scales near 1, the cosine temperatures
    around log 10 (with ``clamped_head`` head 0 above the clamp), other vectors ~0.02,
    matrices at fan-in scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(2.6592)
        if name.endswith("logit_scale"):  # the per-head ones; the model's own is a scalar
            lift = 3.0 if clamped_head else 0.0
            return (2.3 + 0.2 * n + np.where(np.arange(s.shape[0]) == 0, lift, 0.0)).astype(
                np.float32)
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, what, floor=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=1e-5 * max(np.abs(want).max(), floor), rtol=0,
                               err_msg=what)


def _close_grads(module, want_tree):
    """Every gradient leaf within 1e-5 x its largest value; a leaf that is zero in exact
    arithmetic (the key bias: softmax ignores a per-row constant) holds rounding noise on
    both sides, so the scale has a floor of 1e-2 x the module's largest gradient."""
    grads = jax_params_to_port(want_tree)
    floor = 1e-2 * max(np.abs(g).max() for g in grads.values())
    for n, p in module.named_parameters():
        _close(p.grad.numpy(), grads[n], n, floor)


# ----------------------------------------------------------------------------- the modules
@pytest.mark.parametrize("causal", [False, True])
def test_scaled_cosine_attention_matches_jax_values_and_grads(causal):
    x = np.random.default_rng(1).standard_normal((2, 9, 32), dtype=np.float32)
    jm = JaxMHA(width=32, heads=4, scaled_cosine=True, causal=causal)
    params = _random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                          clamped_head=True)
    assert float(params["params"]["logit_scale"][0]) > 4.6052  # head 0 sits in the clamp
    loss = lambda p, x: jnp.sum(jm.apply(p, x) ** 2)  # noqa: E731
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    want_g, want_dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    pm = layers.MultiHeadAttention(32, 4, causal=causal, scaled_cosine=True)
    ported = jax_params_to_port(params)
    assert set(ported) == {n for n, _ in pm.named_parameters()}
    with torch.no_grad():
        for n, p in pm.named_parameters():
            p.copy_(torch.from_numpy(ported[n]))
    xt = torch.from_numpy(x).requires_grad_()
    out = pm(xt)
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), want, "out")
    _close(xt.grad.numpy(), want_dx, "dx")
    _close_grads(pm, want_g)
    assert pm.logit_scale.grad[0] == 0 and pm.logit_scale.grad[1:].abs().min() > 0  # clamped


def test_scaled_cosine_stays_off_the_block_operator_and_the_kernels(monkeypatch):
    """Cosine logits change the attention core itself, so the block goes neither to the block
    operator (at a shape it takes) nor, through ``impl="xla"``, to any attention kernel."""
    called = []
    monkeypatch.setattr(layers, "block_attention", lambda *a, **k: called.append("block"))
    real = layers.attention
    monkeypatch.setattr(layers, "attention",
                        lambda *a, **k: called.append(k.get("impl")) or real(*a, **k))
    assert layers.block_attn_supported(2, 16, 128, 2)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 128, generator=g)
    pm = layers.MultiHeadAttention(128, 2, scaled_cosine=True)
    for m in (pm.query, pm.key, pm.value, pm.out):
        m.init_weights(g)
    out = pm(x, ln_params=(torch.ones(128), torch.zeros(128)), fuse_residual=True)
    assert called == ["xla"] and out.shape == x.shape
    torch.testing.assert_close(pm.logit_scale, torch.full((2,), float(np.log(10.0))))
    bf16 = layers.MultiHeadAttention(128, 2, scaled_cosine=True, dtype=torch.bfloat16)
    assert bf16(x.bfloat16()).dtype == torch.bfloat16


def test_attentional_pooler_matches_jax_values_and_grads():
    x = np.random.default_rng(2).standard_normal((3, 17, 64), dtype=np.float32)
    jm = JaxPooler(d_model=64, n_head=4, n_queries=8)
    params = _random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    loss = lambda p, x: jnp.sum(jm.apply(p, x) ** 2)  # noqa: E731
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    want_g, want_dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    pm = layers.AttentionalPooler(64, n_head=4, n_queries=8)
    ported = jax_params_to_port(params)
    assert set(ported) == {n for n, _ in pm.named_parameters()}
    with torch.no_grad():
        for n, p in pm.named_parameters():
            p.copy_(torch.from_numpy(ported[n]))
    xt = torch.from_numpy(x).requires_grad_()
    out = pm(xt)
    assert out.shape == (3, 8, 64)
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), want, "out")
    _close(xt.grad.numpy(), want_dx, "dx")
    _close_grads(pm, want_g)


def test_attentional_pooler_init_distributions():
    pm = layers.AttentionalPooler(256, n_head=4, n_queries=64)
    g = torch.Generator().manual_seed(0)
    for m in pm.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(g)
    assert abs(pm.query.std().item() - 1.0) < 0.02
    assert abs(pm.key_proj.kernel.std().item() - 256 ** -0.5) < 0.002
    assert pm.out_proj.bias.abs().max() == 0 and pm.ln_q.weight.min() == 1


# ----------------------------------------------------------------------------- the models
@functools.lru_cache(maxsize=None)
def _jax_model(name):
    jm = jax_create_model(name)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))
    return jm, _random_tree(shapes)


def _port_model(name):
    return load_jax_params(create_model(name, device="cpu"), _jax_model(name)[1])


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (B, cfg.text.context_length))
    tokens[np.arange(B), rng.integers(1, cfg.text.context_length, B)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clip_with_each_option_matches_jax(name):
    jm, params = _jax_model(name)
    pm = _port_model(name)
    images, tokens = _batch(jm.cfg, seed=1)
    images = ((images.astype(np.float32) / 255.0) - 0.5) / 0.25
    enc = lambda method: jax.jit(functools.partial(jm.apply, method=method))  # noqa: E731
    want_i = np.asarray(enc(jm.encode_image)(params, jnp.asarray(images)))
    want_t = np.asarray(enc(jm.encode_text)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_i = pm.encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens).long()).numpy()
    assert got_i.shape == (B, 16) and np.isfinite(got_i).all()
    np.testing.assert_allclose(got_i, want_i, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)


def test_pooling_modes_pool_what_they_say():
    images = torch.from_numpy(_batch(create_model("pool-attentional", device="cpu").cfg)[0])
    images = images.float() / 255.0
    gap = _port_model("pool-global-average")
    with torch.inference_mode():
        x = gap.visual_transformer(gap.visual_stem(images))
        want = gap.ln_post(x.mean(dim=1)) @ gap.visual_projection
        torch.testing.assert_close(gap.encode_image(images), want)
        cls = gap.ln_post(x[:, 0]) @ gap.visual_projection
        assert not torch.allclose(want, cls, atol=1e-3)
        pool = _port_model("pool-attentional")
        x = pool.visual_transformer(pool.visual_stem(images))
        want = pool.ln_post(pool.attn_pool(x)[:, 0]) @ pool.visual_projection
        torch.testing.assert_close(pool.encode_image(images), want)
    assert not hasattr(gap, "attn_pool") and pool.attn_pool.query.shape == (4, 32)


def test_load_jax_params_fills_every_new_leaf_and_raises_on_a_missing_one():
    _, params = _jax_model("pool-scaled-cosine-shared")
    ported = jax_params_to_port(params)
    new = ["attn_pool.query", "attn_pool.ln_q.weight", "attn_pool.ln_k.bias",
           "attn_pool.query_proj.kernel", "attn_pool.key_proj.bias", "attn_pool.value_proj.kernel",
           "attn_pool.out_proj.bias", "transformer.resblocks.0.attn.logit_scale",
           "transformer.resblocks.1.attn.logit_scale"]
    assert set(new) <= set(ported)
    pm = _port_model("pool-scaled-cosine-shared")
    for n in new:
        np.testing.assert_array_equal(dict(pm.named_parameters())[n].detach().numpy(), ported[n])
    for lost in ("attn_pool", "logit_scale"):
        tree = jax.tree_util.tree_map(lambda a: a, params)
        if lost == "attn_pool":
            del tree["params"]["attn_pool"]["query"]
        else:
            del tree["params"]["transformer"]["resblock_1"]["attn"]["logit_scale"]
        with pytest.raises(ValueError, match="does not cover the model: missing"):
            load_jax_params(create_model("pool-scaled-cosine-shared", device="cpu"), tree)


def test_per_head_logit_scale_takes_no_weight_decay():
    """The cosine temperatures are 1-D, so the decay rule (ndim >= 2 and not the model's
    logit scale) leaves them alone whether or not the name matches, as the JAX package's
    ``wd_mask`` does on the same tree."""
    from multimodal_tpu.train.optimizer import wd_mask as jax_wd_mask

    jm, params = _jax_model("pool-scaled-cosine-shared")
    pm = _port_model("pool-scaled-cosine-shared")
    mask = wd_mask(list(pm.named_parameters()))
    assert mask == {n: bool(v) for n, v in jax_params_to_port(jax_wd_mask(params)).items()}
    assert not mask["transformer.resblocks.0.attn.logit_scale"] and not mask["logit_scale"]
    assert not mask["attn_pool.ln_q.weight"] and not mask["attn_pool.out_proj.bias"]
    assert mask["attn_pool.query"] and mask["attn_pool.value_proj.kernel"]


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    jm, params = _jax_model(name)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    images, tokens = _batch(jm.cfg)
    batch = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    loss_fn = make_loss_fn(jm, "clip")
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, rng)[0]))(params)
    _, m = jax_train_step(jm, tx, loss_type="clip", donate=False)(
        JaxState.create(params, tx), batch, rng)
    return {k: float(m[k]) for k in ("loss", "grad_norm")}, jax_params_to_port(grads)


@pytest.mark.parametrize("name", ["pool-global-average", "pool-scaled-cosine-shared"])
def test_train_step_with_the_options_matches_jax(name):
    want, want_grads = _jax_step(name)
    model = _port_model(name)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    images, tokens = _batch(model.cfg)
    m = make_train_step(model, opt)(TrainState.create(model, opt), {
        "image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"], rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want_grads)
    for n, w in want_grads.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[n], w, atol=1e-4 * scale, rtol=1e-3, err_msg=n)
