"""The shared-trunk CLIP of the PyTorch port against the JAX package with the same weights:
``encode_image``, ``encode_text`` and one ``make_train_step`` step (loss, grad norm, every
gradient leaf, updated parameters), with and without ``vision.scale_heads``.

Configs: ``tiny-test-shared`` (width 64: plain attention on both passes) and a shared config
built here, width 128 with 192 px images and 16 px patches, so the vision pass has S = 145
and the port runs the LN-fold block operator (its plain versions on the CPU) while the text
pass at S = 16 runs the non-LN operator behind ``ln_rows``. With ``scale_heads`` every block
routes to ``attention`` and multiplies by a per-head scale, seeded away from its unit init
so that a dropped or misplaced scale shows. The JAX parameter tree crosses through
``load_jax_params`` (the OpenAI-format export has no key for ``head_scale``); the model
without ``scale_heads`` also crosses through ``export_torch_state_dict`` ->
``load_openai_state_dict``.

Tolerances, float32 on the CPU, where the two sides differ only in summation order:
encoders atol = rtol = 2e-4 (the JAX package's torch interop test); loss and grad norm rtol
1e-5; every gradient leaf atol 1e-4 x max(1, max|leaf|), rtol 1e-3; parameters after the
step atol 2e-5, rtol 1e-5 — those of tests/test_torch_train_step.py.
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
from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
from multimodal_tpu_torch.models import (
    add_model_config,
    create_model,
    load_jax_params,
    load_openai_state_dict,
)
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.ops import block_attention as ba
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)
B = 4


def _shared_cfg(scale_heads: bool, width=128, image=192) -> dict:
    return {
        "embed_dim": 64,
        "vision_cfg": {"image_size": image, "patch_size": 16, "width": width, "layers": 2,
                       "heads": 2, "scale_heads": scale_heads},
        "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": width, "heads": 2,
                     "layers": 2},
        "share_trunk": True,
    }


CONFIGS = {
    "shared-s145": _shared_cfg(False),
    "shared-s145-scale-heads": _shared_cfg(True),
    "tiny-test-shared-scale-heads": _shared_cfg(True, width=64, image=32),
}
for _name, _cfg in CONFIGS.items():  # the same dict in both registries
    add_model_config(_name, _cfg)
    jax_add_model_config(_name, _cfg)
NAMES = ["tiny-test-shared", *CONFIGS]


def _random_params(jm, seed=0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator: LN scales and head
    scales near 1 (not at it), vectors ~0.02, tables and kernels at fan-in scale."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(2.6592)
        if name.endswith("head_scale"):
            return 1 + 0.3 * n
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (B, cfg.text.context_length))
    tokens[np.arange(B), rng.integers(1, cfg.text.context_length, B)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _models(name):
    jm = jax_create_model(name)
    params = _random_params(jm)
    pm = load_jax_params(create_model(name, seed=1, device="cpu"), params)
    return jm, params, pm


@pytest.mark.parametrize("name", NAMES)
def test_shared_encoders_match_jax(name):
    jm, params, pm = _models(name)
    images, tokens = _batch(jm.cfg, seed=1)
    images = ((images.astype(np.float32) / 255.0) - 0.5) / 0.25
    enc = lambda method: jax.jit(functools.partial(jm.apply, method=method))  # noqa: E731
    want_i = np.asarray(enc(jm.encode_image)(params, jnp.asarray(images)))
    want_t = np.asarray(enc(jm.encode_text)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_i = pm.encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got_i, want_i, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)


def test_shared_model_has_one_trunk_and_one_projection():
    _, params, pm = _models("shared-s145-scale-heads")
    names = {n for n, _ in pm.named_parameters()}
    assert "projection" in names and "ln_post.weight" in names
    assert not any(n.startswith(("visual_transformer", "text_transformer", "ln_final",
                                 "visual_projection", "text_projection")) for n in names)
    assert "transformer.resblocks.1.attn.head_scale" in names
    want = params["params"]["transformer"]["resblock_1"]["attn"]["head_scale"]
    got = dict(pm.named_parameters())["transformer.resblocks.1.attn.head_scale"]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert np.abs(np.asarray(want) - 1).max() > 0.05  # seeded away from the unit init
    fresh = create_model("shared-s145-scale-heads", device="cpu")
    assert torch.equal(fresh.transformer.resblocks[0].attn.head_scale, torch.ones(2))
    _, _, plain = _models("shared-s145")
    assert not any("head_scale" in n for n, _ in plain.named_parameters())


def test_shared_configs_take_the_intended_attention_path(monkeypatch):
    """shared-s145: LN-fold operator on the vision pass (S = 145), non-LN operator behind
    ln_rows on the text pass (S = 16, causal); with scale_heads neither."""
    seen = []
    for fn_name in ("block_attention_ln_reference", "block_attention_reference"):
        plain = getattr(ba, fn_name)

        def spy(*a, _plain=plain, _name=fn_name, **k):
            seen.append((_name, a[0].shape[1], k["causal"]))
            return _plain(*a, **k)

        monkeypatch.setattr(ba, fn_name, spy)
    cfg = _models("shared-s145")[0].cfg
    images, tokens = _batch(cfg)
    for name, want in (
            ("shared-s145", [("block_attention_ln_reference", 145, False)] * 2
             + [("block_attention_reference", 145, False)] * 2  # called by the LN form
             + [("block_attention_reference", 16, True)] * 2),
            ("shared-s145-scale-heads", [])):
        seen.clear()
        pm = _models(name)[2]
        with torch.inference_mode():
            pm.encode_image(torch.from_numpy(images).float())
            pm.encode_text(torch.from_numpy(tokens).long())
        assert sorted(seen) == sorted(want), name


def test_shared_openai_state_dict_round_trip():
    """Without head scales the shared layout also crosses the OpenAI-format export, with
    its fallback keys; with them the loader says what it lacks."""
    jm, params, pm = _models("shared-s145")
    sd = export_torch_state_dict(params, jm.cfg)
    assert "transformer.resblocks.0.attn.in_proj_weight" in sd and "projection" in sd
    again = load_openai_state_dict(create_model("shared-s145", seed=2, device="cpu"), sd)
    for (k, va), vb in zip(again.named_parameters(), pm.parameters()):
        torch.testing.assert_close(va, vb, atol=0, rtol=0, msg=k)
    sd["text_projection"] = sd.pop("projection")
    sd["ln_post.weight"], sd["ln_post.bias"] = (sd.pop("visual.ln_post.weight"),
                                                sd.pop("visual.ln_post.bias"))
    fallback = load_openai_state_dict(create_model("shared-s145", seed=3, device="cpu"), sd)
    torch.testing.assert_close(fallback.projection, pm.projection, atol=0, rtol=0)
    torch.testing.assert_close(fallback.ln_post.weight, pm.ln_post.weight, atol=0, rtol=0)
    jm_h, params_h, _ = _models("shared-s145-scale-heads")
    with pytest.raises(ValueError, match="head_scale"):
        load_openai_state_dict(create_model("shared-s145-scale-heads", device="cpu"),
                               export_torch_state_dict(params_h, jm_h.cfg))


def test_load_jax_params_mismatch_raises():
    _, params, _ = _models("tiny-test-shared")
    with pytest.raises(ValueError, match="head_scale"):
        load_jax_params(create_model("tiny-test-shared-scale-heads", device="cpu"), params)
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["params"]["projection"] = bad["params"]["projection"][:, :-1]
    with pytest.raises(ValueError, match="shape mismatch at projection"):
        load_jax_params(create_model("tiny-test-shared", device="cpu"), bad)


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """Metrics, gradients and updated params of one JAX train step."""
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    jm, params, _ = _models(name)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    images, tokens = _batch(jm.cfg)
    batch = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = jax_train_step(jm, tx, loss_type="clip", donate=False)
    loss_fn = make_loss_fn(jm, "clip")
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, rng)[0]))(params)
    state, m = step(JaxState.create(params, tx), batch, rng)
    metrics = {k: float(m[k]) for k in ("loss", "logit_scale", "grad_norm")}
    return metrics, jax_params_to_port(grads), jax_params_to_port(state.params)


@functools.lru_cache(maxsize=None)
def _port_step(name):
    jm, params, _ = _models(name)
    model = load_jax_params(create_model(name, device="cpu"), params)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    state = TrainState.create(model, opt)
    images, tokens = _batch(jm.cfg)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}
    m = make_train_step(model, opt)(state, batch)
    grads = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    return model, {k: float(v) for k, v in m.items()}, grads


@pytest.mark.parametrize("name", NAMES)
def test_shared_train_step_loss_and_grad_norm_match_jax(name):
    want, _, _ = _jax_step(name)
    _, got, _ = _port_step(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(got["logit_scale"], want["logit_scale"], rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_shared_train_step_every_grad_leaf_matches_jax(name):
    _, want, _ = _jax_step(name)
    _, _, got = _port_step(name)
    assert set(want) == set(got)
    for n, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[n], w, atol=1e-4 * scale, rtol=1e-3, err_msg=n)
    if "scale-heads" in name:
        assert np.abs(got["transformer.resblocks.0.attn.head_scale"]).max() > 0


@pytest.mark.parametrize("name", NAMES)
def test_shared_train_step_updated_params_match_jax(name):
    _, _, want = _jax_step(name)
    model, _, _ = _port_step(name)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-5, rtol=1e-5, err_msg=n)
