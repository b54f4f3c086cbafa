"""CLIP encoders of the PyTorch port against the JAX package with the same weights.

The JAX params cross through ``export_torch_state_dict`` (OpenAI names) and the port's
``load_openai_state_dict``; inputs come from a seeded numpy generator. Tolerance f32
atol = rtol = 2e-4, the one the JAX package's own torch interop test uses. ``tiny-test``
(width 64) runs the port's plain attention; ``tiny`` (width 128, head_dim 64) the
block-attention operator.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
from multimodal_tpu_torch.models import create_model, load_openai_state_dict
from multimodal_tpu_torch.models.clip import eot_pool
from multimodal_tpu_torch.ops.block_attention import block_attn_supported

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)


def random_params(jm, seed: int = 0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator (no Flax init run):
    LN scales near 1, vectors ~0.02, tables and kernels at fan-in scale."""
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
def _models(name):
    jm = jax_create_model(name)
    params = random_params(jm)
    pm = load_openai_state_dict(create_model(name, seed=1, device="cpu"),
                                export_torch_state_dict(params, jm.cfg))
    return jm, params, pm


def _inputs(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.standard_normal((n, s, s, 3), dtype=np.float32)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (n, cfg.text.context_length))
    tokens[np.arange(n), rng.integers(1, cfg.text.context_length, n)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("name", ["tiny-test", "tiny"])
def test_encoders_match_jax(name, normalize):
    jm, params, pm = _models(name)
    images, tokens = _inputs(jm.cfg)
    enc = lambda method: jax.jit(functools.partial(  # noqa: E731
        jm.apply, method=method, normalize=normalize))
    want_i = np.asarray(enc(jm.encode_image)(params, jnp.asarray(images)))
    want_t = np.asarray(enc(jm.encode_text)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_i = pm.encode_image(torch.from_numpy(images), normalize=normalize).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens).long(), normalize=normalize).numpy()
    np.testing.assert_allclose(got_i, want_i, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)


def test_configs_take_the_intended_attention_path():
    assert not block_attn_supported(3, 5, 64, 2)  # tiny-test: plain attention
    for seq in (17, 32):  # tiny: vision S=17, text S=32
        assert block_attn_supported(3, seq, 128, 2)


def test_forward_returns_both_towers_and_scale():
    jm, params, pm = _models("tiny")
    images, tokens = _inputs(jm.cfg, seed=1)
    want = jax.jit(jm.apply)(params, jnp.asarray(images), jnp.asarray(tokens))
    with torch.inference_mode():
        got = pm(torch.from_numpy(images), torch.from_numpy(tokens).long())
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    np.testing.assert_allclose(got["logit_scale"].item(), float(want["logit_scale"]), rtol=1e-6)


def test_eot_pool_takes_the_largest_token():
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    tokens = torch.tensor([[1, 9, 2, 0], [1, 2, 3, 9]])
    torch.testing.assert_close(eot_pool(x, tokens), torch.stack([x[0, 1], x[1, 3]]))


@pytest.mark.parametrize("name", ["tiny-test", "tiny"])
def test_state_dict_round_trip(name):
    """export_torch_state_dict -> load_openai_state_dict reproduces every JAX leaf, from
    numpy values and from torch tensors (a real OpenAI state_dict's type)."""
    jm, params, pm = _models(name)
    sd = export_torch_state_dict(params, jm.cfg)
    p = params["params"]
    got = dict(pm.named_parameters())
    checks = {
        "visual_stem.patch_conv": p["visual_stem"]["patch_conv"]["kernel"],
        "text_stem.token_embedding": p["text_stem"]["token_embedding"]["embedding"],
        "visual_transformer.resblocks.1.attn.key.kernel":
            p["visual_transformer"]["resblock_1"]["attn"]["key"]["kernel"],
        "text_transformer.resblocks.0.mlp.c_proj.bias":
            p["text_transformer"]["resblock_0"]["mlp"]["c_proj"]["bias"],
        "ln_final.weight": p["ln_final"]["LayerNorm_0"]["scale"],
        "visual_projection": p["visual_projection"],
        "logit_scale": p["logit_scale"],
    }
    for k, v in checks.items():
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(v), err_msg=k)
    again = load_openai_state_dict(create_model(name, seed=2, device="cpu"),
                                   {f"module.{k}": torch.tensor(v) for k, v in sd.items()})
    for k, v in again.named_parameters():
        torch.testing.assert_close(v, got[k], atol=0, rtol=0)


def test_state_dict_mismatch_raises():
    jm, params, _ = _models("tiny-test")
    sd = export_torch_state_dict(params, jm.cfg)
    sd["visual.proj"] = sd["visual.proj"][:, :-1]
    with pytest.raises(ValueError, match="visual_projection"):
        load_openai_state_dict(create_model("tiny-test", device="cpu"), sd)
    del sd["ln_final.weight"]
    with pytest.raises(KeyError):
        load_openai_state_dict(create_model("tiny-test", device="cpu"), sd)


def test_seeded_init_is_reproducible_and_unported_configs_raise():
    a, b = create_model("tiny", seed=3, device="cpu"), create_model("tiny", seed=3, device="cpu")
    for (k, va), vb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(va, vb, atol=0, rtol=0, msg=k)
    from multimodal_tpu_torch.models import add_model_config

    add_model_config("tiny-test-cosine", {
        "embed_dim": 64,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 16, "heads": 2,
                       "scaled_cosine": True},
        "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 2,
                     "layers": 2}})
    with pytest.raises(NotImplementedError, match="vision.scaled_cosine"):
        create_model("tiny-test-cosine", device="cpu")
    with pytest.raises(NotImplementedError, match="vision.moe_experts"):
        create_model("tiny-test-moe", device="cpu")


def test_create_model_lands_on_the_card_unless_asked_for_the_cpu():
    """No device argument means the GPU; without one that raises, and nothing moves to the
    CPU on its own."""
    if torch.cuda.is_available():
        assert next(create_model("tiny-test").parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            create_model("tiny-test")
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            create_model("tiny-test", device="cuda:0")
    assert next(create_model("tiny-test", device="cpu").parameters()).device.type == "cpu"
