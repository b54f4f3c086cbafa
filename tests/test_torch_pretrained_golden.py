"""The port's ``--pretrained`` torch-file path against the committed goldens:
``tests/assets/interop_tiny_clip.pt`` (a state_dict in the OpenAI CLIP layout) through
``models.load_pretrained`` must reproduce the embeddings the torch model recorded in
``interop_tiny_golden.npz``, at the reference's tolerance (atol 2e-4, rtol 2e-3,
``tests/test_pretrained_golden.py``), through ``load_pretrained`` alone and through the CLI's
``--pretrained``; and on other inputs the loaded model matches the JAX package's
``load_pretrained`` of the same file (atol 2e-4)."""

import os

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.models import add_model_config, create_model, load_pretrained

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
PT = os.path.join(ASSETS, "interop_tiny_clip.pt")
NAME = "interop-test"  # tests/test_checkpoint_interop.py's config
CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": 64, "layers": 2,
                 "heads": 2},
}
add_model_config(NAME, CFG)


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(ASSETS, "interop_tiny_golden.npz"))
    return {k: data[k] for k in data.files}


def test_load_pretrained_from_disk_matches_torch_goldens(golden):
    model = load_pretrained(create_model(NAME, device="cpu", seed=5), PT)
    images = torch.from_numpy(golden["images"]).permute(0, 2, 3, 1)  # NCHW -> NHWC
    tokens = torch.from_numpy(golden["tokens"]).to(torch.int64)
    with torch.no_grad():
        fi = model.eval().encode_image(images).numpy()
        ft = model.encode_text(tokens).numpy()
    np.testing.assert_allclose(fi, golden["image_embeddings"], atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(ft, golden["text_embeddings"], atol=2e-4, rtol=2e-3)


def test_cli_pretrained_torch_file_loads_the_goldens_weights(tmp_path, monkeypatch):
    """``--pretrained file.pt`` in the CLI goes through ``load_pretrained``."""
    from multimodal_tpu_torch.train import run

    seen = {}
    real = run.load_pretrained

    def spy(model, path):
        seen["model"] = real(model, path)
        return seen["model"]

    monkeypatch.setattr(run, "load_pretrained", spy)
    assert run.main(["--dataset-type", "synthetic", "--model", NAME, "--epochs", "0",
                     "--device", "cpu", "--logs", str(tmp_path), "--name", "g",
                     "--pretrained", PT]) == 0
    want = load_pretrained(create_model(NAME, device="cpu", seed=7), PT)
    for (n, p), (_, q) in zip(seen["model"].named_parameters(), want.named_parameters()):
        assert torch.equal(p, q), n


def test_loaded_model_matches_jax_load_pretrained_on_other_inputs():
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.models import add_model_config as jax_add_model_config
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models import init_params
    from multimodal_tpu.models.checkpoint_interop import load_pretrained as jax_load_pretrained
    from multimodal_tpu.models.config import get_model_config

    jax_add_model_config(NAME, CFG)
    jm = jax_create_model(NAME)
    params = jax_load_pretrained(PT, init_params(jm, jax.random.PRNGKey(0)),
                                 get_model_config(NAME))
    pm = load_pretrained(create_model(NAME, device="cpu"), PT).eval()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, 999, (3, 16))
    tokens[:, 9] = 999  # one EOT (the largest id) per row
    want_i = np.asarray(jm.apply(params, jnp.asarray(images), method=jm.encode_image))
    want_t = np.asarray(jm.apply(params, jnp.asarray(tokens), method=jm.encode_text))
    with torch.no_grad():
        got_i = pm.encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got_i, want_i, atol=2e-4)
    np.testing.assert_allclose(got_t, want_t, atol=2e-4)
