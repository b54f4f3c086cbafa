"""The port's zero-shot classifier, its top-k accuracy, the metadata tables and the paired
top-k metrics against the JAX package's on the same seeded weights (``load_jax_params``) and
inputs: the template-averaged classifier matrix at atol 1e-5 (float32 on the CPU), the top-1
and top-5 accuracies equal, the tables equal, the paired ranks equal (the top-k shares are
equal counts over N, so they agree to a float32 rounding of the division, rel 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.eval import metadata as jax_metadata
from multimodal_tpu.eval import topk as jax_topk
from multimodal_tpu.eval import zero_shot as jax_zs
from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu_torch.eval import metadata, topk, zero_shot
from multimodal_tpu_torch.models import add_model_config, create_model, load_jax_params
from torch_jax_models import random_params

torch.set_num_threads(1)

NAME = "tiny-zero-shot-torch"
CFG = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "layers": 2,
                 "heads": 2},
}
add_model_config(NAME, CFG)
jax_add_model_config(NAME, CFG)
CLASSES = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog"]


@pytest.fixture(scope="module")
def models():
    jm = jax_create_model(NAME)
    params = random_params(jm, seed=5)
    pm = load_jax_params(create_model(NAME, device="cpu"), params).eval()
    return pm, jm, params


def _classifiers(models, tmpl):
    pm, jm, params = models
    enc_j = jax.jit(lambda t: jm.apply(params, t, normalize=True, method=jm.encode_text))
    want = np.asarray(jax_zs.build_zero_shot_classifier(enc_j, CLASSES, tmpl, batch_classes=3,
                                                        context_length=16))
    with torch.no_grad():
        got = zero_shot.build_zero_shot_classifier(
            lambda t: pm.encode_text(t, normalize=True), CLASSES, tmpl, batch_classes=3,
            context_length=16, device="cpu")
    return got, want


@pytest.mark.parametrize("name", ["openai", "simple"])
def test_classifier_matrix_matches_jax(models, name):
    got, want = _classifiers(models, metadata.templates(name)[:12])
    assert got.shape == (16, len(CLASSES)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=0).numpy(), 1.0, atol=1e-6)


def test_zero_shot_accuracy_equals_jax(models):
    pm, jm, params = models
    got_c, want_c = _classifiers(models, metadata.templates("openai")[:8])
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((5, 32, 32, 3)).astype(np.float32),
                rng.integers(0, len(CLASSES), 5).astype(np.int32)) for _ in range(3)]
    enc_j = jax.jit(lambda x: jm.apply(params, x, normalize=True, method=jm.encode_image))
    want = jax_zs.zero_shot_eval(enc_j, jnp.asarray(want_c), iter(batches), topk=(1, 2, 5))
    with torch.no_grad():
        got = zero_shot.zero_shot_eval(lambda x: pm.encode_image(x, normalize=True), got_c,
                                       iter(batches), topk=(1, 2, 5))
    assert got == want
    assert set(got) == {"top1", "top2", "top5"}


def test_accuracy_counts_equal_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 7)).astype(np.float32)
    targets = rng.integers(0, 7, 40)
    want = jax_zs.accuracy_counts(logits, targets, topk=(1, 3, 5, 10))
    assert zero_shot.accuracy_counts(torch.from_numpy(logits), targets, (1, 3, 5, 10)) == want
    assert want[-1] == 40.0  # k capped at the class count


def test_metadata_tables_equal_jax():
    for name in ("openai", "simple", "identity"):
        assert metadata.templates(name) == jax_metadata.templates(name)
    for ds in ("imagenet", "imagenet-v2", "imagenet-sketch", "imagenet-a", "imagenet-r",
               "imagenet-o", "cifar10", "cifar100", "flowers102", "stanford-cars", "food101"):
        assert metadata.classnames(ds) == jax_metadata.classnames(ds)
    tmpl = metadata.templates("openai")
    assert metadata.apply_templates("cat", tmpl) == jax_metadata.apply_templates("cat", tmpl)
    with pytest.raises(KeyError):
        metadata.classnames("no-such-set")


def test_topk_equals_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((37, 8)).astype(np.float32)
    txt = img + 0.8 * rng.standard_normal((37, 8)).astype(np.float32)
    want = np.asarray(jax_topk.paired_ranks(img, txt, batch_size=10))
    np.testing.assert_array_equal(topk.paired_ranks(img, txt, batch_size=10).numpy(), want)
    want = jax_topk.topk_metrics(img, txt, ks=(1, 5, 10))
    assert topk.topk_metrics(img, txt, ks=(1, 5, 10)) == pytest.approx(want, rel=1e-6)
    assert topk.top_k_score(img, txt, k=3) == pytest.approx(jax_topk.top_k_score(img, txt, k=3),
                                                            rel=1e-6)
