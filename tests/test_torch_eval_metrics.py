"""The port's evaluation metrics (``eval/retrieval.py``, ``eval/entropy.py``,
``eval/separability.py``) and the training CLI's ``evaluate`` against the JAX package's on
the same numpy features and weights. Tolerances: ranks and recalls exactly (the rankings
of float32 cosines agree); the k-NN angle rtol 1e-5 (summation order); the whole-set
validation loss rtol 1e-5. The separability probe starts from other random weights than the
reference's (a torch generator for a JAX key), so it is held to the reference on data where
the answer is clear: 1.0 for separated modalities, near 0.5 for one distribution."""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.eval.entropy import average_kth_neighbor_angle, entropy_metric
from multimodal_tpu_torch.eval.retrieval import get_clip_metrics, recall_at_k
from multimodal_tpu_torch.eval.separability import linear_separability

torch.set_num_threads(1)


def _feats(n=40, e=16, seed=0, noise=0.5):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, e)).astype(np.float32)
    txt = (img + noise * rng.standard_normal((n, e))).astype(np.float32)
    return img, txt


@pytest.mark.parametrize("noise", [0.3, 1.5])
def test_clip_metrics_match_jax(noise):
    from multimodal_tpu.eval.retrieval import get_clip_metrics as jax_metrics

    img, txt = _feats(noise=noise)
    got, want = get_clip_metrics(img, txt, 50.0), jax_metrics(img, txt, 50.0)
    assert got == want


def test_recall_at_k_matches_jax_with_several_captions_per_image():
    from multimodal_tpu.eval.retrieval import recall_at_k as jax_recall

    rng = np.random.default_rng(1)
    img = rng.standard_normal((12, 8)).astype(np.float32)
    t2i = np.repeat(np.arange(12), 3)
    txt = (img[t2i] + 0.8 * rng.standard_normal((36, 8))).astype(np.float32)
    got, want = recall_at_k(img, txt, t2i), jax_recall(img, txt, t2i)
    assert got == want and set(got) == {f"{d}_R@{k}" for d in ("text_to_image", "image_to_text")
                                        for k in (1, 5, 10)}


@pytest.mark.parametrize("k,batch_size", [(1, 1000), (3, 7)])
def test_kth_neighbor_angle_matches_jax(k, batch_size):
    from multimodal_tpu.eval.entropy import average_kth_neighbor_angle as jax_angle

    img, _ = _feats(n=30)
    np.testing.assert_allclose(average_kth_neighbor_angle(img, k, batch_size),
                               jax_angle(img, k, batch_size), rtol=1e-5)


def test_entropy_metric_matches_jax():
    from multimodal_tpu.eval.entropy import entropy_metric as jax_entropy

    img, txt = _feats(n=20)
    got, want = entropy_metric(img, txt), jax_entropy(img, txt)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_separability_agrees_with_jax_where_the_answer_is_clear():
    from multimodal_tpu.eval.separability import linear_separability as jax_sep

    rng = np.random.default_rng(2)
    a = rng.standard_normal((64, 8)).astype(np.float32) + 3.0
    b = rng.standard_normal((64, 8)).astype(np.float32) - 3.0
    assert linear_separability(a, b, epochs=200) == jax_sep(a, b, epochs=200) == 1.0
    c = rng.standard_normal((64, 8)).astype(np.float32)
    d = rng.standard_normal((64, 8)).astype(np.float32)
    got, want = linear_separability(c, d, epochs=200), jax_sep(c, d, epochs=200)
    assert abs(got - 0.5) < 0.2 and abs(want - 0.5) < 0.2
    assert linear_separability(c, d, epochs=200, seed=1) == linear_separability(
        c, d, epochs=200, seed=1)


@pytest.mark.parametrize("variational", [False, True])
def test_evaluate_matches_jax(variational):
    """The CLI's validation pass on the same weights and the same synthetic val stream."""
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.data import DataInfo as JaxDataInfo
    from multimodal_tpu.data import SyntheticBatches as JaxBatches
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.train.run import evaluate as jax_evaluate
    from multimodal_tpu_torch.data.pipeline import DataInfo
    from multimodal_tpu_torch.data.synthetic import SyntheticBatches
    from multimodal_tpu_torch.models import create_model, load_jax_params
    from multimodal_tpu_torch.train.run import evaluate
    from torch_jax_models import random_params

    jm = jax_create_model("tiny-test", variational=variational)
    params = random_params(jm)
    c = jm.cfg
    kw = dict(batch_size=8, num_samples=24, image_size=c.vision.image_size,
              context_length=c.text.context_length, vocab_size=c.text.vocab_size)

    class Args:
        pass

    want = jax_evaluate(jm, jax.tree_util.tree_map(jnp.asarray, params),
                        JaxDataInfo(JaxBatches(**kw)), None, 0, Args())
    model = load_jax_params(create_model("tiny-test", variational=variational, device="cpu"),
                            params)
    got = evaluate(model, DataInfo(SyntheticBatches(**kw), "cpu"), 0, Args())
    assert set(got) == set(want)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    for key in ("knn_angle_image", "knn_angle_text"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for key in want:
        if "rank" in key or "R@" in key:
            assert got[key] == want[key], key
    assert 0.0 <= got["modality_separability"] <= 1.0 and got["epoch"] == 0
