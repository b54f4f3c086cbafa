"""The captioning evaluation against the JAX package's, on the CPU: three ``CaptioningMetric``
AdamW steps against optax's ``adamw`` (weight decay 1e-4 on every leaf, biases and
LayerNorms included), the whole train -> generate -> BLEU pipeline, and the CLI's
``--epochs 0 --captioning-eval`` over a COCO-layout fixture against the JAX CLI's result on
the same weights (the encoder through one OpenAI-format ``.pt``, the caption decoder's
initial weights JAX's own, carried across).

Tolerances: after three steps at lr 1e-2, 99% of all parameter elements within 2e-6 of
optax's and every element within 5e-4 (Adam's normalized update turns a sum-order difference
in a gradient element far below the leaf's largest into a fraction of lr: ~2e-4 seen); decay
alone (zero gradients) within 1e-6 relative of p (1 - lr wd)^3, which a wrong decay or a
decay skipped on biases breaks; BLEU and the held-out count equal (the same tokens)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_tpu.eval.captioning import CaptioningMetric as JaxMetric
from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import captioner as jcap
from multimodal_tpu_torch.eval.captioning import CaptioningMetric
from multimodal_tpu_torch.models import add_model_config
from multimodal_tpu_torch.models import captioner as pcap
from multimodal_tpu_torch.train.run import main
from test_torch_captioner import caption_pair, inputs, random_tree

torch.set_num_threads(2)


# The key biases (the mapper's, and the k third of GPT-2's qkv bias) have a gradient of 0 in
# exact arithmetic: both sides hold rounding noise there, which Adam's normalization scales
# up, so they are left out of the comparison.


@pytest.mark.parametrize("transformer_mapper", [True, False], ids=["transformer", "mlp"])
def test_three_adamw_steps_match_optax(transformer_mapper):
    jm, params, pm = caption_pair(transformer_mapper, seed=20)
    emb, toks = inputs(n=12, seed=21)
    kw = dict(epochs=1, batch_size=4, lr=1e-2, seed=3)
    want = JaxMetric(caption_model=jm, **kw).train(emb, toks, params=params)
    start = {k: torch.from_numpy(v) for k, v in pcap.caption_params_to_port(params).items()}
    got = CaptioningMetric(caption_model=pm, **kw).train(emb, toks, params=start)
    want = pcap.caption_params_to_port(want)
    moved, diffs = 0.0, []
    for name, value in want.items():
        g = got[name].numpy()
        if name.endswith("attn_qkv.bias"):  # its q and v thirds are held as the rest
            w = value.shape[0] // 3
            g, value = (np.concatenate([a[:w], a[2 * w:]]) for a in (g, value))
        elif name.endswith("attn.key.bias"):
            continue
        np.testing.assert_allclose(g, value, atol=5e-4, rtol=0, err_msg=name)
        diffs.append(np.abs(g - value).ravel())
        moved = max(moved, float(np.abs(g - start[name].numpy()[: g.shape[0]]).max()))
    assert moved > 1e-3  # the steps moved the weights
    assert np.quantile(np.concatenate(diffs), 0.99) <= 2e-6


def test_weight_decay_reaches_every_leaf():
    """On captions that are all padding the loss and every gradient are exactly 0, so three
    steps are decay alone: every leaf, biases and LayerNorms included, is p (1 - lr wd)^3,
    as optax's adamw leaves it (torch's AdamW default decay, 1e-2, would give another)."""
    jm, params, pm = caption_pair(seed=24)
    emb, _ = inputs(n=12, seed=25)
    toks = np.zeros((12, 8), np.int32)
    kw = dict(epochs=1, batch_size=4, lr=1e-2, seed=3)
    want = pcap.caption_params_to_port(
        JaxMetric(caption_model=jm, **kw).train(emb, toks, params=params))
    start = {k: torch.from_numpy(v) for k, v in pcap.caption_params_to_port(params).items()}
    got = CaptioningMetric(caption_model=pm, **kw).train(emb, toks, params=start)
    decay = (1.0 - 1e-2 * 1e-4) ** 3
    for name, value in want.items():
        expect = start[name].numpy().astype(np.float64) * decay
        np.testing.assert_allclose(value, expect, rtol=1e-6, atol=0, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), expect, rtol=1e-6, atol=0, err_msg=name)
    assert not np.array_equal(got["lm.ln_f.bias"].numpy(), start["lm.ln_f.bias"].numpy())


def test_compute_pipeline_equals_jax():
    """Train (2 epochs), generate greedily until the EOS, BLEU over detokenized captions."""
    jm, params, pm = caption_pair(seed=22)
    rng = np.random.default_rng(23)
    emb_a = rng.normal(2.0, 0.1, (12, 16)).astype(np.float32)
    emb_b = rng.normal(-2.0, 0.1, (12, 16)).astype(np.float32)
    tok_a = np.tile(np.array([5, 6, 7, 3, 0, 0], np.int32), (12, 1))
    tok_b = np.tile(np.array([9, 10, 11, 3, 0, 0], np.int32), (12, 1))
    embeds, tokens = np.concatenate([emb_a, emb_b]), np.concatenate([tok_a, tok_b])
    held = np.concatenate([emb_a[:4], emb_b[:4]])
    refs = ["5 6 7"] * 4 + ["9 10 11"] * 4
    kw = dict(epochs=2, batch_size=8, lr=2e-3, max_gen_len=6, eos_token=3,
              detokenizer=lambda ids: " ".join(str(i) for i in ids))
    want = JaxMetric(caption_model=jm, **kw).compute(embeds, tokens, held, refs, params=params)
    start = {k: torch.from_numpy(v) for k, v in pcap.caption_params_to_port(params).items()}
    got = CaptioningMetric(caption_model=pm, **kw).compute(embeds, tokens, held, refs,
                                                           params=start)
    assert got == want


# ---------------------------------------------------------------------------------- the CLI

NAME = "tiny-caption-cli-torch"
CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": 64, "layers": 1,
                 "heads": 2},
}
add_model_config(NAME, CFG)
jax_add_model_config(NAME, CFG)
WORDS = ["a", "dog", "cat", "red", "car", "on", "the", "street", "two", "people"]
CAPTION_FLAGS = ["--captioning-width", "64", "--captioning-layers", "1",
                 "--captioning-epochs", "2"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
    from torch_jax_models import random_params

    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(0)
    (root / "val2017").mkdir()
    (root / "annotations").mkdir()
    images, anns = [], []
    for i in range(21):  # 21 images: 8 held out, 13 to train on
        fn = f"{i:012d}.jpg"
        arr = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        arr[:, : 8 + i] //= 2
        Image.fromarray(arr).save(root / "val2017" / fn, quality=90)
        images.append({"id": i, "file_name": fn})
        anns += [{"image_id": i, "caption": " ".join(rng.choice(WORDS, 4)) + f" {j}"}
                 for j in range(2)]
    (root / "annotations" / "captions_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    jm = jax_create_model(NAME)
    sd = export_torch_state_dict(random_params(jm, seed=8), jm.cfg)
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()},
               root / "weights.pt")
    return root


def test_cli_captioning_eval_equals_the_jax_cli(coco, tmp_path, monkeypatch):
    from multimodal_tpu.train.run import main as jax_main

    # the decoder JAX's CLI builds, and the initial weights its CaptioningMetric.train draws
    # from the run's seed, carried into the port's in place of the port's own draws
    jm = jcap.ClipCaptionModel(
        gpt2=jcap.GPT2Config(vocab_size=49408, max_positions=128, width=64, layers=1,
                             heads=2),
        clip_dim=CFG["embed_dim"], prefix_length=10, clip_length=4, mapper_layers=2)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, CFG["embed_dim"])),
                   jnp.zeros((2, 77), jnp.int32))
    start = {k: torch.from_numpy(v) for k, v in pcap.caption_params_to_port(
        jax.tree_util.tree_map(np.asarray, init)).items()}
    monkeypatch.setattr(pcap.ClipCaptionModel, "fresh_state_dict", lambda self, seed: start)

    common = ["--dataset-type", "synthetic", "--model", NAME, "--batch-size", "8",
              "--epochs", "0", "--precision", "fp32", "--pretrained", str(coco / "weights.pt"),
              "--captioning-eval", str(coco), "--logs", str(tmp_path)] + CAPTION_FLAGS
    assert jax_main(common + ["--name", "jax"]) == 0
    assert main(common + ["--name", "port", "--device", "cpu"]) == 0
    last = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "results.jsonl") as f:
            last[side] = [json.loads(line) for line in f][-1]
    assert last["port"]["caption_num_eval"] == last["jax"]["caption_num_eval"] == 8
    assert last["port"]["caption_bleu"] == last["jax"]["caption_bleu"]
    assert 0.0 <= last["port"]["caption_bleu"] <= 1.0


def test_cli_captioning_eval_skips_under_20_images(tmp_path):
    root = tmp_path / "folders"
    for cls in ("cat", "dog"):
        (root / cls).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(np.full((32, 32, 3), 40 * i, np.uint8)).save(root / cls / f"{i}.jpg")
    argv = ["--dataset-type", "synthetic", "--model", NAME, "--device", "cpu", "--epochs",
            "0", "--captioning-eval", str(root), "--logs", str(tmp_path), "--name", "few"]
    assert main(argv + CAPTION_FLAGS) == 0
    with open(tmp_path / "few" / "results.jsonl") as f:
        record = [json.loads(line) for line in f][-1]
    assert "caption_bleu" not in record and record["eval"] is True


def test_random_tree_helper_covers_the_decoder():
    """The shared helper's tree loads into the port's model (every leaf named and shaped)."""
    jm = jcap.ClipCaptionModel(gpt2=jcap.TINY_GPT2, clip_dim=16, prefix_length=3,
                               clip_length=2, mapper_layers=2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)),
                                            jnp.zeros((1, 4), jnp.int32)))
    pm = pcap.ClipCaptionModel(gpt2=pcap.TINY_GPT2, clip_dim=16, prefix_length=3,
                               clip_length=2, mapper_layers=2, device="cpu")
    pcap.load_caption_params(pm, random_tree(shapes, 1))
    with pytest.raises(ValueError, match="does not cover"):
        pcap.load_caption_params(pm, {"params": {"lm": {}}})
