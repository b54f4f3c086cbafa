"""The port's ``HFSentenceEncoder`` (``--semantic-model-path``) against the reference class on
a tiny ``BertModel`` saved with a hand-written ``vocab.txt`` into ``tmp_path`` (no download):
the same rows at atol 1e-6 (float32 on the CPU; the two run the same torch model, so only the
pooling's arithmetic could differ). ``make_semantic_encoder`` raises where ``transformers`` or
the snapshot is missing (the reference falls back to hashing), and the CLI trains the align
loss with the encoder over a file-list dataset."""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_tpu_torch.data.semantic import (
    HashingSemanticEncoder,
    HFSentenceEncoder,
    make_semantic_encoder,
)

torch.set_num_threads(1)

WORDS = ["a", "photo", "of", "the", "cat", "dog", "two", "dogs", "in", "snow", "red", "car",
         "on", "bridge", "##s", "play", "##ing"]
TEXTS = ["a photo of a cat", "two dogs playing in the snow", "a red car on a bridge",
         "cat", "an unknown word zebra"]


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    from transformers import BertConfig, BertModel, BertTokenizer

    d = tmp_path_factory.mktemp("bert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=2, intermediate_size=64, max_position_embeddings=64)
    BertModel(cfg).eval().save_pretrained(str(d))
    return str(d)


def test_port_matches_the_reference_class(snapshot):
    from multimodal_tpu.data.semantic import HFSentenceEncoder as JaxPackageEncoder

    want = JaxPackageEncoder(snapshot, batch_size=2)(TEXTS)
    got = HFSentenceEncoder(snapshot, batch_size=2, device="cpu")(TEXTS)
    assert got.shape == (len(TEXTS), 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert got[0] @ got[3] > got[0] @ got[2] - 1.0  # rows are distinct unit vectors
    assert isinstance(make_semantic_encoder(snapshot, device="cpu"), HFSentenceEncoder)


def test_make_semantic_encoder_raises_instead_of_falling_back(snapshot, tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="not a directory"):
        make_semantic_encoder(str(tmp_path / "missing"), device="cpu")
    with pytest.raises((OSError, ValueError)):  # a directory that holds no snapshot
        make_semantic_encoder(str(tmp_path), device="cpu")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        make_semantic_encoder(snapshot, device="cpu")
    assert isinstance(make_semantic_encoder(None), HashingSemanticEncoder)


def test_cli_trains_the_align_loss_with_the_snapshot(snapshot, tmp_path):
    from multimodal_tpu_torch.train.run import main

    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / "data" / cls)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                tmp_path / "data" / cls / f"{i}.jpg", quality=90)
    assert main(["--dataset-type", "cood", "--train-data", str(tmp_path / "data"),
                 "--model", "tiny", "--batch-size", "4", "--epochs", "1", "--device", "cpu",
                 "--precision", "fp32", "--loss", "align", "--nl_semantic_supervision",
                 "--semantic-model-path", snapshot, "--logs", str(tmp_path / "logs"),
                 "--name", "align", "--log-every-n-steps", "1"]) == 0
    text = open(tmp_path / "logs" / "align" / "results.jsonl").read()
    assert '"loss"' in text
