"""Serving a checkpoint the port's training CLI wrote (``serving --checkpoint DIR [--ema]``,
``serving.load_serving_weights``): the CLI saves with and without ``--model-ema``; the
restore serves the EMA or the trained weights as asked and tolerates the EMA toggle; the
served rows equal an ``Embedder`` over a model loaded directly from the checkpoint (bit for
bit, float32 on the CPU) and the JAX ``Embedder`` on the same weights, exported through the
OpenAI format (atol 2e-4, as ``tests/test_torch_serving.py``); a checkpoint of another shape
or a corrupt file raises its own error, not "no restorable checkpoint"; ``--checkpoint``
with ``--state-dict`` is refused."""

import os

import numpy as np
import pytest
import torch

from multimodal_tpu_torch import serving
from multimodal_tpu_torch.inference import Embedder
from multimodal_tpu_torch.models import create_model, export_openai_state_dict
from multimodal_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_tpu_torch.train.run import main as train_main

torch.set_num_threads(1)

MODEL = "tiny"  # 64 px, the full BPE vocabulary (real captions embed)
TEXTS = ["a photo of a cat", "two dogs in the snow", "a red car"]


def _train(logs, name, ema: bool):
    argv = ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size", "8",
            "--train-num-samples", "24", "--epochs", "1", "--lr", "1e-3", "--warmup", "1",
            "--device", "cpu", "--precision", "fp32", "--seed", "1", "--logs", str(logs),
            "--name", name] + (["--model-ema", "--model-ema-decay", "0.5"] if ema else [])
    assert train_main(argv) == 0
    return str(logs / name / "checkpoints")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    logs = tmp_path_factory.mktemp("logs")
    return {"ema": _train(logs, "ema", True), "plain": _train(logs, "plain", False)}


def _images(n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def _direct(ckpt: str, use_ema: bool):
    """A model loaded by hand from the checkpoint: the trained parameters, or the EMA."""
    saved, _ = CheckpointManager(ckpt).restore()
    model = create_model(MODEL, device="cpu")
    model.load_state_dict(saved["model"])
    if use_ema:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved["ema"][n])
    return model


def test_cli_saves_with_and_without_the_ema(checkpoints):
    ema, _ = CheckpointManager(checkpoints["ema"]).restore()
    plain, _ = CheckpointManager(checkpoints["plain"]).restore()
    assert ema["step"] == plain["step"] == 3
    assert plain["ema"] is None
    assert set(ema["ema"]) == set(ema["model"]) & set(ema["ema"])
    moved = [n for n in ema["ema"] if not torch.equal(ema["ema"][n], ema["model"][n])]
    assert moved  # the EMA lags the trained parameters


@pytest.mark.parametrize("ckpt,ask_ema,serves_ema", [
    ("ema", True, True), ("ema", False, False),
    ("plain", True, False),  # the toggle: --ema on a run without one serves its parameters
    ("plain", False, False),
])
def test_restore_serves_the_weights_asked_for(checkpoints, ckpt, ask_ema, serves_ema):
    model = create_model(MODEL, device="cpu", seed=9)
    loaded = serving.load_serving_weights(model, checkpoints[ckpt], ema=ask_ema)
    assert loaded["step"] == 3 and loaded["ema"] == serves_ema
    svc = serving.EmbeddingService(model, max_batch=4)
    try:
        want = Embedder(_direct(checkpoints[ckpt], serves_ema), batch_size=4)
        imgs = _images()
        np.testing.assert_array_equal(svc.embed_image_arrays(imgs), want.embed_images(imgs))
        np.testing.assert_array_equal(svc.embed_texts(TEXTS), want.embed_texts(TEXTS))
    finally:
        svc.close()


def test_ema_and_trained_weights_serve_differently_and_match_jax(checkpoints):
    import jax.numpy as jnp

    from multimodal_tpu.inference import Embedder as JaxEmbedder
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models.checkpoint_interop import convert_torch_state_dict

    rows = {}
    for ema in (True, False):
        model = create_model(MODEL, device="cpu")
        serving.load_serving_weights(model, checkpoints["ema"], ema=ema)
        rows[ema] = Embedder(model, batch_size=4).embed_images(_images())
        jm = jax_create_model(MODEL)
        params = convert_torch_state_dict(export_openai_state_dict(model), jm.cfg)
        theirs = JaxEmbedder(jm, {"params": params["params"] if "params" in params else params},
                             batch_size=4)
        np.testing.assert_allclose(rows[ema], theirs.embed_images(jnp.asarray(_images())),
                                   atol=2e-4)
    assert np.abs(rows[True] - rows[False]).max() > 1e-4


def test_unnormalized_service_returns_the_projections(checkpoints):
    model = create_model(MODEL, device="cpu")
    serving.load_serving_weights(model, checkpoints["ema"], ema=True)
    svc = serving.EmbeddingService(model, max_batch=4, normalize=False)
    try:
        got = svc.embed_image_arrays(_images())
    finally:
        svc.close()
    norms = np.linalg.norm(got, axis=-1)
    assert not np.allclose(norms, 1.0, atol=1e-3)
    want = Embedder(_direct(checkpoints["ema"], True), batch_size=4, normalize=False)
    np.testing.assert_array_equal(got, want.embed_images(_images()))


def test_a_checkpoint_of_another_shape_raises_its_own_error(checkpoints, tmp_path):
    other = create_model("tiny-test", device="cpu")  # other widths and vocabulary
    with pytest.raises(RuntimeError, match="size mismatch"):
        serving.load_serving_weights(other, checkpoints["ema"], ema=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        serving.load_serving_weights(other, checkpoints["plain"], ema=False)
    with pytest.raises(FileNotFoundError, match="no saved step"):
        serving.load_serving_weights(other, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no such directory"):
        serving.load_serving_weights(other, str(tmp_path / "missing"))
    assert not os.path.exists(tmp_path / "missing")
    # a corrupt state file: its own load error, not a quiet fall to the other EMA form
    bad = tmp_path / "bad"
    step = CheckpointManager(checkpoints["plain"]).latest_step()
    os.makedirs(bad / str(step))
    with open(bad / str(step) / "state.pt", "wb") as f:
        f.write(b"not a torch file")
    with open(bad / str(step) / "metadata.json", "w") as f:
        f.write("{}")
    with pytest.raises(Exception) as info:
        serving.load_serving_weights(create_model(MODEL, device="cpu"), str(bad), ema=True)
    assert "restorable" not in str(info.value)


def test_main_serves_a_checkpoint_and_refuses_two_sources(checkpoints, tmp_path,
                                                          monkeypatch):
    with pytest.raises(SystemExit):
        serving.main(["--device", "cpu", "--model", MODEL, "--checkpoint",
                      checkpoints["ema"], "--state-dict", str(tmp_path / "sd.pt")])
    with pytest.raises(SystemExit):
        serving.main(["--device", "cpu", "--model", MODEL, "--ema"])
    served = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def __init__(self, service):
            self.service = service

        def serve_forever(self):  # answer once in process, then stop as Ctrl-C would
            served["rows"] = self.service.embed_image_arrays(_images())
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(serving, "make_server", lambda svc, host, port: Server(svc))
    assert serving.main(["--device", "cpu", "--model", MODEL, "--checkpoint",
                         checkpoints["ema"], "--ema", "--max-batch", "4"]) == 0
    want = Embedder(_direct(checkpoints["ema"], True), batch_size=4).embed_images(_images())
    np.testing.assert_array_equal(served["rows"], want)
