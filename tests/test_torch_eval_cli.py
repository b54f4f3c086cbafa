"""The evaluations through the port's CLI (``--epochs 0`` with the zero-shot, retrieval and
linear-probe flags) against the JAX CLI's on the same weights (one OpenAI-format ``.pt``
through ``--pretrained``) and the same stock-layout fixtures, in the manner of
``tests/test_zero_shot_cli.py`` and ``tests/test_retrieval_cli.py``: every metric equal
(accuracies and recalls are counts; the features agree to float32 rounding, and the fixtures
keep clear of ties: solid-colour classes the probe separates). Per-epoch evaluation under
``--zeroshot-frequency`` / ``--retrieval-frequency`` on the EMA weights, then an eval-only
resume of the checkpoint that reports the same numbers; and the flags still refused (item 9's;
item 11's, ``--captioning-eval`` and ``--profile-steps``, pass the check since they were
ported)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu_torch.models import add_model_config
from multimodal_tpu_torch.train.params import parse_args
from multimodal_tpu_torch.train.run import main

torch.set_num_threads(1)

NAME = "tiny-eval-cli-torch"
CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "layers": 2,
                 "heads": 2},
}
add_model_config(NAME, CFG)
jax_add_model_config(NAME, CFG)
COLOURS = {"red": (200, 30, 30), "green": (30, 200, 30), "blue": (30, 30, 200)}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
    from torch_jax_models import random_params

    root = tmp_path_factory.mktemp("evals")
    rng = np.random.default_rng(0)
    for cls, rgb in COLOURS.items():  # folder-per-class: solid colours with a little noise
        os.makedirs(root / "folder" / cls)
        for i in range(6):
            arr = np.clip(np.asarray(rgb) + rng.integers(-12, 13, (40, 48, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(root / "folder" / cls / f"{i}.jpg",
                                                       quality=95)
    d = root / "cifar" / "cifar-10-batches-py"
    d.mkdir(parents=True)
    data = rng.integers(0, 255, (30, 3072), dtype=np.uint8)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({"data": data, "labels": list(rng.integers(0, 10, 30))}, f)
    with open(d / "batches.meta", "wb") as f:
        pickle.dump({"label_names": ["airplane", "automobile", "bird", "cat", "deer", "dog",
                                     "frog", "horse", "ship", "truck"]}, f)
    (root / "coco" / "val2017").mkdir(parents=True)
    (root / "coco" / "annotations").mkdir()
    images, anns = [], []
    for i in range(6):
        fn = f"{i:012d}.jpg"
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            root / "coco" / "val2017" / fn, quality=90)
        images.append({"id": i, "file_name": fn})
        anns += [{"image_id": i, "caption": f"photo {i} caption {j}"} for j in range(2)]
    (root / "coco" / "annotations" / "captions_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    jm = jax_create_model(NAME)
    sd = export_torch_state_dict(random_params(jm, seed=6), jm.cfg)
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()},
               root / "weights.pt")
    return root


def _evals(root):
    return ["--cifar10", str(root / "cifar"), "--imagenet-val", str(root / "folder"),
            "--coco-retrieval", str(root / "coco"), "--linear-probe-train",
            str(root / "folder"), "--linear-probe-epochs", "60"]


def _last(logs, name):
    with open(logs / name / "results.jsonl") as f:
        return [json.loads(line) for line in f][-1]


def test_eval_only_metrics_equal_the_jax_cli(fixtures, tmp_path):
    from multimodal_tpu.train.run import main as jax_main

    common = ["--dataset-type", "synthetic", "--model", NAME, "--batch-size", "8",
              "--epochs", "0", "--precision", "fp32",
              "--pretrained", str(fixtures / "weights.pt"),
              "--logs", str(tmp_path)] + _evals(fixtures)
    assert jax_main(common + ["--name", "jax"]) == 0
    assert main(common + ["--name", "port", "--device", "cpu"]) == 0
    want, got = _last(tmp_path, "jax"), _last(tmp_path, "port")
    keys = {k for k in want if k != "eval"}
    assert {"cifar10-zeroshot-top1", "imagenet_val-zeroshot-top5",
            "coco_retrieval-image_to_text_R@10", "linear_probe_accuracy",
            "linear_probe_mean_per_class"} <= keys
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["linear_probe_accuracy"] == 1.0


def test_per_epoch_evals_on_the_ema_and_the_eval_only_resume(fixtures, tmp_path):
    argv = ["--dataset-type", "synthetic", "--model", NAME, "--batch-size", "8",
            "--train-num-samples", "16", "--lr", "1e-3", "--warmup", "1", "--device", "cpu",
            "--precision", "fp32", "--model-ema", "--logs", str(tmp_path), "--name", "run",
            "--zeroshot-frequency", "1", "--retrieval-frequency", "1"] + _evals(fixtures)
    assert main(argv + ["--epochs", "1"]) == 0
    with open(tmp_path / "run" / "results.jsonl") as f:
        records = [json.loads(line) for line in f]
    zs = next(r for r in records if "cifar10-zeroshot-top1" in r)
    rt = next(r for r in records if "coco_retrieval-text_to_image_R@1" in r)
    assert zs["epoch"] == rt["epoch"] == 0
    assert not any("linear_probe_accuracy" in r for r in records)  # eval-only mode's
    assert main(argv + ["--epochs", "0", "--resume", "latest"]) == 0
    again = records_after = _last(tmp_path, "run")
    assert again["eval"] is True
    for k in zs:
        if k != "epoch":
            assert records_after[k] == zs[k], k
    for k in rt:
        if k != "epoch":
            assert records_after[k] == rt[k], k
    assert 0.0 <= again["linear_probe_accuracy"] <= 1.0


@pytest.mark.parametrize("extra,item", [
    (["--captioning-eval", "/d/c"], "item 11"), (["--profile-steps", "2"], "item 11"),
    (["--multihost"], "item 9"), (["--fsdp"], "item 9"), (["--tensor-parallel", "2"], "item 9"),
    (["--contrastive-impl", "ring"], "item 9"),
])
def test_flags_still_refused_name_their_item(tmp_path, extra, item):
    """Every flag is ported: item 11's parse, and an eval-only run takes item 9's on one CPU
    process (a world of one rank), or refuses an axis of two ranks that one rank cannot
    give."""
    if item == "item 11":
        parse_args(["--device", "cpu"] + extra)
        return
    argv = ["--dataset-type", "synthetic", "--model", NAME, "--device", "cpu", "--epochs",
            "0", "--logs", str(tmp_path)] + extra
    if extra[0] == "--tensor-parallel":
        with pytest.raises(ValueError, match="does not divide"):
            main(argv)
        return
    assert main(argv) == 0