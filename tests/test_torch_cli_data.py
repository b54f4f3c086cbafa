"""The training CLI on real data, on the CPU: ``multimodal_tpu_torch.train.run.main`` from the
committed fixture's JPEG shards (``tiny``: 64 px, the CLIP vocabulary, so real captions fit).
The first batch its data section builds equals the one the JAX CLI's data section builds from
the same flags, bit for bit (both mains stopped right after their data sections); runs of 3
steps, with and without ``--wire-size 32`` and ``--aug-cfg``, log finite losses and
validation metrics; a run cut after a mid-epoch save and resumed replays the same batches as
the uninterrupted one (the same logged losses and parameters, bit for bit)."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards")
TRAIN = os.path.join(DATA, "train-{000000..000001}.tar")
VAL = "::".join([os.path.join(DATA, "val-000000.tar")] * 2)  # 128 samples: 1 batch of 80
# 256 samples behind a 2000-sample shuffle buffer: 3 batches of 80 in an epoch
BASE = ["--train-data", TRAIN, "--model", "tiny", "--batch-size", "80", "--workers", "1",
        "--warmup", "2", "--lr", "1e-3", "--wd", "0.1", "--log-every-n-steps", "1",
        "--seed", "3", "--precision", "fp32", "--no-save-on-preemption"]
VARIANTS = {
    "plain": [],
    "wire": ["--wire-size", "32"],
    "aug": ["--aug-cfg", "color_jitter=0.4", "re_prob=0.25", "scale=(0.5,1.0)"],
    "wire aug resampled": ["--wire-size", "32", "--aug-cfg", "grayscale_prob=0.5",
                           "--dataset-resampled", "--train-data-upsampling-factors", "2"],
}


class _Stop(Exception):
    pass


def _first_batch(monkeypatch, run_module, argv):
    """The first batch of the train source ``run_module.main(argv)`` builds: its
    ``build_dataset`` recorded, the run stopped at the schedule that follows the data
    section."""
    built = []
    real = run_module.build_dataset

    def record(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(run_module, "build_dataset", record)
    monkeypatch.setattr(run_module, "make_schedule", stop)
    with pytest.raises(_Stop):
        run_module.main(argv)
    return next(iter(built[0]))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_first_batch_matches_the_jax_cli_data_section(tmp_path, monkeypatch, variant):
    import multimodal_tpu.train.run as jax_run
    import multimodal_tpu_torch.train.run as port_run

    argv = BASE + VARIANTS[variant] + ["--epochs", "1", "--logs", str(tmp_path)]
    want = _first_batch(monkeypatch, jax_run, argv + ["--name", "jax"])
    got = _first_batch(monkeypatch, port_run, argv + ["--name", "port", "--device", "cpu"])
    size = 32 if "wire" in variant else 64
    assert got["image"].shape == (80, size, size, 3) and got["image"].dtype == torch.uint8
    np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))
    np.testing.assert_array_equal(got["text"], np.asarray(want["text"]))


def _records(logs, name):
    with open(os.path.join(logs, name, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("variant", ["plain", "wire", "aug"])
def test_cli_trains_from_shards(tmp_path, variant):
    from multimodal_tpu_torch.train.run import main

    argv = BASE + VARIANTS[variant] + [
        "--dataset-type", "webdataset", "--val-data", VAL, "--epochs", "1",
        "--logs", str(tmp_path), "--name", "r", "--device", "cpu"]
    assert main(argv) == 0
    records = _records(tmp_path, "r")
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
    evals = [r for r in records if "val_loss" in r]
    assert len(evals) == 1
    assert np.isfinite([v for v in evals[0].values() if isinstance(v, float)]).all()
    assert all(r["data_time"] >= 0 and r["batch_time"] > 0 for r in records if "loss" in r)


def test_mid_epoch_resume_replays_the_same_batches(tmp_path):
    """Two workers merged round-robin, 40 a batch: 6 steps an epoch. The uninterrupted run
    against one cut after its mid-epoch save at step 2 and resumed (the fast-forward skips
    the two batches it trained): the same losses at steps 3-12 and the same final weights."""
    from multimodal_tpu_torch.train.checkpoints import CheckpointManager
    from multimodal_tpu_torch.train.run import main

    common = [a if a != "80" else "40" for a in BASE]
    common = [a if a != "1" or common[i - 1] != "--workers" else "2"
              for i, a in enumerate(common)]
    common += ["--logs", str(tmp_path), "--device", "cpu"]
    assert main(common + ["--epochs", "2", "--name", "full"]) == 0
    assert main(common + ["--epochs", "1", "--save-frequency-steps", "2", "--name", "cut"]) == 0
    ckpts = tmp_path / "cut" / "checkpoints"
    for d in ckpts.iterdir():
        if d.name.isdigit() and int(d.name) > 2:
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
    assert main(common + ["--epochs", "2", "--resume", "latest", "--name", "cut"]) == 0
    full = {r["step"]: r["loss"] for r in _records(tmp_path, "full") if "loss" in r}
    cut = {r["step"]: r["loss"] for r in _records(tmp_path, "cut") if "loss" in r}
    assert sorted(full) == list(range(1, 13))
    for step in range(3, 13):
        assert cut[step] == full[step], step
    a, _ = CheckpointManager(str(tmp_path / "full" / "checkpoints")).restore()
    b, _ = CheckpointManager(str(tmp_path / "cut" / "checkpoints")).restore()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
