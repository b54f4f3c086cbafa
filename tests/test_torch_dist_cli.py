"""The training CLI over two gloo processes on the CPU.

One group under ``python -m torch.distributed.run --nproc-per-node 2`` runs the CLI's ``main``
on synthetic ``tiny-test`` for two steps each with ``--fsdp``, ``--tensor-parallel 2``,
``--contrastive-impl ring`` and ``--expert-parallel 2`` (``tiny-test-moe``): each run makes
one experiment directory (the ranks agreed on its name) with its records and the step-2
checkpoint; the ranks' rows of a batch are the two halves of the global batch; the preemption
flag's agreement does not block (a rank's first poll returns while the other rank is still
away) and stops both ranks after the same step. A run on the committed JPEG shards, where one
rank reads two shards and the other one, ends the epoch on both ranks after the same step:
the last batch the shorter stream holds. A second group, the CLI module launched once
per rank (``python -m multimodal_tpu_torch.train.run``, RANK / WORLD_SIZE set), takes a SIGTERM
on rank 1: both ranks save the same step and exit 0.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_dist_workers import free_port, rank_env, run_ranks

BASE = ["--dataset-type", "synthetic", "--model", "tiny-test", "--device", "cpu",
        "--batch-size", "8", "--epochs", "1", "--precision", "fp32",
        "--log-every-n-steps", "1"]
RUNS = {
    "fsdp": ["--fsdp"],
    "tensor_parallel": ["--tensor-parallel", "2"],
    "ring": ["--contrastive-impl", "ring"],
    "expert_parallel": ["--expert-parallel", "2", "--model", "tiny-test-moe"],
}
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards")
# three shards of 128 samples: one rank reads two, the other one, 3 batches of 40 rows
SHARDS = [os.path.join(DATA, f) for f in ("train-000000.tar", "train-000001.tar",
                                          "val-000000.tar")]
SHARD_RUN = ["--train-data", "::".join(SHARDS), "--model", "tiny", "--batch-size", "80",
             "--workers", "1", "--epochs", "1", "--precision", "fp32", "--device", "cpu",
             "--log-every-n-steps", "1", "--seed", "3", "--name", "shards"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    runs = {name: BASE + ["--train-num-samples", "16", "--logs", str(tmp / name)] + flags
            for name, flags in RUNS.items()}
    runs["shards"] = SHARD_RUN + ["--logs", str(tmp / "shards")]
    ranks = run_ranks("cli", 2, {"runs": runs}, tmp, torchrun=True)
    with open(tmp / "cli-2.rank0.log") as f:
        console = f.read()
    return tmp, ranks, console


@pytest.mark.parametrize("run", list(RUNS))
def test_two_process_cli_run(cli, run):
    tmp, _, console = cli
    (name,) = os.listdir(tmp / run)  # one directory: both ranks took rank 0's name
    for rank in (0, 1):
        assert f"experiment {name}: rank {rank} of 2" in console
    exp = tmp / run / name
    records = [json.loads(line) for line in open(exp / "results.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert (exp / "checkpoints" / "2" / "state.pt").exists()
    assert (exp / "params.txt").exists() and (exp / "out.log").exists()


def test_ranks_with_unequal_shards_end_the_epoch_after_the_same_step(cli):
    from multimodal_tpu_torch.data.shards import ShardSampler

    tmp, _, console = cli
    held = sorted(len(list(ShardSampler(SHARDS, seed=3, num_hosts=2, host_id=r)))
                  for r in (0, 1))
    assert held == [1, 2]
    records = [json.loads(line) for line in open(tmp / "shards" / "shards" / "results.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in records)
    run = console[console.index("experiment shards: rank"):]
    assert run.count("epoch 0 done: 3 steps") == 2, run[-3000:]
    assert (tmp / "shards" / "shards" / "checkpoints" / "3" / "state.pt").exists()


def test_ranks_agree_on_names_and_split_the_batch(cli):
    from multimodal_tpu_torch.data.synthetic import SyntheticBatches

    _, ranks, _ = cli
    assert ranks[0]["runs"] == ranks[1]["runs"]
    whole = next(iter(SyntheticBatches(batch_size=8, num_samples=16, image_size=32,
                                       context_length=16, vocab_size=1000)))["text"]
    np.testing.assert_array_equal(np.concatenate([r["rows"] for r in ranks]), np.asarray(whole))


def test_preemption_flag_agrees_a_step_late_without_blocking(cli):
    _, ranks, _ = cli
    for r in ranks:
        assert r["flag"]["polls"] == (False, True, True)
    assert ranks[0]["flag"]["first_s"] < 0.5  # rank 1 sleeps a second before its first poll


def test_sigterm_on_one_rank_saves_the_same_step_on_both(tmp_path):
    port = free_port()
    argv = BASE + ["--train-num-samples", "8000", "--logs", str(tmp_path), "--name", "pre"]
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "multimodal_tpu_torch.train.run"] + argv,
                              env=rank_env(r, 2, port), stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        deadline = time.monotonic() + 120
        while "epoch 0 step 3 " not in open(tmp_path / "rank1.log").read():
            assert time.monotonic() < deadline and procs[1].poll() is None, \
                open(tmp_path / "rank1.log").read()[-3000:]
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    saved = []
    for r in range(2):
        text = open(tmp_path / f"rank{r}.log").read()
        line = [ln for ln in text.splitlines() if "preemption signal received: saved step" in ln]
        assert len(line) == 1, text[-3000:]
        saved.append(int(line[0].split("saved step ")[1].split()[0]))
    assert saved[0] == saved[1] < 1000
    ckpts = tmp_path / "pre" / "checkpoints"
    assert os.listdir(ckpts) == [str(saved[0])]
    meta = json.load(open(ckpts / str(saved[0]) / "metadata.json"))
    assert meta["mid_epoch"] and meta["step_in_epoch"] == saved[0]
