"""The port's training CLI (``multimodal_tpu_torch.train.run``) end to end on the CPU
(``--device cpu``), the cases of the JAX package's ``tests/test_cli.py``: a synthetic
``tiny-test`` run that writes ``params.txt``, ``results.jsonl`` and ``checkpoints/<step>/``
and resumes; a mid-epoch resume that ends at the uninterrupted run's parameters (rtol 1e-6,
atol 1e-7: both runs take the same steps on the same data with the same generators); the
EMA and its toggle across a resume; the boundary save; SIGTERM and preemption; the vclip KL
annealing; the skip-scheduler; the freeze modes; the flag surface (``vars(parse_args([]))``
equal to the reference's apart from ``--device``); the flags of later ROADMAP items
refused by name; and no GPU without ``--device cpu``. The parity of the two CLIs' losses is
``tests/test_torch_cli_parity.py``.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.train import run as run_mod
from multimodal_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_tpu_torch.train.params import parse_args
from multimodal_tpu_torch.train.run import main

torch.set_num_threads(1)

BASE = [
    "--dataset-type", "synthetic", "--model", "tiny-test", "--batch-size", "16",
    "--train-num-samples", "48", "--warmup", "2", "--lr", "1e-3",
    "--log-every-n-steps", "2", "--save-frequency", "1", "--seed", "3",
    "--device", "cpu", "--precision", "fp32",
]


def _records(path):
    return [json.loads(line) for line in open(path)]


def _final(tmp_path, name):
    mgr = CheckpointManager(str(tmp_path / name / "checkpoints"))
    saved, meta = mgr.restore()
    return mgr, saved, meta


def test_cli_train_checkpoint_resume(tmp_path):
    logs = str(tmp_path)
    assert main(BASE + ["--epochs", "1", "--logs", logs, "--name", "exp"]) == 0
    exp = tmp_path / "exp"
    params_txt = (exp / "params.txt").read_text()
    assert "device: cpu" in params_txt and "model: tiny-test" in params_txt
    assert (exp / "out.log").exists()
    records = _records(exp / "results.jsonl")
    assert records and np.isfinite(records[-1]["loss"]) and records[-1]["samples_per_s"] > 0
    assert {"data_time", "batch_time", "grad_norm", "logit_scale"} <= set(records[-1])
    assert sorted(os.listdir(exp / "checkpoints")) == ["3"]
    assert sorted(os.listdir(exp / "checkpoints" / "3")) == ["metadata.json", "state.pt"]
    assert main(BASE + ["--epochs", "2", "--logs", logs, "--name", "exp",
                        "--resume", "latest"]) == 0
    records2 = _records(exp / "results.jsonl")
    assert records2[-1]["step"] > records[-1]["step"] and records2[-1]["epoch"] == 1
    mgr, saved, meta = _final(tmp_path, "exp")
    assert mgr.latest_step() == 6 and saved["step"] == 6 and meta["epoch"] == 1


def test_cli_midepoch_resume_matches_uninterrupted(tmp_path):
    """A mid-epoch save at step 2, every later checkpoint deleted, then a resume: the run
    re-enters epoch 0 at batch 2, replays the same per-step generators and ends where the
    uninterrupted run ends."""
    import shutil

    assert main(BASE + ["--epochs", "2", "--logs", str(tmp_path), "--name", "full"]) == 0
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "pre",
                        "--save-frequency-steps", "2"]) == 0
    ckpt_dir = tmp_path / "pre" / "checkpoints"
    steps = sorted(int(p.name) for p in ckpt_dir.iterdir() if p.name.isdigit())
    assert 2 in steps, steps
    for s in steps:
        if s > 2:
            shutil.rmtree(ckpt_dir / str(s))
    assert main(BASE + ["--epochs", "2", "--logs", str(tmp_path), "--name", "pre",
                        "--resume", "latest"]) == 0
    final = {}
    for name in ("full", "pre"):
        mgr, saved, _ = _final(tmp_path, name)
        assert mgr.latest_step() == 6, (name, mgr.all_steps())
        final[name] = saved
    for k, v in final["full"]["model"].items():
        np.testing.assert_allclose(final["pre"]["model"][k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert int(final["pre"]["optimizer"]["count"]) == 6


def test_cli_patch_dropout_resume_replays_the_draws(tmp_path):
    """With patch dropout every step draws from its generator: a mid-epoch resume still
    ends at the uninterrupted run's parameters, bit for bit on the CPU."""
    import shutil

    pd = ["--force-patch-dropout", "0.5"]
    assert main(BASE + pd + ["--epochs", "1", "--logs", str(tmp_path), "--name", "full"]) == 0
    assert main(BASE + pd + ["--epochs", "1", "--logs", str(tmp_path), "--name", "pre",
                             "--save-frequency-steps", "1"]) == 0
    for s in (2, 3):
        shutil.rmtree(tmp_path / "pre" / "checkpoints" / str(s))
    assert main(BASE + pd + ["--epochs", "1", "--logs", str(tmp_path), "--name", "pre",
                             "--resume", "latest"]) == 0
    a, b = _final(tmp_path, "full")[1], _final(tmp_path, "pre")[1]
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k


def test_step_generator_is_a_fixed_mix_of_seed_epoch_and_step():
    draws = lambda s, e, i: torch.rand(4, generator=run_mod.step_generator(s, e, i, "cpu"))  # noqa: E731
    assert torch.equal(draws(3, 1, 2), draws(3, 1, 2))
    assert not torch.equal(draws(3, 1, 2), draws(3, 2, 1))
    assert not torch.equal(draws(3, 1, 2), draws(4, 1, 2))


def test_cli_model_ema_trains_checkpoints_and_evaluates_the_ema(tmp_path, monkeypatch):
    """--model-ema: the checkpoint carries an EMA that tracks but differs from the
    parameters, the validation pass sees the EMA weights, and the training weights come
    back from it bit for bit."""
    seen = {}
    real = run_mod.evaluate

    def spy(model, data_val, epoch, args=None, weights=None):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        seen["weights"] = weights
        out = real(model, data_val, epoch, args, weights)
        seen["restored"] = all(torch.equal(p, before[n]) for n, p in model.named_parameters())
        return out

    monkeypatch.setattr(run_mod, "evaluate", spy)
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "ema",
                        "--model-ema", "--model-ema-decay", "0.9", "--val-data", "synthetic",
                        "--val-num-samples", "32"]) == 0
    _, saved, _ = _final(tmp_path, "ema")
    assert saved["ema"] is not None and seen["weights"] is not None and seen["restored"]
    assert any(not torch.equal(saved["ema"][k], v) for k, v in saved["model"].items())
    assert all(torch.isfinite(v).all() for v in saved["ema"].values())
    evals = [r for r in _records(tmp_path / "ema" / "results.jsonl") if "val_loss" in r]
    assert evals and np.isfinite(evals[-1]["val_loss"])


def test_swapped_parameters_give_the_weights_back_bit_for_bit():
    from multimodal_tpu_torch.models import create_model

    model = create_model("tiny-test", device="cpu")
    own = {n: p.data_ptr() for n, p in model.named_parameters()}
    copies = {n: p.detach().clone() for n, p in model.named_parameters()}
    other = {n: torch.randn_like(p) for n, p in model.named_parameters()}
    with run_mod.swapped_parameters(model, other):
        assert all(torch.equal(p, other[n]) for n, p in model.named_parameters())
    for n, p in model.named_parameters():
        assert p.data_ptr() == own[n] and torch.equal(p, copies[n])


def test_cli_resume_tolerates_ema_toggle(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "tog"]) == 0
    assert main(BASE + ["--epochs", "2", "--logs", str(tmp_path), "--name", "tog",
                        "--resume", "latest", "--model-ema"]) == 0
    assert _final(tmp_path, "tog")[1]["ema"] is not None
    assert main(BASE + ["--epochs", "3", "--logs", str(tmp_path), "--name", "tog",
                        "--resume", "latest"]) == 0
    _, saved, _ = _final(tmp_path, "tog")
    assert saved["ema"] is None and saved["step"] == 9


def test_cli_boundary_step_save_gets_clean_epoch_metadata(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "bnd",
                        "--save-frequency-steps", "3"]) == 0
    mgr, _, meta = _final(tmp_path, "bnd")
    assert mgr.latest_step() == 3 and not meta.get("mid_epoch"), meta


def test_sigterm_sets_preemption_flag():
    run_mod._PREEMPTED.clear()
    run_mod._install_preemption_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert run_mod._PREEMPTED.wait(timeout=5)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        run_mod._PREEMPTED.clear()


def test_cli_preemption_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(run_mod, "_install_preemption_handler", run_mod._PREEMPTED.set)
    try:
        rc = main(BASE + ["--epochs", "2", "--logs", str(tmp_path), "--name", "evict"])
    finally:
        monkeypatch.undo()
        run_mod._PREEMPTED.clear()
    assert rc == 0
    mgr, _, meta = _final(tmp_path, "evict")
    assert mgr.latest_step() == 1 and meta["mid_epoch"] and meta["step_in_epoch"] == 1
    assert main(BASE + ["--epochs", "2", "--logs", str(tmp_path), "--name", "evict",
                        "--resume", "latest"]) == 0
    assert _final(tmp_path, "evict")[0].latest_step() == 6


def test_cli_synthetic_val_split_gets_model_vocab(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "val",
                        "--val-data", "synthetic", "--val-num-samples", "32"]) == 0
    evals = [r for r in _records(tmp_path / "val" / "results.jsonl") if "val_loss" in r]
    assert evals and np.isfinite(evals[-1]["val_loss"])
    assert evals[-1]["image_to_text_mean_rank"] <= 32


def test_cli_vclip_with_kl_annealing(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "v",
                        "--variational", "--kl-warmup-epochs", "2", "--mc-samples", "4"]) == 0
    records = _records(tmp_path / "v" / "results.jsonl")
    assert np.isfinite(records[-1]["loss"]) and "mean_image_concentration" in records[-1]
    assert run_mod.kl_schedule(0, 100.0, 2) == 0.0
    assert run_mod.kl_schedule(1, 100.0, 2) == 50.0 and run_mod.kl_schedule(3, 100.0, 2) == 100.0


def test_cli_reference_recipe_flags_accepted(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "a",
                        "--clip-inModality-loss", "--alpha", "1", "--beta", "0.5",
                        "--local-loss", "--gather-with-grad", "--horovod",
                        "--ddp-static-graph"]) == 0
    assert "loss: align" in (tmp_path / "a" / "params.txt").read_text()


@pytest.mark.parametrize("extra", [
    ["--loss", "cloob"], ["--contrastive-impl", "chunked", "--contrastive-chunk-size", "5"],
    ["--accum-freq", "4", "--feature-cached-accum"], ["--accum-freq", "2"],
    ["--opt", "lamb"], ["--opt", "lars"], ["--loss", "siglip"],
    ["--loss", "align", "--nl_semantic_supervision"], ["--async-checkpointing"],
    ["--precision", "amp_bf16"], ["--precision", "int8"],
])
def test_cli_options_train(tmp_path, extra):
    assert main(BASE + extra + ["--epochs", "1", "--logs", str(tmp_path), "--name", "o"]) == 0
    records = _records(tmp_path / "o" / "results.jsonl")
    assert np.isfinite(records[-1]["loss"]) and np.isfinite(records[-1]["grad_norm"])
    assert _final(tmp_path, "o")[0].latest_step() == 3


def test_cli_eval_only_epoch_zero_evaluates_and_exits(tmp_path):
    assert main(BASE + ["--epochs", "0", "--logs", str(tmp_path), "--name", "ev",
                        "--val-data", "synthetic", "--val-num-samples", "16"]) == 0
    (record,) = _records(tmp_path / "ev" / "results.jsonl")
    assert record["eval"] and np.isfinite(record["val_loss"])
    assert not (tmp_path / "ev" / "checkpoints").exists() or not os.listdir(
        tmp_path / "ev" / "checkpoints")


def test_remote_sync_copies_the_experiment_until_stopped(tmp_path):
    import time

    local, remote = tmp_path / "exp", tmp_path / "remote"
    local.mkdir()
    (local / "params.txt").write_text("x")
    remote.mkdir()
    stop = run_mod._start_remote_sync(str(local), str(remote), 0.05)
    try:
        deadline = time.monotonic() + 10
        while not (remote / "exp" / "params.txt").exists() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        stop.set()
    assert (remote / "exp" / "params.txt").read_text() == "x"


def test_skip_scheduler_constant_lr_and_copy_codebase(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "s",
                        "--skip-scheduler", "--lr", "1e-4", "--copy-codebase"]) == 0
    code = tmp_path / "s" / "code" / "multimodal_tpu_torch"
    assert (code / "train" / "run.py").exists() and not (code / "ops" / "_build_cache").exists()


def test_cli_train_projections_only_moves_only_the_projections(tmp_path):
    from multimodal_tpu_torch.models import create_model

    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "fp",
                        "--train-projections-only"]) == 0
    start = create_model("tiny-test", device="cpu", seed=3).state_dict()
    _, saved, _ = _final(tmp_path, "fp")
    moved = {k for k, v in saved["model"].items() if not torch.equal(v, start[k])}
    assert moved == {"visual_projection", "text_projection", "logit_scale"}, moved
    assert set(saved["optimizer"]["mu"]) == moved


def test_lock_mask_matches_the_reference_freeze_mask():
    import jax

    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models import init_params
    from multimodal_tpu.train.run import _freeze_mask
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
    from multimodal_tpu_torch.train.freeze import lock_mask

    jm = jax_create_model("tiny-test")
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))
    model = create_model("tiny-test", device="cpu")
    cases = [dict(lock_image=True, lock_text=False, unlocked_image_groups=1),
             dict(lock_image=False, lock_text=True, unlocked_text_layers=1,
                  freeze_layer_norm=True),
             dict(lock_image=True, lock_text=True)]
    for kw in cases:
        _, jmask = _freeze_mask(shapes, **kw)
        want = jax_params_to_port(jax.tree_util.tree_map(
            lambda m, s: np.full(s.shape, m, np.float32), jmask["params"], shapes["params"]))
        got = lock_mask(model.named_parameters(), **kw)
        assert set(got) == set(want)
        for name, trainable in got.items():
            assert np.all(want[name] == float(trainable)), (kw, name)


def test_cli_lock_image_trains_only_the_unlocked_tail(tmp_path):
    from multimodal_tpu_torch.models import create_model

    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "lk",
                        "--lock-image", "--lock-image-unlocked-groups", "1"]) == 0
    start = create_model("tiny-test", device="cpu", seed=3).state_dict()
    _, saved, _ = _final(tmp_path, "lk")
    for k, v in saved["model"].items():
        if k.startswith("visual_stem") or "visual_transformer.resblocks.0." in k:
            assert torch.equal(v, start[k]), k
    assert not torch.equal(saved["model"]["text_projection"], start["text_projection"])


def test_variational_freeze_backbone_trains_the_heads_only(tmp_path):
    assert main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--name", "fb",
                        "--variational", "--freeze-backbone", "--mc-samples", "2"]) == 0
    _, saved, _ = _final(tmp_path, "fb")
    trainable = set(saved["optimizer"]["mu"])
    assert any("extra_embedding" in n for n in trainable)
    assert not any("resblocks" in n for n in trainable)


def test_parse_args_defaults_equal_the_references_but_device():
    from multimodal_tpu.train.params import parse_args as jax_parse_args

    got, want = vars(parse_args([])), vars(jax_parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    for argv in (["--model", "RN50"], ["--loss", "vclip", "--variational"],
                 ["--contrastive-impl", "ring"]):
        got, want = vars(parse_args(argv)), vars(jax_parse_args(argv))
        got.pop("device")
        assert got == want, argv


def test_full_reference_flag_surface_parses():
    ns = parse_args([
        "--clip-loss", "--skip-scheduler", "--copy-codebase", "--force-quick-gelu",
        "--force-custom-text", "--use-bn-sync", "--pretrained-image", "--use-bnb-linear", "int8",
        "--lock-image", "--lock-image-unlocked-groups", "2", "--lock-image-freeze-bn-stats",
        "--lock-text", "--lock-text-unlocked-layers", "1", "--lock-text-freeze-layer-norm",
        "--remote-sync-protocol", "fsspec", "--imagenet-sketch", "/d/sk", "--flowers-102",
        "/d/fl", "--food-101", "/d/fo", "--stanford", "/d/ca", "--ms-coco", "/d/coco",
        "--ms-coco-annot", "/d/ann.json", "--flickr", "/d/flk", "--flickr-annot", "/d/tok",
        "--imagenet-train", "/d/in-train", "--device", "cpu",
    ])
    assert ns.loss == "clip" and ns.skip_scheduler and ns.device == "cpu"
    assert ns.imagenet_s == "/d/sk" and ns.stanford_cars == "/d/ca"
    assert ns.linear_probe_train == "/d/in-train"
    with pytest.raises(SystemExit):
        parse_args(["--loss", "siglip", "--accum-freq", "2", "--feature-cached-accum"])
    with pytest.raises(SystemExit):
        parse_args(["--device", "tpu"])


@pytest.mark.parametrize("extra,item", [
    (["--multihost"], "item 9"), (["--tensor-parallel", "2"], "item 9"),
    (["--expert-parallel", "2"], "item 9"), (["--dcn-slices", "2"], "item 9"),
    (["--fsdp"], "item 9"), (["--use-shard-map", "on"], "item 9"),
    (["--opt-state-offload"], "item 9"), (["--contrastive-impl", "ring"], "item 9"),
    # the zero-shot, retrieval and linear-probe flags are ported, and since item 11 was done
    # the captioning eval and the profiler pass the check too
    (["--imagenet-val", "/d/in", "--captioning-eval", "/d/c"], "item 11"),
    (["--coco-retrieval", "/d/coco", "--profile-steps", "1"], "item 11"),
    (["--captioning-eval", "/d/c"], "item 11"),
    (["--linear-probe-train", "/d/lp", "--captioning-eval", "/d/c"], "item 11"),
    (["--profile-steps", "2"], "item 11"),
])
def test_later_items_flags_raise_naming_their_item(tmp_path, extra, item):
    """Every item is ported. Item 11's flags parse; item 9's run here on one CPU process (a
    world of one rank) or raise what a world of one cannot give: two ranks for an axis of
    two, a CUDA device for the moments' offload."""
    if item == "item 11":
        parse_args(BASE + extra)
        return
    argv = BASE + extra + ["--epochs", "1", "--logs", str(tmp_path), "--name", "n"]
    refused = {"--tensor-parallel": (ValueError, "does not divide"),
               "--expert-parallel": (ValueError, "does not divide"),
               "--dcn-slices": (ValueError, "do not divide"),
               "--opt-state-offload": (RuntimeError, "needs a CUDA device")}
    if extra[0] in refused:
        exc, match = refused[extra[0]]
        with pytest.raises(exc, match=match):
            main(argv)
        return
    assert main(argv) == 0
    assert os.listdir(os.path.join(tmp_path, "n", "checkpoints"))


def test_pretrained_orbax_directory_raises(tmp_path):
    """A directory is read as an Orbax save (ported); one that holds no array raises."""
    empty = tmp_path / "not-orbax"
    empty.mkdir()
    with pytest.raises(ValueError, match="no Orbax array"):
        main(BASE + ["--epochs", "1", "--logs", str(tmp_path), "--pretrained", str(empty)])


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--epochs", "1", "--logs", str(tmp_path), "--name", "g"])
    assert not (tmp_path / "g").exists()
