"""The two training CLIs side by side: ``multimodal_tpu.train.run.main`` and
``multimodal_tpu_torch.train.run.main`` on synthetic ``tiny-test`` data (the same numpy
stream), in float32, from the same weights (``--pretrained``: one OpenAI-format ``.pt``
exported from seeded numpy parameters), for ``--loss clip``, ``cloob`` and ``align
--nl_semantic_supervision``: every logged loss agrees to rtol 1e-5 (float32 on the CPU; the
two sides differ in summation order only, the JAX one over its 8 virtual CPU devices)."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ARGS = [
    "--dataset-type", "synthetic", "--model", "tiny-test", "--batch-size", "16",
    "--train-num-samples", "48", "--warmup", "2", "--lr", "1e-3", "--log-every-n-steps", "1",
    "--seed", "3", "--precision", "fp32", "--epochs", "2", "--wd", "0.1",
    "--grad-clip-norm", "1.0",
]


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
    from torch_jax_models import random_params

    jm = jax_create_model("tiny-test")
    path = tmp_path_factory.mktemp("weights") / "tiny-test.pt"
    sd = export_torch_state_dict(random_params(jm), jm.cfg)
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}, path)
    return str(path)


def _losses(logs, name):
    return {r["step"]: r["loss"] for r in map(json.loads, open(logs / name / "results.jsonl"))
            if "loss" in r}


@pytest.mark.parametrize("loss", [["--loss", "clip"], ["--loss", "cloob"],
                                  ["--loss", "align", "--nl_semantic_supervision"]])
def test_logged_losses_match_the_jax_cli(tmp_path, pretrained, loss):
    from multimodal_tpu.train.run import main as jax_main
    from multimodal_tpu_torch.train.run import main

    common = ARGS + loss + ["--pretrained", pretrained, "--logs", str(tmp_path)]
    assert jax_main(common + ["--name", "jax"]) == 0
    assert main(common + ["--name", "port", "--device", "cpu"]) == 0
    want, got = _losses(tmp_path, "jax"), _losses(tmp_path, "port")
    assert sorted(got) == sorted(want) == list(range(1, 7))
    for step in want:
        np.testing.assert_allclose(got[step], want[step], rtol=1e-5, err_msg=f"step {step}")
    assert len(set(want.values())) > 1
