"""Importing the PyTorch port never imports jax or the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import multimodal_tpu_torch.serving, multimodal_tpu_torch.models.clip\n"
        "import multimodal_tpu_torch.inference, multimodal_tpu_torch.ops._build\n"
        "import multimodal_tpu_torch.train, multimodal_tpu_torch.losses\n"
        "import multimodal_tpu_torch.train.engine, multimodal_tpu_torch.train.optimizer\n"
        "import multimodal_tpu_torch.train.schedules, multimodal_tpu_torch.losses.clip_loss\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'multimodal_tpu'))\n"
        "assert not leaked, leaked\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
