"""Shared pieces of the tests that hold the port's model family against the JAX package's:
seeded numpy parameters in a JAX model's tree, a seeded numpy batch, two JAX train steps
with the gradient of each, and a recorder of both sides' int8 codes (imported by
``test_torch_lora.py``, ``test_torch_moe.py``, ``test_torch_siglip.py``,
``test_torch_factory_options.py``, ``test_torch_int8_train.py`` and
``test_torch_quant_serving.py``)."""

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_tpu.models import init_params

OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)  # tests/test_torch_train_step.py's


def random_params(jm, seed: int = 0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator (no Flax init run): LN
    scales near 1, vectors ~0.02, tables and kernels at fan-in scale, the logit scale 2.6592
    and a SigLIP bias -10. LoRA adapters as part-way through a fine-tune: ``lora_a`` at its
    init scale r^-1/2, ``lora_b`` (zero at init) ~0.02, so the merged delta is about a third
    of the base kernel."""
    rng = np.random.default_rng(seed)
    # the "params" collection alone: a MoE model's init also sows its "moe_losses"
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))["params"]

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(-10.0 if name == "logit_bias" else 2.6592)
        if name.endswith("lora_a"):
            return n * np.float32(s.shape[1] ** -0.5)
        if name.endswith("lora_b"):
            return 0.02 * n
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes)}


def batch(cfg, n: int = 8, seed: int = 0):
    """uint8 images and int32 tokens with one EOT (the largest id) per row."""
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (n, cfg.text.context_length))
    tokens[np.arange(n), rng.integers(1, cfg.text.context_length, n)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


def jax_steps(jm, params, tx, loss_type: str = "clip", steps: int = 2, n: int = 8,
              loss_kwargs: dict | None = None):
    """``steps`` JAX train steps from ``params`` with optimizer ``tx``: per-step metrics (host
    floats), per-step gradients (a jitted ``jax.grad`` of the same loss at the parameters
    each step starts from) and the final params."""
    from multimodal_tpu.train import TrainState, make_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    images, tokens = batch(jm.cfg, n)
    data = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    step = make_train_step(jm, tx, loss_type=loss_type, loss_kwargs=loss_kwargs, donate=False)
    loss_fn = make_loss_fn(jm, loss_type, loss_kwargs)
    grad_fn = jax.jit(jax.grad(lambda p: loss_fn(p, data, rng)[0]))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    metrics, grads = [], []
    for _ in range(steps):
        grads.append(grad_fn(state.params))
        state, m = step(state, data, rng)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads, state.params


def port_steps(model, opt, loss_type: str = "clip", steps: int = 2, n: int = 8,
               loss_kwargs: dict | None = None):
    """The port's side of ``jax_steps``: per-step metrics and gradients (by parameter name,
    numpy) of ``steps`` steps of ``make_train_step(model, opt)`` on the same batch."""
    import torch

    from multimodal_tpu_torch.train import TrainState, make_train_step

    images, tokens = batch(model.cfg, n)
    data = {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}
    step = make_train_step(model, opt, loss_type=loss_type, loss_kwargs=loss_kwargs)
    state = TrainState.create(model, opt)
    metrics, grads = [], []
    for _ in range(steps):
        m = step(state, data, torch.Generator())
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()
                      if p.grad is not None})
    return metrics, grads


def assert_grads_close(got: dict, want: dict):
    """Every gradient leaf at ``tests/test_torch_train_step.py``'s limits: atol 1e-4 x
    max(1, max|leaf|), rtol 1e-3."""
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, atol=1e-4 * scale, rtol=1e-3, err_msg=k)


def assert_params_close(model, want: dict):
    """Parameters after the steps at ``tests/test_torch_train_step.py``'s limits: atol 2e-5,
    rtol 1e-5."""
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], atol=2e-5, rtol=1e-5, err_msg=k)


class CodeRecorder:
    """The int8 codes of every quantize on both sides, to count the codes that flip between
    them: the JAX package's ``quantize_rows`` and ``quantize_weight`` (patched in, each
    reporting its codes by ``jax.debug.callback`` from inside the jitted programs) and the
    port's ``quantize_rows`` (every int8 quantize of the port goes through it). Install before
    the programs are traced."""

    def __init__(self, monkeypatch):
        from multimodal_tpu.ops import quant as jq
        from multimodal_tpu_torch.ops import quant as tq

        self.jax, self.port = [], []
        rows, weight, port_rows = jq.quantize_rows, jq.quantize_weight, tq.quantize_rows

        def report(codes):
            jax.debug.callback(lambda a: self.jax.append(np.asarray(a)), codes)

        def jax_rows(x):
            codes, scale = rows(x)
            report(codes)
            return codes, scale

        def jax_weight(w, dtype=jnp.float32):
            codes, scale = weight(w, dtype)
            report(codes)
            return codes, scale

        def rows_of_port(x, form="reciprocal"):
            codes, scale = port_rows(x, form)
            self.port.append(codes.detach().cpu().numpy())
            return codes, scale

        monkeypatch.setattr(jq, "quantize_rows", jax_rows)
        monkeypatch.setattr(jq, "quantize_weight", jax_weight)
        monkeypatch.setattr(tq, "quantize_rows", rows_of_port)

    def flips(self) -> tuple[int, int]:
        """(codes that differ, codes compared): each of the port's quantize calls against the
        JAX call of its shape (a weight's codes transposed: the port keeps [out, in]) that
        differs from it least."""
        jax.effects_barrier()
        flat = lambda a: a.reshape(-1, a.shape[-1])  # noqa: E731
        ref = [flat(a) for a in self.jax]
        flipped = total = 0
        for codes in map(flat, self.port):
            flipped += min(int((cand != codes).sum()) for a in ref for cand in (a, a.T)
                           if cand.shape == codes.shape)
            total += codes.size
        return flipped, total
