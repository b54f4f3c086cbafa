"""The port's LoRA adapters (``Dense(lora_rank=...)``, ``models/lora.py``, the ``"lora"``
freeze mode of ``train/freeze.py``) against the JAX package's (``_DenseParams``,
``models/lora.py``, ``train/run.py:_finetune_mask`` + ``freeze_optimizer``).

Weights come from seeded numpy values in the JAX tree (``lora_b`` nonzero), crossing through
``load_jax_params``; inputs are a seeded numpy batch. Tolerances: the model's outputs 2e-4
(``tests/test_torch_clip.py``'s); gradients and the train step
``tests/test_torch_train_step.py``'s (loss and grad norm rtol 1e-5, every gradient leaf atol
1e-4 x max(1, max|leaf|) and rtol 1e-3, parameters after the step atol 2e-5, rtol 1e-5); a
merge, which changes only where the float32 sums round, 1e-5.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import lora as jax_lora
from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
from multimodal_tpu_torch.models import (
    ALPHA_KEY,
    VariationalCLIP,
    create_model,
    extract_lora,
    jax_adapters_to_port,
    load_jax_params,
    load_lora,
    load_openai_state_dict,
    lora_mask,
    merge_lora,
)
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.train import finetune_mask, freeze_optimizer
from torch_jax_models import OPT, assert_grads_close, batch, jax_steps, port_steps, random_params

torch.set_num_threads(1)

MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
RANK, ALPHA = 4, 8.0


@functools.lru_cache(maxsize=None)
def _models(name, variational=False):
    kw = dict(lora_rank=RANK, lora_alpha=ALPHA)
    jm = jax_create_model(name, variational=variational, **kw)
    params = random_params(jm)
    pm = load_jax_params(create_model(name, variational=variational, device="cpu", seed=1, **kw),
                         params)
    return jm, params, pm


def _inputs(cfg, n=3):
    images, tokens = batch(cfg, n)
    return (images.astype(np.float32) / 255.0 - 0.5), tokens


def _port_out(pm, images, tokens):
    with torch.no_grad():
        return pm(torch.from_numpy(images), torch.from_numpy(tokens).long())


def test_zero_init_adapters_are_a_no_op():
    """The adapters draw after every base weight, so a model with them has the base weights
    of the same seed without them, and lora_b = 0 leaves every output as it was, bit for
    bit."""
    base = create_model("tiny", device="cpu", seed=5)
    adapted = create_model("tiny", device="cpu", seed=5, lora_rank=RANK, lora_alpha=ALPHA)
    base_params = dict(base.named_parameters())
    for name, p in adapted.named_parameters():
        if name.endswith("lora_b"):
            assert not p.any()
        elif not name.endswith("lora_a"):
            torch.testing.assert_close(p, base_params[name], atol=0, rtol=0, msg=name)
    images, tokens = _inputs(base.cfg)
    want, got = _port_out(base, images, tokens), _port_out(adapted, images, tokens)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    assert any(n.endswith("lora_a") for n in lora_mask(adapted) if lora_mask(adapted)[n])


@pytest.mark.parametrize("name", ["tiny-test", "tiny", "tiny-test-shared"])
def test_forward_with_nonzero_adapters_matches_jax(name):
    """tiny-test: plain attention; tiny: the block-attention operator, which takes the merged
    weight; tiny-test-shared: the shared trunk, adapters on its one transformer."""
    jm, params, pm = _models(name)
    images, tokens = _inputs(jm.cfg)
    want = jm.apply(params, images, tokens)
    got = _port_out(pm, images, tokens)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **MODEL_TOL)
    n_adapters = sum(lora_mask(pm).values())
    per_block = 12  # q, k, v, out, c_fc, c_proj, each a pair
    layers = jm.cfg.vision.layers + (0 if jm.cfg.share_trunk else jm.cfg.text.layers)
    assert n_adapters == per_block * layers


def test_variational_clip_with_adapters_matches_jax():
    jm, params, pm = _models("tiny-test", variational=True)
    assert isinstance(pm, VariationalCLIP)
    images, tokens = _inputs(jm.cfg)
    want = jm.apply(params, images, tokens)
    got = _port_out(pm, images, tokens)
    for k in ("image_mean", "text_mean", "image_concentration", "text_concentration"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **MODEL_TOL)


@pytest.mark.parametrize("name", ["tiny-test", "tiny"])
def test_adapter_gradients_match_jax(name):
    """The clip loss's gradient of every leaf, the adapters' included: through the block
    operator (tiny) the kernels' weight gradient reaches lora_a and lora_b by autograd."""
    from multimodal_tpu.train.engine import make_loss_fn as jax_loss_fn
    from multimodal_tpu_torch.train import make_loss_fn

    jm, params, pm = _models(name)
    images, tokens = batch(jm.cfg)
    data = {"image": images, "text": tokens}
    loss_fn = jax_loss_fn(jm, "clip")
    want = jax.grad(lambda p: loss_fn(p, data, jax.random.PRNGKey(0))[0])(params)
    pm.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(pm, "clip")(
        pm, {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()})
    loss.backward()
    got = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert_grads_close(got, jax_params_to_port(jax.device_get(want)))
    assert any(np.abs(g).max() > 0 for n, g in got.items() if n.endswith("lora_a"))


@functools.lru_cache(maxsize=None)
def _lora_steps(name):
    """One masked "lora" step on each side: JAX's freeze_optimizer over the fused AdamW, the
    port's freeze_optimizer."""
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train.run import _finetune_mask, freeze_optimizer as jax_freeze
    from multimodal_tpu_torch.train import make_schedule

    jm, params, _ = _models(name)
    tx = jax_optimizer(jax_schedule("cosine", 1e-2, 2, 50), **OPT)
    want = jax_steps(jm, params, jax_freeze(tx, _finetune_mask(params, "lora")[1]), steps=1)
    model = load_jax_params(create_model(name, device="cpu", lora_rank=RANK, lora_alpha=ALPHA),
                            params)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = freeze_optimizer(model, finetune_mask(model.named_parameters(), "lora"),
                           make_schedule("cosine", 1e-2, 2, 50), **OPT)
    got = port_steps(model, opt, steps=1)
    return want, got, model, opt, start


@pytest.mark.parametrize("name", ["tiny-test", "tiny"])
def test_masked_lora_step_matches_jax_freeze_optimizer(name):
    """Loss and grad norm (over the trainable gradients only, as under optax.masked), every
    parameter after the step; the frozen ones bit for bit unchanged, moments only for the
    trainable ones, and no gradient formed for a frozen one."""
    (want, _, want_params), (got, grads), model, opt, start = _lora_steps(name)
    for k in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
    want_p = jax_params_to_port(jax.device_get(want_params))
    trainable = finetune_mask(model.named_parameters(), "lora")
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n], atol=2e-5, rtol=1e-5,
                                   err_msg=n)
        if not trainable[n]:
            assert torch.equal(p, start[n]) and not p.requires_grad, n
    assert set(opt.mu) == set(opt.nu) == {n for n, t in trainable.items() if t}
    assert set(grads[0]) == set(opt.mu)
    assert any(not torch.equal(p, start[n]) for n, p in model.named_parameters()
               if n.endswith("lora_b"))


def test_extract_load_merge_round_trip():
    """extract -> load into a fresh adapted model -> the same adapters; merge into a model
    without adapters -> the adapted model's outputs."""
    jm, params, pm = _models("tiny")
    adapters = extract_lora(pm, cfg=pm.cfg)
    assert adapters[ALPHA_KEY] == np.float32(ALPHA)
    assert set(adapters) - {ALPHA_KEY} == {n for n, m in lora_mask(pm).items() if m}
    fresh = load_lora(create_model("tiny", device="cpu", lora_rank=RANK, lora_alpha=ALPHA),
                      adapters)
    for n, v in extract_lora(fresh).items():
        np.testing.assert_array_equal(v, adapters[n], err_msg=n)
    merged = merge_lora(pm, adapters=adapters, into=create_model("tiny", device="cpu"))
    assert not any(lora_mask(merged).values())
    images, tokens = _inputs(jm.cfg)
    want, got = _port_out(pm, images, tokens), _port_out(merged, images, tokens)
    for k in ("image_features", "text_features"):
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5, msg=k)
    state = merge_lora(pm.state_dict(), alpha=ALPHA)  # a state dict in, a state dict out
    torch.testing.assert_close(state["visual_transformer.resblocks.0.attn.query.kernel"],
                               dict(merged.named_parameters())[
                                   "visual_transformer.resblocks.0.attn.query.kernel"])


def test_jax_extracted_adapters_merge_like_jax():
    """A JAX ``extract_lora`` dict, renamed by ``jax_adapters_to_port`` and merged into the
    base weights in the port, equals JAX's ``merge_lora`` of the same tree."""
    jm, params, _ = _models("tiny")
    jax_adapters = jax_lora.extract_lora(params["params"], cfg=jm.cfg)
    want = jax_params_to_port(jax_lora.merge_lora(params["params"], cfg=jm.cfg))
    base = load_jax_params(create_model("tiny", device="cpu", lora_rank=RANK, lora_alpha=ALPHA),
                           params)
    with torch.no_grad():  # the dict's adapters alone must reach the merge
        for n, p in base.named_parameters():
            if n.endswith(("lora_a", "lora_b")):
                p.zero_()
    adapters = jax_adapters_to_port(jax_adapters)
    assert adapters[ALPHA_KEY] == np.float32(ALPHA)
    got = merge_lora(base, adapters=adapters)
    assert set(got) == set(want)
    for n, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[n], atol=1e-6, rtol=1e-6, err_msg=n)


def test_alpha_sources_and_bad_adapters_raise():
    _, _, pm = _models("tiny-test")
    adapters = extract_lora(pm, alpha=ALPHA)
    with pytest.raises(ValueError, match="needs the fine-tune's alpha"):
        merge_lora(pm)
    with pytest.raises(ValueError, match="conflicting lora alpha"):
        merge_lora(pm, alpha=ALPHA, cfg=dataclasses.replace(pm.cfg, lora_alpha=2.0))
    with pytest.raises(ValueError, match="conflicting lora alpha"):
        merge_lora(pm, alpha=2.0, adapters=adapters)
    assert set(merge_lora(pm, alpha=ALPHA, cfg=pm.cfg, adapters=adapters)) == {
        n for n, m in lora_mask(pm).items() if not m}
    name = "visual_transformer.resblocks.0.attn.query.lora_a"
    with pytest.raises(KeyError, match="not present"):
        load_lora(pm, {name.replace("resblocks.0", "resblocks.9"): adapters[name]})
    with pytest.raises(ValueError, match="shape"):
        load_lora(pm, {name: adapters[name][:, :2]})
    with pytest.raises(KeyError, match="not present"):  # another rank's adapters
        load_lora(create_model("tiny-test", device="cpu"), adapters)


def test_pretrained_base_under_fresh_adapters(tmp_path):
    """An OpenAI-format base state dict into an adapted model fills every base weight and
    leaves the adapters as they were, as JAX's ``load_pretrained`` does (its tree read from
    the same file, the adapters grafted from its template)."""
    from multimodal_tpu.models import init_params
    from multimodal_tpu.models.checkpoint_interop import load_pretrained

    jm_base = jax_create_model("tiny-test")
    base_params = random_params(jm_base)
    sd = export_torch_state_dict(base_params, jm_base.cfg)
    path = str(tmp_path / "base.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jm = jax_create_model("tiny-test", lora_rank=RANK, lora_alpha=ALPHA)
    template = jax.device_get(init_params(jm))
    want = jax_params_to_port(load_pretrained(path, template, jm.cfg))

    model = create_model("tiny-test", device="cpu", lora_rank=RANK, lora_alpha=ALPHA)
    adapters_before = extract_lora(model)
    load_openai_state_dict(model, sd)
    for n, p in model.named_parameters():
        if n in adapters_before:
            np.testing.assert_array_equal(p.detach().numpy(), adapters_before[n], err_msg=n)
        else:
            np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    assert set(dict(model.named_parameters())) == set(want)


@pytest.mark.parametrize("mode", ["lora", "projections", "heads"])
@pytest.mark.parametrize("variational", [False, True])
def test_finetune_masks_match_jax(mode, variational):
    """Each freeze mode marks the same leaves trainable as the reference's mask."""
    from multimodal_tpu.train.run import _finetune_mask

    jm, params, pm = _models("tiny-test", variational=variational)
    want = jax_params_to_port(jax.tree_util.tree_map(
        lambda m: np.float32(m), _finetune_mask(params, mode)[1]))
    got = finetune_mask(pm.named_parameters(), mode)
    assert got == {n: bool(v) for n, v in want.items()}
    assert any(got.values()) and not all(got.values())
