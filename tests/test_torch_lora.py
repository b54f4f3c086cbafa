"""The port's LoRA adapters (``Dense(lora_rank=...)``, ``models/lora.py``, the ``"lora"``
freeze mode of ``train/freeze.py``) against the JAX package's (``_DenseParams``,
``models/lora.py``, ``train/run.py:_finetune_mask`` + ``freeze_optimizer``).

Weights come from seeded numpy values in the JAX tree (``lora_b`` nonzero), crossing through
``load_jax_params``; inputs are a seeded numpy batch. Tolerances: the model's outputs 2e-4
(``tests/test_torch_clip.py``'s); gradients and the train step
``tests/test_torch_train_step.py``'s (loss and grad norm rtol 1e-5, every gradient leaf atol
1e-4 x max(1, max|leaf|) and rtol 1e-3); the masked step's update held to AdamW's formula in
float64 from the port's own gradients and moments, at a bound derived from float32 rounding
(``_assert_adamw_step``); a merge, which changes only where the float32 sums round, 1e-5.
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


def _relative(*factors) -> float:
    """The bound on |prod (1 + d_i) - 1| when each |d_i| <= factors[i]."""
    return float(np.prod([1.0 + f for f in factors]) - 1.0)


def _assert_adamw_step(opt, grads: dict, start: dict, params: dict):
    """The fused AdamW's first step (count 0 -> 1) held to AdamW's update in float64.

    Inputs, all the port's own: its float32 gradients g, its global norm N, its schedule's
    float32 lr at count 0, the starting parameters p0. Exact values in float64:
    s = min(1, clip / N); mu = (1 - b1) s g; nu = (1 - b2) s^2 g^2; c_i = 1 - b_i;
    p1 = p0 - lr (mu / c1 / (sqrt(nu / c2) + eps) + wd p0) (the decay term where the mask has it).

    Bounds, u = 2^-24, each float32 operation (a scalar's rounding to float32 too) one
    relative u. The moments against the formula from g: mu takes s's division, g s, the
    rounding of 1 - b1 and the product, so |mu - mu64| <= ((1 + u)^4 - 1) |mu64| (a division
    only when s < 1); nu takes g s twice, the square, 1 - b2 and the product: (1 + u)^7 - 1.
    The parameters against the formula from the port's own moments: c_i = 1 - fl(b_i^t) carries
    the float32 power's error u (b's rounding) + 2u (one ulp of pow) times b_i^t, amplified by
    b_i^t / c_i, plus the subtraction's u; mu / c1 and nu / c2 one more u each; the square
    root halves nu / c2's error and adds u; + eps (its rounding, the add) u each; the quotient
    u; the decay term's wd rounding and product; the add to it u; times -lr u; the add to p0 u.
    Errors are composed as products of (1 + d), first differences as the worst case, so the
    bound holds to every order."""
    u = 2.0 ** -24
    b1, b2, eps, wd = opt.beta1, opt.beta2, opt.eps, opt.weight_decay
    clip = opt.grad_clip_norm
    norm = float(opt.grad_norm)
    assert int(opt.count) == 1
    lr = float(opt.schedule(torch.zeros((), dtype=torch.int32)))
    scale = 1.0 if clip is None else min(1.0, clip / max(norm, 1e-12))
    e_s = 0.0 if scale == 1.0 else u
    th_mu = _relative(e_s, u, u, u)
    th_nu = _relative(e_s, e_s, u, u, u, u, u)
    c1, c2 = 1.0 - b1, 1.0 - b2
    e_c1 = u + _relative(u, 2 * u) * b1 / c1
    e_c2 = u + _relative(u, 2 * u) * b2 / c2
    th_a = (1 + u) / (1 - e_c1) - 1
    th_q = (1 + u) / (1 - e_c2) - 1
    th_sq = _relative(1 - np.sqrt(1 - th_q), u)
    th_den = _relative(max(th_sq, u), u)
    th_r = (1 + th_a) * (1 + u) / (1 - th_den) - 1
    th_w = _relative(u, u)
    for n, g32 in grads.items():
        g = g32.astype(np.float64)
        mu64, nu64 = c1 * scale * g, c2 * (scale * g) ** 2
        mu, nu = (opt.mu[n].double().numpy(), opt.nu[n].double().numpy())
        assert (np.abs(mu - mu64) <= th_mu * np.abs(mu64)).all(), n
        assert (np.abs(nu - nu64) <= th_nu * nu64).all(), n
        p0 = start[n].double().numpy()
        r = (mu / c1) / (np.sqrt(nu / c2) + eps)
        w = wd * p0 if opt.decay[n] else np.zeros_like(p0)
        upd = r + w
        e_upd = (th_r * np.abs(r) + th_w * np.abs(w)
                 + u * (np.abs(r) + np.abs(w)) * (1 + max(th_r, th_w)))
        e_step = lr * (e_upd + u * (np.abs(upd) + e_upd))
        p1 = p0 - lr * upd
        bound = e_step + u * (np.abs(p1) + e_step)
        err = np.abs(params[n].detach().double().numpy() - p1)
        assert (err <= bound).all(), (n, float(np.max(err - bound)))


def _assert_optimizer_is_jax(name, opt, trainable: dict):
    """The port's masked optimizer against JAX's freeze_optimizer over the same config: the
    schedule's lr at count 0 bit for bit, beta1, beta2, eps, weight decay and clip norm equal,
    and weight decay on the same trainable leaves (JAX's ``wd_mask`` inside ``optax.masked``)."""
    import inspect

    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import wd_mask as jax_wd_mask
    from multimodal_tpu.train.run import _finetune_mask

    lr = np.float32(opt.schedule(torch.zeros((), dtype=torch.int32)))
    assert lr == np.float32(jax_schedule("cosine", 1e-2, 2, 50)(0))
    defaults = inspect.signature(jax_optimizer).parameters
    assert (opt.beta1, opt.beta2, opt.eps) == tuple(
        defaults[k].default for k in ("beta1", "beta2", "eps"))
    assert (opt.weight_decay, opt.grad_clip_norm) == (OPT["weight_decay"], OPT["grad_clip_norm"])
    params = _models(name)[1]
    keep = _finetune_mask(params, "lora")[1]
    jax_decayed = jax_params_to_port(jax.tree_util.tree_map(
        lambda d, k: bool(d and k), jax_wd_mask(params), keep))
    assert {n for n, v in jax_decayed.items() if v} == {
        n for n, t in trainable.items() if t and opt.decay[n]}
    assert {n for n, v in jax_params_to_port(keep).items() if v} == {
        n for n, t in trainable.items() if t}


@pytest.mark.parametrize("name", ["tiny-test", "tiny"])
def test_masked_lora_step_matches_jax_freeze_optimizer(name):
    """Loss and grad norm (over the trainable gradients only, as under optax.masked), the
    trainable gradients against JAX's, every parameter after the step against AdamW's update
    in float64; the frozen ones bit for bit unchanged, moments only for the
    trainable ones, and no gradient formed for a frozen one."""
    (want, want_grads, _), (got, grads), model, opt, start = _lora_steps(name)
    for k in ("loss", "grad_norm", "logit_scale"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5, err_msg=k)
    trainable = finetune_mask(model.named_parameters(), "lora")
    # The step in two parts. The gradients against JAX's, at the gradient test's limits:
    # AdamW's first step normalises each gradient element (mu_hat / sqrt(nu_hat) is about
    # g / (|g| + eps)), so a sum-order difference in a gradient near eps comes out as an
    # lr-sized difference in the parameter, and the parameters are not compared across the
    # two sides. Then the update itself, in float64 from the port's own gradients and moments.
    want_g = jax_params_to_port(jax.device_get(want_grads[0]))
    assert_grads_close(grads[0], {n: want_g[n] for n in grads[0]})
    # what the float64 update takes from the port's optimizer is JAX's: the lr at count 0,
    # the AdamW constants, and the decayed leaves among the trainable ones
    _assert_optimizer_is_jax(name, opt, trainable)
    _assert_adamw_step(opt, grads[0], start, dict(model.named_parameters()))
    for n, p in model.named_parameters():
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
