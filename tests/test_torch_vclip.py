"""The port's variational CLIP against the JAX package's: ``clip_loss_sampled``, the three
branches of ``vclip_loss``, ``VariationalCLIP`` and one whole vclip train step; then the
step's and the ``Embedder``'s mode. The card's tests are in ``test_torch_vclip_cuda.py``.

Inputs come from seeded numpy generators, weights cross through ``load_jax_params`` (the
flax tree as it is) and JAX's Monte-Carlo draws are replayed through the port's draw
helpers (``torch_jax_replay``). Tolerances: the losses 1e-5 (rtol; atol 1e-5 on
gradients); the model's outputs 2e-4 (``tests/test_torch_clip.py``'s); the train step
``tests/test_torch_train_step.py``'s (loss, grad norm and every metric rtol 1e-5; every
gradient leaf atol 1e-4 x max(1, max|leaf|), rtol 1e-3; parameters after two steps atol
2e-5, rtol 1e-5).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.distributions import PowerSpherical as JPowerSpherical
from multimodal_tpu.distributions import VonMisesFisher as JVonMisesFisher
from multimodal_tpu.distributions.normal import NormalDiag as JNormalDiag
from multimodal_tpu.losses.clip_loss import clip_loss_sampled as jax_clip_loss_sampled
from multimodal_tpu.losses.vclip_loss import vclip_loss as jax_vclip_loss
from multimodal_tpu_torch.distributions import NormalDiag, PowerSpherical, VonMisesFisher
from multimodal_tpu_torch.inference import Embedder, model_mode
from multimodal_tpu_torch.losses import clip_loss_sampled, vclip_loss
from multimodal_tpu_torch.models import (
    VariationalCLIP,
    VariationalConfig,
    add_model_config,
    create_model,
    load_jax_params,
)
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step
from torch_jax_replay import Replay

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _unit_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# --- clip_loss_sampled ---------------------------------------------------------------------

@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("logit_scale", [2.6592, 3.912, 4.5])
def test_clip_loss_sampled_value_and_grads_match_jax(label_smoothing, logit_scale):
    """3.912 is the clamp itself (``torch.minimum`` and ``jnp.minimum`` split a tie's
    gradient alike), 4.5 above it (no scale gradient)."""
    rng = np.random.default_rng(0)
    si, st = (rng.standard_normal((3, 5, 8)).astype(np.float32) for _ in range(2))
    kw = dict(label_smoothing=label_smoothing)
    fn = lambda a, b, s: jax_clip_loss_sampled(a, b, s, **kw)  # noqa: E731
    want, vjp = jax.vjp(fn, jnp.asarray(si), jnp.asarray(st), jnp.float32(logit_scale))
    cot = rng.standard_normal(3).astype(np.float32)
    leaves = [_t(si, True), _t(st, True), _t(logit_scale, True)]
    got = clip_loss_sampled(*leaves, **kw)
    assert got.shape == (3,)
    got.backward(_t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **LOSS_TOL)
    for leaf, w in zip(leaves, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD_TOL)


# --- vclip_loss ----------------------------------------------------------------------------

B, E, S = 6, 16, 4
BRANCHES = {
    "sampled": dict(kl_weight=10.0, num_samples=S),
    "expected": dict(kl_weight=10.0, expected_value=True),
    "mean_only": dict(kl_weight=0.0),
    "use_mean_only": dict(kl_weight=10.0, use_mean_only=True),
    "eval": dict(kl_weight=10.0, is_train=False),
}


def _loss_inputs(family, seed=0):
    rng = np.random.default_rng(seed)
    if family == "normal":
        means = [rng.standard_normal((B, E)).astype(np.float32) for _ in range(2)]
        concs = [np.exp(0.5 * rng.standard_normal((B, E))).astype(np.float32) for _ in range(2)]
    else:
        means = [_unit_rows(rng, (B, E)) for _ in range(2)]
        concs = [rng.uniform(10.0, 120.0, B).astype(np.float32) for _ in range(2)]
    return means + concs + [np.float32(2.6592)]


def _dists(family, mi, mt, ci, ct, lib):
    if lib == "jax":
        cls = {"power_spherical": JPowerSpherical, "vmf": JVonMisesFisher,
               "normal": JNormalDiag}[family]
        sqrt = jnp.sqrt
    else:
        cls = {"power_spherical": PowerSpherical, "vmf": VonMisesFisher,
               "normal": NormalDiag}[family]
        sqrt = torch.sqrt
    if family == "normal":
        return cls(mi, sqrt(ci)), cls(mt, sqrt(ct))
    return cls(mi, ci), cls(mt, ct)


def _queue_loss_draws(replay, family, key, ci, ct, num_samples, embed_dim=None):
    """vclip_loss's draws: k_img, k_txt = split(key), the image samples first."""
    for k, conc in zip(jax.random.split(key), (ci, ct)):
        b, e = conc.shape[0], (E if embed_dim is None else embed_dim)
        if family == "power_spherical":
            alpha = np.broadcast_to((e - 1) / 2 + np.minimum(conc, 1e8), (num_samples, b))
            replay.power_spherical(k, alpha.astype(np.float32), (e - 1) / 2, e)
        elif family == "vmf":
            replay.von_mises_fisher(k, (num_samples, b), e)
        else:
            replay.normal(k, (num_samples, b, e))


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("family", ["power_spherical", "vmf", "normal"])
def test_vclip_loss_branches_match_jax(monkeypatch, family, branch):
    """Every term and the total, and the total's gradients in both means, both
    concentrations and the logit scale."""
    kw = dict(BRANCHES[branch], var_reg_weight=0.1, label_smoothing=0.1)
    arrays = _loss_inputs(family)
    key = jax.random.PRNGKey(3)

    def jfn(mi, mt, ci, ct, ls):
        res = jax_vclip_loss(*_dists(family, mi, mt, ci, ct, "jax"), ci, ct, ls, key=key, **kw)
        return res["total_loss"], res

    _, vjp, want = jax.vjp(jfn, *map(jnp.asarray, arrays), has_aux=True)
    want_grads = vjp(jnp.float32(1.0))
    replay = Replay().install(monkeypatch)
    if branch == "sampled":
        _queue_loss_draws(replay, family, key, arrays[2], arrays[3], S)
    leaves = [_t(a, True) for a in arrays]
    got = vclip_loss(*_dists(family, *leaves[:4], "torch"), leaves[2], leaves[3], leaves[4],
                     generator=torch.Generator(), **kw)
    replay.assert_consumed()
    assert set(got) == set(want) == {"total_loss", "clip_loss", "image_kl_loss", "text_kl_loss",
                                     "var_reg"}
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want[name]),
                                   err_msg=name, **LOSS_TOL)
    got["total_loss"].backward()
    for name, leaf, w in zip(("image_mean", "text_mean", "image_conc", "text_conc",
                              "logit_scale"), leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_sampled_vclip_loss_needs_a_generator():
    mi, mt, ci, ct, ls = (_t(a) for a in _loss_inputs("power_spherical"))
    with pytest.raises(ValueError, match="torch.Generator"):
        vclip_loss(PowerSpherical(mi, ci), PowerSpherical(mt, ct), ci, ct, ls, kl_weight=1.0)


# --- VariationalCLIP -----------------------------------------------------------------------

def _random_params(jm, seed=0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator: LN scales near 1, vectors
    ~0.02, tables and kernels at fan-in scale, the log concentration offsets at log 190."""
    from multimodal_tpu.models import init_params

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(math.log(190.0) if "concentration" in name else 2.6592)
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _models(name, model_type):
    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models.config import VariationalConfig as JaxVariationalConfig

    jm = jax_create_model(name, variational=True,
                          vcfg=JaxVariationalConfig(model_type=model_type))
    params = _random_params(jm)
    pm = load_jax_params(create_model(name, variational=True, device="cpu", seed=1,
                                      vcfg=VariationalConfig(model_type=model_type)), params)
    return jm, params, pm


def _inputs(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.standard_normal((n, s, s, 3), dtype=np.float32)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (n, cfg.text.context_length))
    tokens[np.arange(n), rng.integers(1, cfg.text.context_length, n)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


@pytest.mark.parametrize("name,model_type", [("tiny-test", "Spherical"),
                                             ("tiny-test", "Gaussian"), ("tiny", "Spherical")])
def test_variational_clip_matches_jax(name, model_type):
    """tiny-test runs plain attention, tiny (width 128) the block-attention operator at S=18
    and S=33 causal: the extra token's sequences."""
    jm, params, pm = _models(name, model_type)
    images, tokens = _inputs(jm.cfg)
    want = jax.jit(jm.apply)(params, jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        got = pm(torch.from_numpy(images), torch.from_numpy(tokens).long())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k,
                                   **MODEL_TOL)
    conc = got["image_concentration"]
    assert conc.shape == ((3,) if model_type == "Spherical" else (3, jm.cfg.embed_dim))


def test_variational_parameter_tree_matches_jax_and_fill_refuses_any_mismatch():
    jm, params, pm = _models("tiny-test", "Spherical")
    names = dict(pm.named_parameters())
    assert set(jax_params_to_port(params)) == set(names)
    for leaf in ("visual_stem.extra_embedding", "text_stem.extra_embedding",
                 "mean_image_projection", "var_text_projection",
                 "log_concentration_scale_image", "log_concentration_scale_text"):
        assert leaf in names, leaf
    assert names["visual_stem.positional_embedding"].shape == (2 * 2 + 2, 64)
    assert names["text_stem.positional_embedding"].shape == (16 + 1, 64)
    missing = {k: v for k, v in params["params"].items() if k != "mean_image_projection"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(pm, {"params": missing})
    extra = dict(params["params"], stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(pm, {"params": extra})
    bad = dict(params["params"], var_image_projection=np.zeros((64, 2), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(pm, {"params": bad})
    _, gauss_params, gauss = _models("tiny-test", "Gaussian")
    assert "log_concentration_scale_image" not in dict(gauss.named_parameters())
    assert dict(gauss.named_parameters())["var_image_projection"].shape == (64, 64)


@pytest.mark.parametrize("pre", [0.0, 20.0 - 5.0, 1e-3 - 5.0, -30.0, 9.0])
def test_concentration_clamps_and_their_tie_gradients_match_jax(pre):
    """log_scale + raw at the clamps (20 and 1e-3 exactly: a tie) and beyond them; the value
    and the gradient in both inputs are jnp.clip's."""
    jm, params, pm = _models("tiny-test", "Spherical")
    raw = np.array([[pre], [pre + 0.25]], np.float32)
    log_scale = np.float32(5.0)

    def jfn(r, s):
        return jm.apply(params, r, s, method=jm._concentration)

    want, vjp = jax.vjp(jfn, jnp.asarray(raw), jnp.float32(log_scale))
    rt, st = _t(raw, True), _t(log_scale, True)
    got = pm._concentration(rt, st)
    got.backward(torch.ones(2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    jr, js = vjp(jnp.ones(2, jnp.float32))
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(js), rtol=1e-6)


def test_create_model_variational_options_and_refusals():
    model = create_model("tiny-test", variational=True, device="cpu")
    assert isinstance(model, VariationalCLIP) and not model.training
    assert model.vcfg == VariationalConfig()
    # the reference's VariationalCLIP builds no MoE, so a MoE config builds without it
    moe = create_model("tiny-test-moe", variational=True, device="cpu")
    assert not any("moe" in n for n, _ in moe.named_parameters())
    with pytest.raises(ValueError, match="block_mlp"):
        create_model("tiny-test", variational=True, block_mlp=True, device="cpu")
    with pytest.raises(ValueError, match="model_type"):
        create_model("tiny-test", variational=True, device="cpu",
                     vcfg=VariationalConfig(model_type="Laplace"))
    cfg = create_model("tiny-test", device="cpu").cfg
    # LoRA builds on both trunks; the SigLIP bias is never built, as in the reference
    lora = VariationalCLIP(dataclasses.replace(cfg, lora_rank=4))
    assert sum(n.endswith("lora_a") for n, _ in lora.named_parameters()) == 24
    biased = VariationalCLIP(dataclasses.replace(cfg, logit_bias_init=-10.0))
    assert not any("logit_bias" in n for n, _ in biased.named_parameters())
    # int8_forward reaches both trunks' dense MLPs, as in the reference
    int8 = VariationalCLIP(dataclasses.replace(cfg, int8_forward=True))
    assert all(blk.mlp.int8_fwd for t in (int8.visual_transformer, int8.text_transformer)
               for blk in t.resblocks)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("tiny-test", variational=True)


# --- the train step ------------------------------------------------------------------------

STEP_B = 8
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)
STEP_KWARGS = {
    "point": dict(kl_weight=0.0),
    "sampled": dict(kl_weight=10.0, riemannian=True, num_samples=4),
}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (STEP_B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (STEP_B, cfg.text.context_length))
    tokens[np.arange(STEP_B), rng.integers(1, cfg.text.context_length, STEP_B)] = (
        cfg.text.vocab_size - 1)
    return images, tokens.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_steps(form):
    """Per-step metrics, grads and concentrations (for the replayed draws) and the final
    params of two JAX vclip steps on tiny-test."""
    from multimodal_tpu.data.preprocess import normalize_images
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    jm, params, _ = _models("tiny-test", "Spherical")
    params = jax.tree_util.tree_map(jnp.asarray, params)
    images, tokens = _batch(jm.cfg)
    batch = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = jax_train_step(jm, tx, loss_type="vclip", loss_kwargs=dict(STEP_KWARGS[form]),
                          donate=False)
    loss_fn = make_loss_fn(jm, "vclip", dict(STEP_KWARGS[form]))
    grad_fn = jax.jit(jax.grad(lambda p: loss_fn(p, batch, rng)[0]))
    apply = jax.jit(jm.apply)
    state = JaxState.create(params, tx)
    metrics, grads, concs = [], [], []
    for _ in range(2):
        out = apply(state.params, normalize_images(images), jnp.asarray(tokens))
        concs.append((np.asarray(out["image_concentration"]),
                      np.asarray(out["text_concentration"])))
        grads.append(grad_fn(state.params))
        state, m = step(state, batch, rng)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads, concs, state.params, rng


@functools.lru_cache(maxsize=None)
def _port_steps(form):
    jm, params, _ = _models("tiny-test", "Spherical")
    metrics_j, _, concs, _, rng = _jax_steps(form)
    model = load_jax_params(create_model("tiny-test", variational=True, device="cpu"), params)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = make_train_step(model, opt, loss_type="vclip", loss_kwargs=dict(STEP_KWARGS[form]))
    state = TrainState.create(model, opt)
    images, tokens = _batch(model.cfg)
    batch = {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}
    loss_key = jax.random.split(rng)[0]  # the JAX loss_fn's own split
    metrics, grads = [], []
    for ci, ct in concs:
        with pytest.MonkeyPatch.context() as mp:
            replay = Replay().install(mp)
            if form == "sampled":
                _queue_loss_draws(replay, "power_spherical", loss_key, ci, ct,
                                  STEP_KWARGS[form]["num_samples"], model.cfg.embed_dim)
            m = step(state, batch, torch.Generator())
            replay.assert_consumed()
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()})
    assert state.step == 2 and not model.training
    return model, metrics, grads


@pytest.mark.parametrize("form", list(STEP_KWARGS))
def test_vclip_step_metrics_match_jax(form):
    want, _, _, _, _ = _jax_steps(form)
    _, got, _ = _port_steps(form)
    for w, g in zip(want, got):
        assert set(g) == set(w) == {"loss", "total_loss", "clip_loss", "image_kl_loss",
                                    "text_kl_loss", "var_reg", "mean_image_concentration",
                                    "mean_text_concentration", "grad_norm"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert got[0]["grad_norm"] > OPT["grad_clip_norm"]  # the clip is active
    if form == "sampled":
        assert got[0]["image_kl_loss"] > 0 and got[0]["clip_loss"] > 0


@pytest.mark.parametrize("form", list(STEP_KWARGS))
def test_vclip_step_every_grad_leaf_matches_jax(form):
    _, want_grads, _, _, _ = _jax_steps(form)
    _, _, got_grads = _port_steps(form)
    for want_tree, got in zip(want_grads, got_grads):
        want = jax_params_to_port(want_tree)
        assert set(want) == set(got)
        for n, w in want.items():
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(got[n], w, atol=1e-4 * scale, rtol=1e-3, err_msg=n)


@pytest.mark.parametrize("form", list(STEP_KWARGS))
def test_vclip_step_params_after_two_steps_match_jax(form):
    _, _, _, want_params, _ = _jax_steps(form)
    model, _, _ = _port_steps(form)
    want = jax_params_to_port(want_params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-5, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("distribution_type,model_type", [("vmf", "Spherical"),
                                                          ("normal", "Gaussian")])
def test_other_families_train_from_a_generator(distribution_type, model_type):
    """vMF and the Gaussian mode: finite, and the same generator seed repeats the step."""
    results = []
    for _ in range(2):
        model = create_model("tiny-test", variational=True, device="cpu",
                             vcfg=VariationalConfig(model_type=model_type))
        opt = make_optimizer(model.named_parameters(), 1e-3)
        step = make_train_step(model, opt, loss_type="vclip", loss_kwargs=dict(
            distribution_type=distribution_type, kl_weight=10.0, num_samples=3))
        images, tokens = _batch(model.cfg)
        m = step(TrainState.create(model, opt),
                 {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()},
                 torch.Generator().manual_seed(5))
        results.append({k: float(v) for k, v in m.items()})
    assert all(np.isfinite(v) for v in results[0].values())
    assert results[0] == results[1]
    if distribution_type == "vmf":
        assert results[0]["mean_image_concentration"] >= VariationalConfig().min_concentration


def test_unknown_distribution_type_raises():
    model = create_model("tiny-test", variational=True, device="cpu")
    with pytest.raises(ValueError, match="distribution_type"):
        make_train_step(model, make_optimizer(model.named_parameters(), 1e-3),
                        loss_type="vclip", loss_kwargs={"distribution_type": "cauchy"})


# --- the mode a step and an encode leave the model in --------------------------------------

def _dropout_model():
    add_model_config("tiny-test-pdrop", {
        "embed_dim": 64,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8, "heads": 2,
                       "patch_dropout": 0.5},
        "text_cfg": {"context_length": 16, "vocab_size": 1000, "width": 64, "heads": 2,
                     "layers": 2}})
    return create_model("tiny-test-pdrop", device="cpu")


@pytest.mark.parametrize("start_in_training", [False, True])
def test_embed_after_a_step_is_the_eval_embed_and_modes_are_restored(start_in_training):
    """On a patch-dropout model a step leaves the model in the caller's mode, and an embed
    after it runs in eval mode (no generator needed, no patch dropped) and leaves the mode
    as it found it."""
    model = _dropout_model()
    model.train(start_in_training)
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_train_step(model, opt)
    images, tokens = _batch(model.cfg)
    step(TrainState.create(model, opt),
         {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()},
         torch.Generator().manual_seed(0))
    assert model.training is start_in_training
    emb = Embedder(model, batch_size=4)
    got_i = emb.embed_images(images[:6])
    got_t = emb.encode_tokens(tokens[:2])
    assert model.training is start_in_training
    with model_mode(model, False), torch.no_grad():
        from multimodal_tpu_torch.data.preprocess import normalize_images

        want_i = model.encode_image(normalize_images(torch.from_numpy(images[:6])),
                                    normalize=True).numpy()
        assert not model.training
    assert model.training is start_in_training
    np.testing.assert_allclose(got_i, want_i, atol=1e-6)
    assert got_t.shape == (2, 64) and np.isfinite(got_t).all()


def test_a_failing_step_still_restores_the_mode():
    model = _dropout_model()
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_train_step(model, opt)
    images, tokens = _batch(model.cfg)
    with pytest.raises(ValueError, match="torch.Generator"):
        step(TrainState.create(model, opt),
             {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()})
    assert not model.training
