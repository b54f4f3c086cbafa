"""The block options of the PyTorch port against the JAX package: the ``block_mlp`` switch of
``MLP`` / ``create_model``, ``LayerScale`` (``ls_init_value``), ``PatchDropout``
(``vision.patch_dropout``) and per-block ``remat``; and the fused-MLP slice as a whole:
encoders and one ``make_train_step`` step with ``block_mlp=True`` against the JAX package
with the same weights.

Weights are seeded numpy values in the JAX tree and cross through ``load_jax_params`` (the
OpenAI-format export has no key for the LayerScale gammas). On the CPU the switch runs the
operator's plain versions; the JAX side runs its default composition, which in float32
differs from the operator only in summation order.

Tolerances, float32 on the CPU: encoders atol = rtol = 2e-4; loss and grad norm rtol 1e-5;
every gradient leaf atol 1e-4 x max(1, max|leaf|), rtol 1e-3; parameters after the step atol
2e-5, rtol 1e-5 (those of tests/test_torch_train_step.py and tests/test_torch_shared_clip.py).
The module hand-off equals the composition to atol = rtol = 1e-6 (the JAX package's
``test_mlp_module_ln_handoff_matches_composition``). ``remat`` repeats the same operations,
so its loss and gradients equal the run without it exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.models.layers import LayerScale as JaxLayerScale
from multimodal_tpu.models.layers import PatchDropout as JaxPatchDropout
from multimodal_tpu_torch.models import add_model_config, create_model, layers, load_jax_params
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.ops import block_mlp as bm
from multimodal_tpu_torch.ops.block_attention import LN_EPS, ln_rows
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=2e-4)
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)
B = 4


def _cfg(shared=False, image=64, **extra) -> dict:
    ls = extra.pop("ls_init_value", None)
    vision = {"image_size": image, "patch_size": 16, "width": 128, "layers": 2, "heads": 2,
              "patch_dropout": extra.pop("patch_dropout", 0.0)}
    text = {"context_length": 16, "vocab_size": 1000, "width": 128, "heads": 2, "layers": 2}
    if ls is not None:
        vision["ls_init_value"] = text["ls_init_value"] = ls
    return {"embed_dim": 64, "vision_cfg": vision, "text_cfg": text, "share_trunk": shared,
            **extra}


CONFIGS = {
    "opt-ls": _cfg(ls_init_value=0.1),                                   # two towers, S=17/16
    "opt-ls-remat-shared": _cfg(True, 192, ls_init_value=0.1, remat=True),  # S=145: LN fold
    "opt-shared": _cfg(True, 192),
    "opt-remat-shared": _cfg(True, 192, remat=True),
    "opt-patch-dropout": _cfg(patch_dropout=0.5),
}
for _name, _c in CONFIGS.items():  # the same dict in both registries
    add_model_config(_name, _c)
    jax_add_model_config(_name, _c)


def _random_params(jm, seed=0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator: LN scales near 1 and
    LayerScale gammas near 0.5 (away from their inits), vectors ~0.02, tables and kernels at
    fan-in scale."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(2.6592)
        if name.endswith("/gamma"):
            return 0.5 + 0.1 * n
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (B, cfg.text.context_length))
    tokens[np.arange(B), rng.integers(1, cfg.text.context_length, B)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


def _torch_batch(cfg, seed=0):
    images, tokens = _batch(cfg, seed)
    return {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    jm = jax_create_model(name)
    return jm, _random_params(jm)


def _port_model(name, **kw):
    return load_jax_params(create_model(name, device="cpu", **kw), _jax_model(name)[1])


@pytest.fixture
def mlp_calls(monkeypatch):
    """Counts the calls of the fused MLP operator from the layers module."""
    calls = []

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return bm.block_mlp(x, *a, **k)

    monkeypatch.setattr(layers, "block_mlp", spy)
    return calls


# ----------------------------------------------------------------------------- MLP switch
def _mlp(width, act=layers.quick_gelu, **kw):
    mlp = layers.MLP(width, act=act, **kw)
    g = torch.Generator().manual_seed(0)
    mlp.c_fc.init_weights(g)
    mlp.c_proj.init_weights(g)
    with torch.no_grad():
        mlp.c_fc.bias.normal_(0, 0.02, generator=g)
        mlp.c_proj.bias.normal_(0, 0.02, generator=g)
    return mlp


@pytest.mark.parametrize("act", [layers.quick_gelu, layers.gelu])
def test_mlp_module_ln_handoff_matches_composition(act, mlp_calls):
    """``MLP`` with the pre-LN hand-off, the residual fold and ``block_mlp=True`` equals the
    explicit LayerNorm -> MLP -> add composition (the wiring ``ResidualBlock`` relies on)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 10, 128), dtype=np.float32))
    ln = (torch.from_numpy(1 + 0.1 * rng.standard_normal(128, dtype=np.float32)),
          torch.from_numpy(0.1 * rng.standard_normal(128, dtype=np.float32)))
    fused, plain = _mlp(128, act, block_mlp=True), _mlp(128, act)
    out_fold = fused(x, ln_params=ln, residual=True)
    assert mlp_calls == [(2, 10, 128)]
    out_ref = x + plain(ln_rows(x, ln[0], ln[1], LN_EPS))
    torch.testing.assert_close(out_fold, out_ref, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(plain(x, ln_params=ln, residual=True), out_ref, atol=0, rtol=0)
    assert len(mlp_calls) == 1  # the switch is off by default


@pytest.mark.parametrize("width,kw,handoff,taken", [
    (128, dict(block_mlp=True), True, True),
    (128, dict(), True, False),                        # off by default
    (128, dict(block_mlp=True), False, False),         # no pre-LN hand-off
    (64, dict(block_mlp=True), True, False),           # width not a multiple of 128
    (128, dict(block_mlp=True, act=torch.relu), True, False),  # not one of the two acts
], ids=["on", "default-off", "no-handoff", "width-64", "other-act"])
def test_mlp_dispatch_rule(width, kw, handoff, taken, mlp_calls):
    mlp = _mlp(width, **kw)
    x = torch.randn(2, 5, width, generator=torch.Generator().manual_seed(1))
    ln = (torch.ones(width), torch.zeros(width))
    out = mlp(x, ln_params=ln, residual=True) if handoff else mlp(x)
    assert out.shape == x.shape and bool(mlp_calls) is taken
    with pytest.raises(ValueError, match="requires ln_params"):
        mlp(x, residual=True)


# ----------------------------------------------------------------------------- LayerScale
def test_layer_scale_matches_jax_module():
    x = np.random.default_rng(2).standard_normal((2, 5, 128), dtype=np.float32)
    jls = JaxLayerScale(0.1)
    params = jls.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ls = layers.LayerScale(128, 0.1)
    np.testing.assert_array_equal(ls.gamma.detach().numpy(),
                                  np.asarray(params["params"]["gamma"]))
    np.testing.assert_allclose(ls(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jls.apply(params, jnp.asarray(x))), rtol=1e-7)
    out = ls(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16 and ls.gamma.dtype == torch.float32
    with torch.no_grad():
        ls.gamma.fill_(3.0)
    ls.init_weights(torch.Generator())
    assert torch.equal(ls.gamma, torch.full((128,), 0.1))


@pytest.mark.parametrize("name", ["opt-ls", "opt-ls-remat-shared"])
def test_layer_scale_encoders_match_jax_and_never_reach_block_mlp(name, mlp_calls):
    jm, params = _jax_model(name)
    pm = _port_model(name, block_mlp=True)
    names = {n for n, _ in pm.named_parameters()}
    trunk = "transformer" if jm.cfg.share_trunk else "text_transformer"
    assert f"{trunk}.resblocks.1.ls_1.gamma" in names and f"{trunk}.resblocks.0.ls_2.gamma" in names
    images, tokens = _batch(jm.cfg, seed=1)
    images = ((images.astype(np.float32) / 255.0) - 0.5) / 0.25
    enc = lambda method: jax.jit(functools.partial(jm.apply, method=method))  # noqa: E731
    want_i = np.asarray(enc(jm.encode_image)(params, jnp.asarray(images)))
    want_t = np.asarray(enc(jm.encode_text)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_i = pm.encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got_i, want_i, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    assert mlp_calls == []  # with LayerScale the MLP gets no ln_params


def test_layer_scale_has_a_gamma_per_branch_and_scales_it():
    _, params = _jax_model("opt-ls")
    assert sum(".ls_" in n for n in jax_params_to_port(params)) == 8  # 2 towers x 2 x 2
    pm = _port_model("opt-ls")
    tokens = torch.from_numpy(_batch(pm.cfg)[1]).long()
    with torch.no_grad():
        before = pm.encode_text(tokens)
        pm.text_transformer.resblocks[1].ls_2.gamma.mul_(2.0)
        assert not torch.allclose(pm.encode_text(tokens), before, atol=1e-3)


# ----------------------------------------------------------------------------- PatchDropout
def test_patch_dropout_eval_is_identity_and_training_needs_a_generator():
    pd = layers.PatchDropout(0.5)
    x = torch.randn(3, 17, 8, generator=torch.Generator().manual_seed(0))
    assert pd.eval()(x) is x
    assert layers.PatchDropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        pd.train()(x)


@pytest.mark.parametrize("rate,seq,prefix", [(0.5, 17, 1), (0.75, 50, 1), (0.99, 17, 1),
                                             (0.25, 197, 1), (0.5, 18, 2)])
def test_patch_dropout_shape_and_kept_count_equal_jax(rate, seq, prefix):
    x = np.random.default_rng(5).standard_normal((3, seq, 8), dtype=np.float32)
    want = JaxPatchDropout(rate, num_prefix=prefix).apply(
        {}, jnp.asarray(x), deterministic=False, rngs={"patch_dropout": jax.random.PRNGKey(0)})
    pd = layers.PatchDropout(rate, num_prefix=prefix).train()
    got = pd(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape
    assert got.shape[1] == prefix + max(1, int((seq - prefix) * (1 - rate)))
    np.testing.assert_array_equal(got[:, :prefix], x[:, :prefix])  # the prefix survives
    for b in range(3):  # every kept token is a patch row of its own example, none twice
        rows = [int(np.flatnonzero((x[b] == tok).all(-1))[0]) for tok in got[b, prefix:]]
        assert len(set(rows)) == len(rows) and min(rows) >= prefix


def test_patch_dropout_fixed_generator_repeats():
    pd = layers.PatchDropout(0.5).train()
    x = torch.randn(4, 33, 8, generator=torch.Generator().manual_seed(0))
    run = lambda seed: pd(x, torch.Generator().manual_seed(seed))  # noqa: E731
    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    kept = run(7)
    rows = [[int(((x[b] == tok).all(-1)).nonzero()[0]) for tok in kept[b, 1:]] for b in (0, 1)]
    assert rows[0] != rows[1]  # every example draws its own keep set


def test_patch_dropout_model_trains_with_a_generator():
    """A config with ``vision.patch_dropout`` builds, shortens the vision sequence in
    training only, takes its noise from the step's generator, and is refused nowhere."""
    model = _port_model("opt-patch-dropout", block_mlp=True)
    cfg = model.cfg
    batch = _torch_batch(cfg)
    images = batch["image"].float()
    seen = []
    model.visual_transformer.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[1]))
    with torch.inference_mode():
        model.encode_image(images)
    model.train()
    model.encode_image(images, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model.encode_image(images)
    assert seen == [17, 1 + 8]
    losses = []
    for seed in (3, 3, 4):
        m = _port_model("opt-patch-dropout")
        opt = make_optimizer(m.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
        step = make_train_step(m, opt)
        out = step(TrainState.create(m, opt), batch, torch.Generator().manual_seed(seed))
        losses.append(float(out["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(out["grad_norm"]))
        assert all(torch.isfinite(p.grad).all() for p in m.parameters())
    assert losses[0] == losses[1] and losses[0] != losses[2]
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        step(TrainState.create(m, opt), batch)


# ----------------------------------------------------------------------------- remat
def _loss_and_grads(model, batch):
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(batch["image"].float() / 255.0, batch["text"])
    loss = -(out["image_features"] * out["text_features"]).sum(-1).mean() * out["logit_scale"]
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("block_mlp", [False, True], ids=["plain-mlp", "block-mlp"])
def test_remat_gives_the_same_loss_and_gradients(block_mlp, monkeypatch):
    """``remat: true`` checkpoints each block in training: ``BlockAttentionLN`` (S=145),
    ``BlockAttention`` (S=16) and ``BlockMLP`` run their forwards again inside the backward
    and give exactly what the run without it gives."""
    calls = []
    real = layers.checkpoint

    def counting(fn, *a, **k):
        calls.append(k.get("use_reentrant"))
        return real(fn, *a, **k)

    monkeypatch.setattr(layers, "checkpoint", counting)
    params = _jax_model("opt-shared")[1]
    plain = load_jax_params(create_model("opt-shared", device="cpu", block_mlp=block_mlp), params)
    remat = load_jax_params(create_model("opt-remat-shared", device="cpu", block_mlp=block_mlp),
                            params)
    assert remat.transformer.remat and not plain.transformer.remat
    batch = _torch_batch(plain.cfg)
    want_loss, want = _loss_and_grads(plain, batch)
    assert calls == []
    got_loss, got = _loss_and_grads(remat, batch)
    assert calls == [False] * 4  # 2 layers x (vision pass, text pass), never re-entrant
    torch.testing.assert_close(got_loss, want_loss, atol=0, rtol=0)
    for n, g in want.items():
        torch.testing.assert_close(got[n], g, atol=0, rtol=0, msg=n)
    remat.eval()
    with torch.no_grad():
        remat.encode_text(batch["text"])
    assert len(calls) == 4  # not in eval


def test_remat_reads_the_config_flag():
    assert create_model("opt-remat-shared", device="cpu").cfg.remat is True
    assert create_model("opt-shared", device="cpu").cfg.remat is False
    two = create_model("tiny", device="cpu")
    assert not two.visual_transformer.remat and not two.text_transformer.remat


# ----------------------------------------------------------------------------- the slice
SLICE = ["tiny", "tiny-test-shared", "opt-shared", "opt-ls-remat-shared"]


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """Metrics, gradients and updated params of one JAX train step."""
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    jm, params = _jax_model(name)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    images, tokens = _batch(jm.cfg)
    batch = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = jax_train_step(jm, tx, loss_type="clip", donate=False)
    loss_fn = make_loss_fn(jm, "clip")
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, rng)[0]))(params)
    state, m = step(JaxState.create(params, tx), batch, rng)
    metrics = {k: float(m[k]) for k in ("loss", "logit_scale", "grad_norm")}
    return metrics, jax_params_to_port(grads), jax_params_to_port(state.params)


@functools.lru_cache(maxsize=None)
def _port_step(name):
    model = _port_model(name, block_mlp=True)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    m = make_train_step(model, opt)(TrainState.create(model, opt), _torch_batch(model.cfg))
    grads = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    return model, {k: float(v) for k, v in m.items()}, grads


@pytest.mark.parametrize("name", SLICE[:3])
def test_block_mlp_encoders_match_jax(name, mlp_calls):
    jm, params = _jax_model(name)
    pm = _port_model(name, block_mlp=True)
    images, tokens = _batch(jm.cfg, seed=1)
    images = ((images.astype(np.float32) / 255.0) - 0.5) / 0.25
    enc = lambda method: jax.jit(functools.partial(jm.apply, method=method))  # noqa: E731
    want_i = np.asarray(enc(jm.encode_image)(params, jnp.asarray(images)))
    want_t = np.asarray(enc(jm.encode_text)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_i = pm.encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got_i, want_i, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    # width 128 takes the operator in every block of both passes, width 64 in none
    assert len(mlp_calls) == (0 if name == "tiny-test-shared" else 4)


@pytest.mark.parametrize("name", SLICE)
def test_block_mlp_train_step_loss_and_grad_norm_match_jax(name):
    want, _, _ = _jax_step(name)
    _, got, _ = _port_step(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(got["logit_scale"], want["logit_scale"], rtol=1e-6)


@pytest.mark.parametrize("name", SLICE)
def test_block_mlp_train_step_every_grad_leaf_matches_jax(name):
    _, want, _ = _jax_step(name)
    _, _, got = _port_step(name)
    assert set(want) == set(got)
    for n, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[n], w, atol=1e-4 * scale, rtol=1e-3, err_msg=n)
    if "ls" in name:
        assert np.abs(got["transformer.resblocks.0.ls_2.gamma"]).max() > 0


@pytest.mark.parametrize("name", SLICE)
def test_block_mlp_train_step_updated_params_match_jax(name):
    _, _, want = _jax_step(name)
    model, _, _ = _port_step(name)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-5, rtol=1e-5, err_msg=n)


def test_switch_is_off_by_default_and_reaches_every_block():
    assert not any(m.block_mlp for m in create_model("tiny", device="cpu").modules()
                   if isinstance(m, layers.MLP))
    on = create_model("tiny", device="cpu", block_mlp=True)
    assert sum(m.block_mlp for m in on.modules() if isinstance(m, layers.MLP)) == 4
    assert {n for n, _ in on.named_parameters()} == {
        n for n, _ in create_model("tiny", device="cpu").named_parameters()}
