"""The port's caption model (``multimodal_tpu_torch/models/captioner.py``) and BLEU against
the JAX package's, on the CPU at tiny sizes: seeded numpy weights in the JAX tree carried
across by ``caption_params_to_port``, the same numpy inputs.

Tolerances: BLEU equal to the last bit (the same pure-Python code); float32 logits within
atol 1e-4 and rtol 1e-4 (the JAX cache test's), the loss within 1e-5 relative and every
gradient leaf within 1e-4 x its largest magnitude, at least 1e-7 (sum order only); greedy
tokens equal; ``load_hf_gpt2`` against ``transformers.GPT2LMHeadModel`` at atol 2e-4, rtol
2e-3 (the JAX test's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.eval.captioning import corpus_bleu as jax_corpus_bleu
from multimodal_tpu.eval.captioning import sentence_bleu as jax_sentence_bleu
from multimodal_tpu.models import captioner as jcap
from multimodal_tpu_torch.eval.captioning import corpus_bleu, sentence_bleu
from multimodal_tpu_torch.models import captioner as pcap
from multimodal_tpu_torch.ops import draws

torch.set_num_threads(2)
CLIP_DIM = 16


def random_tree(shapes, seed: int = 0):
    """Numpy leaves of the flax tree ``shapes``: LN scales near 1, vectors ~0.02, the tables
    ~0.02, kernels at fan-in scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("scale") else 0.02 * n
        if name.endswith(("wte/embedding", "wpe", "prefix_const")):
            return 0.02 * n
        return n * np.float32(s.shape[0] ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def caption_pair(transformer_mapper=True, seed=0, prefix_length=4):
    jm = jcap.ClipCaptionModel(gpt2=jcap.TINY_GPT2, clip_dim=CLIP_DIM,
                               prefix_length=prefix_length, clip_length=2, mapper_layers=1,
                               use_transformer_mapper=transformer_mapper)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, CLIP_DIM)),
                                            jnp.zeros((2, 8), jnp.int32)))
    params = random_tree(shapes, seed)
    pm = pcap.ClipCaptionModel(gpt2=pcap.TINY_GPT2, clip_dim=CLIP_DIM,
                               prefix_length=prefix_length, clip_length=2, mapper_layers=1,
                               use_transformer_mapper=transformer_mapper, device="cpu")
    pcap.load_caption_params(pm, params)
    return jm, params, pm


def inputs(n=3, t=8, seed=1):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, CLIP_DIM)).astype(np.float32)
    toks = rng.integers(1, pcap.TINY_GPT2.vocab_size, (n, t)).astype(np.int32)
    toks[0, 5:] = 0  # padding
    toks[1, 7:] = 0
    return emb, toks


def test_bleu_equals_jax_to_the_bit():
    rng = np.random.default_rng(0)
    words = ["a", "cat", "dog", "on", "the", "mat", "red", "car", "two", "in"]
    refs, hyps = [], []
    for i in range(40):
        hyp = list(rng.choice(words, rng.integers(0, 12)))
        ref = [list(rng.choice(words, rng.integers(1, 12))) for _ in range(1 + i % 3)]
        assert sentence_bleu(ref, hyp) == jax_sentence_bleu(ref, hyp)
        assert (sentence_bleu(ref, hyp, weights=(0.5, 0.5), smooth_eps=0.2)
                == jax_sentence_bleu(ref, hyp, weights=(0.5, 0.5), smooth_eps=0.2))
        refs.append(ref)
        hyps.append(hyp)
    assert corpus_bleu(refs, hyps) == jax_corpus_bleu(refs, hyps)
    assert sentence_bleu([["a", "b"]], ["a", "b"]) < 1.0  # short: smoothed 3- and 4-grams


def test_gpt2_logits_with_and_without_the_cache():
    cfg = jcap.TINY_GPT2
    jg = jcap.GPT2(cfg)
    shapes = jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0), jnp.zeros((2, 10, 64))))
    params = random_tree(shapes, 3)
    pg = pcap.GPT2(pcap.TINY_GPT2)
    sd = {k: torch.from_numpy(v) for k, v in pcap.caption_params_to_port(params).items()}
    pg.load_state_dict(sd)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)

    emb = jg.apply(params, jnp.asarray(tokens), method=jcap.GPT2.embed)
    want, _ = jg.apply(params, emb)
    with torch.no_grad():
        got, _ = pg(pg.embed(torch.from_numpy(tokens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

    # the cache: a 6-token prompt, then 4 tokens one at a time, each against the whole cache
    caches = jg.apply(params, 2, 16, method=jcap.GPT2.init_cache)
    logits, caches = jg.apply(params, emb[:, :6], caches=caches, position=0)
    want_inc = [logits[:, -1]]
    for i in range(6, 10):
        logits, caches = jg.apply(params, emb[:, i:i + 1], caches=caches, position=i)
        want_inc.append(logits[:, -1])
    p_emb = pg.embed(torch.from_numpy(tokens))
    with torch.no_grad():
        p_caches = pg.init_cache(2, 16)
        logits, p_caches = pg(p_emb[:, :6], p_caches, position=0)
        got_inc = [logits[:, -1]]
        for i in range(6, 10):
            logits, p_caches = pg(p_emb[:, i:i + 1], p_caches, position=i)
            got_inc.append(logits[:, -1])
    np.testing.assert_allclose(torch.stack(got_inc, 1).numpy(),
                               np.asarray(jnp.stack(want_inc, 1)), atol=1e-4, rtol=1e-4)
    # and the cached logits are the full forward's
    np.testing.assert_allclose(torch.stack(got_inc, 1).numpy(), got[:, 5:10].numpy(),
                               atol=1e-4, rtol=1e-4)
    for (jk, jv), (pk, pv) in zip(caches, p_caches):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("transformer_mapper", [True, False], ids=["transformer", "mlp"])
def test_caption_loss_and_gradients(transformer_mapper):
    jm, params, pm = caption_pair(transformer_mapper, seed=2)
    emb, toks = inputs()
    loss, grads = jax.value_and_grad(lambda p: jm.apply(p, emb, toks))(params)
    got = pm(torch.from_numpy(emb), torch.from_numpy(toks))
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(loss)) <= 1e-5 * abs(float(loss))
    want = pcap.caption_params_to_port(grads)
    named = dict(pm.named_parameters())
    assert set(want) == set(named)
    for name, g in want.items():
        # the key bias's gradient is 0 in exact arithmetic (softmax ignores it): a 1e-7 floor
        tol = max(1e-4 * float(np.abs(g).max()), 1e-7)
        np.testing.assert_allclose(named[name].grad.numpy(), g, atol=tol, rtol=0, err_msg=name)


def test_caption_loss_with_an_explicit_mask():
    jm, params, pm = caption_pair(seed=4)
    emb, toks = inputs(seed=5)
    mask = np.random.default_rng(6).random(toks.shape) > 0.3
    want = float(jm.apply(params, emb, toks, jnp.asarray(mask)))
    with torch.no_grad():
        got = float(pm(torch.from_numpy(emb), torch.from_numpy(toks), torch.from_numpy(mask)))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("transformer_mapper", [True, False], ids=["transformer", "mlp"])
def test_greedy_generate_equals_jax_through_eos(transformer_mapper):
    jm, params, pm = caption_pair(transformer_mapper, seed=7)
    emb, _ = inputs(n=4, seed=8)
    free = np.asarray(jm.apply(params, emb, jax.random.PRNGKey(0), max_len=8,
                               method=jm.generate))
    eos = int(free[1, 2])  # a token row 1 emits at step 2: generation stops there
    want = np.asarray(jm.apply(params, emb, jax.random.PRNGKey(0), max_len=8, eos_token=eos,
                               method=jm.generate))
    got = pm.generate(torch.from_numpy(emb), max_len=8, eos_token=eos).numpy()
    np.testing.assert_array_equal(got, want)
    row = list(got[1])
    assert eos in row and all(t == 0 for t in row[row.index(eos) + 1:])


def test_sampled_generate_with_jaxs_gumbel_draws(monkeypatch):
    """At temperature 0.7 each step's Gumbel noise is JAX's (the key split per step as the
    reference's scan splits it): the sampled tokens are JAX's."""
    jm, params, pm = caption_pair(seed=9)
    emb, _ = inputs(n=3, seed=10)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jm.apply(params, emb, key, max_len=6, temperature=0.7,
                               method=jm.generate))
    noise, k = [], key
    for _ in range(6):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.gumbel(sub, (3, pcap.TINY_GPT2.vocab_size))))

    def replay(shape, generator, like):
        value = noise.pop(0)
        assert value.shape == tuple(shape)
        return torch.from_numpy(value)

    monkeypatch.setattr(draws, "gumbel", replay)
    got = pm.generate(torch.from_numpy(emb), torch.Generator(), max_len=6, temperature=0.7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not noise


def test_generate_is_kv_cached_one_token_a_step(monkeypatch):
    """The decode runs the prefix once, then one token a step at its position against the
    cache of prefix + max_len, and never re-encodes the sequence."""
    _, _, pm = caption_pair(seed=12)
    emb, _ = inputs(n=2, seed=13)
    calls = []
    forward = pcap.GPT2.forward

    def spy(self, embeds, caches=None, position=0):
        calls.append((embeds.shape[1], position, None if caches is None else caches[0][0].shape))
        return forward(self, embeds, caches, position)

    monkeypatch.setattr(pcap.GPT2, "forward", spy)
    pm.generate(torch.from_numpy(emb), max_len=5)
    cache = (2, 4 + 5, 2, 32)
    assert calls == [(4, 0, cache)] + [(1, 4 + i, cache) for i in range(4)]


def test_load_hf_gpt2_against_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(vocab_size=128, n_positions=32, n_embd=32, n_layer=2,
                                     n_head=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = pcap.GPT2Config(vocab_size=128, max_positions=32, width=32, layers=2, heads=2)
    model = pcap.GPT2(cfg)
    model.load_state_dict(pcap.load_hf_gpt2(hf.state_dict(), cfg))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(tokens).logits.numpy()
        got, _ = model(model.embed(tokens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)
    # the JAX package's converter reads the same state dict into the same numbers
    jp = jcap.load_hf_gpt2(hf.state_dict(), jcap.GPT2Config(vocab_size=128, max_positions=32,
                                                            width=32, layers=2, heads=2))
    for name, value in pcap.caption_params_to_port(jp).items():
        np.testing.assert_array_equal(model.state_dict()[name].numpy(), value)


def test_caption_model_lands_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcap.ClipCaptionModel(gpt2=pcap.TINY_GPT2, clip_dim=CLIP_DIM)


def test_fresh_weights_are_the_seeds_on_every_call():
    _, _, pm = caption_pair()
    a, b = pm.fresh_state_dict(3), pm.fresh_state_dict(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = pm.fresh_state_dict(4)
    assert not torch.equal(a["lm.wte.embedding"], c["lm.wte.embedding"])
    # the mapper's transformer keeps the CLIP layers' init; GPT-2's dense kernels flax's
    k = a["lm.h.0.mlp_fc.kernel"]
    assert float(k.abs().max()) <= 2.0 * (1 / 64) ** 0.5 / 0.87962566103423978 + 1e-6
