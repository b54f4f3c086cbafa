"""The port's W8A8 serving path (``inference_quant``, ``Embedder(quantized=True)``,
``EmbeddingService(quantized=True)`` and ``--quantized``) against the JAX package's, as its
``Embedder`` runs it: ``quantize_clip_params`` eagerly at load, the encoders jitted.

Limits. The int8 weights, codes and scales, bit for bit (the port's load-time "divide" form is
the eager reference's). The encodes: min cosine >= 0.999 and max abs <= 2e-2 to the JAX
encode. The activations are bfloat16 throughout, and XLA keeps some fused bfloat16
intermediates in float32 where the port rounds each operation; bfloat16 keeps 8 bits, an
int8 code 7 and a sign, so a bfloat16 ulp moves many codes and the flips cascade (counted by
``CodeRecorder`` and printed: 35% of the activation codes at these seeds), and unit
embeddings differ by up to ~1.1e-2 (min cosine 0.9994). Against the float32 model: JAX's
own gate, cosine > 0.99 (``tests/test_quant.py``).
"""

import base64
import dataclasses
import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu import inference_quant as jax_iq
from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.serving import EmbeddingService as JaxEmbeddingService
from multimodal_tpu_torch import inference_quant as iq
from multimodal_tpu_torch import serving
from multimodal_tpu_torch.inference import Embedder
from multimodal_tpu_torch.models import CLIP, add_model_config, create_model, load_jax_params
from torch_jax_models import CodeRecorder, batch, random_params

torch.set_num_threads(1)

SERVE = "tiny-quant-serve"  # tiny-test with the tokenizer's vocabulary, for text requests
SERVE_CFG = {
    "embed_dim": 64,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "layers": 2,
                 "heads": 2},
}
add_model_config(SERVE, SERVE_CFG)
jax_add_model_config(SERVE, SERVE_CFG)


def _gelu_gap(cfg):
    return dataclasses.replace(cfg, act="gelu", vision=dataclasses.replace(
        cfg.vision, global_average_pool=True))


@functools.lru_cache(maxsize=None)
def _models(variant: str):
    """(JAX model, its params, the port model) on tiny-test: quick_gelu with CLS pooling, or
    tanh-gelu with global-average pooling; ``SERVE`` for the server."""
    from multimodal_tpu.models.clip import CLIP as JaxCLIP

    name = SERVE if variant == SERVE else "tiny-test"
    jm = jax_create_model(name)
    port = create_model(name, device="cpu")
    if variant == "gelu-gap":
        jm = JaxCLIP(_gelu_gap(jm.cfg), dtype=jnp.float32)
        port = CLIP(_gelu_gap(port.cfg))
    params = random_params(jm)
    return jm, params, load_jax_params(port, params)


def _cosine(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.sum(a * b, axis=-1)


@pytest.mark.parametrize("field,value", [("share_trunk", True), ("attentional_pool", True),
                                         ("ls_init_value", 1e-4), ("scaled_cosine", True),
                                         ("scale_heads", True), ("moe_experts", 4),
                                         ("act", "relu")])
def test_quantize_refuses_what_jax_refuses(field, value):
    """The reference asserts on these configs; the port raises ValueError naming each."""
    jm, params, pm = _models("quick_gelu")
    cfg = pm.cfg
    if field in ("share_trunk", "act"):
        bad = dataclasses.replace(cfg, **{field: value})
    else:
        bad = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, **{field: value}))
    with pytest.raises(AssertionError):
        jax_iq.quantize_clip_params(params, bad)
    pm.cfg = bad
    try:
        with pytest.raises(ValueError, match="relu" if field == "act" else field):
            iq.quantize_clip_params(pm)
    finally:
        pm.cfg = cfg


def test_quantize_refuses_the_variational_model():
    with pytest.raises(ValueError, match="VariationalCLIP"):
        iq.quantize_clip_params(create_model("tiny-test", variational=True, device="cpu"))


def test_quantized_weights_are_the_references():
    """Every int8 kernel ([out, in], the reference's transposed) and scale bit for bit."""
    jm, params, pm = _models("quick_gelu")
    want = jax_iq.quantize_clip_params(params, jm.cfg)["params"]
    got = iq.quantize_clip_params(pm)
    pairs = [(got[f"{tower}_projection"], want[f"{tower}_projection"])
             for tower in ("visual", "text")]
    for tower in ("visual", "text"):
        for i, blk in enumerate(got[f"{tower}_blocks"]):
            ref = want[f"{tower}_transformer"][f"resblock_{i}"]
            pairs += [(blk[k], ref["attn"][k]) for k in ("query", "key", "value", "out")]
            pairs += [(blk[k], ref["mlp"][k]) for k in ("c_fc", "c_proj")]
    assert len(pairs) == 2 + 2 * 2 * 6
    for g, w in pairs:
        assert g["kernel_q"].dtype == torch.int8
        assert np.array_equal(g["kernel_q"].numpy(), np.asarray(w["kernel_q"]).T)
        assert np.array_equal(g["scale"].numpy(), np.asarray(w["scale"]))
        if "bias" in w:
            assert np.array_equal(g["bias"].numpy(), np.asarray(w["bias"]))


@pytest.mark.parametrize("variant", ["quick_gelu", "gelu-gap"])
def test_quantized_encoders_match_jitted_jax(monkeypatch, variant):
    jm, params, pm = _models(variant)
    rec = CodeRecorder(monkeypatch)
    qp = jax_iq.quantize_clip_params(params, jm.cfg)
    jax.effects_barrier()
    rec.jax = []  # the load-time weight quantize is held bit for bit above
    images, tokens = batch(jm.cfg, 5, seed=3)
    want_i = np.asarray(jax.jit(lambda q, x: jax_iq.encode_image_q(q, jm.cfg, x))(
        qp, jnp.asarray(images)))
    want_t = np.asarray(jax.jit(lambda q, t: jax_iq.encode_text_q(q, jm.cfg, t))(
        qp, jnp.asarray(tokens)))
    qt = iq.quantize_clip_params(pm)
    rec.port = []
    with torch.inference_mode():
        got_i = iq.encode_image_q(qt, pm.cfg, torch.from_numpy(images)).numpy()
        got_t = iq.encode_text_q(qt, pm.cfg, torch.from_numpy(tokens).long()).numpy()
    flips, codes = rec.flips()
    cos = min(_cosine(got_i, want_i).min(), _cosine(got_t, want_t).min())
    err = max(np.abs(got_i - want_i).max(), np.abs(got_t - want_t).max())
    print(f"quantized encoders {variant}: {flips} of {codes} activation codes flipped; min "
          f"cosine {cos:.6f}, max abs {err:.2e}")
    assert got_i.shape == want_i.shape == (5, jm.cfg.embed_dim) and got_t.dtype == np.float32
    assert cos >= 0.999 and err <= 2e-2


def test_quantized_embedder_tracks_the_float_embedder():
    """JAX's gate: cosine > 0.99 to the float32 encode on both towers, 13 rows through a
    batch of 8 (a padded tail); the model comes back in the mode it was handed over in."""
    _, _, pm = _models("quick_gelu")
    pm.train()
    float_emb, int8_emb = Embedder(pm, batch_size=8), Embedder(pm, batch_size=8, quantized=True)
    images, tokens = batch(pm.cfg, 13, seed=4)
    fi, ft = int8_emb.embed_images(images), int8_emb.encode_tokens(tokens)
    assert fi.shape == ft.shape == (13, pm.cfg.embed_dim)
    assert np.min(_cosine(fi, float_emb.embed_images(images))) > 0.99
    assert np.min(_cosine(ft, float_emb.encode_tokens(tokens))) > 0.99
    assert pm.training
    pm.eval()


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_quantized_server_answers_like_the_jax_quantized_service():
    """``EmbeddingService(quantized=True)`` behind the HTTP server on the CPU: text, image and
    similarity routes, each against the JAX package's quantized service (cosine >= 0.999)."""
    jm, params, pm = _models(SERVE)
    ref = JaxEmbeddingService(jm, params, max_batch=8, max_wait_ms=5.0, quantized=True)
    port = serving.EmbeddingService(pm, max_batch=8, max_wait_ms=5.0, quantized=True)
    srv = serving.make_server(port, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        texts = ["a cat", "a dog on a mat", "two birds"]
        images = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
        raw = [base64.b64encode(a.tobytes()).decode() for a in images]
        code_t, text = _post(url + "/v1/embed/text", {"texts": texts})
        code_i, image = _post(url + "/v1/embed/image", {"images_u8": raw})
        code_s, sim = _post(url + "/v1/similarity", {"texts": texts, "images_u8": raw})
        assert (code_t, code_i, code_s) == (200, 200, 200)
        txt, img = np.float32(text["embeddings"]), np.float32(image["embeddings"])
        assert _cosine(txt, ref.embed_texts(texts)).min() >= 0.999
        assert _cosine(img, ref.embed_image_raw([a.tobytes() for a in images])).min() >= 0.999
        np.testing.assert_allclose(np.float32(sim["similarity"]), img @ txt.T, atol=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        port.close()
        ref.close()


def test_serving_cli_takes_quantized(monkeypatch):
    """``--quantized`` reaches the service (the server itself is not started here)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_service(model, max_batch, max_wait_ms, quantized):
        seen["quantized"] = quantized
        raise Stop

    monkeypatch.setattr(serving, "EmbeddingService", fake_service)
    with pytest.raises(Stop):
        serving.main(["--model", "tiny-test", "--device", "cpu", "--quantized"])
    assert seen == {"quantized": True}
