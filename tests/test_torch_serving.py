"""The port's EmbeddingService and HTTP routes on CPU against the JAX EmbeddingService on a
tiny model with the same weights (atol 2e-4), plus the request checks the reference lacks:
a similarity request embeds its texts once, and a bad ``size`` is a 400, not a 500."""

import base64
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
from multimodal_tpu.serving import EmbeddingService as JaxEmbeddingService
from multimodal_tpu_torch import serving
from multimodal_tpu_torch.models import add_model_config, create_model, load_openai_state_dict

torch.set_num_threads(1)

NAME = "tiny-serve-torch"
CFG = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 128, "layers": 1, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 128, "layers": 1,
                 "heads": 2},
}
add_model_config(NAME, CFG)
jax_add_model_config(NAME, CFG)
TEXTS = ["a cat", "a dog on a mat", "x²½ Ⅻ"]


def _random_params(jm, seed: int = 0):
    """JAX params of ``jm``'s shapes from a seeded numpy generator (no Flax init run)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(2.6592)
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def services():
    jm = jax_create_model(NAME)
    params = _random_params(jm)
    pm = load_openai_state_dict(create_model(NAME, device="cpu"), export_torch_state_dict(params, jm.cfg))
    port = serving.EmbeddingService(pm, max_batch=8, max_wait_ms=5.0)
    ref = JaxEmbeddingService(jm, params, max_batch=8, max_wait_ms=5.0)
    yield port, ref
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def url(services):
    srv = serving.make_server(services[0], "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _b64(images):
    return [base64.b64encode(a.tobytes()).decode() for a in images]


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_service_matches_jax_service(services):
    port, ref = services
    np.testing.assert_allclose(port.embed_texts(TEXTS), ref.embed_texts(TEXTS), atol=2e-4)
    imgs = _images(3, 0)
    got = port.embed_image_raw([a.tobytes() for a in imgs])
    np.testing.assert_allclose(got, ref.embed_image_raw([a.tobytes() for a in imgs]), atol=2e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, port.embed_image_arrays(imgs), atol=0)


def test_embedder_pads_the_tail_and_matches_jax_embedder(services):
    from multimodal_tpu.inference import Embedder as JaxEmbedder
    from multimodal_tpu_torch.inference import Embedder

    port, ref = services
    ours = Embedder(port.model, batch_size=4)
    theirs = JaxEmbedder(ref.model, ref._embedder.params, batch_size=4)
    imgs = _images(5, 4)  # one full chunk and a tail of 1, padded with its last row
    got = ours.embed_images(imgs)
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, theirs.embed_images(imgs), atol=2e-4)
    np.testing.assert_allclose(got[4], ours.embed_images(imgs[4:])[0], atol=1e-6)
    texts = TEXTS + ["one more caption", "and a sixth"]
    np.testing.assert_allclose(ours.embed_texts(texts), theirs.embed_texts(texts), atol=2e-4)


def test_http_routes_match_jax_service(services, url):
    port, ref = services
    health = _get(url + "/healthz")
    assert health["ok"] is True and health["platform"] == "cpu"

    code, out = _post(url + "/v1/embed/text", {"texts": TEXTS})
    assert code == 200
    np.testing.assert_allclose(np.asarray(out["embeddings"]), ref.embed_texts(TEXTS), atol=2e-4)

    imgs = _images(2, 1)
    code, out = _post(url + "/v1/embed/image", {"images_u8": _b64(imgs), "encoding": "b64"})
    assert code == 200 and out["shape"] == [2, 16] and out["decoded"] == [True, True]
    got = np.frombuffer(base64.b64decode(out["embeddings_b64"]), "<f4").reshape(out["shape"])
    np.testing.assert_allclose(got, ref.embed_image_raw([a.tobytes() for a in imgs]), atol=2e-4)

    code, out = _post(url + "/v1/similarity", {"texts": TEXTS[:2], "images_u8": _b64(imgs)})
    assert code == 200
    want = ref.embed_image_raw([a.tobytes() for a in imgs]) @ ref.embed_texts(TEXTS[:2]).T
    np.testing.assert_allclose(np.asarray(out["similarity"]), want, atol=2e-4)

    stats = _get(url + "/v1/stats")
    assert stats["text"]["requests"] >= 2 and stats["image"]["batches"] >= 2


def test_similarity_embeds_texts_once(services, url):
    port, _ = services
    before = port.text_batcher.stats.snapshot()
    code, _ = _post(url + "/v1/similarity", {"texts": ["a", "b", "c"],
                                             "images_u8": _b64(_images(1, 2))})
    after = port.text_batcher.stats.snapshot()
    assert code == 200
    assert after["requests"] - before["requests"] == 1
    assert after["items"] - before["items"] == 3


@pytest.mark.parametrize("payload,route", [
    ({"images_u8": "size", "size": 16}, "/v1/embed/image"),
    ({"images_u8": "size", "size": "32px"}, "/v1/embed/image"),
    ({"images_u8": "size", "size": True}, "/v1/embed/image"),
    ({"texts": ["a"], "images_u8": "size", "size": 8}, "/v1/similarity"),
    ({"images_u8": ["AAAA"]}, "/v1/embed/image"),  # wrong byte count
    ({"images_u8": ["not base64!"]}, "/v1/embed/image"),
    ({"images_u8": []}, "/v1/embed/image"),
    ({"images_b64": ["not base64!"]}, "/v1/embed/image"),
    ({"texts": []}, "/v1/embed/text"),
    ({"texts": "a cat"}, "/v1/embed/text"),
    ({"texts": [3]}, "/v1/embed/text"),
    ({"texts": ["a"]}, "/v1/similarity"),
])
def test_bad_requests_get_400(url, payload, route):
    if payload.get("images_u8") == "size":
        payload = {**payload, "images_u8": _b64(_images(1, 3))}
    code, out = _post(url + route, payload)
    assert code == 400, out
    assert "error" in out


def test_unknown_routes_get_404(url):
    assert _post(url + "/v1/nope", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/v1/nope")
    assert e.value.code == 404


def test_concurrent_clients_coalesce(services, url):
    port, _ = services
    before = port.text_batcher.stats.snapshot()["batches"]
    texts = [f"caption number {i}" for i in range(12)]
    results = [None] * 12

    def client(i):
        results[i] = _post(url + "/v1/embed/text", {"texts": [texts[i]]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert all(code == 200 for code, _ in results)
    direct = port.embed_texts(texts)
    for i, (_, out) in enumerate(results):
        np.testing.assert_allclose(np.asarray(out["embeddings"][0], np.float32), direct[i],
                                   atol=1e-5)
    assert port.text_batcher.stats.snapshot()["batches"] - before < 12


def test_batcher_error_reaches_every_client_and_loop_survives():
    def encode(rows):
        if rows[0, 0] < 0:
            raise RuntimeError("boom")
        return rows

    b = serving.DynamicBatcher(encode, max_batch=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit(np.full((1, 2), -1.0, np.float32))
        np.testing.assert_array_equal(b.submit(np.ones((6, 2), np.float32)), np.ones((6, 2)))
        assert b.stats.snapshot()["max_batch_items"] <= 4
    finally:
        b.stop()


def test_cuda_device_without_gpu_refuses_to_start():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path needs a machine without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serving.main(["--device", "cuda", "--model", NAME])


# ---------------------------------------------------------------------------------- JPEG
# and the low-resolution wire format (a second service pair with wire_size=16)

PHOTOS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards",
                      "photos-000000.tar")


@pytest.fixture(scope="module")
def jpegs():
    """Four photos of the fixture, its corrupt JPEG and its PNG."""
    from multimodal_tpu_torch.data.wds import iter_tar_samples

    bufs = [s.get("jpg", s.get("png")) for s in iter_tar_samples(PHOTOS)]
    return bufs[:4] + bufs[-2:]


@pytest.fixture(scope="module")
def wire_services(services):
    port, ref = services
    ours = serving.EmbeddingService(port.model, max_batch=8, max_wait_ms=5.0, wire_size=16)
    theirs = JaxEmbeddingService(ref.model, ref._embedder.params, max_batch=8, max_wait_ms=5.0,
                                 wire_size=16)
    srv = serving.make_server(ours, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield ours, theirs, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    ours.close()
    theirs.close()


def test_jpeg_route_matches_jax_service(services, url, jpegs):
    _, ref = services
    want, want_ok = ref.embed_image_bytes(jpegs)
    code, out = _post(url + "/v1/embed/image", {"images_b64": _b64_bytes(jpegs)})
    assert code == 200 and out["decoded"] == want_ok.tolist() == [True] * 4 + [False, True]
    got = np.asarray(out["embeddings"], np.float32)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert (got[4] == 0).all()
    code, out = _post(url + "/v1/similarity", {"texts": TEXTS, "images_b64": _b64_bytes(jpegs)})
    assert code == 200 and out["decoded"] == want_ok.tolist()
    np.testing.assert_allclose(np.asarray(out["similarity"]), want @ ref.embed_texts(TEXTS).T,
                               atol=2e-4)


def test_wire_routes_match_jax_service(wire_services, jpegs):
    ours, theirs, wurl = wire_services
    for wire in (True, False):
        want, want_ok = theirs.embed_image_bytes(jpegs, wire=wire)
        code, out = _post(wurl + "/v1/embed/image", {"images_b64": _b64_bytes(jpegs),
                                                     "wire": wire})
        assert code == 200 and out["decoded"] == want_ok.tolist()
        np.testing.assert_allclose(np.asarray(out["embeddings"], np.float32), want, atol=2e-4)
    small = _images(3, 7)[:, :16, :16]
    code, out = _post(wurl + "/v1/embed/image", {"images_u8": _b64(small), "size": 16})
    assert code == 200
    want = theirs.embed_image_raw([a.tobytes() for a in small], size=16)
    np.testing.assert_allclose(np.asarray(out["embeddings"], np.float32), want, atol=2e-4)
    code, out = _post(wurl + "/v1/embed/image", {"images_u8": _b64(small)})  # default: wire
    assert code == 200
    np.testing.assert_allclose(np.asarray(out["embeddings"], np.float32), want, atol=2e-4)
    code, out = _post(wurl + "/v1/similarity", {"texts": TEXTS, "images_b64": _b64_bytes(jpegs),
                                                "wire": True})
    assert code == 200
    stats = _get(wurl + "/v1/stats")
    assert stats["image_wire"]["batches"] >= 3 and stats["image"]["batches"] >= 1


@pytest.mark.parametrize("payload,route", [
    ({"images_b64": ["AAAA"], "wire": True}, "/v1/embed/image"),  # no wire_size
    ({"images_b64": []}, "/v1/embed/image"),
    ({"images_b64": "jpeg"}, "/v1/embed/image"),
    ({"texts": ["a"], "images_b64": ["not base64!"]}, "/v1/similarity"),
    ({"texts": [], "images_b64": ["AAAA"]}, "/v1/similarity"),
    ({}, "/v1/embed/image"),
])
def test_bad_jpeg_requests_get_400(url, payload, route):
    code, out = _post(url + route, payload)
    assert code == 400, out
    assert "error" in out


def test_wire_service_refuses_other_sizes(wire_services):
    ours, _, wurl = wire_services
    code, out = _post(wurl + "/v1/embed/image", {"images_u8": _b64(_images(1, 1)[:, :8, :8]),
                                                 "size": 8})
    assert code == 400 and "16" in out["error"]
    with pytest.raises(serving.RequestError, match="uint8"):
        ours.embed_image_arrays(np.zeros((1, 20, 20, 3), np.uint8))


def _b64_bytes(buffers):
    return [base64.b64encode(b).decode() for b in buffers]
