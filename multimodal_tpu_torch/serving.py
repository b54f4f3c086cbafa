"""Embedding service: dynamic request batching over the port's encoders, behind a stdlib
HTTP front end (port of ``multimodal_tpu/serving.py``).

- **Dynamic batching.** One dispatcher thread per modality coalesces queued requests up to
  ``max_batch`` items or ``max_wait_ms``, pads the batch to the next power of two by
  repeating its last row, and runs ONE encode on the device.
- **uint8 wire for images.** ``images_u8`` carries base64 of raw uint8 HWC rows at the
  model's resolution; normalization runs on the device.

Routes: ``GET /healthz``, ``GET /v1/stats``, ``POST /v1/embed/text`` (``texts``),
``POST /v1/embed/image`` (``images_u8``), ``POST /v1/similarity`` (``texts`` +
``images_u8``). A malformed request gets 400, an encode failure 500. ``quantized=True``
(``--quantized``) answers every route from the int8 W8A8 encoders (``inference_quant``).
JPEG payloads and the low-resolution wire format are not ported yet.
"""

from __future__ import annotations

import base64
import binascii
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np

from multimodal_tpu_torch.data.tokenizer import tokenize
from multimodal_tpu_torch.inference import Embedder


class RequestError(ValueError):
    """A malformed request (HTTP 400), as opposed to a failure while encoding (500)."""


def _next_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class _Request:
    __slots__ = ("rows", "done", "result", "error")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class BatcherStats:
    """Counters a load balancer (or a test) can read: how well requests coalesce."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.items = 0
        self.batches = 0
        self.max_occupancy = 0
        self.padded_items = 0

    def record(self, n_requests: int, n_items: int, bucket: int):
        with self.lock:
            self.requests += n_requests
            self.items += n_items
            self.batches += 1
            self.max_occupancy = max(self.max_occupancy, n_items)
            self.padded_items += bucket - n_items

    def snapshot(self) -> dict:
        with self.lock:
            mean = self.items / self.batches if self.batches else 0.0
            return {
                "requests": self.requests,
                "items": self.items,
                "batches": self.batches,
                "mean_batch_items": round(mean, 2),
                "max_batch_items": self.max_occupancy,
                "padded_items": self.padded_items,
            }


class DynamicBatcher:
    """Coalesce concurrent encode requests into bucketed device batches.

    A copy of ``multimodal_tpu.serving.DynamicBatcher`` (pure host code), so that the
    port never imports the JAX package and runs where jax is not installed.

    ``encode``: np.ndarray [B, ...] -> array-like [B, D]; called only from the internal
    dispatcher thread, with B always a power-of-two bucket <= max_batch."""

    def __init__(self, encode: Callable, max_batch: int = 256, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.encode = encode
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.stats = BatcherStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, rows: np.ndarray) -> np.ndarray:
        """Block until the rows are encoded; returns [len(rows), D]. Thread-safe."""
        if self._stop:
            raise RuntimeError("batcher is stopped")
        if rows.shape[0] == 0:
            return np.zeros((0,), np.float32)
        if rows.shape[0] > self.max_batch:
            parts = [self.submit(rows[i : i + self.max_batch])
                     for i in range(0, rows.shape[0], self.max_batch)]
            return np.concatenate(parts, axis=0)
        req = _Request(rows)
        self._q.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def stop(self):
        self._stop = True
        self._q.put(None)  # wake the dispatcher
        self._thread.join(timeout=5)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            count = first.rows.shape[0]
            deadline = time.monotonic() + self.max_wait
            while count < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch, count)
                    return
                if count + nxt.rows.shape[0] > self.max_batch:
                    self._flush(batch, count)
                    batch, count = [nxt], nxt.rows.shape[0]
                    deadline = time.monotonic() + self.max_wait
                else:
                    batch.append(nxt)
                    count += nxt.rows.shape[0]
            self._flush(batch, count)

    def _flush(self, batch: list, count: int):
        try:
            rows = np.concatenate([r.rows for r in batch], axis=0)
            bucket = _next_bucket(count, self.max_batch)
            if bucket > count:
                rows = np.concatenate([rows, np.repeat(rows[-1:], bucket - count, axis=0)])
            out = np.asarray(self.encode(rows))
            self.stats.record(len(batch), count, bucket)
            off = 0
            for r in batch:
                n = r.rows.shape[0]
                r.result = out[off : off + n]
                off += n
                r.done.set()
        except Exception as e:  # surface to every waiting client, keep the loop alive
            for r in batch:
                r.error = e
                r.done.set()


class EmbeddingService:
    """Tokenization and payload checks on the caller's thread; device encodes funneled
    through one DynamicBatcher per modality. Usable in-process or behind ``make_server``.
    ``quantized=True`` encodes through the int8 encoders (``Embedder(quantized=True)``)."""

    def __init__(self, model, max_batch: int = 256, max_wait_ms: float = 5.0,
                 quantized: bool = False):
        self.model = model
        self._embedder = Embedder(model, batch_size=max_batch, quantized=quantized)
        self.device = self._embedder.device
        self.text_batcher = DynamicBatcher(self._embedder.encode_tokens,
                                           max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.image_batcher = DynamicBatcher(self._embedder.encode_images,
                                            max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.started = time.time()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if (not isinstance(texts, (list, tuple)) or not texts
                or not all(isinstance(t, str) for t in texts)):
            raise RequestError("'texts' must be a non-empty list of strings")
        return self.text_batcher.submit(
            tokenize(list(texts), self.model.cfg.text.context_length))

    def embed_image_arrays(self, images: np.ndarray) -> np.ndarray:
        """[N, S, S, 3] uint8 at the model's resolution S."""
        s = self.model.cfg.vision.image_size
        if images.dtype != np.uint8 or images.ndim != 4 or images.shape[1:] != (s, s, 3):
            raise RequestError(f"images must be uint8 [N, {s}, {s}, 3], got "
                               f"{images.dtype} {list(images.shape)}")
        return self.image_batcher.submit(images)

    def embed_image_raw(self, buffers: Sequence[bytes], size=None) -> np.ndarray:
        """Each buffer is raw uint8 HWC at ``size`` px, which must be the model's size."""
        s = self.model.cfg.vision.image_size
        if size is not None and (isinstance(size, bool) or size != s):
            raise RequestError(f"'size' must be {s} (the model's resolution), got {size!r}")
        n = s * s * 3
        bad = [i for i, b in enumerate(buffers) if len(b) != n]
        if bad:
            raise RequestError(f"raw image {bad[0]} has {len(buffers[bad[0]])} bytes, "
                               f"expected {n} ({s}x{s}x3 uint8)")
        return self.embed_image_arrays(
            np.frombuffer(b"".join(buffers), np.uint8).reshape(-1, s, s, 3))

    def similarity(self, texts: Sequence[str], buffers: Sequence[bytes], size=None):
        """Cosine-similarity matrix [n_images, n_texts] (embeddings are unit-norm); each
        text is embedded once."""
        t = self.embed_texts(texts)
        return self.embed_image_raw(buffers, size) @ t.T

    def stats(self) -> dict:
        return {
            "uptime_s": round(time.time() - self.started, 1),
            "text": self.text_batcher.stats.snapshot(),
            "image": self.image_batcher.stats.snapshot(),
        }

    def close(self):
        self.text_batcher.stop()
        self.image_batcher.stop()


def _decode_u8(raw) -> list:
    if not isinstance(raw, list) or not raw:
        raise RequestError("'images_u8' must be a non-empty list of base64 strings")
    try:
        return [base64.b64decode(s, validate=True) for s in raw]
    except (binascii.Error, TypeError) as e:
        raise RequestError(f"'images_u8' entry is not base64: {e}") from e


class _Handler(BaseHTTPRequestHandler):
    service: EmbeddingService  # set on the subclass by make_server

    def log_message(self, fmt, *args):  # route through logging, not stderr
        import logging

        logging.getLogger("multimodal_tpu_torch.serving").debug(fmt, *args)

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _emb_payload(req: dict, emb: np.ndarray) -> dict:
        """JSON float lists, or with ``"encoding": "b64"`` base64 of packed little-endian
        float32 rows + shape."""
        if req.get("encoding") == "b64":
            a = np.ascontiguousarray(emb, dtype="<f4")
            return {"embeddings_b64": base64.b64encode(a.tobytes()).decode(),
                    "shape": list(a.shape), "dtype": "float32"}
        return {"embeddings": emb.tolist()}

    def do_GET(self):
        if self.path == "/healthz":
            dev = self.service.device
            info = {"ok": True, "platform": dev.type, "device": str(dev)}
            if dev.type == "cuda":
                import torch

                info["device_name"] = torch.cuda.get_device_name(dev)
            self._json(200, info)
        elif self.path == "/v1/stats":
            self._json(200, self.service.stats())
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise RequestError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad request body: {e}"})
        try:
            if self.path == "/v1/embed/text":
                emb = self.service.embed_texts(req.get("texts"))
                return self._json(200, self._emb_payload(req, emb))
            if self.path == "/v1/embed/image":
                if "images_u8" not in req:
                    raise RequestError("send 'images_u8' (raw uint8 HWC at the model's size); "
                                       "JPEG payloads ('images_b64') are not supported")
                emb = self.service.embed_image_raw(_decode_u8(req["images_u8"]),
                                                   req.get("size"))
                return self._json(200, {**self._emb_payload(req, emb),
                                        "decoded": [True] * len(emb)})
            if self.path == "/v1/similarity":
                if "images_u8" not in req:
                    raise RequestError("need 'texts' and 'images_u8'")
                sims = self.service.similarity(req.get("texts"), _decode_u8(req["images_u8"]),
                                               req.get("size"))
                return self._json(200, {"similarity": sims.tolist(),
                                        "decoded": [True] * len(sims)})
            return self._json(404, {"error": f"unknown path {self.path}"})
        except RequestError as e:
            return self._json(400, {"error": str(e)})
        except Exception as e:  # encode failures -> 500 with the message, server stays up
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: EmbeddingService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``port=0`` picks a free port
    (``server.server_address[1]`` has the real one). Run with serve_forever()."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import logging

    import torch

    from multimodal_tpu_torch.models import create_model, load_openai_state_dict

    ap = argparse.ArgumentParser(
        description="Serve CLIP-family embeddings over HTTP with dynamic batching")
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a GPU (there is no CPU fallback)")
    ap.add_argument("--state-dict", default=None,
                    help="OpenAI-CLIP-format state_dict saved with torch.save; "
                         "omit for seeded random weights (smoke mode)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--quantized", action="store_true", help="serve the int8 W8A8 path")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("multimodal_tpu_torch.serving")
    model = create_model(args.model, device=device)
    if args.state_dict:
        load_openai_state_dict(
            model, torch.load(args.state_dict, map_location="cpu", weights_only=True))
    service = EmbeddingService(model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                               quantized=args.quantized)
    server = make_server(service, args.host, args.port)
    log.info("serving %s%s on %s at http://%s:%d (max_batch=%d, wait=%.1fms)", args.model,
             " (int8)" if args.quantized else "", device, *server.server_address,
             args.max_batch, args.max_wait_ms)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
