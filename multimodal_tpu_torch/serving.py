"""Embedding service: dynamic request batching over the port's encoders, behind a stdlib
HTTP front end (port of ``multimodal_tpu/serving.py``).

- **Dynamic batching.** One dispatcher thread per modality coalesces queued requests up to
  ``max_batch`` items or ``max_wait_ms``, pads the batch to the next power of two by
  repeating its last row, and runs ONE encode on the device.
- **uint8 wire for images.** ``images_u8`` carries base64 of raw uint8 HWC rows at the
  model's resolution (or at ``wire_size``); normalization runs on the device.
- **JPEG payloads.** ``images_b64`` carries base64 of encoded images, decoded on the model's
  device (``data.wds.decode_images``: nvJPEG and the resample kernel on the GPU, PIL for what
  is not a JPEG); ``"decoded"`` flags each, and a failed one embeds as a zero row.
- **The low-resolution wire format.** A service built with ``wire_size`` (``--wire-size``)
  takes ``images_u8`` at that size, and with ``"wire": true`` decodes JPEGs at it; such
  batches ride their own batcher and are upsampled to the model's resolution on the device.

Routes: ``GET /healthz``, ``GET /v1/stats``, ``POST /v1/embed/text`` (``texts``),
``POST /v1/embed/image`` (``images_u8`` or ``images_b64``), ``POST /v1/similarity``
(``texts`` + ``images_u8`` or ``images_b64``; each text embedded once). A malformed request
gets 400, an encode failure 500. ``quantized=True`` (``--quantized``) answers every route from
the int8 W8A8 encoders (``inference_quant``); ``normalize=False`` returns the projections
without the L2 normalization.

``python -m multimodal_tpu_torch.serving --checkpoint DIR [--ema]`` serves the latest
checkpoint that the training CLI wrote under ``DIR`` (``<logs>/<name>/checkpoints``), with
``--ema`` its EMA weights when it kept them (``load_serving_weights``); ``--state-dict``
serves an OpenAI-format state dict instead.
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
import torch

from multimodal_tpu_torch.data.tokenizer import tokenize
from multimodal_tpu_torch.data.wds import decode_images
from multimodal_tpu_torch.inference import Embedder


class RequestError(ValueError):
    """A malformed request (HTTP 400), as opposed to a failure while encoding (500)."""


def _cat(parts: list):
    """Concatenate request rows: numpy arrays stay numpy; if any part is a tensor (rows
    decoded on the device), all become tensors on that part's device."""
    dev = next((p.device for p in parts if isinstance(p, torch.Tensor)), None)
    if dev is None:
        return np.concatenate(parts, axis=0)
    return torch.cat([torch.as_tensor(p).to(dev) for p in parts])


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

    ``encode``: np.ndarray or tensor [B, ...] -> array-like [B, D]; called only from the
    internal dispatcher thread, with B always a power-of-two bucket <= max_batch."""

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

    def submit(self, rows) -> np.ndarray:
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
            rows = _cat([r.rows for r in batch])
            bucket = _next_bucket(count, self.max_batch)
            if bucket > count:
                rows = _cat([rows, rows[-1:].repeat(bucket - count, *([1] * (rows.ndim - 1)))
                             if isinstance(rows, torch.Tensor)
                             else np.repeat(rows[-1:], bucket - count, axis=0)])
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
    """Tokenization, decode and payload checks on the caller's thread; device encodes
    funneled through one DynamicBatcher per modality (and one more for ``wire_size``
    batches, which are coalesced apart from the full-size ones). Usable in-process or behind
    ``make_server``. ``quantized=True`` encodes through the int8 encoders
    (``Embedder(quantized=True)``); ``normalize=False`` answers with unnormalized rows."""

    def __init__(self, model, max_batch: int = 256, max_wait_ms: float = 5.0,
                 quantized: bool = False, normalize: bool = True,
                 wire_size: Optional[int] = None):
        self.model = model
        self.wire_size = wire_size
        self._embedder = Embedder(model, batch_size=max_batch, normalize=normalize,
                                  quantized=quantized, wire_size=wire_size)
        self.device = self._embedder.device
        self.text_batcher = DynamicBatcher(self._embedder.encode_tokens,
                                           max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.image_batcher = DynamicBatcher(self._embedder.encode_images,
                                            max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.image_wire_batcher = (
            DynamicBatcher(self._embedder.encode_images, max_batch=max_batch,
                           max_wait_ms=max_wait_ms) if wire_size else None)
        self.started = time.time()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if (not isinstance(texts, (list, tuple)) or not texts
                or not all(isinstance(t, str) for t in texts)):
            raise RequestError("'texts' must be a non-empty list of strings")
        return self.text_batcher.submit(
            tokenize(list(texts), self.model.cfg.text.context_length))

    def _sizes(self) -> tuple:
        s = self.model.cfg.vision.image_size
        return (s, self.wire_size) if self.wire_size else (s,)

    def embed_image_arrays(self, images) -> np.ndarray:
        """[N, S, S, 3] uint8 (numpy or a tensor) at the model's resolution S, or at
        ``wire_size``: those go through the wire batcher and are upsampled on the device."""
        shape = tuple(images.shape)
        dtype_ok = (images.dtype == torch.uint8 if isinstance(images, torch.Tensor)
                    else images.dtype == np.uint8)
        if (not dtype_ok or len(shape) != 4 or shape[1] not in self._sizes()
                or shape[1:] != (shape[1], shape[1], 3)):
            sizes = " or ".join(str(v) for v in self._sizes())
            raise RequestError(f"images must be uint8 [N, S, S, 3] with S {sizes}, got "
                               f"{images.dtype} {list(shape)}")
        if self.image_wire_batcher is not None and shape[1] == self.wire_size != \
                self.model.cfg.vision.image_size:
            return self.image_wire_batcher.submit(images)
        return self.image_batcher.submit(images)

    def embed_image_raw(self, buffers: Sequence[bytes], size=None) -> np.ndarray:
        """Each buffer is raw uint8 HWC at ``size`` px: the model's size or ``wire_size``
        (default: ``wire_size`` when the service has one, else the model's)."""
        if size is not None and (isinstance(size, bool) or size not in self._sizes()):
            sizes = " or ".join(str(v) for v in self._sizes())
            raise RequestError(f"'size' must be {sizes}, got {size!r}")
        s = size or self.wire_size or self.model.cfg.vision.image_size
        n = s * s * 3
        bad = [i for i, b in enumerate(buffers) if len(b) != n]
        if bad:
            raise RequestError(f"raw image {bad[0]} has {len(buffers[bad[0]])} bytes, "
                               f"expected {n} ({s}x{s}x3 uint8)")
        return self.embed_image_arrays(
            np.frombuffer(b"".join(buffers), np.uint8).reshape(-1, s, s, 3))

    def embed_image_bytes(self, buffers: Sequence[bytes], wire: bool = False):
        """Encoded images -> (embeddings, ok), decoded on the model's device at the model's
        size, or with ``wire`` at ``wire_size`` (a cheaper decode; the device upsamples). A
        failed decode embeds as a zero row, flagged in ``ok``."""
        if wire and not self.wire_size:
            raise RequestError("wire decode requested but the service has no wire_size")
        size = self.wire_size if wire else self.model.cfg.vision.image_size
        arr, ok = decode_images(list(buffers), size, train=False, device=self.device)
        emb = np.array(self.embed_image_arrays(arr))
        emb[~ok] = 0.0
        return emb, ok

    def similarity(self, texts: Sequence[str], buffers: Sequence[bytes], size=None):
        """Similarity matrix [n_images, n_texts] of raw uint8 images (the cosine, as the
        embeddings are unit-norm unless the service was built with ``normalize=False``); each
        text is embedded once."""
        t = self.embed_texts(texts)
        return self.embed_image_raw(buffers, size) @ t.T

    def stats(self) -> dict:
        out = {
            "uptime_s": round(time.time() - self.started, 1),
            "text": self.text_batcher.stats.snapshot(),
            "image": self.image_batcher.stats.snapshot(),
        }
        if self.image_wire_batcher is not None:
            out["image_wire"] = self.image_wire_batcher.stats.snapshot()
        return out

    def close(self):
        self.text_batcher.stop()
        self.image_batcher.stop()
        if self.image_wire_batcher is not None:
            self.image_wire_batcher.stop()


def _decode_b64(raw, key: str) -> list:
    if not isinstance(raw, list) or not raw:
        raise RequestError(f"'{key}' must be a non-empty list of base64 strings")
    try:
        return [base64.b64decode(s, validate=True) for s in raw]
    except (binascii.Error, TypeError, ValueError) as e:
        raise RequestError(f"'{key}' entry is not base64: {e}") from e


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
                if "images_u8" in req:
                    emb = self.service.embed_image_raw(_decode_b64(req["images_u8"], "images_u8"),
                                                       req.get("size"))
                    return self._json(200, {**self._emb_payload(req, emb),
                                            "decoded": [True] * len(emb)})
                if "images_b64" not in req:
                    raise RequestError("send 'images_u8' (raw uint8 HWC) or 'images_b64' "
                                       "(encoded images)")
                emb, ok = self.service.embed_image_bytes(
                    _decode_b64(req["images_b64"], "images_b64"), wire=bool(req.get("wire")))
                return self._json(200, {**self._emb_payload(req, emb), "decoded": ok.tolist()})
            if self.path == "/v1/similarity":
                if "images_u8" not in req and "images_b64" not in req:
                    raise RequestError("need 'texts' and 'images_u8' or 'images_b64'")
                t = self.service.embed_texts(req.get("texts"))
                if "images_u8" in req:
                    i = self.service.embed_image_raw(_decode_b64(req["images_u8"], "images_u8"),
                                                     req.get("size"))
                    ok = [True] * len(i)
                else:
                    i, ok = self.service.embed_image_bytes(
                        _decode_b64(req["images_b64"], "images_b64"),
                        wire=bool(req.get("wire")))
                    ok = ok.tolist()
                return self._json(200, {"similarity": (i @ t.T).tolist(), "decoded": ok})
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


def load_serving_weights(model, checkpoint: str, ema: bool = False) -> dict:
    """Load the latest checkpoint the training CLI saved under ``checkpoint`` (its
    ``CheckpointManager`` directory, torch files) into ``model`` in place: its EMA weights
    with ``ema`` when the checkpoint kept them, else its trained parameters. Only the EMA
    toggle is tolerated (``--ema`` against a run without ``--model-ema`` serves the trained
    parameters, and says so); a directory without a checkpoint, an unreadable file or a
    checkpoint of another shape raises its own error. Returns what was loaded: ``step`` and
    ``ema`` (whether the EMA weights were served)."""
    import logging
    import os

    from multimodal_tpu_torch.train.checkpoints import CheckpointManager

    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(f"--checkpoint {checkpoint}: no such directory")
    mgr = CheckpointManager(checkpoint)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"--checkpoint {checkpoint}: no saved step in it")
    saved, _ = mgr.restore(step)
    weights = dict(saved["model"])
    use_ema = ema and saved.get("ema") is not None
    if ema and not use_ema:
        logging.getLogger("multimodal_tpu_torch.serving").warning(
            "checkpoint step %d has no EMA weights (trained without --model-ema); serving its "
            "trained parameters", step)
    if use_ema:
        weights.update(saved["ema"])
    with torch.no_grad():
        model.load_state_dict(weights)
    return {"step": step, "ema": use_ema}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import logging

    from multimodal_tpu_torch.models import create_model, load_openai_state_dict

    ap = argparse.ArgumentParser(
        description="Serve CLIP-family embeddings over HTTP with dynamic batching")
    ap.add_argument("--model", default="ViT-B-32")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' requires a GPU (there is no CPU fallback)")
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint directory written by the training CLI "
                         "(<logs>/<name>/checkpoints); its latest step is served")
    ap.add_argument("--ema", action="store_true",
                    help="serve the checkpoint's EMA weights (a run with --model-ema)")
    ap.add_argument("--state-dict", default=None,
                    help="OpenAI-CLIP-format state_dict saved with torch.save; "
                         "omit both this and --checkpoint for seeded random weights")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--quantized", action="store_true", help="serve the int8 W8A8 path")
    ap.add_argument("--wire-size", type=int, default=None,
                    help="also accept images at this smaller size (raw uint8 'images_u8' or "
                         "'wire': true JPEG) and upsample them on the device")
    args = ap.parse_args(argv)
    if args.checkpoint and args.state_dict:
        ap.error("--checkpoint and --state-dict are two sources of weights; give one")
    if args.ema and not args.checkpoint:
        ap.error("--ema needs --checkpoint")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("multimodal_tpu_torch.serving")
    model = create_model(args.model, device=device)
    if args.checkpoint:
        loaded = load_serving_weights(model, args.checkpoint, args.ema)
        log.info("restored step %d from %s (%s weights)", loaded["step"], args.checkpoint,
                 "EMA" if loaded["ema"] else "trained")
    elif args.state_dict:
        load_openai_state_dict(
            model, torch.load(args.state_dict, map_location="cpu", weights_only=True))
    service = EmbeddingService(model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                               quantized=args.quantized, wire_size=args.wire_size)
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
