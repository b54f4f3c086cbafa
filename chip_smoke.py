#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the result lines):
  1. the card: torch.cuda.is_available() and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ops/csrc with nvcc;
  3. the block-attention kernel against its plain PyTorch version on the card, at the
     ViT-B/32 tower shapes (vision S=50 W=768 H=12, text S=77 W=512 H=8 causal) and
     S=197, in float32 (max abs error <= 1e-4 * max|plain|) and bfloat16 (<= 2e-2 *
     max|plain|), with CUDA-event times at B=256;
  4. serving: ViT-B/32 in float32 with seeded random weights behind the HTTP server,
     answering text, image and similarity requests; the kernel's launch count over those
     requests must be at least 12 per tower encode, and the served embeddings must match
     an encode through the plain version (cosine >= 0.9999);
  5. throughput at bucket 256 and single-request p50 latency.
The second-to-last line is the kernel summary (JSON), the last line the device record.
"""

from __future__ import annotations

import base64
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

MODEL = "ViT-B-32"
SOURCE = "multimodal_tpu_torch/ops/csrc/block_attention_fwd.cu"
REPLACES = "multimodal_tpu/ops/block_attention.py:200"
CASES = [  # (tower, batch, seq, width, heads, causal)
    ("vision", 1, 50, 768, 12, False),
    ("vision", 3, 50, 768, 12, False),
    ("vision", 256, 50, 768, 12, False),
    ("text", 1, 77, 512, 8, True),
    ("text", 256, 77, 512, 8, True),
    ("vision-S197", 4, 197, 768, 12, False),
]
CAPTIONS = ["a photo of a cat", "two dogs playing in the snow", "a red car on a bridge",
            "東京の夜景 ✨"]


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(torch, ba) -> dict:
    """Kernel vs plain at every case and both dtypes; times at B=256."""
    worst_f32, timing, failures = 0.0, {}, []
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for tower, b, s, w, heads, causal in CASES:
            g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
            rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
            x = rnd(b, s, w).to(dtype)
            ws = []
            for _ in range(4):
                ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
            kern = lambda: ba.block_attention(x, *ws, heads=heads, causal=causal)  # noqa: E731
            plain = lambda: ba.block_attention_reference(  # noqa: E731
                x, *ws, heads=heads, causal=causal)
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ref_max = want.abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= rel_tol * ref_max
            name = str(dtype).replace("torch.", "")
            line = (f"kernel {tower:<11} B={b:<3} S={s} W={w} H={heads} causal={causal!s:<5} "
                    f"{name:<8} max_abs_err={err:.3e} tol={rel_tol * ref_max:.3e} "
                    f"({rel_tol:g} x max|plain|={ref_max:.3f}) {'ok' if ok else 'MISMATCH'}")
            if b == 256:
                k_ms, p_ms = cuda_ms(kern), cuda_ms(plain)
                timing[(tower, name)] = (k_ms, p_ms)
                line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
            print(line, flush=True)
            if not ok:
                failures.append(line)
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err)
    if failures:
        fail(f"{len(failures)} kernel/plain mismatches")
    return {"worst_f32": worst_f32, "timing": timing}


def post(url: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def check_embeddings(name: str, emb, n: int):
    emb = np.asarray(emb, np.float32)
    if emb.shape != (n, 512) or not np.isfinite(emb).all():
        fail(f"{name}: shape {emb.shape} (want ({n}, 512)) or non-finite values")
    norms = np.linalg.norm(emb, axis=-1)
    if np.abs(norms - 1).max() > 1e-4:
        fail(f"{name}: embeddings not unit norm ({norms})")
    return emb


def plain_encode(layers, ba, embedder, tokens, images):
    """The same encodes with every block-attention call routed to the plain version."""
    def plain_block_attention(x, *ws, heads, causal=False, ln_scale=None, ln_bias=None,
                              residual=False):
        xn = ba.ln_rows(x, ln_scale, ln_bias, ba.LN_EPS) if ln_scale is not None else x
        out = ba.block_attention_reference(xn, *ws, heads=heads, causal=causal)
        return x + out if residual else out

    kernel_path = layers.block_attention
    layers.block_attention = plain_block_attention
    try:
        return embedder.encode_tokens(tokens), embedder.encode_images(images)
    finally:
        layers.block_attention = kernel_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are enabled; the float32 references must be true float32")

    from multimodal_tpu_torch.data.tokenizer import tokenize
    from multimodal_tpu_torch.models import create_model, layers
    from multimodal_tpu_torch.ops import _build
    from multimodal_tpu_torch.ops import block_attention as ba
    from multimodal_tpu_torch.serving import EmbeddingService, make_server

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> {lib_path}", flush=True)
    for ln in ptxas:
        print(f"  ptxas {ln}")

    print("phase 3 kernel vs plain on the card", flush=True)
    kernels = phase_kernels(torch, ba)

    print("phase 4 serving", flush=True)
    t0 = time.perf_counter()
    model = create_model(MODEL, device="cuda", seed=0)
    svc = EmbeddingService(model, max_batch=256, max_wait_ms=5.0)
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    print(f"  model {MODEL} float32 on {kind} built and served in "
          f"{time.perf_counter() - t0:.2f} s at {url}", flush=True)
    try:
        images = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)
        images_u8 = [base64.b64encode(a.tobytes()).decode() for a in images]
        ba.reset_launch_counts()
        code_t, text = post(url + "/v1/embed/text", {"texts": CAPTIONS})
        code_i, image = post(url + "/v1/embed/image", {"images_u8": images_u8})
        code_s, sim = post(url + "/v1/similarity", {"texts": CAPTIONS, "images_u8": images_u8})
        health, stats = get(url + "/healthz"), get(url + "/v1/stats")
        launches = ba.launch_counts()["block_attention_fwd"]
        if (code_t, code_i, code_s) != (200, 200, 200):
            fail(f"HTTP status text={code_t} image={code_i} similarity={code_s}: "
                 f"{text.get('error')} {image.get('error')} {sim.get('error')}")
        txt = check_embeddings("text", text["embeddings"], len(CAPTIONS))
        img = check_embeddings("image", image["embeddings"], len(images))
        sims = np.asarray(sim["similarity"], np.float32)
        if sims.shape != (3, len(CAPTIONS)) or np.abs(sims - img @ txt.T).max() > 1e-4:
            fail(f"similarity {sims.shape} disagrees with the embedded rows")
        encodes = stats["text"]["batches"] + stats["image"]["batches"]
        print(f"  healthz {health}", flush=True)
        print(f"  stats text={stats['text']} image={stats['image']}", flush=True)
        print(f"  block_attention_fwd launches during serving: {launches} over {encodes} "
              f"tower encodes (need >= {12 * encodes})", flush=True)
        if encodes < 4 or launches < 12 * encodes:
            fail("the serving path did not run the block-attention kernel in every block")
        tokens = tokenize(CAPTIONS, model.cfg.text.context_length)
        p_txt, p_img = plain_encode(layers, ba, svc._embedder, tokens, images)
        cos_t = float((np.sum(p_txt * txt, -1)).min())
        cos_i = float((np.sum(p_img * img, -1)).min())
        print(f"  served vs plain-version encode: min cosine text={cos_t:.7f} "
              f"image={cos_i:.7f} (need >= 0.9999)", flush=True)
        if min(cos_t, cos_i) < 0.9999:
            fail("served embeddings disagree with the plain-version encode")

        print("phase 5 throughput", flush=True)
        emb = svc._embedder
        rng = np.random.default_rng(1)
        batch_img = rng.integers(0, 256, (256, 224, 224, 3), dtype=np.uint8)
        batch_tok = np.repeat(tokens, 64, axis=0)
        for name, fn, arg in (("image", emb.encode_images, batch_img),
                              ("text", emb.encode_tokens, batch_tok)):
            fn(arg)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(arg)
            rate = 5 * 256 / (time.perf_counter() - t0)
            print(f"  {name} encodes/s at bucket 256 (float32, host clock incl. transfer): "
                  f"{rate:.1f} [{card}]", flush=True)
        for name, route, payload in (("text", "/v1/embed/text", {"texts": CAPTIONS[:1]}),
                                     ("image", "/v1/embed/image",
                                      {"images_u8": images_u8[:1]})):
            lat = []
            for _ in range(21):
                t0 = time.perf_counter()
                code, _ = post(url + route, payload)
                lat.append((time.perf_counter() - t0) * 1e3)
                if code != 200:
                    fail(f"latency probe {route} returned {code}")
            print(f"  single-request {name} p50 latency: {float(np.median(lat[1:])):.2f} ms "
                  f"[{card}]", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)

    k_ms, p_ms = kernels["timing"][("vision", "float32")]
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "block_attention_fwd", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": kernels["worst_f32"],
        "ms": k_ms, "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
