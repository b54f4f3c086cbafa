#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and its training step once on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the result lines):
  1. the card: torch.cuda.is_available() and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ops/csrc with nvcc (one process per source, in parallel);
  3. the block-attention forward and backward kernels against their plain PyTorch versions
     on the card, at the ViT-B/32 tower shapes (vision S=50 W=768 H=12, text S=77 W=512
     H=8 causal), S=197 and S=257 (W=1024 H=16), in float32 (max abs error of every
     output <= 1e-4 * max|plain|) and bfloat16 (<= 2e-2 * max|plain|), with CUDA-event
     times at B=256;
  4. serving: ViT-B/32 in float32 with seeded random weights behind the HTTP server,
     answering text, image and similarity requests; the forward kernel's launch count over
     those requests must be at least 12 per tower encode, and the served embeddings must
     match an encode through the plain version (cosine >= 0.9999);
  5. serving throughput at bucket 256 and single-request p50 latency;
  6. training: ViT-B/32 with seeded weights, the fused AdamW (cosine schedule, weight decay
     0.1, clip 1.0) and a fixed synthetic uint8 batch of 256. float32: 2 steps through the
     kernels against 2 from the same start with every block's attention routed to the
     plain version (losses within 1e-5 relative, grad norms within 1e-4, every gradient
     leaf of step 1 within 1e-3 * max|leaf|, at least 24 backward-kernel launches per
     step); bfloat16: 5 steps, every loss and grad norm finite and the loss falling.
     Samples/s and peak memory for both.
The second-to-last line is the kernel summary (JSON), the last line the device record.
"""

from __future__ import annotations

import base64
import contextlib
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

MODEL = "ViT-B-32"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "block_attention_fwd": ("multimodal_tpu_torch/ops/csrc/block_attention_fwd.cu",
                            "multimodal_tpu/ops/block_attention.py:200"),
    "block_attention_bwd": ("multimodal_tpu_torch/ops/csrc/block_attention_bwd.cu",
                            "multimodal_tpu/ops/block_attention.py:272 (_bwd_kernel) and "
                            ":386 (_bwd_kernel_large)"),
}
BWD_OUTPUTS = ("dx", "dq", "dk", "dv", "attnpre")
CASES = [  # (tower, batch, seq, width, heads, causal)
    ("vision", 1, 50, 768, 12, False),
    ("vision", 3, 50, 768, 12, False),
    ("vision", 256, 50, 768, 12, False),
    ("text", 1, 77, 512, 8, True),
    ("text", 256, 77, 512, 8, True),
    ("vision-S197", 4, 197, 768, 12, False),
    ("vision-S257", 2, 257, 1024, 16, False),
]
TRAIN_BATCH = 256
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
    """Forward and backward kernels vs plain at every case and both dtypes; times at B=256."""
    worst_f32 = dict.fromkeys(KERNELS, 0.0)
    timing, failures = {}, []
    for dtype, rel_tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).replace("torch.", "")
        for tower, b, s, w, heads, causal in CASES:
            g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
            rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
            x = rnd(b, s, w).to(dtype)
            ws = []
            for _ in range(4):
                ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
            dy = rnd(b, s, w).to(dtype)
            kw = dict(heads=heads, causal=causal)
            runs = {
                "block_attention_fwd": (lambda: ba.block_attention(x, *ws, **kw),
                                        lambda: ba.block_attention_reference(x, *ws, **kw)),
                "block_attention_bwd": (lambda: ba.block_attention_bwd(x, dy, *ws, **kw),
                                        lambda: ba.block_attention_bwd_reference(x, dy, *ws,
                                                                                 **kw)),
            }
            for kernel, (kern, plain) in runs.items():
                got, want = kern(), plain()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                torch.cuda.synchronize()
                errs, ok = [], True
                for gt, wt in zip(got, want):
                    gt, wt = gt.float(), wt.float()
                    err, ref_max = (gt - wt).abs().max().item(), wt.abs().max().item()
                    ok = ok and bool(torch.isfinite(gt).all()) and err <= rel_tol * ref_max
                    errs.append((err, ref_max))
                err = max(e for e, _ in errs)
                detail = " ".join(f"{o}={e:.2e}/{m:.2e}" for o, (e, m) in zip(
                    BWD_OUTPUTS if len(errs) > 1 else ("y",), errs))
                line = (f"{kernel} {tower:<11} B={b:<3} S={s} W={w} H={heads} "
                        f"causal={causal!s:<5} {name:<8} max_abs_err/max|plain| {detail} "
                        f"(tol {rel_tol:g} x max|plain|) {'ok' if ok else 'MISMATCH'}")
                if b == 256:
                    k_ms, p_ms = cuda_ms(kern), cuda_ms(plain)
                    timing[(kernel, tower, name)] = (k_ms, p_ms)
                    line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
                print(line, flush=True)
                if not ok:
                    failures.append(line)
                if dtype == torch.float32:
                    worst_f32[kernel] = max(worst_f32[kernel], err)
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


@contextlib.contextmanager
def plain_attention(layers, ba):
    """Every block-attention call of the model routed to the plain version (its gradient
    then comes from torch's autograd of that version)."""
    def plain_block_attention(x, *ws, heads, causal=False, ln_scale=None, ln_bias=None,
                              residual=False):
        xn = ba.ln_rows(x, ln_scale, ln_bias, ba.LN_EPS) if ln_scale is not None else x
        out = ba.block_attention_reference(xn, *ws, heads=heads, causal=causal)
        return x + out if residual else out

    kernel_path = layers.block_attention
    layers.block_attention = plain_block_attention
    try:
        yield
    finally:
        layers.block_attention = kernel_path


def train_steps(torch, ba, model, batch, steps: int, grads_at: int = -1):
    """``steps`` training steps from a fresh optimizer as bench.py builds it; returns the
    per-step metrics and launch counts, the gradients after step ``grads_at`` (0-based)
    and the host-clock seconds of every step after the first."""
    from multimodal_tpu_torch.train import (
        TrainState, make_optimizer, make_schedule, make_train_step)

    opt = make_optimizer(model.named_parameters(),
                         make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
                         weight_decay=0.1, grad_clip_norm=1.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    metrics, counts, grads, timed = [], [], None, 0.0
    for i in range(steps):
        torch.cuda.synchronize()
        ba.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        if i > 0:
            timed += time.perf_counter() - t0
        counts.append(ba.launch_counts())
        metrics.append({k: float(v) for k, v in m.items()})
        if i == grads_at:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return metrics, counts, grads, timed


def phase_train(torch, ba, layers, card: str) -> dict:
    """ViT-B/32 training: float32 kernel path vs plain path, then bfloat16."""
    from multimodal_tpu_torch.models import create_model

    rng = np.random.default_rng(0)
    model = create_model(MODEL, device="cuda", seed=0)
    c = model.cfg
    batch = {  # the synthetic uint8 batch of bench.py, normalized on the card
        "image": torch.from_numpy(rng.integers(
            0, 256, (TRAIN_BATCH, c.vision.image_size, c.vision.image_size, 3),
            dtype=np.uint8)).cuda(),
        "text": torch.from_numpy(rng.integers(
            1, c.text.vocab_size - 1, (TRAIN_BATCH, c.text.context_length))).cuda(),
    }
    start = {k: v.clone() for k, v in model.state_dict().items()}
    blocks = c.vision.layers + c.text.layers

    torch.cuda.reset_peak_memory_stats()
    k_metrics, k_counts, k_grads, k_time = train_steps(torch, ba, model, batch, 5, grads_at=0)
    k_peak = torch.cuda.max_memory_allocated()
    model.load_state_dict(start)
    with plain_attention(layers, ba):
        torch.cuda.reset_peak_memory_stats()
        p_metrics, p_counts, p_grads, p_time = train_steps(torch, ba, model, batch, 5,
                                                           grads_at=0)
        p_peak = torch.cuda.max_memory_allocated()
    for i in range(2):
        km, pm = k_metrics[i], p_metrics[i]
        print(f"  float32 step {i + 1}: loss kernel={km['loss']:.7f} plain={pm['loss']:.7f} "
              f"grad_norm kernel={km['grad_norm']:.6f} plain={pm['grad_norm']:.6f} "
              f"launches {k_counts[i]} (plain path {p_counts[i]})", flush=True)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss_rel = max(rel(k_metrics[i]["loss"], p_metrics[i]["loss"]) for i in range(2))
    norm_rel = max(rel(k_metrics[i]["grad_norm"], p_metrics[i]["grad_norm"]) for i in range(2))
    # per leaf |kernel - plain| / max|plain|; a leaf whose exact gradient is zero (the
    # attention key biases: softmax ignores a per-row constant) holds rounding noise on both
    # sides, so the scale has a floor of 1e-3 x the largest gradient of the model
    g_max = max(g.abs().max() for g in p_grads.values())
    leaf_rel = {n: ((k_grads[n] - g).abs().max() / torch.clamp(g.abs().max(), min=1e-3 * g_max))
                for n, g in p_grads.items()}
    leaf_rel = {n: v.item() for n, v in leaf_rel.items()}
    worst_leaf = max(leaf_rel, key=leaf_rel.get)
    bwd_per_step = min(cnt["block_attention_bwd"] for cnt in k_counts)
    print(f"  float32 kernel vs plain: loss rel diff {loss_rel:.3e} (need <= 1e-5), grad norm "
          f"rel diff {norm_rel:.3e} (need <= 1e-4), worst grad leaf {worst_leaf} "
          f"{leaf_rel[worst_leaf]:.3e} x max|leaf| (need <= 1e-3), block_attention_bwd "
          f"launches per step >= {bwd_per_step} (need >= {blocks})", flush=True)
    if not all(np.isfinite([m[k] for m in k_metrics + p_metrics for k in m])):
        fail("non-finite float32 loss or grad norm")
    if loss_rel > 1e-5 or norm_rel > 1e-4 or leaf_rel[worst_leaf] > 1e-3:
        fail("the float32 kernel path disagrees with the plain path")
    if bwd_per_step < blocks or any(n for cnt in p_counts for n in cnt.values()):
        fail("the training step did not run the backward kernel in every block")
    k_rate, p_rate = 4 * TRAIN_BATCH / k_time, 4 * TRAIN_BATCH / p_time
    print(f"  float32 train samples/s at B={TRAIN_BATCH} (steps 2-5, host clock): kernel path "
          f"{k_rate:.1f}, plain path {p_rate:.1f}; peak memory kernel {k_peak / 2**30:.2f} GiB, "
          f"plain {p_peak / 2**30:.2f} GiB [{card}]", flush=True)
    launches = {k: sum(cnt[k] for cnt in k_counts) for k in KERNELS}
    del model, start, k_grads, p_grads
    torch.cuda.empty_cache()

    model = create_model(MODEL, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    b_metrics, b_counts, _, b_time = train_steps(torch, ba, model, batch, 5)
    b_peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in b_metrics]
    norms = [m["grad_norm"] for m in b_metrics]
    print(f"  bfloat16 losses {[round(v, 5) for v in losses]} grad norms "
          f"{[round(v, 4) for v in norms]}", flush=True)
    b_rate = 4 * TRAIN_BATCH / b_time
    print(f"  bfloat16 train samples/s at B={TRAIN_BATCH} (steps 2-5, host clock): "
          f"{b_rate:.1f}; peak memory {b_peak / 2**30:.2f} GiB [{card}]", flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail("non-finite bfloat16 loss or grad norm")
    if not losses[-1] < losses[0]:
        fail("the bfloat16 loss did not fall over 5 steps on a fixed batch")
    if min(cnt["block_attention_bwd"] for cnt in b_counts) < blocks:
        fail("the bfloat16 training step did not run the backward kernel in every block")
    for k in KERNELS:
        launches[k] += sum(cnt[k] for cnt in b_counts)
    return {"launches": launches}


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
        with plain_attention(layers, ba):
            p_txt = svc._embedder.encode_tokens(tokens)
            p_img = svc._embedder.encode_images(images)
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
    del model, svc
    torch.cuda.empty_cache()

    print("phase 6 training", flush=True)
    train = phase_train(torch, ba, layers, card)

    # launches: the serving run (forward only) plus the kernel-path training steps
    launches = {"block_attention_fwd": launches + train["launches"]["block_attention_fwd"],
                "block_attention_bwd": train["launches"]["block_attention_bwd"]}
    entries = []
    for name, (source, replaces) in KERNELS.items():
        k_ms, p_ms = kernels["timing"][(name, "vision", "float32")]
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": kernels["worst_f32"][name],
                        "ms": k_ms, "plain_ms": p_ms})
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
