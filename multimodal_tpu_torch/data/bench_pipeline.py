"""Input-pipeline benchmark: every host-side stage that feeds the device, on the card's host
(port of ``multimodal_tpu/data/bench_pipeline.py``).

    python -m multimodal_tpu_torch.data.bench_pipeline --shards 'dir/train-{000000..000001}.tar'
        [--device cuda|cpu] [--threads 1,4,8,16] [--workers 4] [--model-rate SAMPLES_PER_S]
        [--consumer-ms MS]

Stages, one JSON line each:
  1. tar shard indexing + raw sample iteration (``native/tar_index.cc``);
  2. batched JPEG decode by thread count: train at ``--image-size``, train at ``--wire-size``
     (the --wire-size format) and eval at ``--image-size`` (on ``cuda`` nvJPEG and the resample
     kernel, ``ops/resample.py``; on ``cpu`` the native libjpeg pipeline);
  3. tokenization with the pure-Python BPE (the reference's native BPE fast path is not part
     of the port; its line says so);
  4. the assembled ``WdsReader`` (shards -> shuffled, decoded, tokenized batches on the device);
  5. ``InterleavedReaders`` over ``--workers`` readers (the CLI's ``--workers``);
  6. with ``--consumer-ms`` on ``cuda``: stages 4 and 5 feeding a consumer that queues that many
     ms of device work per batch on its stream without synchronising (the training CLI's
     pattern), with the readers' device work on their own streams (``data.wds.on_own_stream``)
     against the same work on the caller's stream, in turns A B B A.

The summary compares the end-to-end samples/s of stages 4 and 5 with ``--model-rate``, the
samples/s one device's train step consumes (pass the step rate measured on the same card). A
CUDA device's rates include synchronising the device after each batch. Without ``--shards`` a
temporary shard set is synthesized, which needs PIL.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tarfile
import tempfile
import time

import numpy as np

REPEATS = 3  # timed decode calls per (mode, size, threads), after one warm call


def _natural_image(rng, side: int) -> np.ndarray:
    """Natural-statistics test image (smooth gradients + a few shapes): JPEG bitrate and
    entropy-decode cost in the ballpark of real photos."""
    y, x = np.mgrid[0:side, 0:side].astype(np.float32) / side
    fx, fy, ph = rng.uniform(2, 9), rng.uniform(2, 9), rng.uniform(0, 6.28)
    base = 127 + 80 * np.sin(fx * x * 3.14 + ph) * np.cos(fy * y * 3.14)
    img = np.stack([base, 255 * x * rng.uniform(0.4, 1.0),
                    255 * y * rng.uniform(0.4, 1.0)], -1)
    for _ in range(3):
        x0, y0 = rng.integers(0, side - side // 4, 2)
        w, h = rng.integers(side // 8, side // 3, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _make_shards(root: str, num_samples: int, num_shards: int, side: int, quality: int) -> str:
    """Synthesize webdataset shards of JPEGs + short captions (needs PIL)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    per = num_samples // num_shards
    captions = ["a photo of a %s %s" % (c, s) for c in ("red", "green", "blue", "yellow")
                for s in ("circle", "square", "star", "cat")]
    for sh in range(num_shards):
        with tarfile.open(os.path.join(root, f"bench-{sh:04d}.tar"), "w") as tar:
            for i in range(per):
                buf = io.BytesIO()
                Image.fromarray(_natural_image(rng, side)).save(buf, format="JPEG",
                                                                quality=quality)
                for ext, data in (("jpg", buf.getvalue()),
                                  ("txt", captions[i % len(captions)].encode())):
                    info = tarfile.TarInfo(f"{sh:04d}{i:06d}.{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    return os.path.join(root, f"bench-{{0000..{num_shards - 1:04d}}}.tar")


def _emit(records: list, stage: str, value: float, unit: str, **extra) -> dict:
    rec = {"stage": stage, "value": value, "unit": unit, **extra}
    print(json.dumps(rec), flush=True)
    records.append(rec)
    return rec


def _sync(device: str):
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _reader_rate(make, device: str, consume=None) -> tuple:
    """(samples/s after the first batch, batches after it) of one pass over a reader;
    ``consume(batch)``, if given, runs on every batch."""
    it = iter(make())
    first = next(it, None)
    _sync(device)
    if first is None:
        return None, 0
    n = first["text"].shape[0]
    t0 = time.perf_counter()
    batches = 0
    for batch in it:
        if consume is not None:
            consume(batch)
        batches += 1
    _sync(device)
    dt = time.perf_counter() - t0
    return (batches * n / dt if batches else None), batches


def _under_load(records: list, reader, args) -> None:
    """Stage 6: one reader and ``--workers`` interleaved readers feeding a consumer that queues
    ``--consumer-ms`` of spinning per batch on its stream (a train step's place) without
    synchronising, each read in turns A B B A: A with the readers' device work on their own
    streams, B with it on the caller's stream (``wds.on_own_stream`` replaced by a plain call
    for the turn, as the decode ran before it had its own stream)."""
    import torch

    from multimodal_tpu_torch.data import wds
    from multimodal_tpu_torch.data.pipeline import InterleavedReaders

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    cycles = int(args.consumer_ms * 10**7 / start.elapsed_time(end))
    acc = torch.zeros((), device=args.device)

    def consume(batch):  # a step's place: spins, then reads the batch
        torch.cuda._sleep(cycles)
        acc.add_(batch["image"][:, 0, 0, 0].float().sum())

    own = wds.on_own_stream
    caller = lambda device, fn, *a, **k: fn(*a, **k)  # noqa: E731
    rates: dict = {}
    try:
        for arm in ("own", "caller", "caller", "own"):
            wds.on_own_stream = own if arm == "own" else caller
            for workers in (1, args.workers):
                make = (reader if workers == 1 else lambda w=workers: InterleavedReaders(
                    [reader(i, w) for i in range(w)]))
                rate, batches = _reader_rate(make, args.device, consume)
                rates.setdefault((workers, arm), []).append(rate)
                _emit(records, "readers_under_load", rate, "samples/s", workers=workers,
                      decode_stream=arm, consumer_ms=args.consumer_ms, batches=batches)
    finally:
        wds.on_own_stream = own
    for workers in (1, args.workers):
        a, b = np.mean(rates[(workers, "own")]), np.mean(rates[(workers, "caller")])
        _emit(records, "readers_under_load_ratio", float(a / b), "own / caller",
              workers=workers, own=float(a), caller=float(b), consumer_ms=args.consumer_ms)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shards", default=None,
                   help="webdataset pattern; default: synthesize a temporary set (needs PIL)")
    p.add_argument("--device", default="cuda", help="where images decode: cuda or cpu")
    p.add_argument("--num-samples", type=int, default=2048)
    p.add_argument("--num-shards", type=int, default=4)
    p.add_argument("--source-size", type=int, default=320)
    p.add_argument("--quality", type=int, default=92)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--wire-size", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--threads", default="1,4,8,16",
                   help="comma list of decode thread counts")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--model-rate", type=float, default=None,
                   help="samples/s one device's train step consumes (measured on this card)")
    p.add_argument("--consumer-ms", type=float, default=0.0,
                   help="cuda: also time the readers feeding a consumer that queues this many "
                        "ms of device work per batch, own decode streams against the caller's")
    args = p.parse_args(argv)

    from multimodal_tpu_torch.data import tokenizer as tok
    from multimodal_tpu_torch.data.pipeline import InterleavedReaders
    from multimodal_tpu_torch.data.shards import expand_shards
    from multimodal_tpu_torch.data.wds import WdsReader, iter_tar_samples
    from multimodal_tpu_torch.native import bindings as native

    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        from multimodal_tpu_torch.ops.resample import decode_jpegs

        def decode(bufs, size, train, seeds, threads):
            return decode_jpegs(bufs, size, train, seeds, device=args.device,
                                num_threads=threads)
    else:
        def decode(bufs, size, train, seeds, threads):
            return native.decode_batch(bufs, size, train=train, seeds=seeds,
                                       num_threads=threads)

    ncpu = os.cpu_count() or 1
    threads = [int(t) for t in args.threads.split(",")]
    records: list = []
    tmp = None
    pattern = args.shards
    if pattern is None:
        tmp = tempfile.TemporaryDirectory(prefix="mmt_bench_")
        pattern = _make_shards(tmp.name, args.num_samples, args.num_shards, args.source_size,
                               args.quality)
    try:
        shards, _ = expand_shards(pattern, None)
        print(f"[bench_pipeline] shards={len(shards)} device={args.device} cpus={ncpu} "
              f"batch={args.batch_size}", file=sys.stderr, flush=True)

        # -- stage 1: raw tar iteration (index + read, no decode) ------------------------
        t0 = time.perf_counter()
        n = nbytes = 0
        jpegs, texts = [], []
        for shard in shards:
            for sample in iter_tar_samples(shard):
                n += 1
                nbytes += sum(len(v) for k, v in sample.items() if k != "__key__")
                img = sample.get("jpg") or sample.get("jpeg")
                if img and native.is_jpeg(img) and len(jpegs) < args.batch_size:
                    jpegs.append(img)
                    texts.append((sample.get("txt") or b"").decode("utf-8", "replace"))
        dt = time.perf_counter() - t0
        _emit(records, "tar_iterate", n / dt, "samples/s", mb_per_s=nbytes / dt / 1e6,
              shards=len(shards))
        base = len(jpegs)
        while jpegs and len(jpegs) < args.batch_size:  # cycle the real samples up to a batch
            jpegs.append(jpegs[len(jpegs) % base])
            texts.append(texts[len(texts) % base])

        # -- stage 2: batched JPEG decode -------------------------------------------------
        seeds = np.random.default_rng(0).integers(0, 2**63, len(jpegs), dtype=np.uint64)
        for mode, size, train in (("train", args.image_size, True),
                                  ("train", args.wire_size, True),
                                  ("eval", args.image_size, False)):
            for th in threads:
                decode(jpegs[:32], size, train, seeds[:32], th)  # warm
                _sync(args.device)
                t0 = time.perf_counter()
                for _ in range(REPEATS):
                    _, ok = decode(jpegs, size, train, seeds, th)
                _sync(args.device)
                dt = (time.perf_counter() - t0) / REPEATS
                _emit(records, "jpeg_decode", len(jpegs) / dt, "images/s", mode=mode,
                      size=size, threads=th, failed=int((~ok).sum()), device=args.device)

        # -- stage 3: tokenization ----------------------------------------------------------
        batch_texts = (texts or ["a photo of a cat"]) * max(1, 4096 // max(len(texts), 1))
        t0 = time.perf_counter()
        tok.tokenize(batch_texts)
        dt = time.perf_counter() - t0
        _emit(records, "tokenize", len(batch_texts) / dt, "texts/s",
              note="pure-Python BPE; the reference's native BPE fast path is not ported")

        # -- stages 4 and 5: assembled readers ----------------------------------------------
        def reader(worker_id=0, num_workers=1):
            return WdsReader(pattern, batch_size=args.batch_size, train=True,
                             image_size=args.image_size, seed=0, num_workers=num_workers,
                             worker_id=worker_id, device=args.device)

        e2e, batches = _reader_rate(reader, args.device)
        _emit(records, "wds_reader_e2e", e2e, "samples/s", batches=batches)
        inter, ib = _reader_rate(lambda: InterleavedReaders(
            [reader(w, args.workers) for w in range(args.workers)]), args.device)
        _emit(records, "interleaved_readers_e2e", inter, "samples/s", batches=ib,
              workers=args.workers)

        if args.consumer_ms and args.device.startswith("cuda"):
            _under_load(records, reader, args)

        summary = {"stage": "summary", "wds_reader_samples_per_s": e2e,
                   "interleaved_samples_per_s": inter, "model_rate": args.model_rate,
                   "cpus": ncpu, "device": args.device}
        if args.model_rate:
            summary["reader_over_model"] = e2e / args.model_rate if e2e else None
            summary["interleaved_over_model"] = inter / args.model_rate if inter else None
        print(json.dumps(summary), flush=True)
        records.append(summary)
        return records
    finally:
        if tmp is not None:
            tmp.cleanup()


if __name__ == "__main__":
    main()
