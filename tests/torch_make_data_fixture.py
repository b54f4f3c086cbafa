"""Write the input-path fixture of the port's tests and of ``chip_smoke.py`` phase 14 into
``tests/data/torch_shards/`` (needs PIL and the JAX package; run from the repo root):

    python tests/torch_make_data_fixture.py

- the shapes webdataset, ``scripts/make_shapes_dataset.py --train 256 --val 64 --size 128
  --shard-size 128 --seed 0``: ``train-000000.tar``, ``train-000001.tar``, ``val-000000.tar``
  and ``classes.json``;
- ``photos-000000.tar``: 16 smooth JPEGs (the ``_natural_image`` kind of
  ``multimodal_tpu/data/bench_pipeline.py``, quality 90) at sides from 96 to 1100 px, so that
  a 64-px decode reaches every libjpeg DCT scale, then one corrupt ``.jpg`` member and one
  ``.png`` member, each with a caption;
- ``expected_eval64.npy`` / ``expected_train64.npy``: the JAX package's ``decode_images`` of the
  photo shard's images at 64 px, eval, and train with seeds ``0..N-1``; ``photos.json`` the
  members' keys and ok flags.

Everything is drawn from fixed seeds; ``tests/test_torch_native_data.py`` regenerates the
expected arrays from the JAX package and holds them equal to the committed ones.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_shards")
PHOTO_SIDES = [(96, 128), (160, 120), (200, 260), (257, 257), (320, 240), (300, 410),
               (384, 512), (480, 360), (520, 700), (640, 480), (700, 560), (768, 1024),
               (900, 600), (1000, 750), (1024, 1100), (1100, 1100)]  # (height, width)
PHOTO_SIZE = 64


def photo_members() -> list[tuple[str, bytes, bytes]]:
    """(key, image bytes, caption) of the photo shard, in member order."""
    from PIL import Image

    from multimodal_tpu.data.bench_pipeline import _natural_image

    rng = np.random.default_rng(0)
    members = []
    for i, (h, w) in enumerate(PHOTO_SIDES):
        arr = _natural_image(rng, max(h, w))[:h, :w]
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(arr)).save(buf, format="JPEG", quality=90)
        members.append((f"photo{i:03d}", buf.getvalue(), f"a smooth photo number {i}".encode()))
    corrupt = b"\xff\xd8\xff\xe0" + rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    members.append(("photo016", corrupt, b"a corrupt jpeg"))
    buf = io.BytesIO()
    Image.fromarray(_natural_image(rng, 150)).save(buf, format="PNG")
    members.append(("photo017", buf.getvalue(), b"a png image"))
    return members


def write_tar(path: str, members: list[tuple[str, bytes, bytes]], image_ext=None):
    with tarfile.open(path, "w") as tar:
        for key, image, cap in members:
            ext = image_ext or ("png" if image[:4] == b"\x89PNG" else "jpg")
            for name, payload in ((f"{key}.{ext}", image), (f"{key}.txt", cap)):
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))


def expected(buffers: list[bytes]) -> dict:
    """The JAX package's decode of the photo images at PHOTO_SIZE: eval, and train with seeds
    0..N-1."""
    from multimodal_tpu.data.wds import decode_images

    n = len(buffers)
    ev, ok_e = decode_images(buffers, PHOTO_SIZE, train=False)
    tr, ok_t = decode_images(buffers, PHOTO_SIZE, train=True, seeds=np.arange(n, dtype=np.uint64),
                             rng=np.random.default_rng(0))
    return {"eval": ev, "train": tr, "ok_eval": ok_e, "ok_train": ok_t}


def main():
    os.makedirs(OUT, exist_ok=True)
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_shapes_dataset.py"),
                    "--out", OUT, "--train", "256", "--val", "64", "--size", "128",
                    "--shard-size", "128", "--seed", "0"], check=True)
    members = photo_members()
    write_tar(os.path.join(OUT, "photos-000000.tar"), members)
    exp = expected([m[1] for m in members])
    np.save(os.path.join(OUT, "expected_eval64.npy"), exp["eval"])
    np.save(os.path.join(OUT, "expected_train64.npy"), exp["train"])
    with open(os.path.join(OUT, "photos.json"), "w") as f:
        json.dump({"keys": [m[0] for m in members], "size": PHOTO_SIZE,
                   "sides": PHOTO_SIDES, "ok_eval": exp["ok_eval"].tolist(),
                   "ok_train": exp["ok_train"].tolist()}, f, indent=1)
    total = sum(os.path.getsize(os.path.join(OUT, p)) for p in os.listdir(OUT))
    print(f"wrote {OUT}: {total / 2**20:.2f} MiB")


if __name__ == "__main__":
    main()
