"""CLI: extract embeddings -> fit a vMF mixture -> evaluate -> save JSON results (port of
``multimodal_tpu/research/fit_mixture.py``).

CLIP embeddings from a text file, an image directory, a ``.npy`` array or synthetic clusters;
a seeded train/test split; the EM fit (``research.vmf_mixture``) on ``--device``; the
log-likelihoods and the test perplexity; the parameters, all as JSON. Run:

    python -m multimodal_tpu_torch.research.fit_mixture --text-file captions.txt --components 5
    python -m multimodal_tpu_torch.research.fit_mixture --image-dir ./photos --components 3
    python -m multimodal_tpu_torch.research.fit_mixture --synthetic 1000 --dim 64 [--device cpu]

The encoder (``--text-file``, ``--image-dir``) is ``create_model(--model)`` with seeded weights,
or ``--pretrained`` (an OpenAI-format torch file or an Orbax directory), in bfloat16.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _synthetic_embeddings(n: int, dim: int, components: int, seed: int) -> np.ndarray:
    """Well-separated vMF-ish clusters (papers-1-and-2/clip_embeddings.py create_sample_data)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(components):
        mu = rng.normal(size=dim)
        mu /= np.linalg.norm(mu)
        x = mu + 0.15 * rng.normal(size=(n // components, dim))
        out.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    return np.concatenate(out)


def main(argv=None):
    p = argparse.ArgumentParser("vMF mixture fitting")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--text-file", help="one caption per line -> text embeddings")
    src.add_argument("--image-dir", help="directory of images -> image embeddings")
    src.add_argument("--embeddings", help=".npy array of precomputed embeddings")
    src.add_argument("--synthetic", type=int, help="generate N synthetic embeddings")
    p.add_argument("--model", default="ViT-B-32")
    p.add_argument("--pretrained", default=None, help="checkpoint for the encoder")
    p.add_argument("--components", type=int, default=3)
    p.add_argument("--dim", type=int, default=64, help="synthetic dimensionality")
    p.add_argument("--test-fraction", type=float, default=0.2)
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="vmf_mixture_results.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.synthetic:
        x = _synthetic_embeddings(args.synthetic, args.dim, args.components, args.seed)
    elif args.embeddings:
        x = np.load(args.embeddings)
    else:
        import torch

        from multimodal_tpu_torch.inference import Embedder
        from multimodal_tpu_torch.models import create_model, load_pretrained

        model = create_model(args.model, dtype=torch.bfloat16, device=args.device,
                             seed=args.seed)
        if args.pretrained:
            load_pretrained(model, args.pretrained)
        emb = Embedder(model)
        if args.text_file:
            with open(args.text_file) as f:
                texts = [line.strip() for line in f if line.strip()]
            x = emb.embed_texts(texts)
        else:
            paths = [
                os.path.join(args.image_dir, fn)
                for fn in sorted(os.listdir(args.image_dir))
                if fn.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
            ]
            x, ok = emb.embed_image_files(paths, image_size=model.cfg.vision.image_size)
            x = x[ok]

    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(x))
    n_test = int(len(x) * args.test_fraction)
    test, train = x[order[:n_test]], x[order[n_test:]]

    from multimodal_tpu_torch.research import fit_von_mises_fisher_mixture

    em = fit_von_mises_fisher_mixture(
        train, n_components=args.components, max_iter=args.max_iter, seed=args.seed,
        device=args.device,
    )
    results = {
        "model": em.to_dict(),
        "train_log_likelihood": em.log_likelihood(train),
        "test_log_likelihood": em.log_likelihood(test) if n_test else None,
        "test_perplexity": em.perplexity(test) if n_test else None,
        "n_train": int(len(train)),
        "n_test": int(n_test),
        "dim": int(x.shape[1]),
    }
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"fit {args.components} components on {len(train)} pts "
          f"(dim {x.shape[1]}): train LL {results['train_log_likelihood']:.4f}"
          + (f", test LL {results['test_log_likelihood']:.4f}" if n_test else "")
          + f" -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
