"""The training CLI: ``python -m multimodal_tpu_torch.train.run ...`` (port of
``multimodal_tpu/train/run.py``).

    python -m multimodal_tpu_torch.train.run --dataset-type synthetic --model ViT-B-32 \
        --batch-size 256 --epochs 1 --logs ./logs [--device cpu]
    python -m torch.distributed.run --nproc-per-node 2 -m multimodal_tpu_torch.train.run \
        --device cpu --fsdp ...

The same flags (``train.params``), the same experiment layout (``<logs>/<name>/params.txt``,
``out.log``, ``results.jsonl``, ``checkpoints/<step>/``) and the same resume semantics as the
reference: parse the flags, build the model (``--pretrained`` from an OpenAI-format torch
file or an Orbax directory of the JAX package's parameters), the optimizer with its freeze
mode, the data, the LR schedule; resume the latest checkpoint (mid-epoch saves fast-forward
the data stream); then per epoch train, evaluate (the EMA weights with ``--model-ema``) and
checkpoint. ``--epochs 0`` only evaluates. The run is on the GPU unless
``--device cpu`` asks for the CPU; without a CUDA device it raises.

Each step's ``torch.Generator`` (patch dropout, the vclip draws) is seeded from
``numpy.random.SeedSequence([seed + 1, epoch, i])``, a fixed mix of the run's seed, the epoch
and the step's index in it, so a resumed run replays the draws of an uninterrupted one.
SIGTERM sets a local flag that the loop reads after every step: it checkpoints and exits.

Distributed runs, one process per device: under ``python -m torch.distributed.run`` (or with
``--multihost --dist-url tcp://host:port`` and RANK / WORLD_SIZE set), or with any mesh flag,
the run joins a process group (NCCL on the GPU, gloo with ``--device cpu``; a world of one
rank without a launcher) and builds the reference's mesh: ``('data', 'model')`` with
``--tensor-parallel``, ``('data', 'expert')`` with ``--expert-parallel``, ``('replica',
'data')`` with ``--dcn-slices``, else ``('data',)``; then places the parameters (``--fsdp``,
TP, EP; whole otherwise) and trains the data-parallel step (``train.engine``). ``--batch-size``
is the global batch: each rank takes its rows (synthetic data: its slice of the global stream;
the readers: their rank's shards). Rank 0 names the experiment and every rank takes its name;
rank 0 writes the logs and the checkpoints, which hold whole tensors (gathered from every rank
under a placement that splits parameters), so a run resumes at any world size. A SIGTERM on any
rank stops every rank after the same step: the flag's all-reduce (over a gloo group, so it never
waits on the device) is started after each step and read after the next, and the loop holds no
blocking collective of its own.

The data section is the reference's: ``--dataset-type`` (``auto`` picks ``webdataset`` for a
``.tar`` pattern, ``synthetic`` without ``--train-data``, else ``coco``), the webdataset
readers with ``--workers`` shard-disjoint workers merged round-robin, ``--dataset-resampled``
and ``--train-data-upsampling-factors``, the file-list datasets with the CSV keys, ``--aug-cfg``,
the semantic encoder for ``--nl_semantic_supervision`` (hashing, or with
``--semantic-model-path`` a local transformers snapshot), and a real ``--val-data``. Images
decode on the run's device (on the GPU through nvJPEG and the resample kernel) at
``--wire-size`` when it is set, the step upsampling them to the model's resolution.

The evaluations, after every ``--zeroshot-frequency`` / ``--retrieval-frequency`` epochs and
in eval-only mode: zero-shot classification on the sets whose path flags are given
(``ZERO_SHOT_DATASETS``, stock layouts or folder-per-class), COCO / Flickr retrieval through
``Embedder``, and in eval-only mode the linear probe (``--linear-probe-train``) and the
captioning evaluation (``--captioning-eval``: a caption decoder trained on the frozen image
embeddings, scored by BLEU on held-out images).

``--profile-steps N`` traces N steps of epoch 0 with ``torch.profiler``, from its second
step, into ``<logs>/<name>/profile`` (``profiling.trace``); the device is synchronized before
the trace stops, and an epoch that ends first stops it there.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import shutil
import signal
import subprocess
import threading
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from multimodal_tpu_torch.data.augment import parse_aug_cfg
from multimodal_tpu_torch.data.datasets import build_dataset
from multimodal_tpu_torch.data.pipeline import DataInfo
from multimodal_tpu_torch.data.semantic import make_semantic_encoder
from multimodal_tpu_torch.inference import Embedder, model_mode
from multimodal_tpu_torch.models import create_model, load_pretrained
from multimodal_tpu_torch.models.config import VariationalConfig
from multimodal_tpu_torch.parallel import mesh as meshes
from multimodal_tpu_torch.parallel.collectives import broadcast_object
from multimodal_tpu_torch.parallel.placement import Placement
from multimodal_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_tpu_torch.train.engine import TrainState, batch_images, init_ema, make_train_step
from multimodal_tpu_torch.train.freeze import finetune_mask, freeze_optimizer, lock_mask
from multimodal_tpu_torch.train.logging_utils import (
    AverageMeter,
    ExperimentLogger,
    ThroughputMeter,
    setup_logging,
)
from multimodal_tpu_torch.train.optimizer import make_optimizer
from multimodal_tpu_torch.train.params import parse_args
from multimodal_tpu_torch.train.schedules import make_schedule

log = logging.getLogger(__name__)

# set by SIGTERM (an eviction); the train loop reads it after every step, saves and exits
_PREEMPTED = threading.Event()

ZERO_SHOT_DATASETS = {  # CLI flag -> its class table in eval.metadata
    "imagenet_val": "imagenet",
    "imagenet_v2": "imagenet-v2",
    "imagenet_s": "imagenet-sketch",
    "imagenet_a": "imagenet-a",
    "imagenet_o": "imagenet-o",
    "imagenet_r": "imagenet-r",
    "imagenet_c": "imagenet",  # the corruption sets share ImageNet's classes
    "cifar10": "cifar10",
    "cifar100": "cifar100",
    "flowers": "flowers102",
    "food": "food101",
    "stanford_cars": "stanford-cars",
}


def _install_preemption_handler():
    def _on_sigterm(signum, frame):
        _PREEMPTED.set()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (main() called from a test runner's thread)
        log.warning("not in main thread; SIGTERM preemption handler not installed")


def _dataset_type(args) -> str:
    if args.dataset_type != "auto":
        return args.dataset_type
    if not args.train_data:
        return "synthetic"
    return "webdataset" if ".tar" in args.train_data else "coco"


def wants_mesh(args) -> bool:
    """Whether the run trains over a process group: a launcher's WORLD_SIZE above 1,
    ``--multihost`` or a mesh flag."""
    return (args.multihost or args.tensor_parallel > 1 or args.expert_parallel > 1
            or args.dcn_slices > 1 or args.fsdp or args.use_shard_map
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def build_mesh(args):
    """The reference's mesh for the flags, over every rank of the process group."""
    from multimodal_tpu_torch.parallel.ep import create_ep_mesh
    from multimodal_tpu_torch.parallel.tp import create_tp_mesh

    world = dist.get_world_size()
    tp, ep = max(args.tensor_parallel, 1), max(args.expert_parallel, 1)
    if (tp > 1 or ep > 1) and args.dcn_slices > 1:
        raise ValueError("--tensor-parallel / --expert-parallel and --dcn-slices are exclusive")
    for flag, n in (("--tensor-parallel", tp), ("--expert-parallel", ep)):
        if world % n:
            raise ValueError(f"{flag} {n} does not divide the {world} ranks of the run")
    if tp > 1:
        return create_tp_mesh(world // tp, tp)
    if ep > 1:
        return create_ep_mesh(world // ep, ep)
    if args.dcn_slices > 1:
        return meshes.create_hybrid_mesh(args.dcn_slices)
    return meshes.create_mesh()


def place_model(args, model, mesh) -> Placement:
    """The placement of ``model``'s parameters the flags ask for (whole without one)."""
    from multimodal_tpu_torch.parallel.ep import shard_model_ep
    from multimodal_tpu_torch.parallel.fsdp import shard_model_fsdp
    from multimodal_tpu_torch.parallel.tp import shard_model_tp

    tp, ep = args.tensor_parallel > 1, args.expert_parallel > 1
    if args.opt_state_offload and (tp or ep or args.fsdp):
        raise SystemExit("--opt-state-offload does not compose with --tp/--ep/--fsdp (the "
                         "offloaded moments are not split with the parameters); drop one of "
                         "the flags")
    if tp:
        return shard_model_tp(model, mesh)
    if ep:
        return shard_model_ep(model, mesh)
    if args.fsdp:
        return shard_model_fsdp(model, mesh)
    return Placement(model, mesh, {})


def resolve_experiment_name(args) -> str:
    """``--name``, else ``<model>-<loss>-<date>`` with rank 0's date, which every rank
    takes."""
    if args.name is not None:
        return args.name
    date_str = broadcast_object(datetime.now().strftime("%Y_%m_%d-%H_%M_%S"))
    return f"{args.model}-{args.loss}-{date_str}"


def _loss_kwargs(args, mesh=None) -> dict:
    if args.loss == "clip":
        kw = {"label_smoothing": args.label_smoothing,
              "contrastive_impl": args.contrastive_impl,
              "chunk_size": args.contrastive_chunk_size}
        # --local-loss selects the mesh form of the loss; on one device there is none, and
        # feature-cached accumulation computes its own whole-bank form
        if mesh is not None and not args.feature_cached_accum:
            kw["local_loss"] = args.local_loss
        return kw
    if args.loss == "cloob":
        return {"inv_tau": args.inv_tau, "scale_hopfield": args.scale_hopfield}
    if args.loss == "align":
        return {"alpha": args.alpha, "beta": args.beta, "separate_text": args.separate_text,
                "separate_image": args.separate_image}
    if args.loss == "vclip":
        return {"distribution_type": args.distribution_type, "kl_weight": args.kl_weight,
                "num_samples": args.mc_samples, "var_reg_weight": args.variance_reg_weight,
                "use_mean_only": args.use_mean_only}
    if args.loss == "siglip":
        return {}
    raise ValueError(args.loss)


def kl_schedule(epoch: int, kl_weight: float, warmup_epochs: int) -> float:
    """Staged KL annealing: zero for the first ``warmup_epochs - 1`` epochs (the vclip loss
    then falls back to mean-point InfoNCE), then a linear ramp from ``kl_weight / 2`` to
    ``kl_weight`` by epoch ``2 * warmup_epochs``."""
    if warmup_epochs <= 0:
        return kl_weight
    e = epoch + 1
    if e < warmup_epochs:
        return 0.0
    if e >= 2 * warmup_epochs:
        return kl_weight
    return kl_weight * e / (2.0 * warmup_epochs)


def build_train_step(args, model, optimizer, epoch: int = 0, mesh=None, placement=None):
    """The step a run of these ``args`` trains ``epoch`` with: the loss's keyword arguments,
    for vclip with the epoch's KL weight and, after the KL warm-up, the Riemannian mean
    gradient; on ``mesh`` the rank's step with ``placement``."""
    kw = _loss_kwargs(args, mesh)
    if args.loss == "vclip":
        if args.kl_warmup_epochs:
            kw = dict(kw, kl_weight=kl_schedule(epoch, args.kl_weight, args.kl_warmup_epochs))
        if args.distribution_type != "normal":
            kw = dict(kw, riemannian=epoch > args.kl_warmup_epochs)
    return make_train_step(model, optimizer, loss_type=args.loss, loss_kwargs=kw,
                           mesh=mesh, use_shard_map=args.use_shard_map and mesh is not None,
                           state_shardings=placement, accum_steps=args.accum_freq,
                           wire_size=args.wire_size,
                           feature_cached_accum=args.feature_cached_accum,
                           ema_decay=args.model_ema_decay if args.model_ema else None,
                           offload_opt_state=args.opt_state_offload)


def step_generator(seed: int, epoch: int, i: int, device) -> torch.Generator:
    """The generator of step ``i`` of ``epoch``: a fresh one on ``device``, seeded from a
    fixed mix of ``(seed + 1, epoch, i)``."""
    mixed = int(np.random.SeedSequence([seed + 1, epoch, i]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


def _by_name(tensors: dict, placement, move) -> dict:
    """``tensors`` (parameter name -> tensor) through ``move(placement, name, tensor)`` where
    the placement splits that parameter."""
    if placement is None:
        return tensors
    return {n: move(placement, n, t) if n in placement.specs and placement.is_split(n) else t
            for n, t in tensors.items()}


def _optimizer_state(sd: dict, placement, move) -> dict:
    return {k: _by_name(v, placement, move) if isinstance(v, dict) else v
            for k, v in sd.items()}


def checkpoint_state(state: TrainState, args, placement=None) -> dict:
    """What a checkpoint holds: the model's and the optimizer's state dicts, the EMA (or
    None), the step, and the seed the per-step generators derive from. Under a
    ``placement`` that splits parameters every split tensor is gathered whole (a collective:
    every rank calls this at the same step)."""
    gather = Placement.full
    ema = None if state.ema is None else _by_name(state.ema, placement, gather)
    return {"model": _by_name(state.model.state_dict(), placement, gather),
            "optimizer": _optimizer_state(state.optimizer.state_dict(), placement, gather),
            "ema": ema, "step": state.step, "seed": args.seed}


@torch.no_grad()
def restore_state(state: TrainState, saved: dict, model_ema: bool, placement=None):
    """Load ``saved`` (a ``checkpoint_state``) into ``state`` in place, each split tensor cut
    to this rank's tile under ``placement``. An EMA toggle across the resume is tolerated
    either way: a checkpoint without one seeds the EMA from the restored parameters, one with
    an EMA this run does not keep drops it."""
    tile = Placement.local
    state.model.load_state_dict(_by_name(saved["model"], placement, tile))
    state.optimizer.load_state_dict(_optimizer_state(saved["optimizer"], placement, tile))
    state.step = int(saved["step"])
    if not model_ema:
        if saved.get("ema") is not None:
            log.info("resume: dropped the checkpoint's EMA (--model-ema off)")
        state.ema = None
    elif saved.get("ema") is None:
        state.ema = init_ema(state.model)
        log.info("resume: checkpoint had no EMA; initialized it from params")
    else:
        device = next(state.model.parameters()).device
        state.ema = {n: t.to(device, torch.float32, copy=True)
                     for n, t in _by_name(saved["ema"], placement, tile).items()}


@contextlib.contextmanager
def swapped_parameters(model: torch.nn.Module, weights: dict | None):
    """Run the body with ``model``'s parameters replaced by ``weights`` (by name; None: as
    they are), then give the model back its own tensors, the same objects, bit for bit."""
    if weights is None:
        yield model
        return
    named = dict(model.named_parameters())
    own = {n: p.data for n, p in named.items()}
    try:
        for n, p in named.items():
            p.data = weights[n].to(p.dtype)
        yield model
    finally:
        for n, p in named.items():
            p.data = own[n]


def evaluate(model, data_val, epoch: int, args=None, weights: dict | None = None) -> dict:
    """Validation over ``data_val``: paired retrieval metrics, the whole set's contrastive
    loss (the SigLIP loss for a model with a logit bias), and from 16 rows on the k-NN
    angles and the modality separability. ``weights`` (the EMA, by name) stand in for the
    model's parameters for the pass and are swapped back out after it. A variational model
    is scored on its normalized means."""
    from multimodal_tpu_torch.eval.entropy import average_kth_neighbor_angle
    from multimodal_tpu_torch.eval.retrieval import get_clip_metrics
    from multimodal_tpu_torch.eval.separability import linear_separability
    from multimodal_tpu_torch.losses.clip_loss import clip_loss
    from multimodal_tpu_torch.losses.siglip_loss import siglip_loss

    feats_i, feats_t, ls, lb = [], [], None, None
    with swapped_parameters(model, weights), model_mode(model, False), torch.no_grad():
        for batch in data_val:
            out = model(batch_images(batch, model, getattr(args, "wire_size", None)),
                        batch["text"])
            if "image_features" in out:
                fi, ft = out["image_features"], out["text_features"]
            else:
                fi, ft = out["image_mean"], out["text_mean"]
            fi, ft = fi.to(torch.float32), ft.to(torch.float32)
            feats_i.append((fi / torch.linalg.vector_norm(fi, dim=-1, keepdim=True)).cpu())
            feats_t.append((ft / torch.linalg.vector_norm(ft, dim=-1, keepdim=True)).cpu())
            ls = out["logit_scale"].detach().to(torch.float32).cpu()
            lb = out.get("logit_bias")
            lb = None if lb is None else lb.detach().to(torch.float32).cpu()
    if not feats_i:
        return {}
    fi, ft = torch.cat(feats_i), torch.cat(feats_t)
    metrics = get_clip_metrics(fi.numpy(), ft.numpy(), float(torch.exp(ls)))
    if lb is not None:
        metrics["val_loss"] = float(siglip_loss(fi, ft, ls, lb, normalize=False))
    else:
        metrics["val_loss"] = float(clip_loss(fi, ft, ls, normalize=False))
    if len(fi) >= 16:
        metrics["knn_angle_image"] = float(average_kth_neighbor_angle(fi.numpy()))
        metrics["knn_angle_text"] = float(average_kth_neighbor_angle(ft.numpy()))
        metrics["modality_separability"] = float(linear_separability(fi.numpy(), ft.numpy(),
                                                                     epochs=200))
    metrics["epoch"] = epoch
    return metrics


def zero_shot_eval_all(model, args, weights: dict | None = None) -> dict:
    """Zero-shot classification on every eval set whose path flag is given: the
    template-averaged classifier of the set's class table (the folder names where a
    folder-per-class set's classes differ from the table), then top-1 and top-5 over its
    batches. ``weights`` (the EMA) stand in for the parameters; a variational model has no
    point encoder and is skipped."""
    from multimodal_tpu_torch.data.eval_sets import open_eval_dataset
    from multimodal_tpu_torch.eval.metadata import classnames, templates
    from multimodal_tpu_torch.eval.zero_shot import build_zero_shot_classifier, zero_shot_eval

    active = {k: getattr(args, k) for k in ZERO_SHOT_DATASETS if getattr(args, k, None)}
    if args.variational or not active:
        return {}
    device = next(model.parameters()).device
    results = {}
    with swapped_parameters(model, weights), model_mode(model, False), torch.inference_mode():
        for flag, path in active.items():
            t0 = time.perf_counter()
            ds = open_eval_dataset(flag, path, batch_size=args.batch_size,
                                   image_size=model.cfg.vision.image_size, device=device)
            names = classnames(ZERO_SHOT_DATASETS[flag])
            if len(names) != len(ds.classes):  # a folder set that is not the table's
                names = [c.replace("_", " ") for c in ds.classes]
            classifier = build_zero_shot_classifier(
                lambda t: model.encode_text(t, normalize=True), names, templates("openai"),
                context_length=model.cfg.text.context_length, device=device)
            acc = zero_shot_eval(
                lambda x: model.encode_image(batch_images({"image": x}, model), normalize=True),
                classifier, iter(ds))
            results[f"{flag}-zeroshot-top1"] = acc["top1"]
            results[f"{flag}-zeroshot-top5"] = acc["top5"]
            log.info("zero-shot %s: top1 %.4f top5 %.4f (%d images in %.2f s)", flag,
                     acc["top1"], acc["top5"], len(ds), time.perf_counter() - t0)
    return results


def retrieval_eval_all(model, args, weights: dict | None = None) -> dict:
    """COCO / Flickr cross-modal retrieval: every image and all its captions embedded
    through ``Embedder``, R@{1,5,10} both ways (``eval.retrieval.recall_at_k``)."""
    from multimodal_tpu_torch.data.datasets import coco_captions, flickr_items
    from multimodal_tpu_torch.eval.retrieval import recall_at_k

    if args.variational:
        return {}
    loaders = [
        ("coco_retrieval", lambda root: coco_captions(root, split="val",
                                                      ann_path=args.ms_coco_annot)),
        ("flickr_retrieval", lambda root: flickr_items(root, token_path=args.flickr_annot)),
    ]
    results = {}
    for flag, loader in loaders:
        root = getattr(args, flag, None)
        if not root:
            continue
        t0 = time.perf_counter()
        by_image: dict = {}  # the captions of each image, in file order
        for path, caption in loader(root):
            by_image.setdefault(path, []).append(caption)
        image_paths = list(by_image)
        captions = [c for p in image_paths for c in by_image[p]]
        text_to_image = np.asarray([i for i, p in enumerate(image_paths) for _ in by_image[p]])
        with swapped_parameters(model, weights):
            emb = Embedder(model, batch_size=args.batch_size)
            img_feats, _ = emb.embed_image_files(image_paths,
                                                 image_size=model.cfg.vision.image_size)
            txt_feats = emb.embed_texts(captions)
        r = recall_at_k(img_feats, txt_feats, text_to_image)
        results.update({f"{flag}-{k}": v for k, v in r.items()})
        log.info("retrieval %s: %s (%d images, %d captions in %.2f s)", flag, r,
                 len(image_paths), len(captions), time.perf_counter() - t0)
    return results


def linear_probe_eval(model, args, weights: dict | None = None) -> dict:
    """The linear probe on frozen image features: ``--linear-probe-train``'s train split
    (``--linear-probe-val``'s, else the same path's, test split to score), fitted for
    ``--linear-probe-epochs`` on the model's device."""
    from multimodal_tpu_torch.data.eval_sets import open_eval_dataset
    from multimodal_tpu_torch.eval.linear_probe import linear_probe_metrics

    if args.variational or not args.linear_probe_train:
        return {}
    t0 = time.perf_counter()
    device = next(model.parameters()).device

    def featurize(emb, root, split):
        ds = open_eval_dataset("linear_probe", root, batch_size=args.batch_size,
                               image_size=model.cfg.vision.image_size, split=split,
                               device=device)
        feats, labels = [], []
        for images, lab in ds:
            feats.append(emb.embed_images(images))
            labels.append(lab)
        return np.concatenate(feats), np.concatenate(labels), len(ds.classes)

    with swapped_parameters(model, weights):
        emb = Embedder(model, batch_size=args.batch_size)
        xtr, ytr, n_classes = featurize(emb, args.linear_probe_train, "train")
        xte, yte, _ = featurize(emb, args.linear_probe_val or args.linear_probe_train, "test")
    metrics = linear_probe_metrics(xtr, ytr, xte, yte, n_classes,
                                   epochs=args.linear_probe_epochs, device=device)
    log.info("linear probe: %s (%d train, %d test features in %.2f s)", metrics, len(xtr),
             len(xte), time.perf_counter() - t0)
    return metrics


def captioning_eval(model, args, weights: dict | None = None) -> dict:
    """The downstream captioning evaluation: one caption per image of ``--captioning-eval``
    (COCO val layout, else folder-per-class with the class name as caption), shuffled with
    the run's seed and cut to ``--captioning-num-samples``; the images embedded by the frozen
    encoder; a CLIP-prefix caption decoder (a from-scratch GPT-2 of ``--captioning-width`` and
    ``--captioning-layers`` over the CLIP BPE vocabulary) trained on all but the held-out
    max(8, n // 10), which it captions, greedy, until the EOT; corpus BLEU against their
    captions. Fewer than 20 images: skipped. A variational model has no point encoder and is
    skipped."""
    from multimodal_tpu_torch.data.datasets import coco_captions, cood_items
    from multimodal_tpu_torch.data.tokenizer import default_tokenizer, tokenize
    from multimodal_tpu_torch.eval.captioning import CaptioningMetric
    from multimodal_tpu_torch.models.captioner import ClipCaptionModel, GPT2Config

    root = args.captioning_eval
    if not root or args.variational:
        return {}
    t0 = time.perf_counter()
    try:
        items = coco_captions(root, split="val", ann_path=args.ms_coco_annot)
    except (FileNotFoundError, NotADirectoryError, OSError, ValueError):
        items = cood_items(root)  # folder-per-class fallback (caption = class name)
    one_per_image: dict = {}
    for path, caption in items:
        one_per_image.setdefault(path, caption)
    items = list(one_per_image.items())
    rng = np.random.default_rng(args.seed)
    rng.shuffle(items)
    items = items[: args.captioning_num_samples]
    if len(items) < 20:
        log.warning("captioning eval: only %d usable images; skipping", len(items))
        return {}
    n_eval = max(8, len(items) // 10)
    train_items, eval_items = items[n_eval:], items[:n_eval]

    size = model.cfg.vision.image_size
    with swapped_parameters(model, weights):
        emb = Embedder(model, batch_size=args.batch_size)
        train_feats, _ = emb.embed_image_files([p for p, _ in train_items], image_size=size)
        eval_feats, _ = emb.embed_image_files([p for p, _ in eval_items], image_size=size)

    tok = default_tokenizer()
    sot, eot = tok.sot_token_id, tok.eot_token_id
    train_tokens = tokenize([c for _, c in train_items], tokenizer=tok)
    caption_model = ClipCaptionModel(
        gpt2=GPT2Config(vocab_size=49408, max_positions=128, width=args.captioning_width,
                        layers=args.captioning_layers,
                        heads=max(2, args.captioning_width // 64)),
        clip_dim=model.cfg.embed_dim, prefix_length=10, clip_length=4, mapper_layers=2,
        device=next(model.parameters()).device, seed=args.seed)
    metric = CaptioningMetric(
        caption_model=caption_model,
        detokenizer=lambda ids: tok.decode([i for i in ids if i not in (sot, eot)]).strip(),
        epochs=args.captioning_epochs, batch_size=min(32, len(train_items)), lr=2e-4,
        seed=args.seed, eos_token=eot)  # CLIP's EOT: without it decoding never ends
    bleu, info = metric.compute(train_feats, train_tokens, eval_feats,
                                [c for _, c in eval_items])
    log.info("captioning eval: BLEU %.4f over %d held-out images (%d train, %.2f s)", bleu,
             info["num_eval"], len(train_items), time.perf_counter() - t0)
    return {"caption_bleu": bleu, "caption_num_eval": info["num_eval"]}


def _start_remote_sync(local_dir: str, remote_dir: str, frequency_s: int) -> threading.Event:
    """Copy ``local_dir`` into ``remote_dir`` every ``frequency_s`` seconds on a daemon
    thread (rsync when there is one, else ``cp -r``); set the returned event to stop."""
    stop = threading.Event()

    def loop():
        while not stop.wait(frequency_s):
            try:
                subprocess.run(["rsync" if shutil.which("rsync") else "cp", "-r", local_dir,
                                remote_dir], check=False, capture_output=True, timeout=600)
            except Exception as e:  # noqa: BLE001
                log.warning("remote sync failed: %r", e)

    threading.Thread(target=loop, daemon=True).start()
    return stop


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StopFlag:
    """Whether the run was preempted, asked after every step. One rank: the local SIGTERM
    flag. Over a ``group`` (a gloo group of every rank): whether any rank was, agreed without
    blocking the loop: ``poll`` reads the flags' all-reduce (max) started by the previous
    ``poll`` and starts the next one, so every rank stops after the same step, one step after
    the signal, and waits only on a collective that finished during a step. ``settle`` agrees
    once more, blocking, at the epoch's end.

    ``batches(data)`` numbers an epoch's batches. Over a group it also ends the epoch on every
    rank at the same batch, the first one that some rank's stream lacks (a rank reading its
    own shards may hold fewer batches than another): each rank reads two batches ahead, the
    all-reduce that ``poll`` starts after step i carries whether this rank holds batch i + 2,
    and the ``poll`` after step i + 1 reads it; one blocking agreement at the epoch's start
    covers batches 0 and 1."""

    def __init__(self, group=None):
        self.group, self.pending = group, None
        self.more, self.agreed = True, 0  # this rank holds batch i + 2; every rank holds [0, agreed)

    def _start(self):
        flag = torch.tensor([int(_PREEMPTED.is_set()), int(not self.more)], dtype=torch.int32)
        work = dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group, async_op=True)
        self.pending = (work, flag)

    def _finish(self) -> bool:
        stop = False
        if self.pending is not None:
            work, flag = self.pending
            work.wait()
            stop = bool(flag[0])
            if not flag[1]:
                self.agreed += 1
            self.pending = None
        if stop:
            _PREEMPTED.set()
        return stop

    def poll(self) -> bool:
        if self.group is None:
            return _PREEMPTED.is_set()
        stop = self._finish()
        self._start()
        return stop

    def settle(self) -> bool:
        if self.group is None:
            return _PREEMPTED.is_set()
        self._finish()
        self._start()
        return self._finish()

    def batches(self, data):
        """(i, batch) for the batches of ``data`` every rank holds."""
        if self.group is None:
            yield from enumerate(data)
            return
        it = iter(data)
        ahead = collections.deque(itertools.islice(it, 2))
        held = torch.tensor([len(ahead)], dtype=torch.int32)
        dist.all_reduce(held, op=dist.ReduceOp.MIN, group=self.group)
        self.agreed, i = int(held), 0
        while i < self.agreed:
            batch = ahead.popleft()
            ahead.extend(itertools.islice(it, 1))
            self.more = len(ahead) == 2
            yield i, batch
            i += 1
        self.more = True


class RankRows:
    """A global batch stream cut to one rank's rows (``parallel.mesh.shard_batch``), with
    the source's epoch protocol."""

    def __init__(self, source, mesh):
        self.source, self.mesh = source, mesh

    def set_epoch(self, epoch: int):
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    @property
    def num_batches(self):
        return getattr(self.source, "num_batches", None)

    def __iter__(self):
        for batch in self.source:
            yield meshes.shard_batch(batch, self.mesh)


class RankCheckpoints:
    """A run's checkpoints over ranks: every rank saves at the same steps what it gathered,
    rank 0 writes; ``latest_step`` is the last step saved or restored, the same on every
    rank; every rank reads a restore."""

    def __init__(self, manager: CheckpointManager, rank: int):
        self.manager, self.rank = manager, rank
        self.last = manager.latest_step()

    def save(self, step: int, state, metadata=None):
        if self.rank == 0:
            self.manager.save(step, state, metadata)
        self.last = step

    def latest_step(self):
        return self.last

    def restore(self, step=None):
        return self.manager.restore(step)

    def wait(self):
        if self.rank == 0:
            self.manager.wait()

    def delete(self, step: int):
        if self.rank == 0:
            self.manager.delete(step)

    def close(self):
        if self.rank == 0:
            self.manager.close()


class _Quiet:
    """The experiment logger of a rank other than 0."""

    def log(self, record: dict, step=None):
        pass


def train_one_epoch(step_fn, state: TrainState, data_train, epoch: int, args, exp_logger,
                    ckpt=None, skip_steps: int = 0, stop: StopFlag | None = None,
                    placement=None, shards: int = 1) -> tuple:
    """One epoch of steps over ``data_train``, with batch and data time and samples/s logged
    every ``--log-every-n-steps``. With ``--save-frequency-steps`` N the state is saved every
    N steps with mid-epoch metadata; ``skip_steps`` fast-forwards the (deterministic,
    epoch-seeded) stream past batches an interrupted run already trained. In epoch 0,
    ``--profile-steps`` N traces the N steps after the first one taken, or those the epoch
    has left. ``stop`` says after each step whether to save and stop (default: the local
    SIGTERM flag); ``placement`` gathers a checkpoint's split tensors; ``shards`` ranks share
    each step's batch (the samples/s count them all). Returns (state, the last logged metrics,
    the steps taken)."""
    stop = stop or StopFlag()
    from multimodal_tpu_torch.profiling import trace

    batch_time, data_time = AverageMeter(), AverageMeter()
    tput = ThroughputMeter(1)
    losses = {}
    end = time.perf_counter()
    steps = 0
    save_every = args.save_frequency_steps or 0
    to_profile, profiled = (args.profile_steps if epoch == 0 else 0), 0
    if skip_steps:
        log.info("mid-epoch resume: fast-forwarding %d batches of epoch %d", skip_steps, epoch)
    # closing the stack synchronizes the device and stops the trace: after the N-th traced
    # step, or at the epoch's end if it comes first
    with contextlib.ExitStack() as profiler:
        for i, batch in stop.batches(data_train):
            if i < skip_steps:
                if stop.poll():
                    log.info("preemption during fast-forward; exiting (nothing to save)")
                    return state, losses, 0
                end = time.perf_counter()
                continue
            data_time.update(time.perf_counter() - end)
            device = batch["text"].device
            if to_profile and steps == 1 and profiled == 0:  # the first step warms up
                _sync(device)
                profiler.enter_context(trace(os.path.join(args.log_dir, "profile")))
                profiler.callback(_sync, device)
                log.info("profiling %d steps of epoch %d into %s", to_profile, epoch,
                         os.path.join(args.log_dir, "profile"))
            generator = step_generator(args.seed, epoch, i, device)
            tracing = to_profile and steps >= 1 and profiled < to_profile
            # each traced step is one "train_step" span of the trace
            with (torch.profiler.record_function("train_step") if tracing
                  else contextlib.nullcontext()):
                metrics = step_fn(state, batch, generator)
            steps += 1
            if tracing:
                profiled += 1
                if profiled == to_profile:
                    profiler.close()
            preempted = stop.poll() and ckpt is not None
            if ckpt is not None and ((save_every and (i + 1) % save_every == 0) or preempted):
                ckpt.save(state.step, checkpoint_state(state, args, placement),
                          metadata={"epoch": epoch, "name": args.name, "mid_epoch": True,
                                    "step_in_epoch": i + 1})
            if preempted:
                log.info("preemption signal received: saved step %d (epoch %d, batch %d); "
                         "resume with --resume latest", state.step, epoch, i + 1)
                break
            tput.update(batch["text"].shape[0] * shards)
            batch_time.update(time.perf_counter() - end)
            end = time.perf_counter()
            if (i + 1) % args.log_every_n_steps == 0:
                host_metrics = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
                rates = tput.rates()
                record = {"epoch": epoch, "step": state.step, "data_time": data_time.avg,
                          "batch_time": batch_time.avg, **rates, **host_metrics}
                log.info("epoch %d step %d loss %.4f | %.1f samples/s (%.1f/device)", epoch,
                         record["step"], record.get("loss", float("nan")),
                         rates["samples_per_s"], rates["samples_per_s_per_device"])
                exp_logger.log(record, step=record["step"])
                losses = host_metrics
                tput.reset()
    return state, losses, steps


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available; pass --device cpu to "
                           "train on the CPU")
    if args.dist_backend is not None and args.dist_backend != meshes.backend_for(args.device):
        raise ValueError(f"--dist-backend {args.dist_backend} does not fit --device "
                         f"{args.device} (that device takes {meshes.backend_for(args.device)})")
    _PREEMPTED.clear()
    if not wants_mesh(args):
        return _run(args, torch.device(args.device), None)
    formed = not dist.is_initialized()
    device = meshes.init_process_group(args.device, args.dist_url if args.multihost else None,
                                       args.dist_backend)
    try:
        return _run(args, device, build_mesh(args))
    finally:
        if formed:
            dist.destroy_process_group()


def _run(args, device: torch.device, mesh) -> int:
    """The run of ``main`` on ``device``, over ``mesh`` (None: one device, no process
    group)."""
    rank = dist.get_rank() if mesh is not None else 0
    index, shards = meshes.batch_shard(mesh) if mesh is not None else (0, 1)
    if args.batch_size % shards:
        raise ValueError(f"--batch-size {args.batch_size} does not split over {shards} ranks")
    if args.save_on_preemption:  # after the process group forms
        _install_preemption_handler()
    args.name = resolve_experiment_name(args)
    args.log_dir = os.path.join(args.logs, args.name)
    os.makedirs(args.log_dir, exist_ok=True)
    if args.copy_codebase and rank == 0:
        import multimodal_tpu_torch as _pkg

        dst = os.path.join(args.log_dir, "code", "multimodal_tpu_torch")
        if not os.path.exists(dst):
            shutil.copytree(os.path.dirname(os.path.abspath(_pkg.__file__)), dst,
                            ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.o",
                                                          "_build_cache"))
    log_file = None
    if rank == 0 or args.log_local:
        log_file = os.path.join(args.log_dir, "out.log" if rank == 0 else f"out.rank{rank}.log")
    setup_logging(log_file, level=logging.DEBUG if args.debug else logging.INFO, rank=rank)
    exp_logger = _Quiet()
    if rank == 0:
        with open(os.path.join(args.log_dir, "params.txt"), "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k}: {getattr(args, k)}\n")
        report_to = [r for r in args.report_to.split(",") if r]
        exp_logger = ExperimentLogger(
            args.log_dir, use_wandb="wandb" in report_to,
            use_tensorboard="tensorboard" in report_to,
            wandb_kwargs={"project": args.wandb_project_name, "notes": args.wandb_notes,
                          "config": vars(args), "name": args.name})
    log.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if mesh is not None:
        log.info("experiment %s: rank %d of %d, mesh %s, batch rows %d of %d (%s backend)",
                 args.name, rank, dist.get_world_size(),
                 dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)), index, shards,
                 dist.get_backend())

    # ------------------------------------------------------------------ model
    dtype = torch.float32 if args.precision == "fp32" else torch.bfloat16
    vcfg = VariationalConfig(
        model_type="Spherical" if args.distribution_type != "normal" else "Gaussian",
        initial_concentration=args.initial_concentration,
        min_concentration=args.min_concentration) if args.variational else None
    model = create_model(
        args.model, variational=args.variational, vcfg=vcfg, dtype=dtype, device=device,
        seed=args.seed, force_image_size=args.force_image_size,
        remat=args.grad_checkpointing or None, patch_dropout=args.force_patch_dropout,
        force_quick_gelu=args.force_quick_gelu, siglip=args.loss == "siglip",
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        int8_forward=args.precision == "int8")
    if args.pretrained:
        load_pretrained(model, args.pretrained)
    log.info("model %s: %.1fM params", args.model,
             sum(p.numel() for p in model.parameters()) / 1e6)
    placement = place_model(args, model, mesh) if mesh is not None else None
    split = placement is not None and placement.any_split

    # ------------------------------------------------------------------- data
    dataset_type = _dataset_type(args)
    # --wire-size: decode at a smaller size; the step upsamples to the model's on the device
    data_kw = {"image_size": args.wire_size or model.cfg.vision.image_size,
               "context_length": model.cfg.text.context_length}
    if dataset_type == "webdataset":
        data_kw.update(resampled=args.dataset_resampled,
                       weights=args.train_data_upsampling_factors)
    if dataset_type == "csv":
        data_kw.update(img_key=args.csv_img_key, caption_key=args.csv_caption_key,
                       sep=args.csv_separator)
    if dataset_type == "synthetic":
        data_kw.update(num_samples=args.train_num_samples or 100 * args.batch_size,
                       vocab_size=model.cfg.text.vocab_size)
    else:  # the readers split their shards by rank and deliver this rank's rows
        data_kw.update(device=device, num_hosts=shards, host_id=index)
    if args.nl_semantic_supervision and args.loss == "align":
        if dataset_type == "synthetic":
            data_kw["with_semantic"] = 256
        else:
            data_kw["semantic_encoder"] = make_semantic_encoder(args.semantic_model_path,
                                                                device=device)
    if args.aug_cfg:
        if dataset_type == "synthetic":
            log.warning("--aug-cfg has no effect on synthetic data (no decode stage)")
        else:  # crop bounds for the decode, pixel augmentations after it; unknown keys warn
            data_kw["aug_cfg"] = parse_aug_cfg(dict(args.aug_cfg))
    synthetic = dataset_type == "synthetic"
    train_src = build_dataset(dataset_type, path=args.train_data or "",
                              batch_size=args.batch_size // (1 if synthetic else shards),
                              train=True, seed=args.seed, num_workers=max(args.workers, 1),
                              **data_kw)
    # synthetic data: every rank draws the global stream and keeps its rows
    data_train = DataInfo(RankRows(train_src, mesh) if synthetic and mesh is not None
                          else train_src, device)
    data_val = None
    if args.val_data:
        val_type = "webdataset" if ".tar" in args.val_data else dataset_type
        val_kw = {"image_size": data_kw["image_size"],
                  "context_length": data_kw["context_length"]}
        if val_type == "synthetic":
            val_kw.update(num_samples=args.val_num_samples or 10 * args.batch_size,
                          vocab_size=model.cfg.text.vocab_size)
        else:
            val_kw["device"] = device
        if val_type == "csv":
            val_kw.update(img_key=args.csv_img_key, caption_key=args.csv_caption_key,
                          sep=args.csv_separator)
        val_src = build_dataset(val_type, path=args.val_data, batch_size=args.batch_size,
                                train=False, seed=args.seed, **val_kw)
        data_val = DataInfo(val_src, device)
    steps_per_epoch = (args.steps_per_epoch
                       or (args.train_num_samples // args.batch_size
                           if args.train_num_samples else None)
                       or train_src.num_batches or 1000)
    gathered = (lambda: placement.gathered(grad=False)) if split else contextlib.nullcontext
    total_steps = steps_per_epoch * args.epochs

    # -------------------------------------------------------------- optimizer
    if args.skip_scheduler:
        schedule = args.lr
    else:
        schedule = make_schedule(
            args.lr_scheduler, args.lr, warmup_steps=args.warmup, total_steps=total_steps,
            cooldown_steps=(args.epochs_cooldown or 0) * steps_per_epoch,
            cooldown_power=args.lr_cooldown_power, cooldown_end_lr=args.lr_cooldown_end)
    opt_kw = dict(weight_decay=args.wd, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
                  grad_clip_norm=args.grad_clip_norm, skip_nonfinite=args.skip_nonfinite,
                  opt=args.opt, state_dtype=getattr(torch, args.opt_state_dtype))
    named = list(model.named_parameters())
    mask = None
    if args.lora_rank:
        mask = finetune_mask(named, "lora")
    elif args.train_projections_only or args.freeze_backbone:
        mask = finetune_mask(named, "heads" if args.freeze_backbone else "projections")
    elif args.lock_image or args.lock_text:
        mask = lock_mask(named, args.lock_image, args.lock_text,
                         unlocked_image_groups=args.lock_image_unlocked_groups,
                         unlocked_text_layers=args.lock_text_unlocked_layers,
                         freeze_layer_norm=args.lock_text_freeze_layer_norm)
    if mask is not None:
        optimizer = freeze_optimizer(model, mask, schedule, **opt_kw)
    else:
        optimizer = make_optimizer(named, schedule, **opt_kw)
    state = TrainState.create(model, optimizer, ema=args.model_ema)

    # ---------------------------------------------------------------- resume
    ckpt = CheckpointManager(os.path.join(args.log_dir, "checkpoints"),
                             max_to_keep=1 if args.delete_previous_checkpoint else None,
                             async_save=args.async_checkpointing)
    if mesh is not None:
        ckpt = RankCheckpoints(ckpt, rank)
    start_epoch, resume_skip_steps = 0, 0
    if args.resume:
        saved, meta = ckpt.restore(None if args.resume == "latest" else int(args.resume))
        if saved is not None:
            restore_state(state, saved, args.model_ema, placement)
            del saved
            meta = meta or {}
            if meta.get("mid_epoch"):
                start_epoch = meta.get("epoch", 0)
                resume_skip_steps = meta.get("step_in_epoch", 0)
                log.info("resumed mid-epoch from step %d (epoch %d, %d batches done)",
                         state.step, start_epoch, resume_skip_steps)
            else:
                start_epoch = meta.get("epoch", 0) + 1
                log.info("resumed from step %d (epoch %d)", state.step, start_epoch)
        else:
            log.info("no checkpoint found; starting fresh")
    sync_stop = None
    if args.remote_sync and rank == 0:
        sync_stop = _start_remote_sync(args.log_dir, args.remote_sync, args.remote_sync_frequency)

    def eval_weights():
        """The EMA with --model-ema (whole, gathered from every rank's tiles under a
        placement that splits parameters), else None."""
        ema = state.ema if args.model_ema and state.ema is not None else None
        if ema is None or not split:
            return ema
        return _by_name(ema, placement, Placement.full)

    # ----------------------------------------------------------------- loops
    # every rank evaluates, with the whole weights gathered under a placement that splits
    # them; rank 0 logs
    if args.epochs == 0:  # eval-only
        record = {"eval": True}
        with gathered():
            weights = eval_weights()
            if data_val is not None:
                record.update(evaluate(model, data_val, 0, args, weights))
            record.update(zero_shot_eval_all(model, args, weights))
            record.update(retrieval_eval_all(model, args, weights))
            record.update(linear_probe_eval(model, args, weights))
            record.update(captioning_eval(model, args, weights))
        log.info("eval-only: %s", record)
        exp_logger.log(record)
        return 0

    # the step is rebuilt only where the vclip KL weight or the Riemannian flip changes
    rebuild_every_epoch = args.loss == "vclip" and (
        bool(args.kl_warmup_epochs) or args.distribution_type != "normal")
    step_fn = build_train_step(args, model, optimizer, start_epoch, mesh, placement)
    # the preemption flag's agreement runs over a gloo group of its own, whatever the
    # device: its all-reduce never queues behind the step's work on the card
    stop = StopFlag(dist.new_group(backend="gloo")
                    if mesh is not None and dist.get_world_size() > 1 else None)
    for epoch in range(start_epoch, args.epochs):
        data_train.set_epoch(epoch)
        if rebuild_every_epoch and epoch != start_epoch and epoch <= 2 * args.kl_warmup_epochs + 1:
            step_fn = build_train_step(args, model, optimizer, epoch, mesh, placement)
        t0 = time.perf_counter()
        skip = resume_skip_steps if epoch == start_epoch else 0
        state, _, n_steps = train_one_epoch(step_fn, state, data_train, epoch, args,
                                            exp_logger, ckpt=ckpt, skip_steps=skip, stop=stop,
                                            placement=placement, shards=shards)
        log.info("epoch %d done: %d steps in %.1fs", epoch, n_steps, time.perf_counter() - t0)
        if stop.settle():
            # the signal may have come after the loop's last check: keep the epoch's steps
            ckpt.wait()
            if n_steps and ckpt.latest_step() != state.step:
                ckpt.save(state.step, checkpoint_state(state, args, placement),
                          metadata={"epoch": epoch, "name": args.name, "mid_epoch": True,
                                    "step_in_epoch": skip + n_steps})
                log.info("preemption: saved step %d before exit", state.step)
            break
        if data_val is not None and (epoch + 1) % args.val_frequency == 0:
            with gathered():
                metrics = evaluate(model, data_val, epoch, args, eval_weights())
            log.info("eval epoch %d: %s", epoch, metrics)
            exp_logger.log(metrics, step=state.step)
        if (epoch + 1) % args.zeroshot_frequency == 0:
            with gathered():
                zs = zero_shot_eval_all(model, args, eval_weights())
            if zs:
                exp_logger.log({"epoch": epoch, **zs}, step=state.step)
        if (epoch + 1) % args.retrieval_frequency == 0:
            with gathered():
                rt = retrieval_eval_all(model, args, eval_weights())
            if rt:
                exp_logger.log({"epoch": epoch, **rt}, step=state.step)
        if (epoch + 1) % args.save_frequency == 0 or epoch == args.epochs - 1:
            ckpt.wait()
            if ckpt.latest_step() == state.step:
                # a step-frequency save on the epoch boundary: replace it, so the metadata
                # that survives is the epoch-end one and resume starts the next epoch
                ckpt.delete(state.step)
            ckpt.save(state.step, checkpoint_state(state, args, placement),
                      metadata={"epoch": epoch, "name": args.name})
            log.info("saved checkpoint at step %d", state.step)
    ckpt.close()
    if sync_stop is not None:
        sync_stop.set()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
