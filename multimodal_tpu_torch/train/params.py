"""The training CLI's flags (port of ``multimodal_tpu/train/params.py``): the reference's
surface flag for flag, with the same defaults and ``parser.error`` checks, plus
``--device`` (``cuda``, the default, or ``cpu``).

Every flag parses here, so the reference's shell recipes parse too; ``train.run`` takes them
all, on one device or over a process group."""

from __future__ import annotations

import argparse


class ParseKwargs(argparse.Action):
    """--aug-cfg key=val [key=val ...] (params.py:15-24)."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, _, val = value.partition("=")
            try:
                kw[key] = eval(val)  # noqa: S307 - same trusted-CLI semantics as reference
            except Exception:
                kw[key] = val
        setattr(namespace, self.dest, kw)


def get_default_params(model_name: str) -> dict:
    """Per-model optimizer defaults (params.py:9-12): ViT models use the CLIP paper values."""
    if "ViT" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


def parse_args(args=None):
    parser = argparse.ArgumentParser("multimodal_tpu_torch trainer")

    # ------------------------------------------------------------------ data
    g = parser.add_argument_group("data")
    g.add_argument("--train-data", default=None,
                   help="shard urls / dataset root; '::'-separated multi-source")
    g.add_argument("--train-data-upsampling-factors", default=None,
                   help="'::'-separated per-source resampling weights")
    g.add_argument("--val-data", default=None)
    g.add_argument("--train-num-samples", type=int, default=None)
    g.add_argument("--val-num-samples", type=int, default=None)
    g.add_argument("--dataset-type",
                   choices=["webdataset", "coco", "laion", "cood", "csv", "synthetic", "auto"],
                   default="auto")
    g.add_argument("--dataset-resampled", action="store_true",
                   help="with-replacement shard sampling")
    g.add_argument("--csv-separator", default="\t")
    g.add_argument("--csv-img-key", default="filepath")
    g.add_argument("--csv-caption-key", default="title")
    g.add_argument("--workers", type=int, default=4,
                   help="webdataset: N shard-disjoint readers drained round-robin on "
                        "threads (parallel tar read + decode; deterministic order). "
                        "Other dataset types decode natively multi-threaded and ignore "
                        "this flag")
    g.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs)

    # ---------------------------------------------------------- optimization
    g = parser.add_argument_group("optimization")
    g.add_argument("--batch-size", type=int, default=64, help="per-host batch size")
    g.add_argument("--epochs", type=int, default=32)
    g.add_argument("--epochs-cooldown", type=int, default=None)
    g.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override when the dataset cannot report its size")
    g.add_argument("--lr", type=float, default=None)
    g.add_argument("--opt", choices=["adamw", "lamb", "lars"], default="adamw",
                   help="adamw (reference) or large-batch trust-ratio optimizers "
                        "(beyond reference; for very large global contrastive batches)")
    g.add_argument("--opt-state-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="AdamW moment storage dtype; bfloat16 halves optimizer-state HBM "
                        "(4 vs 8 bytes/param) for billion-param models on one chip")
    g.add_argument("--opt-state-offload", action="store_true",
                   help="keep AdamW moments in pinned host RAM instead of HBM "
                        "(parallel/offload.py) — frees ~8 bytes/param of HBM for "
                        "batch on HBM-bound models (ViT-g/14)")
    g.add_argument("--beta1", type=float, default=None)
    g.add_argument("--beta2", type=float, default=None)
    g.add_argument("--eps", type=float, default=None)
    g.add_argument("--wd", type=float, default=0.2)
    g.add_argument("--warmup", type=int, default=10000, help="warmup steps")
    g.add_argument("--lr-scheduler", choices=["cosine", "const", "const-cooldown"],
                   default="cosine")
    g.add_argument("--skip-scheduler", action="store_true",
                   help="constant LR, no warmup/decay (params.py --skip-scheduler)")
    g.add_argument("--lr-cooldown-end", type=float, default=0.0)
    g.add_argument("--lr-cooldown-power", type=float, default=1.0)
    g.add_argument("--accum-freq", type=int, default=1, help="gradient accumulation steps")
    g.add_argument("--feature-cached-accum", action="store_true",
                   help="OpenCLIP feature-cached accumulation (enlarges the contrastive batch)")
    g.add_argument("--grad-clip-norm", type=float, default=None)
    g.add_argument("--skip-nonfinite", action="store_true", default=True,
                   help="skip steps with non-finite grads (reference NaN-skip loops)")

    # ------------------------------------------------------- precision/model
    g = parser.add_argument_group("model")
    g.add_argument("--model", default="ViT-B-32")
    g.add_argument("--pretrained", default="", help="checkpoint path: an OpenAI-format torch .pt/.pth/.bin")
    g.add_argument("--precision",
                   choices=["amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16", "pure_bf16",
                            "pure_fp16", "fp32", "int8"],
                   default="amp_bf16",
                   help="every amp/bf16/fp16 mode = bfloat16 compute with float32 "
                        "params; fp32 = float32 throughout; int8 = bfloat16 plus the "
                        "SwitchBack int8 MLP GEMMs (forward and input gradient)")
    g.add_argument("--force-image-size", type=int, default=None)
    g.add_argument("--wire-size", type=int, default=None,
                   help="host-side decode/crop resolution; the train step upsamples to "
                        "the model's image_size ON DEVICE (bicubic prolog). "
                        "(wire/model)^2 less host->device bandwidth — use when the host "
                        "link, not decode, bounds real-input throughput (e.g. 128 for "
                        "a 224-px model on 128-px sources)")
    g.add_argument("--force-patch-dropout", type=float, default=None,
                   help="FLIP-style patch token dropout rate at train time")
    g.add_argument("--lock-image", action="store_true",
                   help="freeze the image tower (run.py:248-259)")
    g.add_argument("--lock-image-unlocked-groups", type=int, default=0,
                   help="with --lock-image: leave the last N blocks (+post-norm/proj) "
                        "trainable (params.py --lock-image-unlocked-groups)")
    g.add_argument("--lock-image-freeze-bn-stats", action="store_true",
                   help="accepted for recipe compat; ViT towers have no batch norm")
    g.add_argument("--lock-text", action="store_true")
    g.add_argument("--lock-text-unlocked-layers", type=int, default=0,
                   help="with --lock-text: leave the last N blocks (+final LN/proj) trainable")
    g.add_argument("--lock-text-freeze-layer-norm", action="store_true",
                   help="with partial unlocking: keep LayerNorm params in unlocked blocks "
                        "frozen (params.py --lock-text-freeze-layer-norm)")
    g.add_argument("--force-quick-gelu", action="store_true",
                   help="force QuickGELU MLPs regardless of model config (factory.py:137)")
    g.add_argument("--train-projections-only", action="store_true",
                   help="freeze everything except the output projections + logit scale "
                        "(Models/clipModel.py:37-42 freeze_for_finetuning)")
    g.add_argument("--freeze-backbone", action="store_true",
                   help="variational finetune: train only the heads vCLIP adds on a "
                        "pretrained backbone (variationalClip.py:204 / trainer.ipynb "
                        "FREEZE_BACKBONE)")
    g.add_argument("--lora-rank", type=int, default=0,
                   help="PEFT-style LoRA finetune (finetune.ipynb:cell 12): add rank-r "
                        "adapters on every attention/MLP projection and train ONLY the "
                        "adapters + logit scale (base weights frozen)")
    g.add_argument("--lora-alpha", type=float, default=16.0,
                   help="LoRA scaling numerator; effective delta = alpha/rank * A@B")
    g.add_argument("--force-custom-text", "--use-bn-sync", "--pretrained-image",
                   action="store_true", dest="gpu_flags_noop",
                   help="accepted for recipe compat; HF text towers / SyncBN / "
                        "timm-pretrained stems have no counterpart here")
    g.add_argument("--use-bnb-linear", default=None,
                   help="accepted for recipe compat; bitsandbytes int8 linears are not used "
                        "(--precision int8 is the int8 path) — ignored")
    g.add_argument("--grad-checkpointing", action="store_true",
                   help="remat per encoder block (transformer.py:319-326)")
    g.add_argument("--torchscript", "--torchcompile", "--trace", action="store_true",
                   dest="jit_flags_noop",
                   help="accepted for recipe compat — ignored")
    # variational heads (Models/variationalClip.py)
    g.add_argument("--variational", action="store_true")
    g.add_argument("--distribution-type",
                   choices=["power_spherical", "vmf", "normal"], default="power_spherical")
    g.add_argument("--initial-concentration", type=float, default=100.0)
    g.add_argument("--min-concentration", type=float, default=10.0)

    # ------------------------------------------------------------------ loss
    g = parser.add_argument_group("loss")
    g.add_argument("--loss", choices=["clip", "cloob", "align", "vclip", "siglip"],
                   default="clip")
    g.add_argument("--clip-loss", action="store_true",
                   help="force plain InfoNCE (reference --clip-loss); same as --loss clip")
    g.add_argument("--local-loss", action="store_true", default=True,
                   help="local@global logits with axis-offset labels (loss.py:109-117)")
    g.add_argument("--gather-with-grad", action="store_true", default=True,
                   help="accepted for recipe compat: over a process group the features are "
                        "always gathered with their gradient")
    g.add_argument("--label-smoothing", type=float, default=0.0)
    g.add_argument("--contrastive-impl", choices=["dense", "chunked", "ring"],
                   default="dense",
                   help="global-batch logits strategy: dense local@global block, "
                        "chunked streaming logsumexp, or ppermute ring (no all-gather)")
    g.add_argument("--contrastive-chunk-size", type=int, default=1024)
    # AlignCLIP in-modality terms (align_clip/loss.py:135-273)
    g.add_argument("--clip-inModality-loss", action="store_true",
                   help="use the AlignCLIP in-modality separation loss (implies --loss align)")
    g.add_argument("--alpha", type=float, default=1.0)
    g.add_argument("--beta", type=float, default=0.5)
    g.add_argument("--nl_semantic_supervision", action="store_true")
    g.add_argument("--semantic-model-path", default=None,
                   help="local HF snapshot for caption sentence embeddings "
                        "(e.g. all-mpnet-base-v2); hashing fallback when absent")
    g.add_argument("--separate_text", action="store_true", default=True)
    g.add_argument("--separate_image", action="store_true", default=True)
    # CLOOB (losses/cloobLoss.py)
    g.add_argument("--inv-tau", type=float, default=30.0)
    g.add_argument("--scale-hopfield", type=float, default=8.0)
    # vCLIP (losses/vclipLoss.py + trainer.ipynb CONFIG)
    g.add_argument("--kl-weight", type=float, default=100.0)
    g.add_argument("--kl-warmup-epochs", type=int, default=0,
                   help="linear KL annealing epochs (trainer.ipynb:cell 17)")
    g.add_argument("--mc-samples", type=int, default=20,
                   help="Monte-Carlo rsample count (vclipLoss.py:114)")
    g.add_argument("--variance-reg-weight", type=float, default=1.0)
    g.add_argument("--use-mean-only", action="store_true",
                   help="mean-point InfoNCE instead of MC sampling")

    # -------------------------------------------------------- checkpointing
    g = parser.add_argument_group("checkpointing")
    g.add_argument("--logs", default="./logs", help="experiment root directory")
    g.add_argument("--name", default=None, help="experiment name (default: timestamp)")
    g.add_argument("--resume", default=None,
                   help="'latest' or a checkpoint step/path (run.py:139-171)")
    g.add_argument("--save-frequency", type=int, default=1, help="epochs between saves")
    g.add_argument("--save-frequency-steps", type=int, default=0,
                   help="also checkpoint every N steps WITHIN an epoch (0 = off); "
                        "resume fast-forwards the data stream past trained batches — "
                        "preemption-safe training (beyond reference)")
    g.add_argument("--save-most-recent", action="store_true", default=True)
    g.add_argument("--model-ema", action="store_true",
                   help="maintain an exponential moving average of the params; eval and "
                        "final checkpoints use the averaged model (beyond reference)")
    g.add_argument("--model-ema-decay", type=float, default=0.9998)
    g.add_argument("--save-on-preemption", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="on SIGTERM (pod eviction), checkpoint mid-epoch and exit "
                        "cleanly; resume with --resume latest. Under --multihost the "
                        "stop is coordinated (per-step flag all-reduce) so every host "
                        "saves the same step (beyond reference)")
    g.add_argument("--delete-previous-checkpoint", action="store_true",
                   help="keep only the newest checkpoint (run.py:438-441)")
    g.add_argument("--async-checkpointing", action="store_true",
                   help="copy the state to host memory, then write the checkpoint on a "
                        "thread while training goes on")
    g.add_argument("--remote-sync", default=None,
                   help="rsync/fsspec target directory for background checkpoint sync")
    g.add_argument("--remote-sync-frequency", type=int, default=300)
    g.add_argument("--remote-sync-protocol", choices=["s3", "fsspec"], default="s3",
                   help="accepted for recipe compat; the sync backend is chosen from the "
                        "target path (local/posix recursive copy here)")
    g.add_argument("--copy-codebase", action="store_true",
                   help="snapshot the multimodal_tpu_torch package into the experiment dir "
                        "(run.py:468-486)")

    # ------------------------------------------------------------- logging
    g = parser.add_argument_group("logging")
    g.add_argument("--log-every-n-steps", type=int, default=100)
    g.add_argument("--log-local", action="store_true")
    g.add_argument("--report-to", default="", help="comma list: wandb,tensorboard")
    g.add_argument("--wandb-project-name", default="multimodal_tpu")
    g.add_argument("--wandb-notes", default="")
    g.add_argument("--debug", action="store_true")
    g.add_argument("--profile-steps", type=int, default=0,
                   help="trace N steps of epoch 0 (from its second step) with torch.profiler "
                        "into <logs>/<name>/profile")

    # ------------------------------------------------------------------ eval
    g = parser.add_argument_group("eval")
    g.add_argument("--val-frequency", type=int, default=1)
    g.add_argument("--zeroshot-frequency", type=int, default=2)
    g.add_argument("--retrieval-frequency", type=int, default=1)
    # second option string = the reference's spelling of the same flag (params.py:441-535)
    for names in [["imagenet-val"], ["imagenet-v2"], ["imagenet-s", "imagenet-sketch"],
                  ["imagenet-a"], ["imagenet-o"], ["imagenet-r"],
                  ["imagenet-c"],  # corruption split (zero_shot.py:118-120, data.py "c")
                  ["cifar10"], ["cifar100"],
                  ["flowers", "flowers-102"], ["food", "food-101"],
                  ["stanford-cars", "stanford"], ["coco-retrieval", "ms-coco"],
                  ["flickr-retrieval", "flickr"]]:
        g.add_argument(*[f"--{n}" for n in names], default=None,
                       help=f"path to {names[0]} eval data")
    g.add_argument("--ms-coco-annot", default=None,
                   help="COCO retrieval annotation file (captions json); defaults to the "
                        "standard location under --coco-retrieval")
    g.add_argument("--flickr-annot", default=None,
                   help="Flickr30K retrieval annotation/token file")
    g.add_argument("--linear-probe-train", "--imagenet-train", default=None,
                   dest="linear_probe_train",
                   help="folder-per-class train set for linear probing (the reference's "
                        "--imagenet-train)")
    g.add_argument("--linear-probe-val", default=None)
    g.add_argument("--linear-probe-epochs", type=int, default=100)
    g.add_argument("--captioning-eval", default=None,
                   help="COCO-format (or folder-per-class) root for the downstream "
                        "captioning BLEU eval (metrics.ipynb cells 15-21); runs in "
                        "eval-only mode (--epochs 0)")
    g.add_argument("--captioning-num-samples", type=int, default=2048)
    g.add_argument("--captioning-epochs", type=int, default=3)
    g.add_argument("--captioning-width", type=int, default=256,
                   help="width of the from-scratch caption decoder")
    g.add_argument("--captioning-layers", type=int, default=4)

    # ------------------------------------------------------------ distributed
    g = parser.add_argument_group("distributed")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the run trains: the GPU (default; without one the run "
                        "raises) or, when asked, the CPU")
    g.add_argument("--dist-backend", default=None,
                   help="the process group's backend; it must be the device's (nccl for "
                        "cuda, gloo for cpu), which is also the default")
    g.add_argument("--dist-url", default="env://",
                   help="multihost coordinator: tcp://host:port with RANK/WORLD_SIZE env "
                        "(the reference's convention, distributed.py:63-137) or env:// "
                        "for the torchrun environment")
    g.add_argument("--horovod", action="store_true",
                   help="accepted for recipe compat — ignored")
    g.add_argument("--ddp-static-graph", action="store_true", help="accepted for recipe compat — ignored")
    g.add_argument("--no-set-device-rank", action="store_true", help="accepted for recipe compat — ignored")
    g.add_argument("--multihost", action="store_true",
                   help="initialize the multi-process group before building the mesh")
    g.add_argument("--dcn-slices", type=int, default=1,
                   help="multi-slice pods: hybrid ('replica','data') mesh with the replica "
                        "axis over DCN (parallel/mesh.py:create_hybrid_mesh)")
    g.add_argument("--tensor-parallel", type=int, default=1,
                   help="model-axis size of a (data, model) mesh; params shard by the "
                        "Megatron column/row rules (parallel/tp.py)")
    g.add_argument("--expert-parallel", type=int, default=1,
                   help="expert-axis size of a (data, expert) mesh; MoE expert stacks "
                        "shard by the GShard rules (parallel/ep.py; needs a model config "
                        "with moe_experts > 0, e.g. vision_cfg.moe_experts)")
    g.add_argument("--fsdp", action="store_true",
                   help="ZeRO/FSDP: shard params + AdamW state over the data axis "
                        "(parallel/fsdp.py); whole weights are gathered at use and the "
                        "gradients reduce-scattered; composes with --dcn-slices (shards "
                        "ride the data axis only)")
    g.add_argument("--use-shard-map", choices=["auto", "on", "off"], default="auto",
                   help="the reference's shard_map mode (auto = on with --contrastive-impl "
                        "ring); its exclusions hold. A PyTorch step always runs each rank's "
                        "loss with explicit collectives, in the --local-loss form or the "
                        "global matrix")

    ns = parser.parse_args(args)

    # per-model defaults (params.py:9-12)
    defaults = get_default_params(ns.model)
    for k, v in defaults.items():
        if getattr(ns, k) is None:
            setattr(ns, k, v)
    if ns.clip_inModality_loss:
        ns.loss = "align"
    if ns.clip_loss:
        ns.loss = "clip"
    if ns.variational:
        if ns.loss == "siglip":
            parser.error("--loss siglip is for the standard CLIP family "
                         "(drop --variational)")
        ns.loss = "vclip"

    # resolve the shard_map mode: ring streaming needs manual collectives (ppermute)
    ns.use_shard_map = {
        "auto": ns.contrastive_impl == "ring",
        "on": True,
        "off": False,
    }[ns.use_shard_map]
    if ns.contrastive_impl == "ring" and not ns.use_shard_map:
        parser.error("--contrastive-impl ring requires shard_map "
                     "(drop --use-shard-map off)")
    if ns.loss == "siglip" and ns.feature_cached_accum:
        parser.error("--feature-cached-accum is a CLIP-InfoNCE feature "
                     "(SigLIP needs no feature cache: use plain --accum-freq)")
    if ns.use_shard_map and ns.tensor_parallel > 1:
        parser.error("--use-shard-map and --tensor-parallel are exclusive "
                     "(TP shards params via GSPMD propagation)")
    if ns.fsdp and ns.tensor_parallel > 1:
        parser.error("--fsdp and --tensor-parallel are exclusive "
                     "(both assign parameter shardings)")
    if ns.fsdp and ns.use_shard_map:
        parser.error("--fsdp requires the GSPMD jit path "
                     "(drop --use-shard-map on / --contrastive-impl ring)")
    if ns.expert_parallel > 1 and (
        ns.tensor_parallel > 1 or ns.fsdp or ns.use_shard_map
    ):
        parser.error("--expert-parallel is exclusive with --tensor-parallel/--fsdp/"
                     "--use-shard-map (one parameter-sharding scheme at a time)")
    return ns
