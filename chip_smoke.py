#!/usr/bin/env python3
"""Drive the PyTorch port's serving path, its training step, its training CLI and its
evaluations once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the result lines):
  1. the card: torch.cuda.is_available() and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ops/csrc with nvcc (one process per source, in parallel);
     print every kernel's registers and spills (ptxas), the attention passes' shared memory,
     and from the SASS the passes' HMMA / LDSM / LDGSTS counts and the tensor-core
     instructions by form of each flash kernel and of every instantiation of the projection
     GEMM (mma_gemm_kernel<T, TOut, form, load, store>: the block forward's and backward's,
     the MLP's float32 c_fc, c_proj, dh, dln and weight gradients; HMMA.16816.F32.BF16 in bfloat16,
     HMMA.1688.F32.TF32 for float32's 3xTF32; a GEMM instantiation with no HMMA or another
     form fails), and the wgmma instructions (GMMA) of each int8 GEMM instantiation (none
     fails); every bfloat16 instantiation of the flash forward, dQ and dK/dV
     (flash_fwd_kernel<WgmmaOps<..>>, flash_dq_kernel<WgmmaOps<..>>,
     flash_dkv_kernel<WgmmaOps<..>>), all four of the bfloat16 fused forward
     (fused_fwd_kernel<FusedOps<64, 128|112|96>>, <FusedOps<128, 64>>), all seven of the fused
     MLP's bfloat16 GEMM (wgmma_gemm_kernel<bfloat16, TOut, form, load, store>: c_fc, c_proj
     with and without the residual, dh, dln, dW2, dW1) and all six of the block kernels' (the
     five forms with three operand sets, the weight gradients' TN form with four) must hold
     wgmma (HGMMA) and no HMMA, or the phase fails before any launch; the MLP's float32
     instantiations of mma_gemm_kernel are held to 3xTF32 with the block kernels';
  3. every kernel against its plain PyTorch version on the card, every output, in float32
     (max abs error <= 1e-4 * max|plain|) and bfloat16 (<= 2e-2 * max|plain|), with
     CUDA-event times at B=256: the block-attention forward and backward at the ViT-B/32
     tower shapes (vision S=50 W=768 H=12, text S=77 W=512 H=8 causal), the shared trunk's
     text pass (S=77 W=768 H=12 causal), S=197 and S=257 (W=1024 H=16), with torch's
     multi_head_attention_forward timed beside them, and the caption mappers' shapes (S=20
     W=768 H=8, head dim 96; S=14 W=256 H=8), at B=3 and timed at B=32; their LN-fold forms
     (LayerNorm and residual inside the kernel; also ln_out, dgamma and dbeta) at S=145
     (ViT-B/32's vision tower at 384 px, timed at B=256), S=197, S=257 and S=320, causal and
     not; both forms at the head dims 80 and 88 (S=257, W=1280 and 1408), whose last k-step
     of 16 is zero-padded; phase 18's shapes at the batches it trains at (PHASE18_TIMED: the
     LN-fold form at S=257 W=1024 / 1280 / 1408, the non-LN form at the H/14 and g/14 text
     tower's S=77 W=1024 H=16 causal, their weight gradients, ViT-L/14's int8 quantizes and
     GEMMs), timed; the fused whole-sequence attention pair at S=128, 197, 257 and 512
     with D=32, 64 and 128 and at S=129 and 191 (one past and one short of a 64-row tile
     edge), causal and not, with torch's scaled_dot_product_attention timed beside it and a
     second launch of the timed case compared bit for bit with the first; the fused MLP branch
     (LayerNorm, c_fc, activation, c_proj, residual) forward and backward, with and without
     the residual, at the ViT-B/32, ViT-B/16 and ViT-L/14 token counts and widths (c_proj's
     float32 sums run K = H = 2048-4096 long) and a ragged T=3x197 (outputs y, h and dx, dW1,
     dW2, db1, db2, dgamma, dbeta; no library call holds it, and the same two or four
     products as plain torch.matmul calls are timed beside it as information); the
     flash-attention trio (forward with lse, dQ, dK/dV) at S=2048 (B=1, the timed
     B=8 and the text tower's own call at B=32) and S=4096 causal, S=1024 and S=2048 not
     causal, a ragged S=2050, sq != sk causal, D=32, 80, 88 and 128, with
     scaled_dot_product_attention(is_causal=True) forward and backward timed beside it; each
     timed line with its TFLOP/s and share of its bound (the float32 kernels that run
     3xTF32, the flash trio, the block pair in both forms and the MLP pair, at the 3xTF32
     ceiling, 495 / 3 TFLOP/s, and at the CUDA cores' 67 beside it); in bfloat16 also the
     wgmma flash kernels' tile edges, Sq = Sk = 127, 129, 255 and 257, causal and not, at
     D = 8, 24, 64, 96 and 128 (FLASH_EDGE_CASES), the wgmma dQ's query and key tile edges,
     Sq = 31-257 against Sk = 31-257, cross lengths under the top-left mask, D = 64, 80, 88 and
     128 (DQ_EDGE_CASES), the wgmma fused forward's (FUSED_EDGE_CASES: S = 128, 129, 191-193,
     255-257, 511 and 512, D = 32, 64 and 128, causal and not, B = 1 and 256, every key tile
     width it picks); in both dtypes the fused backward's (FUSED_BWD_EDGE_CASES: the same
     lengths, head dims, masks and batches around its dQ and dK/dV kernels' passes, tiles and
     resident rings); and the fused MLP's edges on its wgmma GEMM
     (MLP_EDGE_CASES: T = 1, 63, 65, 127, 129, 255, 257 and 4607-5121 around a weight-gradient
     split's edge, W = 128-1024, H = 128 and 3072, both activations, with and without the
     residual); in bfloat16 the block backward's weight-gradient kernel (dWq, dWk, dWv, dWo in
     one launch on the wgmma GEMM's TN form, the serial store) at the token rows and width of
     every block and LN-fold case (WGRAD_CASES) against its split walk, with the library's four
     bf16 GEMMs with float32 out (torch.mm(..., out_dtype=torch.float32)) and, as information,
     the widened float32 products the port ran before it, timed at B=256 and the caption
     mappers' B=32; the timed flash and fused kernels, those
     edge cases and every block, weight-gradient and MLP case launched twice and compared bit
     for bit,
     every output; the block backward's recomputed q, k, v compared bit for bit with the
     forward's, both forms and dtypes; the float32 flash forward at S=8192; then the flash
     operator against the plain attention path, forward plus backward, time and peak memory at
     S=1024, 2048 and 4096, causal and not (the dispatch's crossover). The library calls are
     yardsticks, held to the plain versions too and used nowhere in the port. Then the int8
     kernels at ViT-B/32's int8 shapes at B=256, float32 and bfloat16 activations: the row
     quantize (ops/csrc/quant.cu; activations [12800|19712, 768|3072|512|2048]; the float32
     weights W1 and W2 of both towers by rows, the backward's, and in the column form, the
     forward's [in, out] -> [out, in], in both scale forms) and the wgmma int8 GEMM with the
     rescale in its epilogue (ops/csrc/int8_gemm.cu) on random codes at the four products of
     the step, each store form: the product scaled, float32 or bfloat16 out; the bias in a
     fused multiply-add, float32 (the float32 train path) or bfloat16 out (the W8A8 encoders'
     c_fc); the bias added after the bfloat16 rounding (the bfloat16 train path); and the image
     projection at M=256, float32 out: codes, scales and outputs bit for bit against the plain
     versions, a zero row and a row of exact .5 ties in every quantize input, a second launch
     the same bits; device times (CUDA events around calls queued behind a spin kernel, with
     torch.profiler's reading beside) with GB/s or TOP/s and the share of the bound, and beside each GEMM the same product as torch._int_mm (cuBLASLt, int32 out, no
     rescale) and as a bfloat16 torch.matmul (information);
  4. serving: ViT-B/32 in float32 with seeded random weights behind the HTTP server,
     answering text, image and similarity requests; the forward kernel's launch count over
     those requests must be at least 12 per tower encode, and the served embeddings must
     match an encode through the plain version (cosine >= 0.9999);
  5. serving throughput at bucket 256 and single-request p50 latency;
  6. training: ViT-B/32 with seeded weights, the fused AdamW (cosine schedule, weight decay
     0.1, clip 1.0) and a fixed synthetic uint8 batch of 256. float32: 6 steps through the
     kernels against 6 from the same start with every block's attention routed to the
     plain version (losses of the first 2 within 1e-5 relative, grad norms within 1e-4,
     every gradient leaf of step 1 within 1e-3 * max|leaf|, 24 launches of each block kernel
     per step); bfloat16: 6 steps, every loss and grad norm finite and the loss
     falling. Samples/s over steps 2-6 and peak memory for both;
  7. the shared-trunk ViT-B/16 at full width (12 layers, W=768, H=12; vision S=197 through
     the LN-fold kernels, text S=77 causal through the non-LN kernels): served as in phases
     4-5 (per image encode >= 12 LN-fold forward launches, per text encode >= 12 forward
     launches); trained as in phase 6, the float32 comparison at a batch both paths hold
     (64) and the rates at the largest of 64/128/256 the kernel path holds, reckoned from
     the measured peak; and the same model with ``vision.scale_heads``, whose vision pass
     goes through ``attention()`` to the fused pair (12 launches of each per step);
  8. the same shared-trunk ViT-B/16, all 12 layers, built with ``block_mlp=True``, so that
     every block's MLP half runs the fused operator's kernels: served as in phase 7 (and
     >= 12 MLP forward launches per encode); trained as in phase 7 (float32 kernel path
     against the plain path at B=64; exactly 24 MLP forward and 24 MLP backward launches per
     step beside the 12 of each block-attention kernel; float32 and bfloat16 at the largest
     batch, to be read beside phase 7's rates with the switch off); and one float32 run with
     ``remat`` at that batch: the same losses, twice the forward launches, its peak memory;
  9. the long-context causal path: ViT-B/32 at full width and depth with the text tower's
     ``context_length`` at 2048 (``ViT-B-32-ctx2048``), whose every text block goes through
     ``attention()`` to the flash kernels: served as in phases 4-5 at bucket 32 (per text
     encode >= 12 flash forward launches, per image encode >= 12 block forward launches);
     trained as in phase 6, the float32 kernel path against the plain path at B=8 (per step
     exactly 12 launches of each block kernel and of each of the three flash kernels), then
     float32 and bfloat16 at the largest of 8/16/32 the kernel path holds; and one float32
     run of ViT-B/32 with ``vision.scaled_cosine`` and ``vision.attentional_pool`` at B=64
     (finite, falling, the text tower's 12 + 12 block launches and nothing else);
 10. the variational ViT-B/32 at full width and depth (``create_model(..., variational=True)``:
     a concentration token on each tower, so the vision blocks run the block kernels at S=51
     and the text blocks at S=78 causal, both also phase-3 rows): an eval-mode encode at
     B=256 in float32, kernel path against plain path (means at cosine >= 0.9999,
     concentrations within 1e-4 relative, >= 12 block-forward launches per tower encode);
     training with the reference recipe's loss (``power_spherical``, KL weight 100, 20
     samples, var_reg 0.1, label smoothing 0.1, the Riemannian mean gradient; the fused AdamW
     at lr 1e-3 and weight decay 1e-8), each run's Monte-Carlo draws from a CUDA generator
     seeded alike: float32 at B=128 through the kernels against the plain path as in phase 6
     (24 launches of each block kernel per step), bfloat16 at B=128 and B=256 (finite, the
     total loss falling), then 2 float32 steps each of ``vmf`` and of the Gaussian mode with
     ``normal`` (finite; vMF concentrations at or above the minimum); samples/s over steps
     2-6 and peak memory;
 11. the rest of the model family, each ViT-B/32 at full width and depth with seeded weights,
     each run as in phase 6 (the fused AdamW, a fixed synthetic uint8 batch, samples/s over
     steps 2-6, peak memory, float32 kernel path against plain path with phase 6's limits):
     a LoRA fine-tune (r=8, alpha 16) of a base loaded from an OpenAI-format state dict,
     trained in the "lora" freeze mode at B=256 (every frozen parameter bit for bit unchanged;
     the optimizer state's bytes beside phase 6's), bfloat16 at B=256, then the adapters merged
     into a model without them, its encodes at bucket 256 against the adapted model's (cosine
     >= 0.9999); a MoE vision tower (8 experts, top-2, capacity factor 1.25 on every second
     block: 6 MoE blocks, 15 slots an expert an image) at B=256, each MoE layer's expert
     choices compared between the paths: a step whose d routing decisions differ holds its
     loss to 1e-5 + d / (B * S) and prints its grad norm and leaves unheld; the aux term
     finite, its mean per layer and round in [1, 8]; bfloat16 at B=256; SigLIP
     (``siglip=True``, ``loss_type="siglip"``) at B=256, the logit bias moving from -10, and
     bfloat16 (finite, each step's loss within 2e-2 of the float32 kernel path's and falling
     below step 1's; on this batch the loss rises again at step 6 on both float32 paths);
     ``force_image_size=384`` (vision S=145 through the LN-fold kernels, 12 launches
     of each a step, the text tower through the others) for 2 float32 steps at B=128, then
     bfloat16 rates;
 12. int8: ViT-B/32 at full width and depth with ``int8_forward=True`` at B=256 (every dense
     MLP on the SwitchBack GEMMs: per step 192 row-quantize and 96 int8 GEMM launches beside
     the 24 of each block kernel): float32 kernel path against plain path, the int8 codes that
     flip between them counted and printed, with phase 6's limits widened by 3x each held
     quantity's distance between the int8 step and the float step from the same start (the
     flips cascade: the two paths may hold independent roundings of a value, ``int8_limit``);
     bfloat16 in turns with the bfloat16 step without int8 (A, B, B, A, A, B: samples/s and
     peak memory, the A/B); then the
     W8A8 encoders behind the HTTP server (``quantized=True``): 73 launches of each int8
     kernel per tower encode, cosine > 0.99 to the float32 encode and >= 0.9999 to the same
     encode through the plain versions, encodes/s at bucket 256 and single-request p50;
 13. the training CLI (``multimodal_tpu_torch.train.run``), ViT-B/32 at full width and depth:
     (a) float32, B=256 as 4 micro-batches of 64, one feature-cached step against one
     full-batch step from the same weights at phase 6's limits, every leaf the logit scale's
     included, and one plain-accumulation step (finite; per step 192 + 96 and 96 + 96 block
     launches); (b) the chunked loss (chunk 64) through the model against the same dense step,
     then the loss alone on 32768 x 512 float32 features, forward and backward: dense against
     chunked (chunk 1024) peak memory, the chunked peak under a quarter of the dense one;
     (c) ``main([...])`` in this process, bfloat16, B=256, 6 steps each with ``--loss clip``,
     ``cloob``, ``align --nl_semantic_supervision``, ``--contrastive-impl chunked``,
     ``--accum-freq 4 --feature-cached-accum``, ``--opt lamb``, ``--opt lars``,
     ``--model-ema --val-data synthetic`` and ``--precision int8``: finite logged losses and
     exactly the run's kernel launches (steps x per-step launches, plus the validation
     forwards); (e) the CLI's samples/s, ``data_time`` and ``batch_time`` beside phase 6's
     bfloat16 rate; (d) float32 B=64, 2 epochs x 3 steps, the same run twice (bit for bit?),
     then one cut after a mid-epoch save at step 2 and resumed: its final parameters equal the
     uninterrupted run's bit for bit where the two identical runs agreed bit for bit, else
     within 1e-3 x max|param|. The runs write under ``chip_smoke_logs/`` in the checkout,
     removed at the end;
 14. real data, from the committed fixture (``tests/data/torch_shards``): (a) the host: g++,
     whether a libjpeg program builds, the JPEG libraries the loader knows, nvJPEG beside
     nvcc, the data library's build; (b) the card's decode (nvJPEG and the resample kernel,
     ``ops/csrc/resample.cu``) of the photo shard at 64 px, eval and train, against the host
     pipeline's committed outputs (mean |diff| < 3, correlation > 0.99 per image; the corrupt
     JPEG not ok, the PNG ok exactly when PIL imports), the decode returning on the host while
     a second of work waits on the caller's stream (it runs on the thread's own stream), and
     the resample kernel against its plain version on the same decoded images (within 1 step,
     a second launch the same bits) at B=256 shapes JPEGs to 224 train, 128 train and 224
     eval, with CUDA-event times and the bound (each image's tapped rows and columns read
     once, the output written once); (c) ``data.bench_pipeline`` on the shards: decode
     images/s at 1, 4, 8 and 16 threads, the shards' captions tokenized by the native BPE and
     by the Python one (texts/s each, equal ids or the phase fails), the WdsReader and 4
     InterleavedReaders, beside phase 6's bfloat16 rate; (d) the CLI in this process from the
     shapes shards (``--dataset-type webdataset --dataset-resampled --workers 4``, a real
     ``--val-data``), ViT-B/32 bfloat16
     at B=256, 8 steps each at 224, with ``--wire-size 128`` and with ``--aug-cfg
     color_jitter=0.4 re_prob=0.25``: finite losses and validation metrics, exactly
     8 x (24 + 24) block launches plus 24 for the validation batch and 9 resample launches,
     samples/s over steps 5-8 beside phase 13's and phase 6's rates; (e) the wire upsample at
     B=256, 128 -> 224 in float32, on the card against the CPU (1e-5 x max); (f) ViT-B/32
     served with
     ``wire_size=128``: JPEG requests (``images_b64``, with and without ``"wire": true``)
     against the ``images_u8`` route on the same decoded pixels (cosine >= 0.9999), p50
     latency and encodes/s at bucket 256 from JPEG bytes;
 15. train, evaluate and serve, ViT-B/32 at full width and depth: (a) eval sets made in a
     temporary directory in their stock layouts (CIFAR-10 pickle batches, 1000 test and 1000
     train images; 10 folders x 20 JPEGs at 160 px; Flowers-102 JPEGs with ``.mat`` files
     where scipy imports, else the port's ImportError naming scipy; a COCO-val set of 128 JPEGs
     x 5 captions); (b) ``python -m multimodal_tpu_torch.train.run`` in a child process, the
     entry point users run: bfloat16, B=256, one epoch of 8 synthetic steps with
     ``--model-ema``, evaluating after it (``--zeroshot-frequency 1 --retrieval-frequency 1``:
     zero-shot on CIFAR-10, the folders and Flowers, COCO retrieval) and saving a checkpoint,
     then ``--epochs 0 --resume latest`` (eval-only: the same and the linear probe on CIFAR,
     20 epochs): every metric the reference names finite and in [0, 1], and the eval-only
     numbers equal to the training run's last evaluation; each evaluation's seconds as the
     CLI logged them. The training run is a child process, ``python -m`` as users run it; the
     eval-only run is the CLI's ``main`` in this process, its launches counted exactly (one
     ``block_attention_fwd`` per block for every image and text encode of the zero-shot
     classifiers and batches, the retrieval chunks and the probe's featurisation, and one
     ``resample`` per batch of JPEGs); (c) one CIFAR batch's image features and the CIFAR-10
     classifier from the checkpoint's EMA weights through the kernels against the plain path
     (cosine >= 0.9999, the top-1 agreement printed); (d) the checkpoint served through
     ``serving.load_serving_weights`` with and without the EMA (texts and 64 JPEGs over HTTP):
     the EMA replies against an ``Embedder`` over the EMA weights loaded by hand (cosine >=
     0.9999), the trained weights' replies different, a ``normalize=False`` service's rows not
     unit norm, and ``Embedder.embed_images`` over 4096 uint8 images at bucket 256 (the
     windowed encode, exactly 16 x 12 ``block_attention_fwd`` launches) beside phase 5's rate
     (information); (e) whether tensorstore and
     transformers import; where they do, an OCDBT zarr set written with tensorstore read back
     by ``read_orbax_params`` and ``HFSentenceEncoder`` on a tiny BertModel, card against CPU
     (<= 1e-4); either way the port's ImportError naming each when it is hidden;
 16. captioning, the research toolkit and the profiler: (a) the reference's decoder at full
     width (``ClipCaptionModel()``: GPT-2 base, vocab 50257, 12 layers at W=768; the 8-block
     mapper at S=20, W=768, H=8, head dim 96, through the block kernels) on ViT-B/32 features
     of 256 synthetic images: 4 float32 AdamW steps at B=32 and caption length 40 through the
     kernels against the plain path at phase 6's limits (in step 1 the plain path replays the
     kernel path's ReLU gates, whose flips it counts), exactly 8 + 8 block launches a step,
     samples/s of both paths in turns; then the greedy ``generate(max_len=40)`` at B=32 (one
     token a step against the static cache): first-step logits at cosine >= 0.9999 to the
     plain path's, the tokens equal up to each row's first step where the plain path's top-2
     margin is under 1e-4, tokens/s;
     (b) the port's GPT-2 at base width against ``transformers.GPT2LMHeadModel`` from the same
     random weights (``load_hf_gpt2``), atol 2e-4 + rtol 2e-3; (c) ``--epochs 0
     --captioning-eval`` (the CLI's main in this process) over a COCO-val layout of 128 JPEGs at
     the decoder's defaults (width 256, 4 layers, 3 epochs; the mapper at S=14, W=256): BLEU in
     [0, 1], 12 held out, the launches exactly (12 per encode, the mapper's 2 + 2 a step, 2 per
     decode batch, 1 resample per decode of JPEGs); (d) ``--profile-steps 2`` on a 4-step bf16
     B=256 CLI run: one trace of 2 ``train_step`` spans holding exactly 2 x 24 block forward
     cores and 2 x 24 backward dQ passes, each stream's occupancy at most its sum; (e) vMF EM at
     50,000 x 512, K=10, 20 iterations on the card against the CPU from the same means (weights,
     kappas, log-likelihoods within 1e-4 relative), ms per iteration on each; (f)
     ``run_loss_bench`` at its defaults but 200 steps (``BENCH_CARD_STEPS``) for each
     distribution on the card (seconds, final statistics) and the CPU's trajectory at its
     defaults, 1000 steps, from a CPU generator (seconds; a child process started at phase 15,
     ``LossBenchCpu``); at 5 steps along it, 0 to 999, one card step from the CPU's state with
     the CPU's draws
     against the CPU's step (stats within 1e-4 relative, the mean arc 0.02 degrees, points
     1e-5, concentrations 1e-4); the two free runs are not held to each other, float32
     rounding grows over them; (g)
     ``LlamaCaptioner`` over a tiny random local Llama snapshot written here: card captions
     equal to the CPU's;
 17. the distributed layer on one card: (a) in a child under ``python -m
     torch.distributed.run --nproc-per-node 1`` (this script with ``--dp-child``): the NCCL
     process group at world size 1 (an all-reduce and an all-gather checked), the float32 DP
     step through ``make_train_step(mesh=...)`` against the single-card step from the same
     start (ViT-B/32, B=256, phase 6's limits, exactly 24 + 24 block launches each), and the
     DP step's bfloat16 samples/s beside phase 6's; then in the same process group two steps
     each of the CLI's ``main`` with ``--fsdp`` and with ``--contrastive-impl ring`` (finite
     losses, one experiment directory, the step-2 checkpoint); (b) ``--opt-state-offload``: three float32
     steps with the moments on the card and three offloaded, from one start, at phase 6's
     limits; the moments' bytes on the card between steps (0), the drop in allocated and peak
     memory beside the moments' size; the offloaded bfloat16 samples/s beside phase 6's; (c)
     the ring's schedule (``ring_attention_blocks``) over 4 blocks of a B=2, S=8192, H=8, D=64
     sequence on the flash kernels, full and causal, float32 and bfloat16, against one flash
     call over the whole sequence at phase 3's limits, the launches exactly (16, or 10 causal,
     of each flash kernel), ms of forward + backward beside the one call;
 18. the large-ViT family at full width and depth (``LARGE_VITS``): for each of ViT-L/14,
     ViT-H/14 and ViT-g/14 (vision S=257 through the LN-fold kernels at W=1024 / 1280 / 1408,
     head dims 64 / 80 / 88; text S=77 causal through the non-LN ones): (a) served as in
     phases 4-5 (bucket 256 for L/14, 64 for H/14 and g/14), every image encode at least 24 /
     32 / 40 LN-fold forward launches and every text encode 12 / 24 / 24 non-LN ones, cosine
     >= 0.9999 to the plain-version encode, encodes/s and p50; (b) trained: float32 kernel
     path against plain path for 6 steps (B=16 / 8 / 8) at phase 6's limits with exactly 24 /
     32 / 40 LN-fold and 12 / 24 / 24 non-LN forward and backward launches a step (the
     counts follow from the shipped configs, ``block_need``), then bfloat16 for 6 steps at the
     largest batch the kernel path holds (``bf16_largest_run``: 256 / 192 / 128 as measured,
     then one step of the same model at the next candidate up must run out of memory; where it
     runs, the run moves up, and where the run runs out of memory, down), with bfloat16 AdamW
     moments for H/14 and g/14, as bench.py (one step with float32 moments beside: its peak or
     its out-of-memory error), finite and falling, samples/s and peak memory; (c) ViT-L/14 with
     ``int8_forward=True``: float32 int8 kernel path against plain path at phase 12's limits,
     widened by (b)'s float32 kernel path from the same start, then one bfloat16 run at (b)'s
     bfloat16 batch, finite and falling, its rate beside (b)'s; (d) ViT-L-16,
     ViT-S-16-128, ViT-B-16-512 and ViT-B-32-two-tower-16 at full width and depth, B=32: two
     float32 steps kernel against plain at phase 6's limits with exact launches, one encode of
     each tower through ``Embedder`` with exact launches at cosine >= 0.9999 to the plain
     version, one bfloat16 step, finite; the phase's seconds.
Every bfloat16 training run's exact launch counts hold one launch of the weight-gradient kernel
beside each block backward of either form (``with_wgrad``; float32 forms its weight gradients
with torch.matmul). Before the last line come the card's name and power limit and the kernel
summary (JSON); the last line is the device record.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

MODEL = "ViT-B-32"
SHARED_MODEL = "ViT-B-16"
SCALE_HEADS_MODEL = "ViT-B-16-scale-heads"
REMAT_MODEL = "ViT-B-16-remat"
LONG_MODEL = "ViT-B-32-ctx2048"
LONG_CONTEXT = 2048
LONG_BUCKET = 32  # the serving bucket of the long-context model: 32 x 2048 = 65,536 tokens
LONG_COMPARE_BATCH = 8
OPTIONS_MODEL = "ViT-B-32-cosine-attnpool"
VCLIP_BATCH = 128  # the reference recipe's (scripts/train_vclip.sh)
VCLIP_LOSS = dict(distribution_type="power_spherical", kl_weight=100.0, num_samples=20,
                  var_reg_weight=0.1, label_smoothing=0.1, riemannian=True)
VCLIP_OPT = dict(schedule=1e-3, weight_decay=1e-8)
LORA = dict(lora_rank=8, lora_alpha=16.0)
MOE_MODEL = "ViT-B-32-moe"
MOE_VISION = dict(moe_experts=8, moe_every=2, moe_top_k=2, moe_capacity_factor=1.25)
HIRES = dict(force_image_size=384)  # ViT-B/32's vision tower at S = 12 * 12 + 1 = 145
HIRES_BATCH = 128
_CSRC = "multimodal_tpu_torch/ops/csrc/"
_JAX_BLOCK = "multimodal_tpu/ops/block_attention.py"
_JAX_FUSED = "multimodal_tpu/ops/fused_attention.py"
_JAX_MLP = "multimodal_tpu/ops/block_mlp.py"
_JAX_FLASH = "multimodal_tpu/ops/flash_attention.py"
_JAX_QUANT = "multimodal_tpu/ops/quant.py"
KERNELS = {  # name -> (source, the TPU kernel it replaces, the timed case that stands for it)
    "block_attention_fwd": (_CSRC + "block_attention_fwd.cu", _JAX_BLOCK + ":200", "vision"),
    "block_attention_bwd": (_CSRC + "block_attention_bwd.cu",
                            _JAX_BLOCK + ":272 (_bwd_kernel) and :386 (_bwd_kernel_large)",
                            "vision"),
    "block_attention_ln_fwd": (_CSRC + "block_attention_fwd.cu",
                               _JAX_BLOCK + ":200 (_fwd_kernel, LN-fold form via :650)",
                               "ln-S197"),
    "block_attention_ln_bwd": (_CSRC + "block_attention_bwd.cu",
                               _JAX_BLOCK + ":272 (_bwd_kernel, LN form via :687)", "ln-S197"),
    "fused_attention_fwd": (_CSRC + "fused_attention.cu", _JAX_FUSED + ":61", "fused-S197"),
    "fused_attention_bwd": (_CSRC + "fused_attention.cu", _JAX_FUSED + ":83", "fused-S197"),
    "block_mlp_fwd": (_CSRC + "block_mlp.cu", _JAX_MLP + ":105", "mlp-B16-vision"),
    "block_mlp_bwd": (_CSRC + "block_mlp.cu", _JAX_MLP + ":123", "mlp-B16-vision"),
    "flash_attention_fwd": (_CSRC + "flash_attention.cu", _JAX_FLASH + ":93", "flash-S2048"),
    "flash_attention_dq": (_CSRC + "flash_attention.cu", _JAX_FLASH + ":207", "flash-S2048"),
    "flash_attention_dkv": (_CSRC + "flash_attention.cu", _JAX_FLASH + ":241", "flash-S2048"),
    "quantize_rows": (_CSRC + "quant.cu", _JAX_QUANT + ":31 (quantize_rows) and :22 "
                      "(quantize_weight)", "q-B32-vision-act"),
    "int8_gemm": (_CSRC + "int8_gemm.cu", _JAX_QUANT + ":41 (_int8_product, its rescale :49), "
                  ":78 (_int8_dense_bwd's dx product and rescale) and :100 (int8_matmul), the "
                  "int8 products and their rescales", "g-B32-vision-fc"),
    # not a TPU kernel: the device form of the reference's host JPEG pipeline's resample
    "resample": (_CSRC + "resample.cu", "multimodal_tpu/native/jpeg_pipeline.cc:194 (resample, "
                 "host C++; no TPU kernel)", "resample-B256-train224"),
    # not a TPU kernel: the reference leaves the block backward's weight gradients to XLA
    "block_attention_wgrad": (_CSRC + "block_attention_bwd.cu", "not a TPU kernel: the "
                              "reference's XLA product " + _JAX_BLOCK + ":454 (_attn_wgrad, "
                              "called at :625-626 and :703-704)", "wgrad-vision"),
}
# the kernels that run in one dtype only, and so report that dtype's error and time (every other
# kernel reports float32's); the weight-gradient kernel is bfloat16's (float32 keeps torch.matmul)
KERNEL_DTYPES = {"block_attention_wgrad": "bfloat16"}
# the kernels whose wrapper's host work (tensor maps, scratch) outlasts their device time at the
# main path's shapes: timed, with their library call and other timed runs, by device time
# (``device_ms``), where back-to-back CUDA events would time the host
DEVICE_TIMED = ("block_attention_wgrad",)
# phase 18: the large-ViT family at full width and depth. Per model: the float32
# kernel-vs-plain comparison's batch; the largest bfloat16 batch the card holds as measured
# (bf16_largest_run starts there, proves the next candidate up runs out of memory, and moves
# where it does not; phase 3 times the model's block shapes at it); the serving bucket; the
# AdamW moments' dtype (bench.py's: bfloat16 for H/14 and g/14). The launches follow from the
# shipped configs (block_need).
LARGE_VITS = {
    "ViT-L-14": dict(compare=16, train=256, bucket=256, moments="float32"),
    "ViT-H-14": dict(compare=8, train=192, bucket=64, moments="bfloat16"),
    "ViT-g-14": dict(compare=8, train=128, bucket=64, moments="bfloat16"),
}
# bf16_largest_run's candidates in phase 18
LARGE_CANDIDATES = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384)
B_L14, B_H14, B_G14 = (LARGE_VITS[m]["train"] for m in ("ViT-L-14", "ViT-H-14", "ViT-g-14"))
# phase 18 (d): the other shipped configs at full width and depth
OTHER_CONFIGS = ("ViT-L-16", "ViT-S-16-128", "ViT-B-16-512", "ViT-B-32-two-tower-16")
OTHER_BATCH = 32
BLOCK_CASES = [  # (case, batch, seq, width, heads, causal)
    ("vision", 1, 50, 768, 12, False),
    ("vision", 3, 50, 768, 12, False),
    ("vision", 256, 50, 768, 12, False),
    ("text", 1, 77, 512, 8, True),
    ("text", 256, 77, 512, 8, True),
    ("text-shared", 1, 77, 768, 12, True),  # the shared ViT-B/16 trunk's text pass
    ("text-shared", 256, 77, 768, 12, True),
    ("vision-S197", 4, 197, 768, 12, False),
    ("vision-S197", 256, 197, 768, 12, False),
    ("vision-S257", 2, 257, 1024, 16, False),
    ("vision-D80", 2, 257, 1280, 16, False),  # ViT-H/14's width: head dim 80, a padded k-step
    ("vision-D88", 2, 257, 1408, 16, True),   # ViT-g/14's width: head dim 88
    ("text-W1024", 2, 77, 1024, 16, True),  # the H/14 and g/14 text towers, at their batches
    *(("text-W1024", b, 77, 1024, 16, True) for b in sorted({B_H14, B_G14})),
    ("vclip-vision", 3, 51, 768, 12, False),  # VariationalCLIP: CLS, 49 patches, the
    ("vclip-vision", 256, 51, 768, 12, False),  # concentration token (an odd S)
    ("vclip-text", 3, 78, 512, 8, True),  # 77 tokens and the concentration token, which
    ("vclip-text", 256, 78, 512, 8, True),  # attends to every row
    ("caption-mapper", 3, 20, 768, 8, False),  # the reference decoder's mapper: 10 CLIP
    ("caption-mapper", 32, 20, 768, 8, False),  # tokens and 10 constants, head dim 96
    ("caption-cli", 3, 14, 256, 8, False),  # the CLI decoder's mapper: 4 + 10 tokens, W=256
    ("caption-cli", 32, 14, 256, 8, False),
]
LN_CASES = [  # (case, batch, seq, width, heads, causal, residual)
    ("ln-S145", 3, 145, 768, 12, False, True),    # ViT-B/32's vision tower at 384 px
    ("ln-S145", 256, 145, 768, 12, False, True),
    ("ln-S197", 4, 197, 768, 12, False, True),
    ("ln-S197", 4, 197, 768, 12, True, True),
    ("ln-S197", 4, 197, 768, 12, False, False),
    ("ln-S197", 256, 197, 768, 12, False, True),
    ("ln-S257", 2, 257, 1024, 16, False, True),
    ("ln-S257", B_L14, 257, 1024, 16, False, True),  # ViT-L/14's vision tower, phase 18's B
    ("ln-S320", 2, 320, 768, 12, False, True),
    ("ln-S320", 2, 320, 768, 12, True, True),
    ("ln-D80", 2, 257, 1280, 16, False, True),
    ("ln-D80", B_H14, 257, 1280, 16, False, True),  # ViT-H/14's
    ("ln-D88", 2, 257, 1408, 16, False, True),
    ("ln-D88", B_G14, 257, 1408, 16, False, True),  # ViT-g/14's
]
# the phase-3 cases timed at phase 18's batches (every other block case is timed at B=256)
PHASE18_TIMED = {("text-W1024", B_H14), ("text-W1024", B_G14), ("ln-S257", B_L14),
                 ("ln-D80", B_H14), ("ln-D88", B_G14)}
FUSED_CASES = [  # (case, batch, seq, heads, head_dim, causal)
    ("fused-S128", 2, 128, 8, 32, False),
    ("fused-S128", 2, 128, 8, 32, True),
    ("fused-S197", 4, 197, 12, 64, False),
    ("fused-S197", 4, 197, 12, 64, True),
    ("fused-S197", 256, 197, 12, 64, False),
    ("fused-S512", 2, 512, 4, 128, False),
    ("fused-S512", 2, 512, 4, 128, True),
    ("fused-S129", 3, 129, 12, 64, True),    # one past a 64-row tile edge
    ("fused-S191", 3, 191, 12, 64, False),   # one short of it
    ("fused-S257", 2, 257, 16, 64, False),
    ("fused-S257", 2, 257, 16, 64, True),
    ("fused-S512-D32", 2, 512, 4, 32, False),
]
MLP_CASES = [  # (case, batch, seq, width, hidden, act); T = batch * seq token rows
    ("mlp-B32-vision", 256, 50, 768, 3072, "quick_gelu"),
    ("mlp-B32-text", 256, 77, 512, 2048, "quick_gelu"),
    ("mlp-B16-vision", 256, 197, 768, 3072, "quick_gelu"),
    ("mlp-L14", 64, 257, 1024, 4096, "gelu"),
    ("mlp-ragged", 3, 197, 768, 3072, "quick_gelu"),
]
# bfloat16 only: the edges of the wgmma GEMM under the fused MLP (ops/csrc/wgmma_gemm.cuh):
# T one short of and one past its 128-row tiles of M and the weight gradients' 64-row K-steps
# over T, at W = 128-1024 and H = 128 and 3072; and, at W = H = 128 (one output tile, so a
# bfloat16 split is T // 512 rows, ops/block_mlp.py:_wgrad_splits), T around a split's edge:
# 8 splits of 576 rows (the last 575), 9 of 512, 9 of 576 (the last one row), 10 asked of which
# 9 hold rows (the tenth is zeroed). Each with and without the residual, within 2e-2 x
# max|plain| on every output, a second launch the same bits; not timed
MLP_EDGE_CASES = [  # (case, batch, seq, width, hidden, act)
    ("mlp-edge-T1", 1, 1, 128, 128, "quick_gelu"),
    ("mlp-edge-T1", 1, 1, 768, 3072, "gelu"),
    ("mlp-edge-T63", 1, 63, 512, 128, "gelu"),
    ("mlp-edge-T65", 1, 65, 512, 3072, "quick_gelu"),
    ("mlp-edge-T127", 1, 127, 768, 3072, "quick_gelu"),
    ("mlp-edge-T129", 1, 129, 768, 3072, "gelu"),
    ("mlp-edge-T127", 1, 127, 1024, 128, "gelu"),
    ("mlp-edge-T129", 1, 129, 1024, 3072, "quick_gelu"),
    ("mlp-edge-T255", 1, 255, 128, 3072, "gelu"),
    ("mlp-edge-T257", 1, 257, 128, 128, "quick_gelu"),
    ("mlp-edge-T4607", 1, 4607, 128, 128, "gelu"),
    ("mlp-edge-T4608", 1, 4608, 128, 128, "quick_gelu"),
    ("mlp-edge-T4609", 1, 4609, 128, 128, "gelu"),
    ("mlp-edge-T5121", 1, 5121, 128, 128, "quick_gelu"),
]
FLASH_CASES = [  # (case, batch, sq, sk, heads, head_dim, causal, timed)
    ("flash-S2048", 1, 2048, 2048, 8, 64, True, False),
    ("flash-S2048", 8, 2048, 2048, 8, 64, True, True),  # the text tower's call at B=8
    ("flash-S4096", 2, 4096, 4096, 8, 64, True, True),
    ("flash-S1024-full", 2, 1024, 1024, 8, 64, False, False),
    ("flash-S2048-full", 2, 2048, 2048, 8, 64, False, False),
    ("flash-S2050", 1, 2050, 2050, 8, 64, True, False),
    ("flash-cross", 2, 300, 520, 8, 64, True, False),  # sq != sk: the top-left mask
    ("flash-D80", 2, 514, 514, 4, 80, True, False),
    ("flash-D88", 2, 514, 514, 4, 88, True, False),  # no multiple of 16: a zero-padded k-step
    ("flash-D128", 2, 514, 514, 4, 128, True, False),
    ("flash-D32", 2, 514, 514, 8, 32, False, False),
    ("flash-B32", 32, 2048, 2048, 8, 64, True, True),  # the text tower's call at B=32
]
# bfloat16 only: the wgmma forward's and dK/dV's tile edges (128-row blocks and key tiles,
# 64-row warpgroups and dK/dV query tiles) at every head dim class (one 64-column TMA box or
# two, zero columns past D); each output within 2e-2 x max|plain|, a second launch the same bits
FLASH_EDGE_CASES = [(f"flash-edge-S{s}-D{d}", 2, s, s, 3, d, causal)
                    for s in (127, 129, 255, 257) for causal in (False, True)
                    for d in (8, 24, 64, 96, 128)]
# bfloat16 only: the wgmma dQ's edges, Sq one short of and one past its 128-row query tiles and
# Sk around its key tiles (64 keys, 32 above D=64), Sq != Sk both ways under the top-left mask,
# D = 80 and 88 (a zero-padded last k-step of 16); all three kernels run on them, each output
# within 2e-2 x max|plain|, a second launch the same bits
DQ_EDGE_CASES = [(f"flash-edge-dq-{sq}x{sk}-D{d}", 2, sq, sk, 3, d, causal)
                 for sq, sk, d, causal in [
                     (63, 63, 64, True), (65, 65, 64, False), (127, 65, 64, True),
                     (129, 63, 64, True), (63, 129, 64, True), (129, 129, 64, False),
                     (127, 127, 80, True), (129, 65, 80, False), (31, 33, 88, True),
                     (33, 31, 88, False), (65, 129, 88, True), (129, 127, 88, True),
                     (255, 257, 128, True), (257, 255, 128, False)]]
# bfloat16 only: the wgmma fused forward's edges (ops/csrc/fused_attention.cu): S one short of,
# at and one past its 128-row passes and its key tiles (128, 112 or 96 keys as fused_keys picks
# them; 64 at D=128), D = 32, 64 and 128, causal and not, one item (B=1) and many per block
# (B=256); forward only, within 2e-2 x max|plain|, a second launch the same bits, not timed
FUSED_EDGE_CASES = [(f"fused-edge-S{s}-D{d}", b, s, h, d, causal)
                    for s in (128, 129, 191, 192, 193, 255, 256, 257, 511, 512)
                    for d in (32, 64, 128) for causal in (False, True)
                    for b, h in ((1, 3), (256, 2))]
# both dtypes: the fused backward's edges (ops/csrc/fused_attention.cu): the same lengths, one
# short of, at and one past the dQ kernel's 128-row passes and key tiles (64 keys, 32 above
# D=64), the dK/dV kernel's 128-key passes and 32- or 16-row query tiles,
# and where an item stops fitting the resident rings (D = 128 past 192 query rows or keys); in
# float32 the flash dQ and dK/dV kernels' 128- and 64-row blocks and 32-row tiles, on lse and
# delta that the operator hands them; D = 32, 64 and 128, causal and not,
# B = 1 and 256; dq, dk and dv within 1e-4 / 2e-2 x max|plain|, a second launch the same bits,
# not timed
FUSED_BWD_EDGE_CASES = [(f"fused-bwd-edge-S{s}-D{d}", b, s, h, d, causal)
                        for s in (128, 129, 191, 192, 193, 255, 256, 257, 511, 512)
                        for d in (32, 64, 128) for causal in (False, True)
                        for b, h in ((1, 3), (256, 2))]
# bfloat16 only: the block kernels' edges, both forms (the LN form with the residual): S one
# short of, at and one past the 64-row warpgroups (one item a warpgroup up to S = 64) and the
# 128-row passes, B = 1 and 3 (M = B*S ragged across the GEMMs' 128-row tiles), causal and not,
# at D = 64, and at D = 32 and 128 on the packed and unpacked sides and at S = 320, where D = 128
# streams its tiles; every output within 2e-2 x max|plain|, a second launch the same bits, not
# timed
BLOCK_EDGE_CASES = ([(f"block-edge-S{s}", b, s, 768, 12, causal)
                     for s in (63, 64, 65, 127, 128, 129) for b in (1, 3)
                     for causal in (False, True)]
                    + [(f"block-edge-S{s}-D{w // h}", 3 if s < 320 else 2, s, w, h, causal)
                       for s in (64, 129, 320) for w, h in ((256, 8), (512, 4))
                       for causal in (False, True)])
# bfloat16 only: the block backward's weight-gradient kernel (ops/csrc/wgmma_gemm.cuh's TN form
# over four operand sets, the serial store) at the token rows and widths every block case above
# hands it, both forms (T = B*S, W), once each; against the split walk (attn_wgrad_walk) and the
# library's four bf16 products with float32 out; timed at B=256 and at the caption mappers' B=32
WGRAD_CASES = list(dict.fromkeys((f"wgrad-{case}", b, s, w) for case, b, s, w, *_ in
                                 BLOCK_CASES + LN_CASES))
QUANT_CASES = [  # (case, rows, cols, weight form or None): ViT-B/32's int8 step at B=256
    ("q-B32-vision-x", 256 * 50, 768, None),      # c_fc's input; dx's g of c_proj
    ("q-B32-vision-act", 256 * 50, 3072, None),   # c_proj's input act(h); g of c_fc
    ("q-B32-text-x", 256 * 77, 512, None),
    ("q-B32-text-act", 256 * 77, 2048, None),
    ("q-vision-w1-cols", 768, 3072, "columns"),  # W1 [in, out]: the forward's per-column
    ("q-vision-w1-rows", 768, 3072, "rows"),     # W1 by rows: the backward's (W1^T per column)
    ("q-vision-w2-cols", 3072, 768, "columns"),
    ("q-vision-w2-rows", 3072, 768, "rows"),
    ("q-text-w1-cols", 512, 2048, "columns"),
    ("q-text-w1-rows", 512, 2048, "rows"),
    ("q-text-w2-cols", 2048, 512, "columns"),
    ("q-text-w2-rows", 2048, 512, "rows"),
    # ViT-L/14's int8 step (phase 18 (c)) at its bfloat16 batch: vision 1024 <-> 4096 over
    # B*257 rows, text 768 <-> 3072 over B*77
    ("q-L14-vision-x", B_L14 * 257, 1024, None),
    ("q-L14-vision-act", B_L14 * 257, 4096, None),
    ("q-L14-text-x", B_L14 * 77, 768, None),
    ("q-L14-text-act", B_L14 * 77, 3072, None),
    ("q-L14-vision-w1-cols", 1024, 4096, "columns"),
    ("q-L14-vision-w1-rows", 1024, 4096, "rows"),
    ("q-L14-vision-w2-cols", 4096, 1024, "columns"),
    ("q-L14-vision-w2-rows", 4096, 1024, "rows"),
    ("q-L14-text-w1-cols", 768, 3072, "columns"),
    ("q-L14-text-w1-rows", 768, 3072, "rows"),
    ("q-L14-text-w2-cols", 3072, 768, "columns"),
    ("q-L14-text-w2-rows", 3072, 768, "rows"),
]
GEMM_CASES = [  # (case, M, K, N): y [M, N] = x [M, K] . w [N, K]^T
    ("g-B32-vision-fc", 256 * 50, 768, 3072),    # c_fc forward; c_proj's dx
    ("g-B32-vision-proj", 256 * 50, 3072, 768),  # c_proj forward; c_fc's dx
    ("g-B32-text-fc", 256 * 77, 512, 2048),
    ("g-B32-text-proj", 256 * 77, 2048, 512),
    ("g-L14-vision-fc", B_L14 * 257, 1024, 4096),
    ("g-L14-vision-proj", B_L14 * 257, 4096, 1024),
    ("g-L14-text-fc", B_L14 * 77, 768, 3072),
    ("g-L14-text-proj", B_L14 * 77, 3072, 768),
]
# the store forms: (case suffix, bias, bias after the rounding, out dtype or None for the
# loop's): the product scaled (every dx, the forward without a bias); the bias in one fused
# multiply-add (the float32 train path; in bfloat16 the W8A8 encoders); the bias added after
# the bfloat16 rounding (the bfloat16 train path's forward)
GEMM_STORES = [("", False, False, None), ("+bias", True, False, None),
               ("+bias-after", True, True, "bfloat16")]
GEMM_PROJECTION = ("g-serve-projection", 256, 768, 512)  # the image projection, float32 out
INT8 = {"int8_forward": True}
INT8_NEED = {"block_attention_fwd": 24, "block_attention_bwd": 24, "quantize_rows": 192,
             "int8_gemm": 96}  # 48 dense layers: 4 quantizes and 2 products each a step
AB_RUNS = 3  # the int8/bf16 A/B: each arm this many times, in turns (A, B, B, A, A, B)
INT8_SPREAD = 3.0  # int8_limit: sqrt(2) for two independent roundings, and room for a max
CROSSOVER_TOKENS = 16384  # batch x S of every crossover case (B=8 at S=2048)
TRAIN_BATCH = 256
TRAIN_STEPS = 6  # every train run: the first step warms up, the five after it are timed
SHARED_COMPARE_BATCH = 64  # both paths hold it in float32; the plain path does not hold 256
CAPTIONS = ["a photo of a cat", "two dogs playing in the snow", "a red car on a bridge",
            "東京の夜景 ✨"]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): CUDA-core float32 for
# float32, tensor-core bf16 for bfloat16; HBM3 bytes/s. The float32 flash trio, the block
# kernels' GEMMs and the MLP pair's run 3xTF32 on the tensor cores, whose ceiling is a third
# of the TF32 peak: those kernels' float32 bound is taken at that rate, and their lines give
# the CUDA-core bound beside it
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12
TF32_KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                "block_attention_fwd", "block_attention_bwd", "block_attention_ln_fwd",
                "block_attention_ln_bwd", "block_mlp_fwd", "block_mlp_bwd",
                "fused_attention_bwd")


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


def device_ms(fn, iters: int = 10) -> float:
    """Device time of ``fn`` per call with no host gaps between calls: what a kernel that takes
    less time than its wrapper's host work is measured by. A spin kernel (``torch.cuda._sleep``)
    holds the stream while the host queues ``iters`` calls between two CUDA events, so the
    events time the card alone (with the launches' own gaps, ~1.5 us a call on the H100). Where
    the card reached the first event before the host had queued every call, the spin is made
    four times longer and the run repeated; CUDA events over back-to-back calls where even a
    ~130 ms spin does not cover the host (a call that waits on the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22  # ~2 ms at the H100's clock
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        early = start.query()
        torch.cuda.synchronize()
        if not early:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return cuda_ms(fn, iters)


def profiler_ms(fn, iters: int = 10) -> tuple[float, int]:
    """torch.profiler's reading of ``fn``: the summed device time of its kernel rows over
    ``iters`` calls, per call, and the number of kernel launches the profile recorded (shown
    beside ``device_ms``, which does not depend on it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, records = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:  # kernels; an operator repeats them
            t = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if t is None else t
            records += ev.count
    return total / iters / 1e3, records


def bound(kernel: str, flops: float, nbytes: float,
          dtype_name: str) -> tuple[float, str, float]:
    """The least time the card could take, in ms, what sets it and the FLOPs: the
    operations over the kernel's peak rate (``peak_of``), or each input read once and each
    output written once over the memory rate."""
    t_ops, t_bytes = flops / peak_of(kernel, dtype_name), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def attention_pairs(s: int, causal: bool) -> float:
    """(query, key) pairs one head's attention needs: all of them, or the lower triangle."""
    return s * (s + 1) / 2 if causal else s * s


def peak_of(kernel: str, dtype_name: str) -> float:
    """The rate a kernel's bound is taken at: 3xTF32's ceiling for the float32 kernels that
    run it on the tensor cores, else the dtype's peak."""
    tf32 = dtype_name == "float32" and kernel in TF32_KERNELS
    return PEAK_3XTF32 if tf32 else PEAK_FLOPS[dtype_name]


def block_bound(kernel: str, b, s, w, heads, causal, dtype_name: str):
    """(ms, what bounds it, FLOPs): work of the TPU kernels' definition at this shape. Forward: four [B*S,W]x[W,W] projections and the core's two products.
    Backward: seven projection-sized products (q, k, v recomputed, do, and dx over K=3W) and
    six core products (logits, attnpre, dv, dp, dq, dk), bound in float32 at the 3xTF32
    ceiling. Bytes: x [, dy], the outputs, the weights and biases [, gamma, beta, ln_out,
    dgamma and dbeta in float32]."""
    e = 4 if dtype_name == "float32" else 2
    m, pairs = b * s, b * heads * attention_pairs(s, causal) * (w // heads)
    ln = "_ln_" in kernel
    if kernel.endswith("fwd"):
        flops = 8 * m * w * w + 4 * pairs
        nbytes = e * (2 * m * w + 4 * w * w + 4 * w + (2 * w if ln else 0))
    else:
        flops = 14 * m * w * w + 12 * pairs
        nbytes = e * (7 * m * w + 4 * w * w + 4 * w + ((m * w + 2 * w) if ln else 0))
        nbytes += 8 * w if ln else 0
    return bound(kernel, flops, nbytes, dtype_name)


def fused_bound(kernel: str, b, s, heads, d, causal, dtype_name: str):
    """Forward: two products over q, k, v, out. Backward: five products (logits, dv, dp,
    dq, dk) over q, k, v, do, dq, dk, dv."""
    e = 4 if dtype_name == "float32" else 2
    pairs = b * heads * attention_pairs(s, causal) * d
    if kernel.endswith("fwd"):
        return bound(kernel, 4 * pairs, e * 4 * b * s * heads * d, dtype_name)
    return bound(kernel, 10 * pairs, e * 7 * b * s * heads * d, dtype_name)


def flash_flops(kernel: str, b, sq, sk, heads, d, causal) -> float:
    """Forward: two products a pair (logits, out). dQ: three (logits, dp, dq). dK/dV: four
    (logits, dp, dv, dk); the two backward kernels each rebuild logits and dp, a one-pass
    backward would need five products, 10 x pairs x D. Pairs under the top-left causal mask:
    query r sees keys 0..min(r, sk-1)."""
    n = min(sq, sk)
    pairs = n * (n + 1) / 2 + max(sq - sk, 0) * sk if causal else sq * sk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kernel.rsplit("_", 1)[1]]
    return 2 * products * b * heads * pairs * d


def flash_bound(kernel: str, b, sq, sk, heads, d, causal, dtype_name: str):
    """(ms, what bounds it, FLOPs). Bytes: q, k, v and do or out-sized tensors once each,
    lse and delta in float32. The float32 trio's operations run at the 3xTF32 ceiling, the
    arithmetic it does."""
    e = 4 if dtype_name == "float32" else 2
    flops = flash_flops(kernel, b, sq, sk, heads, d, causal)
    q_size, k_size, rows = b * sq * heads * d, b * sk * heads * d, 4 * b * heads * sq
    nbytes = {"fwd": e * (2 * q_size + 2 * k_size) + rows,
              "dq": e * (3 * q_size + 2 * k_size) + 2 * rows,
              "dkv": e * (2 * q_size + 4 * k_size) + 2 * rows}[kernel.rsplit("_", 1)[1]]
    return bound(kernel, flops, nbytes, dtype_name)


def rate_note(kernel: str, dtype_name: str, ms: float, b_ms: float, flops: float) -> str:
    """A timed line's rate: TFLOP/s, the share of its bound reached, and for a float32 kernel
    bound at the 3xTF32 ceiling the CUDA cores' bound too."""
    note = f" tflops={flops / ms / 1e9:.1f} of_bound={100 * b_ms / ms:.1f}%"
    if peak_of(kernel, dtype_name) == PEAK_3XTF32:
        b_cc = 1e3 * flops / PEAK_FLOPS["float32"]
        note += f" bound_cuda_cores_ms={b_cc:.4f} of_cuda_core_bound={100 * b_cc / ms:.1f}%"
    return note


def mlp_bound(kernel: str, t, w, hid, dtype_name: str):
    """Work of the TPU kernels' definition: two [T,W]x[W,H]-sized products forward, four
    backward. Bytes forward: x, y, h and the parameters; backward: x, dy, h, dx, both weights
    and both weight gradients, and the four vector sums in float32."""
    e = 4 if dtype_name == "float32" else 2
    if kernel.endswith("fwd"):
        return bound(kernel, 4 * t * w * hid,
                     e * (2 * t * w + t * hid + 2 * w * hid + hid + 3 * w), dtype_name)
    nbytes = e * (3 * t * w + t * hid + 4 * w * hid + 2 * w) + 4 * (hid + 3 * w)
    return bound(kernel, 8 * t * w * hid, nbytes, dtype_name)


def wgrad_bound(t: int, w: int, splits: int):
    """(ms, what bounds it, FLOPs) of the block backward's four weight gradients: 8 T W^2 bf16
    FLOPs; the six bf16 operands [T, W] read once (a, shared by three products; dq, dk, dv,
    attnpre, dy), the four bf16 [W, W] gradients written once, and the running sums the serial
    store writes and reads back between splits (float32 [4, W, W], splits - 1 times each way)."""
    nbytes = 2 * 6 * t * w + 2 * 4 * w * w + 2 * 4 * 4 * w * w * (splits - 1)
    return bound("block_attention_wgrad", 8 * t * w * w, nbytes, "bfloat16")


def kernel_cases(torch, ba, fa, bm, fl, dtype):
    """Every (kernel, case, shape text, timed, run kernel, run plain, library, other timed
    runs by name, output names, bound) of phase 3 for one dtype, built lazily: each case
    frees its tensors before the next is made. ``library`` is None or (run, view): one
    PyTorch call computing the same function on the same tensors, timed as ``library_ms``
    and used nowhere in the port, and the view of its result that has the layout of the
    plain version's first output."""
    import torch.nn.functional as F

    name = str(dtype).replace("torch.", "")

    def block_inputs(b, s, w):
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
        x = rnd(b, s, w).to(dtype)
        ws = []
        for _ in range(4):
            ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
        dy = rnd(b, s, w).to(dtype)
        gamma, beta = (1 + 0.1 * rnd(w)).to(dtype), (0.1 * rnd(w)).to(dtype)
        return x, ws, dy, gamma, beta

    def mha(x, ws, heads, causal):
        """The library yardstick of the non-LN block kernels: torch's multi-head attention
        with separate q/k/v weights on views of the same tensors (sequence-first input,
        [out, in] weights); returns [B, S, W]."""
        wq, bq, wk, bk, wv, bv, wo, bo = ws
        s, w = x.shape[1], x.shape[2]
        xt = x.transpose(0, 1)
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").triu(1) if causal else None
        return F.multi_head_attention_forward(
            xt, xt, xt, w, heads, None, torch.cat([bq, bk, bv]), None, None, False, 0.0,
            wo.t(), bo, need_weights=False, attn_mask=mask, is_causal=causal,
            use_separate_proj_weight=True, q_proj_weight=wq.t(), k_proj_weight=wk.t(),
            v_proj_weight=wv.t())[0].transpose(0, 1)

    for case, b, s, w, heads, causal in BLOCK_CASES:
        x, ws, dy, _, _ = block_inputs(b, s, w)
        kw = dict(heads=heads, causal=causal)
        shape = f"B={b:<3} S={s} W={w} H={heads} causal={causal!s:<5}"
        # the library's backward is timed on a graph built once; like the kernel it gives
        # the gradient of x (the weight gradients are outside the kernel and outside this)
        x_leaf = x.detach().requires_grad_()
        mha_out = mha(x_leaf, ws, heads, causal)
        # the caption rows at their B=32, the H/14 and g/14 text shape at phase 18's batches
        timed = b == 256 or case.startswith("caption") or (case, b) in PHASE18_TIMED
        yield ("block_attention_fwd", case, shape, timed,
               lambda: ba.block_attention(x, *ws, **kw),
               lambda: ba.block_attention_reference(x, *ws, **kw),
               (lambda: mha(x, ws, heads, causal), lambda y: y), {}, ("y",),
               block_bound("block_attention_fwd", b, s, w, heads, causal, name))
        yield ("block_attention_bwd", case, shape, timed,
               lambda: ba.block_attention_bwd(x, dy, *ws, **kw),
               lambda: ba.block_attention_bwd_reference(x, dy, *ws, **kw),
               (lambda: torch.autograd.grad(mha_out, [x_leaf], dy, retain_graph=True),
                lambda grads: grads[0]), {},
               ("dx", "dq", "dk", "dv", "attnpre"),
               block_bound("block_attention_bwd", b, s, w, heads, causal, name))
    for case, b, s, w, heads, causal, residual in LN_CASES:
        x, ws, dy, gamma, beta = block_inputs(b, s, w)
        kw = dict(heads=heads, causal=causal, residual=residual)
        shape = f"B={b:<3} S={s} W={w} H={heads} causal={causal!s:<5} residual={residual!s:<5}"
        # beside the fold, what it replaces: ln_rows, the non-LN kernel and the add as three
        # steps (the S<=128 dispatch), to show what the fold buys on this card. No library
        # call: no single PyTorch call holds the LayerNorm, the attention block and the add
        timed = b == 256 or (case, b) in PHASE18_TIMED
        yield ("block_attention_ln_fwd", case, shape, timed,
               lambda: ba.block_attention_ln(x, gamma, beta, *ws, **kw),
               lambda: ba.block_attention_ln_reference(x, gamma, beta, *ws, **kw), None,
               {"unfolded_ms": lambda: x + ba.block_attention(
                   ba.ln_rows(x, gamma, beta, ba.LN_EPS), *ws, heads=heads, causal=causal)},
               ("y",), block_bound("block_attention_ln_fwd", b, s, w, heads, causal, name))
        yield ("block_attention_ln_bwd", case, shape, timed,
               lambda: ba.block_attention_ln_bwd(x, dy, gamma, beta, *ws, **kw),
               lambda: ba.block_attention_ln_bwd_reference(x, dy, gamma, beta, *ws, **kw),
               None, {}, ("dx", "dq", "dk", "dv", "attnpre", "ln_out", "dgamma", "dbeta"),
               block_bound("block_attention_ln_bwd", b, s, w, heads, causal, name))
    block_edges = BLOCK_EDGE_CASES if dtype == torch.bfloat16 else []
    for case, b, s, w, heads, causal in block_edges:
        x, ws, dy, gamma, beta = block_inputs(b, s, w)
        kw = dict(heads=heads, causal=causal)
        shape = f"B={b:<3} S={s} W={w} H={heads} causal={causal!s:<5}"
        yield ("block_attention_fwd", case, shape, False,
               lambda: ba.block_attention(x, *ws, **kw),
               lambda: ba.block_attention_reference(x, *ws, **kw), None, {}, ("y",),
               block_bound("block_attention_fwd", b, s, w, heads, causal, name))
        yield ("block_attention_bwd", case, shape, False,
               lambda: ba.block_attention_bwd(x, dy, *ws, **kw),
               lambda: ba.block_attention_bwd_reference(x, dy, *ws, **kw), None, {},
               ("dx", "dq", "dk", "dv", "attnpre"),
               block_bound("block_attention_bwd", b, s, w, heads, causal, name))
        yield ("block_attention_ln_fwd", case, shape, False,
               lambda: ba.block_attention_ln(x, gamma, beta, *ws, residual=True, **kw),
               lambda: ba.block_attention_ln_reference(x, gamma, beta, *ws, residual=True, **kw),
               None, {}, ("y",),
               block_bound("block_attention_ln_fwd", b, s, w, heads, causal, name))
        yield ("block_attention_ln_bwd", case, shape, False,
               lambda: ba.block_attention_ln_bwd(x, dy, gamma, beta, *ws, residual=True, **kw),
               lambda: ba.block_attention_ln_bwd_reference(x, dy, gamma, beta, *ws,
                                                           residual=True, **kw),
               None, {}, ("dx", "dq", "dk", "dv", "attnpre", "ln_out", "dgamma", "dbeta"),
               block_bound("block_attention_ln_bwd", b, s, w, heads, causal, name))
    for case, b, s, w in (WGRAD_CASES if dtype == torch.bfloat16 else []):
        t = b * s
        g = torch.Generator(device="cuda").manual_seed(t + w)
        ops = [torch.randn(t, w, generator=g, device="cuda").to(dtype) for _ in range(6)]
        pairs = tuple(zip((ops[0],) * 3 + (ops[4],), ops[1:4] + ops[5:]))
        splits, rows = ba.wgrad_plan(t, w)
        shape = f"T={b}x{s} W={w} splits={splits}x{rows}"
        # the library yardstick: the four products as cuBLAS bf16 GEMMs with float32 out (no
        # rounding to bf16); beside it, as information, what the port ran before the kernel:
        # both operands widened to float32 and a float32 product, rounded
        timed = (b == 256 or case.startswith("wgrad-caption")
                 or (case[len("wgrad-"):], b) in PHASE18_TIMED)
        yield ("block_attention_wgrad", case, shape, timed,
               lambda: ba.attn_wgrad(*ops, dtype),
               lambda: ba.attn_wgrad_walk(*ops, dtype),
               (lambda: tuple(torch.mm(a.T, dz, out_dtype=torch.float32) for a, dz in pairs),
                lambda grads: grads[0]),
               {"widened_f32_ms": lambda: tuple(ba._attn_wgrad(a, dz, dtype) for a, dz in pairs)},
               ("dWq", "dWk", "dWv", "dWo"), wgrad_bound(t, w, splits))
    fused_edges = FUSED_EDGE_CASES if dtype == torch.bfloat16 else []
    for case, b, s, heads, d, causal in fused_edges:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s + d)
        q, k, v = (torch.randn(b, s, heads * d, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        kw = dict(heads=heads, causal=causal)
        shape = f"B={b:<3} S={s} H={heads} D={d} causal={causal!s:<5}"
        yield ("fused_attention_fwd", case, shape, False, lambda: fa.fused_attention(q, k, v, **kw),
               lambda: fa.fused_attention_reference(q, k, v, **kw), None, {}, ("out",),
               fused_bound("fused_attention_fwd", b, s, heads, d, causal, name))
    for case, b, s, heads, d, causal in FUSED_BWD_EDGE_CASES:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s + d)
        q, k, v, do = (torch.randn(b, s, heads * d, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        # the backward takes the forward kernel's out and lse, as the operator hands them over
        # (float32 reads them for delta and p; bfloat16 forms its own)
        kw = dict(heads=heads, causal=causal)
        bwd_kw = dict(zip(("out", "lse"), fa.fused_attention_fwd(q, k, v, **kw)), **kw)
        shape = f"B={b:<3} S={s} H={heads} D={d} causal={causal!s:<5}"
        yield ("fused_attention_bwd", case, shape, False,
               lambda: fa.fused_attention_bwd(q, k, v, do, **bwd_kw),
               lambda: fa.fused_attention_bwd_reference(q, k, v, do, **kw), None, {},
               ("dq", "dk", "dv"),
               fused_bound("fused_attention_bwd", b, s, heads, d, causal, name))
    for case, b, s, heads, d, causal in FUSED_CASES:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
        q, k, v, do = (torch.randn(b, s, heads * d, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        kw = dict(heads=heads, causal=causal)
        shape = f"B={b:<3} S={s} H={heads} D={d} causal={causal!s:<5}"
        # the library yardstick: one scaled_dot_product_attention call on the same tensors
        # (head-major views of them); its backward is timed on a graph built once
        packed = lambda t: t.transpose(1, 2).reshape(b, s, heads * d)  # noqa: E731
        qh, kh, vh, doh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v, do))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        yield ("fused_attention_fwd", case, shape, b == 256,
               lambda: fa.fused_attention(q, k, v, **kw),
               lambda: fa.fused_attention_reference(q, k, v, **kw),
               (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal), packed),
               {}, ("out",),
               fused_bound("fused_attention_fwd", b, s, heads, d, causal, name))
        bwd_kw = dict(zip(("out", "lse"), fa.fused_attention_fwd(q, k, v, **kw)), **kw)
        yield ("fused_attention_bwd", case, shape, b == 256,
               lambda: fa.fused_attention_bwd(q, k, v, do, **bwd_kw),
               lambda: fa.fused_attention_bwd_reference(q, k, v, do, **kw),
               (lambda: torch.autograd.grad(sdpa_out, leaves, doh, retain_graph=True),
                lambda grads: packed(grads[0])), {},
               ("dq", "dk", "dv"),
               fused_bound("fused_attention_bwd", b, s, heads, d, causal, name))
    mlp_edges = MLP_EDGE_CASES if dtype == torch.bfloat16 else []
    for case, b, s, w, hid, act in MLP_CASES + mlp_edges:
        t = b * s
        g = torch.Generator(device="cuda").manual_seed(t + hid)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
        x, dy = rnd(t, w).to(dtype), rnd(t, w).to(dtype)
        w1, b1 = (rnd(w, hid) * w ** -0.5).to(dtype), (rnd(hid) * 0.02).to(dtype)
        w2, b2 = (rnd(hid, w) * hid ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)
        gamma, beta = 1 + 0.1 * rnd(w), 0.1 * rnd(w)  # float32, as the blocks hand them in
        h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act)[1]
        # no library call: no single PyTorch call holds the LayerNorm, both products, the
        # activation and the add. Beside the kernels, as information and no yardstick, the
        # same products as plain torch.matmul calls in the same dtype: c_fc and c_proj (#9);
        # dy W2^T, dh W1^T, g^T dy and ln^T dh (#10). Timed with the residual; the branch alone
        # is compared only
        ln, g_act = ba.ln_rows(x, gamma.to(dtype), beta.to(dtype), ba.LN_EPS), bm.act_fwd(h, act)
        dh = ((dy @ w2.T).float() * bm.act_bwd(h.float(), act)).to(dtype)
        matmul = {"block_mlp_fwd": lambda: (ln @ w1, g_act @ w2),
                  "block_mlp_bwd": lambda: (dy @ w2.T, dh @ w1.T, g_act.T @ dy, ln.T @ dh)}
        for residual in (True, False):
            timed = residual and case != "mlp-ragged" and not case.startswith("mlp-edge")
            kw = dict(act=act, residual=residual)
            shape = f"T={b}x{s} W={w} H={hid} act={act} residual={residual!s:<5}"
            yield ("block_mlp_fwd", case, shape, timed,
                   lambda: bm.block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, **kw),
                   lambda: bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, **kw),
                   None, {"matmul_ms": matmul["block_mlp_fwd"]}, ("y", "h"),
                   mlp_bound("block_mlp_fwd", t, w, hid, name))
            yield ("block_mlp_bwd", case, shape, timed,
                   lambda: bm.block_mlp_bwd(x, dy, h, gamma, beta, w1, w2, **kw),
                   lambda: bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, **kw),
                   None, {"matmul_ms": matmul["block_mlp_bwd"]},
                   ("dx", "dW1", "dW2", "db1", "db2", "dgamma", "dbeta"),
                   mlp_bound("block_mlp_bwd", t, w, hid, name))
    edges = ([(*c, False) for c in FLASH_EDGE_CASES + DQ_EDGE_CASES]
             if dtype == torch.bfloat16 else [])
    for case, b, sq, sk, heads, d, causal, timed in FLASH_CASES + edges:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + sq)
        q, k, v, do = (torch.randn(b, s_, heads, d, generator=g, device="cuda").to(dtype)
                       for s_ in (sq, sk, sk, sq))
        kw = dict(causal=causal)
        shape = f"B={b:<3} Sq={sq} Sk={sk} H={heads} D={d} causal={causal!s:<5}"
        # the backward kernels take the forward kernel's out and lse, as the operator's
        # backward hands them over; delta = rowsum(do * out) is formed outside, once
        out, lse = fl.flash_attention_fwd(q, k, v, **kw)
        delta = fl.flash_delta(out, do)
        # the library yardstick: one scaled_dot_product_attention call on head-major views of
        # the same tensors; its one backward call yields dq, dk and dv together, so both
        # backward kernels are timed beside the whole of it. Not at sq != sk
        library = {}
        if sq == sk and not case.startswith("flash-edge"):
            heads_first = lambda t: t.transpose(1, 2)  # noqa: E731
            qh, kh, vh, doh = (heads_first(t) for t in (q, k, v, do))
            leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            sdpa_grad = lambda which: (  # noqa: E731
                lambda: torch.autograd.grad(sdpa_out, leaves[which], doh, retain_graph=True))
            library = {
                "fwd": (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
                        heads_first),
                "dq": (sdpa_grad(slice(0, 1)), lambda grads: heads_first(grads[0])),
                "dkv": (sdpa_grad(slice(1, 3)), lambda grads: heads_first(grads[0])),
            }
        yield ("flash_attention_fwd", case, shape, timed,
               lambda: fl.flash_attention_fwd(q, k, v, **kw),
               lambda: fl.flash_attention_reference(q, k, v, **kw),
               library.get("fwd"), {}, ("out", "lse"),
               flash_bound("flash_attention_fwd", b, sq, sk, heads, d, causal, name))
        yield ("flash_attention_dq", case, shape, timed,
               lambda: fl.flash_attention_dq(q, k, v, do, lse, delta, **kw),
               lambda: fl.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[:1],
               library.get("dq"), {}, ("dq",),
               flash_bound("flash_attention_dq", b, sq, sk, heads, d, causal, name))
        yield ("flash_attention_dkv", case, shape, timed,
               lambda: fl.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
               lambda: fl.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[1:],
               library.get("dkv"), {}, ("dk", "dv"),
               flash_bound("flash_attention_dkv", b, sq, sk, heads, d, causal, name))


def phase_kernels(torch, ba, fa, bm, fl) -> dict:
    """Every kernel vs plain at every case and both dtypes; times at B=256 (ViT-L/14's MLP
    shape at B=64; the flash trio at B=8 S=2048 and B=2 S=4096). The library
    call, where there is one, is held to the plain version's first output too, at a wider
    limit (1e-3 and 5e-2 x max|plain|: it rounds at other points and sums in another
    order), so that its time is the time of the same function. Times are CUDA events over
    back-to-back calls, device time (``device_ms``) for ``DEVICE_TIMED``'s kernels and their
    library calls. ``worst_f32`` holds each kernel's worst error in float32, or in the one dtype
    ``KERNEL_DTYPES`` names for it."""
    worst_f32 = dict.fromkeys(KERNELS, 0.0)
    timing, failures = {}, []
    for dtype, rel_tol, lib_tol in ((torch.float32, 1e-4, 1e-3), (torch.bfloat16, 2e-2, 5e-2)):
        name = str(dtype).replace("torch.", "")
        for (kernel, case, shape, timed, kern, plain, library, others, outputs,
             (b_ms, b_by, flops)) in kernel_cases(torch, ba, fa, bm, fl, dtype):
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            errs, ok = [], len(got) == len(want) == len(outputs)
            for gt, wt in zip(got, want):
                gt, wt = gt.float(), wt.float()
                err, ref_max = (gt - wt).abs().max().item(), wt.abs().max().item()
                ok = ok and bool(torch.isfinite(gt).all()) and err <= rel_tol * ref_max
                errs.append((err, ref_max))
            err = max(e for e, _ in errs)
            detail = " ".join(f"{o}={e:.2e}/{m:.2e}" for o, (e, m) in zip(outputs, errs))
            line = (f"{kernel} {case:<11} {shape} {name:<8} max_abs_err/max|plain| {detail} "
                    f"(tol {rel_tol:g} x max|plain|) {'ok' if ok else 'MISMATCH'}")
            if library is not None:
                lib_run, lib_view = library
                lib_err = (lib_view(lib_run()).float() - want[0].float()).abs().max().item()
                lib_ok = lib_err <= lib_tol * errs[0][1]
                ok = ok and lib_ok
                line += f" library_err={lib_err:.2e}{'' if lib_ok else ' LIBRARY MISMATCH'}"
            if kernel.startswith(("block_attention", "block_mlp")) or case.startswith(
                    ("flash-edge", "fused-edge", "fused-bwd-edge")) or (
                    timed and kernel.startswith(("fused_attention", "flash_attention"))):
                # no float atomics, one owner and a fixed order for every sum: a second launch
                # gives the same bits, every output
                again = kern()
                again = again if isinstance(again, tuple) else (again,)
                same = all(torch.equal(a, b) for a, b in zip(again, got))
                ok = ok and same
                line += f" same_bits_twice={same}"
                del again
            del got, want
            if timed:
                slow = ("S197" in case or case.startswith(("mlp", "flash"))
                        or case in {c for c, _ in PHASE18_TIMED})
                iters = 8 if slow else 20
                timer = device_ms if kernel in DEVICE_TIMED else cuda_ms
                k_ms, p_ms = timer(kern, iters), cuda_ms(plain, iters)
                other_ms = {k: timer(fn, iters) for k, fn in others.items()}
                if library is not None:
                    other_ms["library_ms"] = timer(library[0], iters)
                timing[(kernel, case, name)] = {
                    "ms": k_ms, "plain_ms": p_ms, "library_ms": other_ms.get("library_ms"),
                    "bound_ms": b_ms, "bound_by": b_by}
                line += (f" kernel_ms={k_ms:.4f}{' (device)' if timer is device_ms else ''} "
                         f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})"
                         + "".join(f" {k}={v:.4f}" for k, v in other_ms.items()))
                line += rate_note(kernel, name, k_ms, b_ms, flops)
            print(line, flush=True)
            if not ok:
                failures.append(line)
            if name == KERNEL_DTYPES.get(kernel, "float32"):
                worst_f32[kernel] = max(worst_f32[kernel], err)
        torch.cuda.empty_cache()
    if failures:
        fail(f"{len(failures)} kernel/plain mismatches")
    return {"worst_f32": worst_f32, "timing": timing}


def quant_bound(kernel: str, elems: int, in_bytes: int, out_bytes: int, rows: int,
                cols: int):
    """(ms, what bounds it, operations) of a quantize, either form: x read once, the int8
    codes and a float32 scale a row (a column in the column form) written once, over the
    CUDA cores' float32 rate for its 4 operations an element (abs, max, divide, round)."""
    return bound(kernel, 4 * elems, elems * (in_bytes + out_bytes) + 4 * rows, "float32")


def gemm_bound(m: int, k: int, n: int, out_bytes: int, bias: bool = False):
    """(ms, what bounds it, operations) of an int8 GEMM with its rescale: 2MNK int8 operations
    at the tensor cores' dense int8 rate, or the codes, the scales [, the bias] read once and
    y written once."""
    nbytes = m * k + n * k + m * n * out_bytes + 4 * m + 4 * n * (2 if bias else 1)
    return bound("int8_gemm", 2 * m * k * n, nbytes, "int8")


def quant_cases(torch, q, dtype):
    """Every (kernel, case, shape text, timed, run kernel, run plain, others, bound) of the
    int8 kernels for one activation dtype, built lazily. Quantize inputs hold a zero row and a
    row of exact .5 ties (amax 127: both forms give scale 1.0), a zero column and a column of
    ties for the column form; weights are float32 and run both scale forms (the train step's
    "reciprocal", timed, and the serving load's "divide"), once, with the float32 loop. GEMM
    inputs are random codes and scales, each store form at the step's four products (out in
    the loop's dtype; the bias after the rounding in bfloat16 only), and the image projection
    in float32; beside each product's first form, as information, the same product as
    ``torch._int_mm`` (cuBLASLt: int32 out, no rescale) and as a bfloat16 ``torch.matmul``."""
    name = str(dtype).replace("torch.", "")
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, 3.5, -0.5, 126.5], device="cuda")
    for case, rows, cols, weight in QUANT_CASES:
        if weight and dtype != torch.float32:
            continue
        g = torch.Generator(device="cuda").manual_seed(rows + cols)
        lead, inner = (cols, rows) if weight == "columns" else (rows, cols)
        x = torch.randn(lead, inner, generator=g, device="cuda") * (0.05 if weight else 3.0)
        x[0] = 0.0
        x[1] = ties.repeat(inner // 8)
        x = x.t().contiguous() if weight == "columns" else x.to(torch.float32 if weight else dtype)
        b_ms, b_by, ops = quant_bound("quantize_rows", rows * cols, x.element_size(), 1,
                                      cols if weight == "columns" else rows, cols)
        run, plain = ((q.quantize_weight, q.quantize_weight_reference) if weight == "columns"
                      else (q.quantize_rows, q.quantize_rows_reference))
        for form in (("reciprocal", "divide") if weight else ("reciprocal",)):
            shape = f"R={rows} C={cols} {weight or 'rows':<7} {form:<10}"
            yield ("quantize_rows", case, shape, form == "reciprocal",
                   (lambda x=x, form=form, run=run: run(x, form)),
                   (lambda x=x, form=form, plain=plain: plain(x, form)), {},
                   (b_ms, b_by, ops, rows * cols * (x.element_size() + 1) + 4 * rows))
    cases = [(case, m, k, n, store) for case, m, k, n in GEMM_CASES for store in GEMM_STORES]
    cases.append((*GEMM_PROJECTION, ("", False, False, "float32")))
    for case, m, k, n, (suffix, bias, after, out) in cases:
        out_dtype = getattr(torch, out) if out else dtype
        if out and out_dtype != dtype:
            continue
        g = torch.Generator(device="cuda").manual_seed(m + k + n)
        aq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        bq = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        sx = torch.rand(m, generator=g, device="cuda") * 0.05
        sw = torch.rand(n, generator=g, device="cuda") * 1e-3
        b = torch.randn(n, generator=g, device="cuda") * 0.02 if bias else None
        kw = dict(out_dtype=out_dtype, round_before_bias=after)
        others = {}
        if not suffix:
            a16, b16 = aq.to(torch.bfloat16), bq.to(torch.bfloat16).t().contiguous()
            others = {"int_mm_ms": (lambda aq=aq, bq=bq: torch._int_mm(aq, bq.t()), 2 * m * k * n),
                      "bf16_matmul_ms": (lambda a=a16, b=b16: a @ b, 2 * m * k * n)}
        b_ms, b_by, ops = gemm_bound(m, k, n, torch.empty(0, dtype=out_dtype).element_size(), bias)
        shape = (f"M={m} K={k} N={n} bias={'after' if after else bias!s:<5} "
                 f"out={str(out_dtype)[6:]}")
        yield ("int8_gemm", case + suffix, shape, True,
               (lambda aq=aq, bq=bq, sx=sx, sw=sw, b=b, kw=kw: q.int8_gemm(aq, bq, sx, sw, b,
                                                                         **kw)),
               (lambda aq=aq, bq=bq, sx=sx, sw=sw, b=b, kw=kw: q.int8_gemm_reference(
                   aq, bq, sx, sw, b, **kw)),
               others, (b_ms, b_by, ops, None))


def phase_quant_kernels(torch, q) -> dict:
    """The row-quantize kernel (both forms) and the int8 GEMM against their plain versions at
    ViT-B/32's int8 shapes (B=256), float32 and bfloat16: every output the same bits (codes,
    scales, the GEMM's rescaled values in every store form), a second launch the same bits
    again; each kernel's device time (``device_ms``; beside it torch.profiler's reading with the
    kernel records it holds, and the CUDA-event time of back-to-back calls, which holds the
    wrapper's host work too) with GB/s (quantize) or TOP/s (GEMM) and the share of the
    bound; beside each GEMM its product's ``torch._int_mm`` and bfloat16 ``torch.matmul``
    device times and rates, as information; the plain versions by CUDA events."""
    worst_f32 = {"quantize_rows": 0.0, "int8_gemm": 0.0}
    timing, failures, t0 = {}, [], time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for kernel, case, shape, timed, kern, plain, others, (b_ms, b_by, ops, nbytes) in (
                quant_cases(torch, q, dtype)):
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
            twice = all(torch.equal(a, b) for a, b in zip(again, got))
            diff = max(int((a != b).sum()) for a, b in zip(got, want))
            ok = same and twice and all(bool(torch.isfinite(a.float()).all()) for a in got)
            line = (f"{kernel} {case:<25} {shape} {name:<8} bit for bit vs plain={same} "
                    f"(differing elements {diff}) same_bits_twice={twice} "
                    f"{'ok' if ok else 'MISMATCH'}")
            del got, want, again
            if timed:
                k_ms, p_ms = device_ms(kern), cuda_ms(plain, 5)
                prof_ms, records = profiler_ms(kern)
                rate = (f"GB/s={nbytes / k_ms / 1e6:.1f}" if nbytes is not None
                        else f"TOP/s={ops / k_ms / 1e9:.1f}")
                line += (f" kernel_ms={k_ms:.4f} (device; profiler {prof_ms:.4f} from {records} "
                         f"kernel records of 10 calls; events {cuda_ms(kern, 20):.4f}) "
                         f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) {rate} "
                         f"of_bound={100 * b_ms / k_ms:.1f}%")
                for other, (fn, flops) in others.items():
                    o_ms, unit = device_ms(fn), "TOP/s" if other.startswith("int") else "TFLOP/s"
                    line += f" {other}={o_ms:.4f} ({flops / o_ms / 1e9:.1f} {unit})"
                timing[(kernel, case, name)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                                "bound_ms": b_ms, "bound_by": b_by}
            print(line, flush=True)
            if not ok:
                failures.append(line)
        torch.cuda.empty_cache()
    if failures:
        fail(f"{len(failures)} int8 kernel/plain mismatches")
    print(f"  the int8 kernels' cases took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"worst_f32": worst_f32, "timing": timing}


def qkv_repeats(torch, ba):
    """The block backward's recomputed q, k and v against the forward's, bit for bit, in both
    forms (vision S=50 and the LN form at S=197, B=4) and both dtypes: the two run the
    projection GEMM's NN loop over the same A values (x; ln_out, whose elements are the
    forward's LN load transform's) and add the bias and round alike."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for ln, b, s, w, heads in ((False, 4, 50, 768, 12), (True, 4, 197, 768, 12)):
            g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
            rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
            x, dy = rnd(b, s, w).to(dtype), rnd(b, s, w).to(dtype)
            ws = []
            for _ in range(4):
                ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
            gamma, beta = (1 + 0.1 * rnd(w)).to(dtype), (0.1 * rnd(w)).to(dtype)
            fwd, bwd = (torch.empty((3, b * s, w), dtype=dtype, device="cuda") for _ in range(2))
            kw = dict(heads=heads, causal=False)
            if ln:
                ba._block_attention_ln_cuda(x, gamma, beta, *ws, residual=True, qkv=fwd, **kw)
                ba._block_attention_ln_bwd_cuda(x, dy, gamma, beta, *ws, residual=True, qkv=bwd,
                                                **kw)
            else:
                ba._block_attention_cuda(x, *ws, qkv=fwd, **kw)
                ba._block_attention_bwd_cuda(x, dy, *ws, qkv=bwd, **kw)
            torch.cuda.synchronize()
            same = torch.equal(fwd, bwd)
            print(f"block_attention_{'ln_' if ln else ''}bwd recomputed q, k, v vs the forward's "
                  f"B={b} S={s} W={w} {name}: same_bits={same}", flush=True)
            if not same:
                fail("the backward's recomputed q, k, v differ from the forward's")


def flash_long_error(torch, fl) -> float:
    """The float32 flash forward at S=8192 (B=1, H=8, D=64, causal), four times the longest
    shipped text context, where its sums run longest: out and lse against the plain version,
    each within 1e-4 x max|plain|. Returns the larger absolute error."""
    g = torch.Generator(device="cuda").manual_seed(8192)
    q, k, v = (torch.randn(1, 8192, 8, 64, generator=g, device="cuda") for _ in range(3))
    got = fl.flash_attention_fwd(q, k, v, causal=True)
    want = fl.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    errs = [((a - r).abs().max().item(), r.abs().max().item()) for a, r in zip(got, want)]
    ok = all(e <= 1e-4 * m for e, m in errs) and all(bool(torch.isfinite(a).all()) for a in got)
    print(f"flash_attention_fwd flash-S8192 B=1 Sq=8192 Sk=8192 H=8 D=64 causal=True float32 "
          "max_abs_err/max|plain| " + " ".join(f"{o}={e:.2e}/{m:.2e}" for o, (e, m) in
                                               zip(("out", "lse"), errs))
          + f" (tol 1e-4 x max|plain|) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the float32 flash forward breaks its limit at S=8192")
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return max(e for e, _ in errs)


def flash_crossover(torch, attention, card):
    """Where the dispatch's rule (causal, S >= MIN_FLASH_SEQ) stands on this card: the flash
    operator against the plain attention path through ``attention()``, forward plus backward
    at H=8 D=64 and 16,384 tokens a batch, time and peak memory beyond the operands."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for s in (1024, 2048, 4096):
            for causal in (True, False):
                b = CROSSOVER_TOKENS // s
                g = torch.Generator(device="cuda").manual_seed(s)
                q, k, v, do = (torch.randn(b, s, 8, 64, generator=g, device="cuda").to(dtype)
                               for _ in range(4))
                leaves = [t.requires_grad_() for t in (q, k, v)]
                cells = {}
                for impl in ("flash", "xla"):
                    def run():
                        out = attention(*leaves, causal=causal, impl=impl)
                        torch.autograd.grad(out, leaves, do)
                    run()
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    ms = cuda_ms(run, iters=4, warmup=1)
                    cells[impl] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**20)
                print(f"  crossover S={s} B={b} causal={causal!s:<5} {name:<8} fwd+bwd ms: flash "
                      f"{cells['flash'][0]:.3f} plain path {cells['xla'][0]:.3f}; peak MiB "
                      f"beyond the operands: flash {cells['flash'][1]:.0f} plain path "
                      f"{cells['xla'][1]:.0f} [{card}]", flush=True)
                del q, k, v, do, leaves
                torch.cuda.empty_cache()


def kernel_label(mangled: str) -> str:
    """A kernel's name with its template arguments, from its mangled name: mangled as they
    stand (Li64E is 64, Lb1E true, f float, 13__nv_bfloat16 bfloat16) except the attention
    kernels' operand structs and the projection GEMM's types, form, load and store, written
    out (flash_dq_kernel<Tf32Ops<64>>, fused_fwd_kernel<FusedOps<64, 112>>,
    mma_gemm_kernel<bfloat16, float, TN, LN-b, round>; the block kernels' wgmma GEMMs end in
    ", x3", wgmma_gemm_kernel<bfloat16, bfloat16, NN, LN, round, x3>, their weight gradients'
    in ", x4", wgmma_gemm_kernel<bfloat16, bfloat16, TN, plain, serial, x4>)."""
    from multimodal_tpu_torch.ops._build import gemm_sets, gemm_signature

    found = re.search(r"_cu_[0-9a-f]{8}\d+([a-z][a-z_0-9]*_kernel)(I\w+?E)?Ev", mangled)
    if not found:
        return mangled.split()[-1]
    ops = re.fullmatch(r"INS_\d+(\w+Ops)I((?:Li\d+E)+)EE+", found.group(2) or "")
    if ops:
        ints = ", ".join(re.findall(r"Li(\d+)E", ops.group(2)))
        return f"{found.group(1)}<{ops.group(1)}<{ints}>>"
    gemm = gemm_signature(mangled)
    if gemm:  # the block kernels' wgmma GEMMs (three operand sets; four for the weight
        # gradients) marked x3 or x4
        sets = gemm_sets(mangled)
        return f"{found.group(1)}<{', '.join(gemm)}{f', x{sets}' if sets > 1 else ''}>"
    return found.group(1) + (found.group(2) or "")


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of ``nvcc -Xptxas -v``'s output: its name with its template
    arguments (``kernel_label``), stack and spill bytes, registers and static shared
    memory."""
    lines, name = [], "?"
    for ln in log.splitlines():
        text = ln.strip().replace("ptxas info    : ", "")
        if "Function properties for" in text:
            name = kernel_label(text)
        elif "spill" in text:
            lines.append(f"{name}: {text}")
        elif "registers" in text and lines:
            lines[-1] += f"; {text}"
    return lines


def read_sass(lib_path: str) -> str | None:
    """The built library's SASS (``cuobjdump -sass``), or None where the toolkit has no
    ``cuobjdump``."""
    from multimodal_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    return subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def sass_report(sass: str) -> str:
    """Tensor-core (HMMA), ldmatrix (LDSM) and asynchronous-copy (LDGSTS) instructions in the
    SASS, summed over the bfloat16 attention passes (``*_mma_kernel``)."""
    counts, kernels, inside = dict.fromkeys(("HMMA", "LDSM", "LDGSTS"), 0), 0, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "_mma_kernel" in ln
            kernels += inside
        elif inside:
            for op in counts:
                counts[op] += f" {op}." in ln
    return f"{kernels} *_mma_kernel functions in the SASS: {counts}"


def hmma_forms(sass: str) -> dict[str, dict[str, int]]:
    """Per flash-attention kernel, bfloat16 fused-attention kernel (the forward, the backward's
    dQ and dK/dV) and projection GEMM in the SASS (each instantiation:
    dtype and head dim, or types and form, as ``kernel_label`` names it), its tensor-core
    instructions counted by form (HMMA.16816.F32.BF16 is mma.sync m16n8k16 on bf16,
    HMMA.1688.F32.TF32 m16n8k8 on TF32, HGMMA.64x128x16.F32.BF16 a wgmma)."""
    kernels, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_label(ln) if ("flash_" in ln or "fused_fwd_kernel" in ln
                                        or "fused_d" in ln or "mma_gemm_kernel" in ln) else None
            if name:
                kernels.setdefault(name, {})
        elif name:
            found = re.search(r"\b(?:HMMA|[A-Z]*GMMA)(\.\S+?)?(?=\s)", ln)
            if found:
                form = found.group(0)
                kernels[name][form] = kernels[name].get(form, 0) + 1
    return kernels


def hmma_report(sass: str) -> list[str]:
    """One line per kernel of ``hmma_forms``: its tensor-core instructions by form, or that it
    has none."""
    return [f"{k}: " + (", ".join(f"{form} x {n}" for form, n in sorted(c.items()))
                        or "no HMMA (CUDA cores)") for k, c in sorted(hmma_forms(sass).items())]


def gemm_hmma_faults(sass: str) -> list[str]:
    """The projection GEMM's instantiations whose products are not all on the tensor cores in
    their dtype's form: HMMA.16816.F32.BF16 for bfloat16 operands, HMMA.1688.F32.TF32 (3xTF32)
    for float32. An instantiation with no HMMA at all is a fault too."""
    want = {"bfloat16": "HMMA.16816.F32.BF16", "float": "HMMA.1688.F32.TF32"}
    faults = []
    for name, forms in sorted(hmma_forms(sass).items()):
        if name.startswith("mma_gemm_kernel<"):
            dtype = name[len("mma_gemm_kernel<"):].split(",")[0]
            if set(forms) != {want[dtype]}:
                faults.append(f"{name}: {forms or 'no HMMA'}")
    return faults


# their bfloat16 forms run wgmma
WGMMA_FLASH = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def flash_wgmma_faults(sass: str) -> list[str]:
    """The bfloat16 instantiations of the flash forward, dQ and dK/dV (every one not on
    Tf32Ops) whose products are not all wgmma: one with an HMMA, or with no GMMA, is a fault,
    and so is a kernel with no bfloat16 instantiation at all. The float32 forms keep mma.sync
    (3xTF32)."""
    faults, seen = [], set()
    for name, forms in sorted(hmma_forms(sass).items()):
        kernel = name.split("<")[0]
        if kernel not in WGMMA_FLASH or "Tf32Ops" in name:
            continue
        seen.add(kernel)
        if any(f.startswith("HMMA") for f in forms) or not any("GMMA" in f for f in forms):
            faults.append(f"{name}: {forms or 'no tensor-core instructions'}")
    return faults + [f"{k}: no bfloat16 instantiation" for k in WGMMA_FLASH if k not in seen]


def wgmma_instantiation_faults(sass: str, kernel: str | tuple, expected: int) -> list[str]:
    """The instantiations of ``kernel`` (a name, or a tuple of names counted together) whose
    products are not all wgmma: one with an HMMA, or with no GMMA, is a fault, and so is a build
    with fewer than ``expected`` of them."""
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    faults, seen = [], 0
    for name, forms in sorted(hmma_forms(sass).items()):
        if name.split("<")[0] not in kernels:
            continue
        seen += 1
        if any(f.startswith("HMMA") for f in forms) or not any("GMMA" in f for f in forms):
            faults.append(f"{name}: {forms or 'no tensor-core instructions'}")
    if seen < expected:
        faults.append(f"{seen} {' / '.join(kernels)} instantiations in the SASS, {expected} "
                      "expected")
    return faults


# the bfloat16 fused kernels of fused_attention.cu: the forward with 128-, 112- and 96-key
# tiles at D <= 64 and 64 above; the backward's dQ and dK/dV at D <= 64 and above, in the fused
# form (the block form's eight instantiations beside them are counted by block_wgmma_faults)
FUSED_WGMMA_KERNELS = ("fused_fwd_kernel", "fused_dq_kernel", "fused_dkv_kernel")
FUSED_WGMMA_INSTANTIATIONS = 8
# the float32 fused backward: the flash dQ and dK/dV kernels on Tf32Ops (3xTF32), at D <= 64
# and above
FUSED_TF32_KERNELS = ("flash_dq_kernel", "flash_dkv_kernel")
FUSED_TF32_INSTANTIATIONS = 4


def fused_wgmma_faults(sass: str) -> list[str]:
    """The fused attention's kernels of its own off their tensor-core form, or missing: every
    bfloat16 instantiation (the forward, the backward's dQ and dK/dV) must be all wgmma, with
    no HMMA; every instantiation of the float32 backward (the flash dQ and dK/dV kernels on
    Tf32Ops) all HMMA.1688.F32.TF32 (3xTF32), with no other form. The float32 forward keeps
    attention_passes.cuh's forward core (attention_f32_kernel), which the block kernels
    share."""
    faults = wgmma_instantiation_faults(sass, FUSED_WGMMA_KERNELS, FUSED_WGMMA_INSTANTIATIONS)
    seen = 0
    for name, forms in sorted(hmma_forms(sass).items()):
        if name.split("<")[0] in FUSED_TF32_KERNELS and "Tf32Ops" in name:
            seen += 1
            if set(forms) != {"HMMA.1688.F32.TF32"}:
                faults.append(f"{name}: {forms or 'no HMMA'}")
    if seen < FUSED_TF32_INSTANTIATIONS:
        faults.append(f"{seen} {' / '.join(FUSED_TF32_KERNELS)} instantiations in the SASS, "
                      f"{FUSED_TF32_INSTANTIATIONS} expected")
    return faults


# the bfloat16 GEMM of the fused MLP: c_fc, c_proj with and without the residual, dh, dln, dW2
# and dW1, each its own instantiation of wgmma_gemm_kernel
MLP_WGMMA_INSTANTIATIONS = 7


def wgmma_form_faults(forms: dict, expected: int, what: str) -> list[str]:
    """Of ``hmma_forms``' entries ``forms``, those whose products are not all wgmma (an HMMA, or
    no GMMA), and a fault if there are fewer than ``expected`` of them."""
    faults = [f"{k}: {v or 'no tensor-core instructions'}" for k, v in sorted(forms.items())
              if any(f.startswith("HMMA") for f in v) or not any("GMMA" in f for f in v)]
    if len(forms) < expected:
        faults.append(f"{len(forms)} {what} instantiations in the SASS, {expected} expected")
    return faults


def mlp_wgmma_faults(sass: str) -> list[str]:
    """The fused MLP's bfloat16 GEMM instantiations (wgmma_gemm_kernel with one operand set) off
    wgmma, or fewer than the MLP launches. The float32 MLP keeps mma_gemm_kernel (3xTF32), held
    by ``gemm_hmma_faults``."""
    forms = {k: v for k, v in hmma_forms(sass).items()
             if k.startswith("wgmma_gemm_kernel<") and not k.endswith((", x3>", ", x4>"))}
    return wgmma_form_faults(forms, MLP_WGMMA_INSTANTIATIONS, "wgmma_gemm_kernel")


# the block-attention kernels' bfloat16 instantiations: the wgmma GEMM with three operand sets in
# five forms (NN q/k/v or out projection with the plain load and round store, with the LN load,
# with the two-rounding residual store; NT do and dx in bfloat16, and g in float32) and with four
# in one (TN, the serial store: the weight gradients), and the backward's dQ and dK/dV kernels in
# their block form at D <= 64 and above, with one or two items a pass
BLOCK_GEMM_INSTANTIATIONS = 6
BLOCK_ATTENTION_INSTANTIATIONS = 8


def block_wgmma_faults(sass: str) -> list[str]:
    """The block kernels' bfloat16 GEMM and attention instantiations off wgmma (an HMMA, or no
    GMMA), or fewer of them than the block kernels launch. Their float32 GEMMs stay on
    mma_gemm_kernel (3xTF32, ``gemm_hmma_faults``) and their float32 passes on the CUDA cores;
    at D = 80, 88 and 96 the bfloat16 passes stay on mma.sync (``sass_report``'s
    *_mma_kernel)."""
    forms = hmma_forms(sass)
    gemms = {k: v for k, v in forms.items()
             if k.startswith("wgmma_gemm_kernel<") and k.endswith((", x3>", ", x4>"))}
    attn = {k: v for k, v in forms.items() if re.fullmatch(
        r"fused_d(?:q|kv)_kernel<Fused(?:Dq|Dkv)Ops<(?:\d+, )+1, [01]>>", k)}
    return (wgmma_form_faults(gemms, BLOCK_GEMM_INSTANTIATIONS, "block GEMM")
            + wgmma_form_faults(attn, BLOCK_ATTENTION_INSTANTIATIONS, "block attention"))


def int8_gmma_counts(sass: str) -> dict[str, int]:
    """Per instantiation of the int8 GEMM in the SASS, its warpgroup tensor-core instructions
    (``wgmma`` on s8 is IGMMA); 0 would mean its products left the tensor cores."""
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_label(ln) if "int8_gemm_kernel" in ln else None
            if name:
                counts[name] = 0
        elif name and "GMMA" in ln:
            counts[name] += 1
    return counts


def pass_smem_report() -> list[str]:
    """Dynamic shared memory a block of each attention pass asks for at launch, in bytes, as
    ``attention_passes.cuh`` sizes it: bfloat16 by the head dim rounded up to 64 or 128,
    float32 by the head dim."""
    lines = []
    for dp in (64, 128):  # 64-row resident tiles, two stages of two 32-row streamed tiles
        tile = lambda rows: 2 * rows * (dp + 8)  # noqa: E731
        lines.append(f"bfloat16 D<={dp}: forward {tile(64 + 128)}, dQ {tile(128 + 128)}, "
                     f"dK/dV {tile(128 + 128) + 24 * 32}")
    for d in (64, 128):
        tile, probs = 4 * 64 * (d + 4), 4 * 64 * 68
        lines.append(f"float32 D={d}: forward {3 * tile + probs}, dQ {4 * tile + probs}, "
                     f"dK/dV {4 * tile + 2 * probs + 768}")
    return lines


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


def check_embeddings(name: str, emb, n: int, dim: int):
    emb = np.asarray(emb, np.float32)
    if emb.shape != (n, dim) or not np.isfinite(emb).all():
        fail(f"{name}: shape {emb.shape} (want ({n}, {dim})) or non-finite values")
    norms = np.linalg.norm(emb, axis=-1)
    if np.abs(norms - 1).max() > 1e-4:
        fail(f"{name}: embeddings not unit norm ({norms})")
    return emb


@contextlib.contextmanager
def plain_attention(mods):
    """Every kernel call of the model routed to its plain version (the gradient then comes
    from torch's autograd of that version): the block operator in both its forms, the fused
    and the flash operator behind ``attention()``, the fused MLP operator, and the int8 row
    quantize and rescale (every int8 product of training and serving calls them through the
    ``ops.quant`` module)."""
    ba, fa, bm, fl, q = mods["ba"], mods["fa"], mods["bm"], mods["fl"], mods["q"]
    layers, attention = mods["layers"], mods["attention"]

    def plain_block_attention(x, *ws, heads, causal=False, ln_scale=None, ln_bias=None,
                              residual=False):
        xn = ba.ln_rows(x, ln_scale, ln_bias, ba.LN_EPS) if ln_scale is not None else x
        out = ba.block_attention_reference(xn, *ws, heads=heads, causal=causal)
        return x + out if residual else out

    def plain_block_mlp(x, w1, b1, w2, b2, *, ln_scale, ln_bias, act="quick_gelu",
                        residual=True):
        y, _ = bm.block_mlp_reference(x.reshape(-1, x.shape[-1]), ln_scale, ln_bias, w1, b1, w2,
                                      b2, act=act, residual=residual)
        return y.reshape(x.shape)

    def plain_flash_attention(q, k, v, *, causal=False, sm_scale=None):
        return fl.flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)[0]

    kernel_paths = (layers.block_attention, attention.fused_attention, layers.block_mlp,
                    attention.flash_attention, q.quantize_rows, q.quantize_weight, q.int8_gemm)
    layers.block_attention = plain_block_attention
    attention.fused_attention = fa.fused_attention_reference
    layers.block_mlp = plain_block_mlp
    attention.flash_attention = plain_flash_attention
    q.quantize_rows, q.quantize_weight = q.quantize_rows_reference, q.quantize_weight_reference
    q.int8_gemm = q.int8_gemm_reference
    try:
        yield
    finally:
        (layers.block_attention, attention.fused_attention, layers.block_mlp,
         attention.flash_attention, q.quantize_rows, q.quantize_weight,
         q.int8_gemm) = kernel_paths


class Tally:
    """Kernel launches of the main-path runs: each run sets every count to 0 just before it
    and reads the counts just after; comparison launches never pass through here."""

    def __init__(self, launches):
        self.launches, self.total = launches, dict.fromkeys(KERNELS, 0)

    def start(self):
        self.launches.reset_launch_counts()

    def stop(self) -> dict:
        counts = self.launches.launch_counts()
        for k in self.total:
            self.total[k] += counts[k]
        return counts


def phase_serving(torch, mods, tally, card, kind, model_name, need_text, need_image,
                  block_mlp=False, bucket=256, quantized=False, model=None):
    """Serve ``model_name`` (float32, seeded weights; or ``model``, the caller's, which it
    keeps) over HTTP; check the answers, the launch counts (``need_*``: kernel -> launches per
    tower encode) and the agreement with the plain-version encode; then throughput at
    ``bucket`` and single-request latency. Returns the encodes/s by tower.
    ``quantized`` serves the int8 W8A8 encoders (``EmbeddingService(quantized=True)``), whose
    embeddings must also hold cosine > 0.99 to the float32 encode of the same model."""
    from multimodal_tpu_torch.data.tokenizer import tokenize
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.serving import EmbeddingService, make_server

    t0 = time.perf_counter()
    if model is None:
        model = create_model(model_name, seed=0, block_mlp=block_mlp)
    dim, size = model.cfg.embed_dim, model.cfg.vision.image_size
    svc = EmbeddingService(model, max_batch=bucket, max_wait_ms=5.0, quantized=quantized)
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    model_name += (" block_mlp" if block_mlp else "") + (" int8 W8A8" if quantized else "")
    print(f"  model {model_name} float32 on {kind} built and served in "
          f"{time.perf_counter() - t0:.2f} s at {url}", flush=True)
    try:
        images = np.random.default_rng(0).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
        images_u8 = [base64.b64encode(a.tobytes()).decode() for a in images]
        tally.start()
        code_t, text = post(url + "/v1/embed/text", {"texts": CAPTIONS})
        code_i, image = post(url + "/v1/embed/image", {"images_u8": images_u8})
        code_s, sim = post(url + "/v1/similarity", {"texts": CAPTIONS, "images_u8": images_u8})
        counts = tally.stop()
        health, stats = get(url + "/healthz"), get(url + "/v1/stats")
        if (code_t, code_i, code_s) != (200, 200, 200):
            fail(f"HTTP status text={code_t} image={code_i} similarity={code_s}: "
                 f"{text.get('error')} {image.get('error')} {sim.get('error')}")
        txt = check_embeddings("text", text["embeddings"], len(CAPTIONS), dim)
        img = check_embeddings("image", image["embeddings"], len(images), dim)
        sims = np.asarray(sim["similarity"], np.float32)
        if sims.shape != (3, len(CAPTIONS)) or np.abs(sims - img @ txt.T).max() > 1e-4:
            fail(f"similarity {sims.shape} disagrees with the embedded rows")
        n_text, n_image = stats["text"]["batches"], stats["image"]["batches"]
        print(f"  healthz {health}", flush=True)
        print(f"  stats text={stats['text']} image={stats['image']}", flush=True)
        need = dict.fromkeys(KERNELS, 0)
        for per_encode, n in ((need_text, n_text), (need_image, n_image)):
            for k, per in per_encode.items():
                need[k] += per * n
        need = {k: v for k, v in need.items() if v}
        print(f"  launches during serving: { {k: counts[k] for k in need} } over {n_text} text "
              f"and {n_image} image tower encodes (need >= {need})", flush=True)
        if n_text < 2 or n_image < 2 or any(counts[k] < v for k, v in need.items()):
            fail("the serving path did not run its kernel in every block")
        tokens = tokenize(CAPTIONS, model.cfg.text.context_length)
        with plain_attention(mods):
            p_txt = svc._embedder.encode_tokens(tokens)
            p_img = svc._embedder.encode_images(images)
        cos_t = float((np.sum(p_txt * txt, -1)).min())
        cos_i = float((np.sum(p_img * img, -1)).min())
        print(f"  served vs plain-version encode: min cosine text={cos_t:.7f} "
              f"image={cos_i:.7f} (need >= 0.9999)", flush=True)
        if min(cos_t, cos_i) < 0.9999:
            fail("served embeddings disagree with the plain-version encode")
        if quantized:
            from multimodal_tpu_torch.inference import Embedder

            exact = Embedder(model, batch_size=bucket)
            f_t, f_i = exact.encode_tokens(tokens), exact.encode_images(images)
            gate_t = float(np.sum(f_t * txt, -1).min())
            gate_i = float(np.sum(f_i * img, -1).min())
            print(f"  served int8 vs the float32 encode: min cosine text={gate_t:.6f} "
                  f"image={gate_i:.6f} (need > 0.99)", flush=True)
            if min(gate_t, gate_i) <= 0.99:
                fail("the int8 embeddings left the float32 encode (cosine <= 0.99)")

        print(f"  throughput ({model_name})", flush=True)
        emb = svc._embedder
        rates = {}
        rng = np.random.default_rng(1)
        batch_img = rng.integers(0, 256, (bucket, size, size, 3), dtype=np.uint8)
        batch_tok = np.repeat(tokens, bucket // len(tokens), axis=0)
        for name, fn, arg in (("image", emb.encode_images, batch_img),
                              ("text", emb.encode_tokens, batch_tok)):
            fn(arg)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(arg)
            rate = rates[name] = 5 * bucket / (time.perf_counter() - t0)
            print(f"  {model_name} {name} encodes/s at bucket {bucket} "
                  f"({'int8, bfloat16 activations' if quantized else 'float32'}, host clock "
                  f"incl. transfer): {rate:.1f} [{card}]", flush=True)
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
            print(f"  {model_name} single-request {name} p50 latency: "
                  f"{float(np.median(lat[1:])):.2f} ms [{card}]", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)
    del model, svc
    torch.cuda.empty_cache()
    return rates


def make_batch(torch, cfg, n: int) -> dict:
    """The synthetic uint8 batch of bench.py, normalized on the card by the step."""
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    return {
        "image": torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)).cuda(),
        "text": torch.from_numpy(rng.integers(1, cfg.text.vocab_size - 1,
                                              (n, cfg.text.context_length))).cuda(),
    }


def train_steps(torch, tally, model, batch, steps: int, grads_at: int = -1, count=True,
                loss_type: str = "clip", loss_kwargs: dict | None = None,
                opt_kw: dict | None = None, freeze: str | None = None,
                step_kw: dict | None = None, state_dtype=None) -> dict:
    """``steps`` training steps from a fresh optimizer (by default as bench.py builds it; with
    ``freeze`` a fine-tune mode of ``train.freeze``, the optimizer over the trainable
    parameters alone). Returns the per-step ``metrics`` and launch ``counts``, the gradients
    after step ``grads_at`` (0-based), the host-clock seconds of every step after the first
    (``time``), the ``peak`` device memory and the optimizer state's bytes (``opt_bytes``).
    The step's generator is a CUDA generator seeded 0, so two runs draw alike. ``step_kw``
    goes to ``make_train_step`` (a mesh, the moments' offload); ``state_dtype`` is the AdamW
    moments' dtype (float32 unless given)."""
    from multimodal_tpu_torch.train import (
        TrainState, finetune_mask, freeze_optimizer, make_optimizer, make_schedule,
        make_train_step)

    opt_kw = dict(opt_kw or dict(
        schedule=make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
        weight_decay=0.1, grad_clip_norm=1.0))
    schedule = opt_kw.pop("schedule")
    if state_dtype is not None:
        opt_kw["state_dtype"] = state_dtype
    if freeze:
        opt = freeze_optimizer(model, finetune_mask(model.named_parameters(), freeze), schedule,
                               **opt_kw)
    else:
        opt = make_optimizer(model.named_parameters(), schedule, **opt_kw)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_type=loss_type, loss_kwargs=loss_kwargs,
                           **(step_kw or {}))
    generator = torch.Generator(device="cuda").manual_seed(0)
    out = {"metrics": [], "counts": [], "grads": None, "time": 0.0}
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        tally.start()
        t0 = time.perf_counter()
        m = step(state, batch, generator)
        torch.cuda.synchronize()
        if i > 0:
            out["time"] += time.perf_counter() - t0
        # the plain path's counts are read but kept out of the main-path tally
        out["counts"].append(tally.stop() if count else tally.launches.launch_counts())
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == grads_at:
            out["grads"] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                            if p.grad is not None}
    out["peak"] = torch.cuda.max_memory_allocated()
    out["opt_bytes"] = sum(t.numel() * t.element_size()
                           for moments in (opt.mu, opt.nu) for t in moments.values())
    return out


def with_wgrad(need: dict) -> dict:
    """``need`` of a bfloat16 run: one launch of the weight-gradient kernel beside every block
    backward, either form (a float32 run forms its weight gradients with torch.matmul)."""
    n = need.get("block_attention_bwd", 0) + need.get("block_attention_ln_bwd", 0)
    return {**need, "block_attention_wgrad": n} if n else dict(need)


def check_launches(counts, need: dict, what: str):
    """Every step of ``counts`` ran each kernel of ``need`` just that often, and no kernel
    outside it."""
    for cnt in counts:
        if {k: v for k, v in cnt.items() if v} != need:
            fail(f"{what}: launches per step {cnt}, need {need} and nothing else")


def model_label(model_name: str, block_mlp=False, variational=None, model_kw=None) -> str:
    return model_name + (" block_mlp" if block_mlp else "") + (
        f" variational {variational.model_type}" if variational else "") + "".join(
        f" {k}={v}" for k, v in (model_kw or {}).items())


def build_model(torch, model_name, dtype, block_mlp=False, variational=None, model_kw=None,
                prepare=None):
    """``create_model`` on the card with seed 0 and the options given; ``prepare(model)`` runs
    after it (a weight load)."""
    from multimodal_tpu_torch.models import create_model

    model = create_model(model_name, dtype=dtype, seed=0, block_mlp=block_mlp,
                         variational=variational is not None, vcfg=variational,
                         **(model_kw or {}))
    if prepare is not None:
        prepare(model)
    return model


def compare_paths(torch, mods, tally, card, model_name, n, steps, need, block_mlp=False,
                  variational=None, model_kw=None, prepare=None, routing=None, code_flips=None,
                  int8_reference=None, model=None, keep_grads=False, **step_kw) -> dict:
    """float32: ``steps`` steps through the kernels against the same from the same start
    with every kernel call routed to its plain version. ``variational`` (a
    ``VariationalConfig``) builds the variational model, ``model_kw`` goes to
    ``create_model`` and ``prepare`` to ``build_model``; ``step_kw`` goes to ``train_steps``
    (with ``freeze``, every frozen parameter must end bit for bit where it started, on both
    paths). ``routing`` (a ``RoutingRecorder``) records a MoE model's expert choices on both
    paths: a step whose choices differ in d > 0 of its decisions holds its loss to
    ``moe_loss_limit(d, tokens)`` and prints its grad norm and leaves without holding them.
    ``code_flips`` (a ``CodeFlips``) counts an int8 model's flipped codes in the first two
    steps; ``int8_reference`` (the float step's ``train_steps`` result from the same start)
    widens an int8 model's limits by ``int8_limit``, the loss and grad norm of each step and
    every leaf of step 1 by its own int8-vs-float distance. Returns the kernel path's
    ``peak`` memory, the model's parameter count (``params``), the optimizer state's bytes
    (``opt_bytes``), the kernel path's per-step ``metrics``, samples/s (``rate``) and the
    ``model`` after the plain path's run; with ``keep_grads`` also the kernel path's gradients
    after step 1 (``grads``). ``model``: the float32 model ``build_model`` would
    give, built by the caller (phase 18 serves it first)."""
    if model is None:
        model = build_model(torch, model_name, torch.float32, block_mlp, variational,
                            model_kw, prepare)
    model_name = model_label(model_name, block_mlp, variational, model_kw)
    batch = make_batch(torch, model.cfg, n)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = []
    if step_kw.get("freeze"):
        from multimodal_tpu_torch.train import finetune_mask

        frozen = [k for k, t in finetune_mask(model.named_parameters(), step_kw["freeze"]).items()
                  if not t]

    def run(**kw):
        if routing is not None:
            routing.attach(model)
        if code_flips is not None:
            code_flips.attach()
        out = train_steps(torch, tally, model, batch, steps, grads_at=0, **kw, **step_kw)
        out["routes"] = routing.detach() if routing is not None else None
        if code_flips is not None:
            code_flips.detach()
        params = dict(model.named_parameters())
        moved = [k for k in frozen if not torch.equal(params[k], start[k])]
        if moved:
            fail(f"{model_name}: frozen parameters moved: {moved[:5]}")
        return out

    k_run = run()
    model.load_state_dict(start)
    with plain_attention(mods):
        p_run = run(count=False)
    k_metrics, p_metrics = k_run["metrics"], p_run["metrics"]
    flips = ([routing.flips(k_run["routes"], p_run["routes"], i) for i in range(2)]
             if routing is not None else [0, 0])
    for i in range(2):
        km, pm = k_metrics[i], p_metrics[i]
        print(f"  float32 step {i + 1}: loss kernel={km['loss']:.7f} plain={pm['loss']:.7f} "
              f"grad_norm kernel={km['grad_norm']:.6f} plain={pm['grad_norm']:.6f} "
              f"launches { {k: v for k, v in k_run['counts'][i].items() if v} }"
              + (f" routing flips d={flips[i]} of {routing.decisions(k_run['routes'], i)}"
                 if routing is not None else "")
              + (f" int8 code flips {code_flips.flips[i]} of {code_flips.codes[i]} "
                 f"(share {code_flips.share(i):.3e})" if code_flips is not None else ""),
              flush=True)
    print(f"  float32 losses kernel {[round(m['loss'], 7) for m in k_metrics]} plain "
          f"{[round(m['loss'], 7) for m in p_metrics]}", flush=True)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    tokens = n * routing.seq if routing is not None else 1
    loss_rel = [rel(k_metrics[i]["loss"], p_metrics[i]["loss"]) for i in range(2)]
    norm_rel = [rel(k_metrics[i]["grad_norm"], p_metrics[i]["grad_norm"]) for i in range(2)]
    # per leaf |kernel - plain| / max|plain|; a leaf whose exact gradient is zero (the
    # attention key biases: softmax ignores a per-row constant) holds rounding noise on both
    # sides, so the scale has a floor of 1e-3 x the largest gradient of the model
    k_grads, p_grads = k_run["grads"], p_run["grads"]
    g_max = max(g.abs().max() for g in p_grads.values())
    leaf_dist = lambda grads: {  # noqa: E731
        n_: ((grads[n_] - g).abs().max() / torch.clamp(g.abs().max(), min=1e-3 * g_max)).item()
        for n_, g in p_grads.items()}
    leaf_rel = leaf_dist(k_grads)
    loss_lim = [moe_loss_limit(d, tokens) for d in flips]
    norm_lim, leaf_lim = [1e-4, 1e-4], dict.fromkeys(leaf_rel, 1e-3)
    if int8_reference is not None:
        ref = int8_reference["metrics"]
        loss_lim = [int8_limit(lim, rel(k_metrics[i]["loss"], ref[i]["loss"]))
                    for i, lim in enumerate(loss_lim)]
        norm_lim = [int8_limit(1e-4, rel(k_metrics[i]["grad_norm"], ref[i]["grad_norm"]))
                    for i in range(2)]
        leaf_lim = {n_: int8_limit(1e-3, v) for n_, v in leaf_dist(int8_reference["grads"]).items()}
    worst_leaf = max(leaf_rel, key=lambda n_: leaf_rel[n_] / leaf_lim[n_])
    print(f"  float32 kernel vs plain: loss rel diff {max(loss_rel):.3e} (need <= "
          f"{'/'.join(f'{v:.3e}' for v in loss_lim)}), grad norm rel diff {max(norm_rel):.3e} "
          f"(need <= {'/'.join(f'{v:.3e}' for v in norm_lim)}), worst grad leaf {worst_leaf} "
          f"{leaf_rel[worst_leaf]:.3e} x max|leaf| (need <= {leaf_lim[worst_leaf]:.3e})"
          f"{' (printed, not held: routing flips at step 1)' if flips[0] else ''}"
          f"{' (step 2 grad norm printed, not held)' if flips[1] else ''}; launches per step "
          f"need {need}", flush=True)
    if not all(np.isfinite([m[k] for m in k_metrics + p_metrics for k in m])):
        fail("non-finite float32 loss or grad norm")
    held_norm = [(r, lim) for r, lim, d in zip(norm_rel, norm_lim, flips) if d == 0]
    if (any(r > lim for r, lim in zip(loss_rel, loss_lim)) or any(r > lim for r, lim in held_norm)
            or (flips[0] == 0 and leaf_rel[worst_leaf] > leaf_lim[worst_leaf])):
        fail("the float32 kernel path disagrees with the plain path")
    check_launches(k_run["counts"], need, f"{model_name} float32 kernel path")
    check_launches(p_run["counts"], {}, f"{model_name} float32 plain path")
    k_rate, p_rate = (steps - 1) * n / k_run["time"], (steps - 1) * n / p_run["time"]
    print(f"  {model_name} float32 train samples/s at B={n} (steps 2-{steps}, host clock): "
          f"kernel path {k_rate:.1f}, plain path {p_rate:.1f}; peak memory kernel "
          f"{k_run['peak'] / 2**30:.2f} GiB, plain {p_run['peak'] / 2**30:.2f} GiB [{card}]",
          flush=True)
    return {"peak": k_run["peak"], "params": sum(p.numel() for p in model.parameters()),
            "opt_bytes": k_run["opt_bytes"], "metrics": k_metrics, "model": model,
            "rate": k_rate, **({"grads": k_grads} if keep_grads else {})}


class CodeFlips:
    """The int8 codes of every quantize call of a run's first ``steps`` steps (``per_step``
    calls a step, in the port's fixed order), kept on the card from the kernel path's run and
    compared call by call in the plain path's: an ulp upstream (the block kernels against
    their plain versions) that moves a value across a code's midpoint flips the code, and the
    flip moves its element by 1/127 of its row's largest magnitude, so flips cascade through
    the blocks (printed as a count and a share of the step's codes)."""

    def __init__(self, q, per_step: int, steps: int = 2):
        self.q, self.per_step, self.steps = q, per_step, steps
        self.kept, self.flips, self.codes, self.calls, self.inner = [], [], [], 0, None

    def attach(self):
        """Wrap the current ``quantize_rows`` and ``quantize_weight`` (the kernels', or inside
        ``plain_attention`` the plain versions'): the first run keeps its codes, the second
        compares with them."""
        self.inner, self.calls = {}, 0
        compare = bool(self.kept)
        if compare:
            self.flips, self.codes = [0] * self.steps, [0] * self.steps

        def recorder(inner):
            def recorded(x, form="reciprocal"):
                codes, scale = inner(x, form)
                step = self.calls // self.per_step
                if step < self.steps:
                    if compare:
                        self.flips[step] += int((codes != self.kept[self.calls]).sum())
                        self.codes[step] += codes.numel()
                    else:
                        self.kept.append(codes.clone())
                self.calls += 1
                return codes, scale
            return recorded

        for name in ("quantize_rows", "quantize_weight"):
            if hasattr(self.q, name):
                self.inner[name] = getattr(self.q, name)
                setattr(self.q, name, recorder(self.inner[name]))

    def detach(self):
        for name, inner in self.inner.items():
            setattr(self.q, name, inner)
        if self.codes:
            self.kept = []

    def share(self, step: int) -> float:
        return self.flips[step] / self.codes[step] if self.codes else 0.0


def int8_limit(base: float, int8_vs_float: float) -> float:
    """A float32 int8 step's limit, kernel path against plain path: phase 6's ``base`` plus
    ``INT8_SPREAD`` times the same quantity's distance between the int8 step and the float
    step from the same start (the size of the int8 rounding itself). The codes' flips cascade
    (a fifth of them flip by the last block of a 12-block tower), so at worst the two paths
    hold two independent roundings of every value, whose difference is ~sqrt(2) times one
    rounding's."""
    return base + INT8_SPREAD * int8_vs_float


def moe_loss_limit(flips: int, tokens: int) -> float:
    """A step's loss limit, kernel path against plain path, relative: phase 6's 1e-5, plus
    d / tokens when d of the step's routing decisions differ between the paths (a token
    routed elsewhere, or moved past capacity, changes its MLP branch outright)."""
    return 1e-5 + flips / tokens


class RoutingRecorder:
    """The experts each MoE layer of a model chooses, recorded by forward hooks: per forward
    call of each layer, its k rounds of choices [G, S, k] (``top_k_rounds`` of the router's
    probabilities on the layer's input, as the layer takes them)."""

    def __init__(self, torch):
        self.torch, self.handles, self.records, self.layers, self.seq = torch, [], [], 0, 0

    def attach(self, model):
        from multimodal_tpu_torch.models.moe import MoEMLP, top_k_rounds

        layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
        self.layers, self.records = len(layers), []

        def hook(module, inputs, _):
            with self.torch.no_grad():
                probs = module.router_probs(inputs[0])
                self.records.append(self.torch.stack(top_k_rounds(probs, module.top_k), -1))
            self.seq = inputs[0].shape[1]

        self.handles = [m.register_forward_hook(hook) for m in layers]

    def detach(self) -> list:
        for h in self.handles:
            h.remove()
        self.handles, records = [], self.records
        return records

    def step_records(self, records: list, step: int) -> list:
        """One train step's records: one forward call of each layer (no remat)."""
        return records[step * self.layers:(step + 1) * self.layers]

    def flips(self, a: list, b: list, step: int) -> int:
        return routing_flips(self.step_records(a, step), self.step_records(b, step))

    def decisions(self, records: list, step: int) -> int:
        return sum(r.numel() for r in self.step_records(records, step))


def routing_flips(a: list, b: list) -> int:
    """Routing decisions (token, round, layer) whose chosen expert differs between two
    runs' records."""
    return int(sum(int((x != y).sum()) for x, y in zip(a, b)))


def kernel_path_run(torch, tally, card, model_name, dtype, n, steps, need, falling=False,
                    block_mlp=False, variational=None, model_kw=None, prepare=None,
                    stats=None, after=None, **step_kw) -> list:
    """``steps`` steps on the kernel path alone: finite (and with ``falling`` a loss that
    falls on the fixed batch), the launch counts, samples/s over steps 2 on (none for one step)
    and peak memory (also put into ``stats``, a dict, as ``rate`` and ``peak``).
    ``variational``, ``model_kw``, ``prepare`` and ``step_kw`` as in ``compare_paths``;
    ``after(model, batch)`` runs before the two are freed. Returns the per-step metrics."""
    name = str(dtype).replace("torch.", "")
    model = build_model(torch, model_name, dtype, block_mlp, variational, model_kw, prepare)
    model_name = model_label(model_name, block_mlp, variational, model_kw)
    batch = make_batch(torch, model.cfg, n)
    run = train_steps(torch, tally, model, batch, steps, **step_kw)
    metrics = run["metrics"]
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    print(f"  {name} losses {[round(v, 7) for v in losses]} grad norms "
          f"{[round(v, 4) for v in norms]}", flush=True)
    rate = (steps - 1) * n / run["time"] if steps > 1 else None
    if stats is not None:
        stats.update(rate=rate, peak=run["peak"])
    timed = (f"train samples/s at B={n} (steps 2-{steps}, host clock): {rate:.1f}" if rate
             else f"one train step at B={n}")
    moments = str(step_kw.get("state_dtype") or "").replace("torch.", "")
    print(f"  {model_name} {name} {timed}; peak memory {run['peak'] / 2**30:.2f} GiB"
          f"{f' ({moments} moments)' if moments else ''} [{card}]", flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"non-finite {name} loss or grad norm")
    if falling and not losses[-1] < losses[0]:
        fail(f"the {name} loss did not fall over {steps} steps on a fixed batch")
    check_launches(run["counts"], with_wgrad(need) if dtype == torch.bfloat16 else need,
                   f"{model_name} {name} kernel path")
    if after is not None:
        after(model, batch)
    del model, batch
    torch.cuda.empty_cache()
    return metrics


def largest_batch(torch, peak_at_compare: int, n_params: int, compare_batch: int,
                  candidates=(64, 128, 256)) -> int:
    """The largest of ``candidates`` the float32 kernel path holds, reckoned before running it
    from ``compare_paths``' measured float32 peak at ``compare_batch``: there 24 bytes a
    parameter stay (parameters, gradients, two float32 moments, the comparison's copy of the
    start and of step 1's gradients) and the rest grows with the batch; in the run reckoned
    16 bytes a parameter stay; 15% to spare. Fails when none fits."""
    per_sample = (peak_at_compare - 24 * n_params) / compare_batch
    static = 16 * n_params
    total = torch.cuda.mem_get_info()[1]
    fits = [b for b in candidates if static + 1.15 * per_sample * b <= total]
    print(f"  reckoned: {static / 2**30:.2f} GiB static + {per_sample / 2**20:.1f} MiB per "
          f"sample (from the measured peak at B={compare_batch}) against {total / 2**30:.1f} GiB "
          f"-> {({b: round((static + per_sample * b) / 2**30, 1) for b in candidates})} GiB; "
          f"largest batch with 15% to spare: {max(fits) if fits else None}", flush=True)
    if not fits:
        fail(f"no batch of {candidates} fits the card by the reckoning")
    return max(fits)


def register_variant(name: str, base: str, vision: dict | None = None,
                     text: dict | None = None, **top):
    """Register config ``name``: the shipped config ``base`` with ``top`` set at its top level,
    ``vision`` in its vision tower and ``text`` in its text tower."""
    from multimodal_tpu_torch import paths
    from multimodal_tpu_torch.models import add_model_config

    with open(os.path.join(paths.CONFIG_DIR, base + ".json")) as f:
        cfg = json.load(f)
    cfg.update(top)
    cfg["vision_cfg"].update(vision or {})
    cfg["text_cfg"].update(text or {})
    add_model_config(name, cfg)


def phase_vclip_encode(torch, mods, tally, card, n: int):
    """The variational model's eval-mode encode at batch ``n`` in float32, kernel path
    against plain path: the means at cosine >= 0.9999, the concentrations within 1e-4
    relative, >= 12 block-forward launches per tower encode; the model is handed over in
    training mode, and the encode must give it back in that mode."""
    from multimodal_tpu_torch.data.preprocess import normalize_images
    from multimodal_tpu_torch.inference import model_mode
    from multimodal_tpu_torch.models import create_model

    model = create_model(MODEL, variational=True, seed=0).train()
    batch = make_batch(torch, model.cfg, n)
    images = normalize_images(batch["image"])

    def encode(tower):
        with model_mode(model, False), torch.inference_mode():
            out = (model.encode_image(images) if tower == "image"
                   else model.encode_text(batch["text"]))
        torch.cuda.synchronize()
        return out

    got, counts = {}, {}
    for tower in ("image", "text"):
        tally.start()
        got[tower] = encode(tower)
        counts[tower] = tally.stop()["block_attention_fwd"]
    with plain_attention(mods):
        want = {tower: encode(tower) for tower in ("image", "text")}
    if not model.training:
        fail("the eval-mode encode did not give the model back in training mode")
    for tower in ("image", "text"):
        (mean, conc), (p_mean, p_conc) = got[tower], want[tower]
        ok_shape = mean.shape == (n, model.cfg.embed_dim) and conc.shape == (n,)
        finite = bool(torch.isfinite(mean).all() and torch.isfinite(conc).all())
        cos = torch.nn.functional.cosine_similarity(mean, p_mean, dim=-1).min().item()
        rel = ((conc - p_conc).abs() / p_conc.abs()).max().item()
        print(f"  encode {tower} B={n} float32 kernel vs plain: min cosine of the means "
              f"{cos:.7f} (need >= 0.9999), concentration rel diff {rel:.3e} (need <= 1e-4), "
              f"concentrations {conc.min().item():.2f}-{conc.max().item():.2f}, block forward "
              f"launches {counts[tower]} (need >= 12)", flush=True)
        if not (ok_shape and finite) or cos < 0.9999 or rel > 1e-4 or counts[tower] < 12:
            fail(f"the variational {tower} encode: shapes {tuple(mean.shape)} "
                 f"{tuple(conc.shape)}, finite {finite}, or kernel vs plain disagree")
    del model, batch, images, got, want
    torch.cuda.empty_cache()


def phase_vclip_train(torch, mods, tally, card):
    """The recipe's loss through the kernels: float32 against the plain path, bfloat16 at
    two batches, then two float32 steps of vMF and of the Gaussian mode."""
    from multimodal_tpu_torch.models import VariationalConfig

    spherical, gaussian = VariationalConfig(), VariationalConfig(model_type="Gaussian")
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    step_kw = dict(loss_type="vclip", loss_kwargs=VCLIP_LOSS, opt_kw=VCLIP_OPT)
    compare_paths(torch, mods, tally, card, MODEL, VCLIP_BATCH, TRAIN_STEPS, need,
                  variational=spherical, **step_kw)
    torch.cuda.empty_cache()
    for n in (VCLIP_BATCH, TRAIN_BATCH):
        metrics = kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, n, TRAIN_STEPS,
                                  need, falling=True, variational=spherical, **step_kw)
        print(f"  bfloat16 B={n} terms of step 1: " + ", ".join(
            f"{k}={metrics[0][k]:.5g}" for k in ("clip_loss", "image_kl_loss", "text_kl_loss",
                                                "var_reg", "mean_image_concentration",
                                                "mean_text_concentration")), flush=True)
    for vcfg, family in ((spherical, "vmf"), (gaussian, "normal")):
        print(f"  {family} ({vcfg.model_type}), float32, 2 steps", flush=True)
        metrics = kernel_path_run(torch, tally, card, MODEL, torch.float32, VCLIP_BATCH, 2, need,
                                  variational=vcfg, loss_type="vclip", opt_kw=VCLIP_OPT,
                                  loss_kwargs=dict(VCLIP_LOSS, distribution_type=family))
        if not all(np.isfinite(list(m.values())).all() for m in metrics):
            fail(f"non-finite metrics in the {family} run: {metrics}")
        lowest = min(min(m["mean_image_concentration"], m["mean_text_concentration"])
                     for m in metrics)
        if family == "vmf" and lowest < vcfg.min_concentration:
            fail(f"vMF concentration {lowest} below the minimum {vcfg.min_concentration}")


def phase_lora(torch, mods, tally, card, full_opt_bytes: int):
    """A LoRA fine-tune of a loaded base: ViT-B/32 built with r=8 adapters, every base weight
    from an OpenAI-format state dict exported from a seeded model without adapters, trained in
    the "lora" freeze mode; float32 kernel path against plain path at B=256 (24 launches of
    each block kernel a step, every frozen parameter bit for bit unchanged), bfloat16 at
    B=256; then the adapters merged into a model without them, whose encodes at bucket 256
    must match the adapted model's (cosine >= 0.9999)."""
    from multimodal_tpu_torch.inference import Embedder
    from multimodal_tpu_torch.models import (
        create_model, export_openai_state_dict, load_openai_state_dict, merge_lora)

    base = export_openai_state_dict(create_model(MODEL, seed=1))
    torch.cuda.empty_cache()
    prepare = lambda model: load_openai_state_dict(model, base)  # noqa: E731
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need,
                        model_kw=LORA, prepare=prepare, freeze="lora")
    model = res["model"]
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"  optimizer state (fused AdamW moments, float32): {res['opt_bytes'] / 2**20:.2f} MiB "
          f"for {n_train} trainable of {res['params']} parameters; phase 6's full model "
          f"{full_opt_bytes / 2**20:.2f} MiB ({full_opt_bytes / res['opt_bytes']:.1f}x)",
          flush=True)
    merged = merge_lora(model, cfg=model.cfg, into=create_model(MODEL, seed=2))
    rng = np.random.default_rng(3)
    size, ctx = model.cfg.vision.image_size, model.cfg.text.context_length
    images = rng.integers(0, 256, (TRAIN_BATCH, size, size, 3), dtype=np.uint8)
    tokens = rng.integers(1, model.cfg.text.vocab_size - 1, (TRAIN_BATCH, ctx))
    tokens[:, -1] = model.cfg.text.vocab_size - 1
    cos = {}
    for tower in ("image", "text"):
        enc = [Embedder(m).encode_images(images) if tower == "image"
               else Embedder(m).encode_tokens(tokens) for m in (model, merged)]
        cos[tower] = float(np.sum(enc[0] * enc[1], -1).min())
    lora_b = max(p.abs().max().item() for n, p in model.named_parameters()
                 if n.endswith("lora_b"))
    print(f"  merged (lora_rank=0) vs adapted encode at bucket {TRAIN_BATCH}: min cosine image "
          f"{cos['image']:.7f} text {cos['text']:.7f} (need >= 0.9999); max |lora_b| after "
          f"training {lora_b:.3e}", flush=True)
    if min(cos.values()) < 0.9999 or lora_b == 0.0:
        fail("the merged model's encodes disagree with the adapted model's, or the adapters "
             "did not train")
    del res, model, merged
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS, need,
                    falling=True, model_kw=LORA, prepare=prepare, freeze="lora")


def phase_moe(torch, mods, tally, card):
    """The MoE vision tower: ViT-B/32 with 8 experts, top-2, capacity factor 1.25 on every
    second vision block (6 MoE blocks, 15 slots an expert an image); float32 kernel path
    against plain path at B=256 with the routing-flip rule, the aux term finite and its mean
    per layer and round in [1, 8]; then bfloat16 at B=256."""
    register_variant(MOE_MODEL, MODEL, vision=MOE_VISION)
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    routing = RoutingRecorder(torch)
    res = compare_paths(torch, mods, tally, card, MOE_MODEL, TRAIN_BATCH, TRAIN_STEPS, need,
                        routing=routing)
    rounds = routing.layers * MOE_VISION["moe_top_k"]
    aux = [m["moe_aux_loss"] for m in res["metrics"]]
    print(f"  moe_aux_loss per step {[round(v, 5) for v in aux]}: {routing.layers} layers x "
          f"top-{MOE_VISION['moe_top_k']}, per layer and round "
          f"{[round(v / rounds, 4) for v in aux]} (need finite, in [1, "
          f"{MOE_VISION['moe_experts']}])", flush=True)
    if routing.layers != 6 or not all(
            np.isfinite(v) and 1.0 <= v / rounds <= MOE_VISION["moe_experts"] for v in aux):
        fail("the MoE aux loss is off its range")
    del res
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MOE_MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS,
                    need, falling=True)


def phase_siglip(torch, mods, tally, card):
    """``create_model(MODEL, siglip=True)`` under the SigLIP loss: float32 kernel path against
    plain path at B=256, the logit bias moving from -10; bfloat16 at B=256, finite, its loss
    falling below step 1's and every step's loss within 2e-2 of the float32 kernel path's
    (``siglip_tracks``). On this batch both float32 paths' losses rise again at step 6, alike
    (a SigLIP property of the fixed batch under phase 6's optimizer), so the bfloat16 run is
    held to that trajectory rather than to a last loss below the first."""
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    kw = dict(model_kw={"siglip": True}, loss_type="siglip")
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need, **kw)
    bias = [m["logit_bias"] for m in res["metrics"]]
    print(f"  logit_bias per step {[round(v, 6) for v in bias]} (from -10), logit_scale "
          f"{[round(m['logit_scale'], 6) for m in res['metrics']]}", flush=True)
    if bias[-1] == -10.0:
        fail("the SigLIP logit bias did not move")
    f32 = [m["loss"] for m in res["metrics"]]
    del res
    torch.cuda.empty_cache()
    bf16 = [m["loss"] for m in kernel_path_run(torch, tally, card, MODEL, torch.bfloat16,
                                               TRAIN_BATCH, TRAIN_STEPS, need, **kw)]
    ok, worst = siglip_tracks(bf16, f32)
    print(f"  bfloat16 vs float32 kernel path, step by step: worst loss rel diff {worst:.3e} "
          f"(need <= 2e-2); lowest bfloat16 loss of steps 2-{TRAIN_STEPS} {min(bf16[1:]):.7f} "
          f"(need < step 1's {bf16[0]:.7f})", flush=True)
    if not ok:
        fail("the bfloat16 SigLIP run left the float32 trajectory or its loss did not fall")


def siglip_tracks(bf16: list, f32: list) -> tuple[bool, float]:
    """The bfloat16 run's losses against the float32 kernel path's of the same steps: each
    within 2e-2 relative (phase 3's bfloat16 limit), and some step after the first below the
    first. Returns (held, the worst relative difference)."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(bf16, f32))
    return worst <= 2e-2 and min(bf16[1:]) < bf16[0], worst


def phase_hires(torch, mods, tally, card):
    """ViT-B/32 built at 384 px (``force_image_size``): the vision tower at S=145 through the
    LN-fold kernels, 12 launches each a step, the text tower at S=77 through the others;
    float32 kernel path against plain path for 2 steps at B=128, then bfloat16 rates."""
    need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
            "block_attention_fwd": 12, "block_attention_bwd": 12}
    del compare_paths(torch, mods, tally, card, MODEL, HIRES_BATCH, 2, need,
                      model_kw=HIRES)["model"]
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, HIRES_BATCH, TRAIN_STEPS, need,
                    falling=True, model_kw=HIRES)


def phase_int8(torch, mods, tally, card, kind, float_rate: float):
    """ViT-B/32 at full width and depth built with ``int8_forward=True``, B=256: every dense
    MLP of both towers on the SwitchBack GEMMs (the row-quantize kernel and the int8 GEMM with
    its rescale), the block-attention kernels as in phase 6. float32 kernel path against
    plain path, the flipped codes counted (``CodeFlips``) and the limits widened by
    ``int8_limit``; then bfloat16 in turns with the bfloat16 step without int8 (A, B, B, A, A,
    B), each 6 steps, finite and falling: samples/s over
    steps 2-6 and peak memory, the A/B; then the W8A8 encoders (``--quantized``) behind the
    HTTP server, held to the float32 encode (cosine > 0.99) and to the plain-version encode
    (cosine >= 0.9999), their encodes/s at bucket 256 and single-request p50."""
    float_need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    # the float step from the same start (phase 6's kernel path, 2 steps): how far the int8
    # rounding itself moves each held quantity, the measure of ``int8_limit``
    model = build_model(torch, MODEL, torch.float32)
    reference = train_steps(torch, tally, model, make_batch(torch, model.cfg, TRAIN_BATCH), 2,
                            grads_at=0, count=False)
    del model
    code_flips = CodeFlips(mods["q"], per_step=INT8_NEED["quantize_rows"])
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, INT8_NEED,
                        model_kw=INT8, code_flips=code_flips, int8_reference=reference)
    del reference
    print(f"  float32 int8 vs phase 6's float32 kernel path in this call: {res['rate']:.1f} vs "
          f"{float_rate:.1f} samples/s ({res['rate'] / float_rate:.3f}x) [{card}]", flush=True)
    del res
    torch.cuda.empty_cache()
    arms = {"bfloat16": [], "bfloat16 int8": []}
    for i in range(2 * AB_RUNS):  # A, B, B, A, A, B
        arm = list(arms)[(i + i // 2) % 2]
        stats = {}
        int8 = arm.endswith("int8")
        kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS,
                        INT8_NEED if int8 else float_need, falling=True,
                        model_kw=INT8 if int8 else None, stats=stats)
        arms[arm].append(stats)
    mean = {arm: float(np.mean([r["rate"] for r in runs])) for arm, runs in arms.items()}
    peak = {arm: max(r["peak"] for r in runs) / 2**30 for arm, runs in arms.items()}
    print(f"  A/B bfloat16 B={TRAIN_BATCH}, in turns: int8 {mean['bfloat16 int8']:.1f} "
          f"({', '.join(f'{r['rate']:.1f}' for r in arms['bfloat16 int8'])}) vs without int8 "
          f"{mean['bfloat16']:.1f} ({', '.join(f'{r['rate']:.1f}' for r in arms['bfloat16'])}) "
          f"samples/s: {mean['bfloat16 int8'] / mean['bfloat16']:.3f}x; peak memory "
          f"{peak['bfloat16 int8']:.2f} vs {peak['bfloat16']:.2f} GiB [{card}]", flush=True)
    per_encode = {"quantize_rows": 73, "int8_gemm": 73}  # 12 blocks x 6 products + 1
    phase_serving(torch, mods, tally, card, kind, MODEL, need_text=per_encode,
                  need_image=per_encode, quantized=True)


CLI_BATCH = 256
CLI_MICRO = 4  # phase 13 (a): B=256 as 4 micro-batches of 64
CLI_CHUNK = 64  # phase 13 (b): the chunked loss's chunk through the model
LOSS_ROWS, LOSS_DIM, LOSS_CHUNK = 32768, 512, 1024  # phase 13 (b): the loss alone
CLI_STEPS = 6
CLI_RUNS = [  # phase 13 (c): name, extra flags, launches per step beyond phase 6's
    ("clip", ["--loss", "clip"], None),
    ("cloob", ["--loss", "cloob"], None),
    ("align semantic", ["--loss", "align", "--nl_semantic_supervision"], None),
    ("clip chunked", ["--loss", "clip", "--contrastive-impl", "chunked",
                      "--contrastive-chunk-size", str(CLI_CHUNK)], None),
    ("feature-cached accum 4", ["--accum-freq", str(CLI_MICRO), "--feature-cached-accum"],
     {"block_attention_fwd": 24 * 2 * CLI_MICRO, "block_attention_bwd": 24 * CLI_MICRO}),
    ("lamb", ["--opt", "lamb"], None),
    ("lars", ["--opt", "lars"], None),
    ("ema + val", ["--model-ema", "--val-data", "synthetic", "--val-num-samples",
                   str(2 * CLI_BATCH)], None),
    ("int8", ["--precision", "int8"], INT8_NEED),
]
CLI_LOGS = "chip_smoke_logs"  # under the checkout; removed at the end of phase 13


def rel_leaf_dist(torch, got: dict, want: dict) -> dict:
    """Per leaf max|got - want| / max|want|, the scale floored at 1e-3 x the largest
    gradient of the model (phase 6's measure)."""
    g_max = max(g.abs().max() for g in want.values())
    return {n: ((got[n] - g).abs().max() / torch.clamp(g.abs().max(), min=1e-3 * g_max)).item()
            for n, g in want.items()}


def one_step(torch, tally, model, batch, start, **step_kw) -> dict:
    """One step from ``start`` (a state dict) with phase 6's optimizer and ``step_kw`` for
    ``make_train_step``: the metrics, the gradients and the launch counts."""
    from multimodal_tpu_torch.train import (TrainState, make_optimizer, make_schedule,
                                            make_train_step)

    model.load_state_dict(start)
    opt = make_optimizer(model.named_parameters(),
                         make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
                         weight_decay=0.1, grad_clip_norm=1.0)
    step = make_train_step(model, opt, **step_kw)
    torch.cuda.synchronize()
    tally.start()
    m = step(TrainState.create(model, opt), batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    counts = tally.stop()
    return {"metrics": {k: float(v) for k, v in m.items()}, "counts": counts,
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()}}


def hold_step(torch, what: str, got: dict, want: dict):
    """``got``'s step against ``want``'s at phase 6's float32 limits: loss 1e-5 and grad
    norm 1e-4 relative, every gradient leaf (the logit scale's too) within 1e-3 x
    max|leaf|."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss_rel = rel(got["metrics"]["loss"], want["metrics"]["loss"])
    norm_rel = rel(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"])
    leaf = rel_leaf_dist(torch, got["grads"], want["grads"])
    worst = max(leaf, key=leaf.get)
    print(f"  {what}: loss {got['metrics']['loss']:.7f} vs {want['metrics']['loss']:.7f} (rel "
          f"{loss_rel:.3e}, need <= 1e-5), grad norm rel {norm_rel:.3e} (need <= 1e-4), worst "
          f"leaf {worst} {leaf[worst]:.3e} (need <= 1e-3), logit scale gradient "
          f"{got['grads']['logit_scale'].item():.6e} vs {want['grads']['logit_scale'].item():.6e}"
          f" ({leaf['logit_scale']:.3e})", flush=True)
    if loss_rel > 1e-5 or norm_rel > 1e-4 or leaf[worst] > 1e-3:
        fail(f"{what} disagrees with the full-batch dense step")


def loss_peaks(torch, card):
    """The CLIP loss alone, forward and backward, on LOSS_ROWS x LOSS_DIM float32 features:
    dense (two [N, N] logits matrices) against chunked (one [N, LOSS_CHUNK] block at a time):
    value, gradients, time and the peak memory above the inputs."""
    from multimodal_tpu_torch.losses import chunked_clip_loss, clip_loss

    g = torch.Generator(device="cuda").manual_seed(0)
    fi = torch.randn(LOSS_ROWS, LOSS_DIM, device="cuda", generator=g)
    ft = torch.randn(LOSS_ROWS, LOSS_DIM, device="cuda", generator=g)
    fi, ft = fi / fi.norm(dim=-1, keepdim=True), ft / ft.norm(dim=-1, keepdim=True)
    out = {}
    for name, fn in (("dense", lambda a, b, s: clip_loss(a, b, s, normalize=False)),
                     ("chunked", lambda a, b, s: chunked_clip_loss(
                         a, b, s, chunk_size=LOSS_CHUNK, normalize=False))):
        leaves = [t.clone().requires_grad_(True) for t in (fi, ft)]
        ls = torch.tensor(2.6592, device="cuda", requires_grad=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = fn(*leaves, ls)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = {"loss": loss.item(), "peak": torch.cuda.max_memory_allocated() - base,
                     "ms": ms, "grads": [t.grad for t in leaves] + [ls.grad]}
        del loss, leaves
    d, c = out["dense"], out["chunked"]
    loss_rel = abs(c["loss"] - d["loss"]) / abs(d["loss"])
    grad_rel = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(c["grads"], d["grads"]))
    print(f"  loss alone on {LOSS_ROWS}x{LOSS_DIM} float32 features, forward + backward: dense "
          f"peak {d['peak'] / 2**30:.3f} GiB in {d['ms']:.1f} ms, chunked ({LOSS_CHUNK}) peak "
          f"{c['peak'] / 2**30:.3f} GiB in {c['ms']:.1f} ms (host clock, first call); ratio "
          f"{c['peak'] / d['peak']:.4f} (need < 0.25); loss rel {loss_rel:.3e} (need <= 1e-5), "
          f"gradients rel {grad_rel:.3e} x max (need <= 1e-3) [{card}]", flush=True)
    if c["peak"] >= d["peak"] / 4 or loss_rel > 1e-5 or grad_rel > 1e-3:
        fail("the chunked loss is off the dense loss or holds too much memory")
    del out
    torch.cuda.empty_cache()


def cli_main(argv: list) -> int:
    """``multimodal_tpu_torch.train.run.main(argv)`` in this process; the root logger's
    handlers (the run's out.log among them) are closed after it."""
    import logging

    from multimodal_tpu_torch.train.run import main

    try:
        return main(argv)
    finally:
        root = logging.getLogger()
        for h in list(root.handlers):
            h.close()
            root.removeHandler(h)


def cli_records(logs: str, name: str) -> list:
    with open(os.path.join(logs, name, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def cli_final_model(torch, logs: str, name: str) -> dict:
    from multimodal_tpu_torch.train.checkpoints import CheckpointManager

    saved, _ = CheckpointManager(os.path.join(logs, name, "checkpoints")).restore()
    return saved["model"]


def phase_cli(torch, tally, card, bf16_rate: float):
    """Phase 13: the training CLI's paths on the card, ViT-B/32 at full width and depth."""

    logs = os.path.abspath(CLI_LOGS)
    shutil.rmtree(logs, ignore_errors=True)
    base_need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    try:
        print(f"  (a) feature-cached accumulation, float32, B={CLI_BATCH} as {CLI_MICRO} "
              f"micro-batches of {CLI_BATCH // CLI_MICRO}, against one full-batch step from "
              "the same weights", flush=True)
        model = build_model(torch, MODEL, torch.float32)
        batch = make_batch(torch, model.cfg, CLI_BATCH)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        full = one_step(torch, tally, model, batch, start)
        fca = one_step(torch, tally, model, batch, start, accum_steps=CLI_MICRO,
                       feature_cached_accum=True)
        check_launches([full["counts"]], base_need, "full-batch step")
        check_launches([fca["counts"]], {"block_attention_fwd": 24 * 2 * CLI_MICRO,
                                         "block_attention_bwd": 24 * CLI_MICRO},
                       "feature-cached step")
        hold_step(torch, "feature-cached vs full batch", fca, full)
        plain = one_step(torch, tally, model, batch, start, accum_steps=CLI_MICRO)
        check_launches([plain["counts"]], {"block_attention_fwd": 24 * CLI_MICRO,
                                           "block_attention_bwd": 24 * CLI_MICRO},
                       "plain accumulation step")
        print(f"  plain accumulation ({CLI_MICRO} x {CLI_BATCH // CLI_MICRO}): loss "
              f"{plain['metrics']['loss']:.7f} (the mean of the micro-batches' losses), grad "
              f"norm {plain['metrics']['grad_norm']:.6f}", flush=True)
        if not np.isfinite(list(plain["metrics"].values())).all():
            fail("non-finite plain-accumulation step")
        print(f"  (b) the chunked loss (chunk {CLI_CHUNK}) through the model, float32, "
              f"B={CLI_BATCH}, against the dense step of (a)", flush=True)
        chunked = one_step(torch, tally, model, batch, start,
                           loss_kwargs={"contrastive_impl": "chunked", "chunk_size": CLI_CHUNK})
        check_launches([chunked["counts"]], base_need, "chunked step")
        hold_step(torch, "chunked vs dense", chunked, full)
        del model, batch, start, full, fca, plain, chunked
        gc.collect()
        torch.cuda.empty_cache()
        loss_peaks(torch, card)

        print(f"  (c) the CLI in this process, bfloat16, B={CLI_BATCH}, {CLI_STEPS} steps each",
              flush=True)
        common = ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size",
                  str(CLI_BATCH), "--train-num-samples", str(CLI_STEPS * CLI_BATCH),
                  "--epochs", "1", "--warmup", "100", "--lr", "1e-3", "--wd", "0.1",
                  "--grad-clip-norm", "1.0", "--log-every-n-steps", "3", "--seed", "0",
                  "--precision", "amp_bf16", "--no-save-on-preemption", "--logs", logs]
        cli_rate = None
        for name, extra, per_step in CLI_RUNS:
            tag = name.replace(" ", "-")
            need = {k: v * CLI_STEPS for k, v in with_wgrad(per_step or base_need).items()}
            if "--val-data" in extra:  # the validation pass: 2 batches, 24 forwards each
                need["block_attention_fwd"] += 2 * 24
            t0 = time.perf_counter()
            tally.start()
            rc = cli_main(common + extra + ["--name", tag])
            counts = tally.stop()
            secs = time.perf_counter() - t0
            records = cli_records(logs, tag)
            train = [r for r in records if "loss" in r]
            losses = [r["loss"] for r in train]
            print(f"  CLI {name}: rc {rc}, {secs:.1f} s in all; logged losses "
                  f"{[round(v, 5) for v in losses]}; samples/s (steps 4-6) "
                  f"{train[-1]['samples_per_s']:.1f}, data_time {train[-1]['data_time']:.4f} s, "
                  f"batch_time {train[-1]['batch_time']:.4f} s (averages over steps 1-6); "
                  f"launches {({k: v for k, v in counts.items() if v})} (need {need}) [{card}]",
                  flush=True)
            if rc != 0 or len(train) != 2 or not np.isfinite(losses).all():
                fail(f"the CLI run {name} did not log finite losses")
            if {k: v for k, v in counts.items() if v} != need:
                fail(f"the CLI run {name} launched {counts}, need {need}")
            if "--val-data" in extra:
                evals = [r for r in records if "val_loss" in r]
                if not evals or not np.isfinite(evals[-1]["val_loss"]):
                    fail("the EMA run logged no finite validation loss")
                print(f"  EMA validation: val_loss {evals[-1]['val_loss']:.5f}, image_to_text "
                      f"R@1 {evals[-1]['image_to_text_R@1']:.4f}", flush=True)
            if name == "clip":
                cli_rate = train[-1]
            shutil.rmtree(os.path.join(logs, tag), ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
        print(f"  (e) CLI bfloat16 clip at B={CLI_BATCH}: {cli_rate['samples_per_s']:.1f} "
              f"samples/s over steps 4-6 (data_time {cli_rate['data_time']:.4f} s, batch_time "
              f"{cli_rate['batch_time']:.4f} s, averages over the epoch) beside phase 6's "
              f"bfloat16 step rate {bf16_rate:.1f} samples/s in this call: "
              f"{cli_rate['samples_per_s'] / bf16_rate:.3f}x [{card}]", flush=True)

        cli_resume(torch, tally, card, logs)
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    return cli_rate["samples_per_s"]


def cli_resume(torch, tally, card, logs: str):
    """Phase 13 (d): float32 B=64, 2 epochs of 3 steps; the same run twice (is the step
    deterministic on the card?), then a run cut after a mid-epoch save at step 2 and resumed:
    its final parameters against the uninterrupted run's, bit for bit if the two identical
    runs agreed bit for bit, else at phase 6's float32 leaf limit (1e-3 x max|leaf|)."""

    n = 64
    common = ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size", str(n),
              "--train-num-samples", str(3 * n), "--warmup", "100", "--lr", "1e-3", "--wd",
              "0.1", "--grad-clip-norm", "1.0", "--log-every-n-steps", "1", "--seed", "0",
              "--precision", "fp32", "--no-save-on-preemption", "--logs", logs]
    per_step = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    print(f"  (d) mid-epoch resume, float32, B={n}, 2 epochs x 3 steps", flush=True)
    finals, losses = {}, {}

    def run(tag, extra, steps):
        tally.start()
        rc = cli_main(common + extra + ["--name", tag])
        counts = tally.stop()
        need = {k: v * steps for k, v in per_step.items()}
        if rc != 0 or {k: v for k, v in counts.items() if v} != need:
            fail(f"CLI resume run {tag}: rc {rc}, launches {counts}, need {need}")
        losses[tag] = {r["step"]: r["loss"] for r in cli_records(logs, tag) if "loss" in r}

    for tag in ("full-a", "full-b"):
        run(tag, ["--epochs", "2", "--save-frequency", "2"], 6)
        finals[tag] = cli_final_model(torch, logs, tag)
        shutil.rmtree(os.path.join(logs, tag))
    run("pre", ["--epochs", "1", "--save-frequency-steps", "2"], 3)
    ckpts = os.path.join(logs, "pre", "checkpoints")
    steps = sorted(int(d) for d in os.listdir(ckpts) if d.isdigit())
    if 2 not in steps:
        fail(f"no mid-epoch save at step 2: {steps}")
    for s in steps:
        if s > 2:
            shutil.rmtree(os.path.join(ckpts, str(s)))
    run("pre", ["--epochs", "2", "--save-frequency", "2", "--resume", "latest"], 4)
    finals["resumed"] = cli_final_model(torch, logs, "pre")
    a, b, r = finals["full-a"], finals["full-b"], finals["resumed"]
    deterministic = all(torch.equal(a[k], b[k]) for k in a)
    leaf = {k: ((r[k] - a[k]).abs().max() / torch.clamp(a[k].abs().max(), min=1e-30)).item()
            for k in a}
    worst = max(leaf, key=leaf.get)
    same = all(torch.equal(a[k], r[k]) for k in a)
    loss_rel = max(abs(losses["pre"][s] - losses["full-a"][s]) / abs(losses["full-a"][s])
                   for s in losses["pre"])
    print(f"  two identical runs {'agree bit for bit' if deterministic else 'differ'} (largest "
          f"parameter difference {max(((a[k] - b[k]).abs().max()).item() for k in a):.3e}); "
          f"resumed vs uninterrupted: {'bit for bit' if same else 'not bit for bit'}, worst "
          f"parameter {worst} {leaf[worst]:.3e} x max|param|, logged losses of the resumed "
          f"steps rel {loss_rel:.3e} [{card}]", flush=True)
    if deterministic and not same:
        fail("the step is deterministic on the card but the resumed run ended elsewhere")
    if not deterministic and (leaf[worst] > 1e-3 or loss_rel > 1e-5):
        fail("the resumed run is off the uninterrupted one beyond phase 6's float32 limits")
    shutil.rmtree(os.path.join(logs, "pre"), ignore_errors=True)
    del finals
    gc.collect()


DATA_DIR = "tests/data/torch_shards"  # the committed fixture (tests/torch_make_data_fixture.py)
DATA_TRAIN = "train-{000000..000001}.tar"  # 2 shards x 128 shapes JPEGs at 128 px
DATA_REPEAT = 8  # listed 8 times: 4 workers x 4 resampled shard draws x 128 = 2 batches each
DATA_VAL_REPEAT = 4  # the 64-sample val shard 4 times: one validation batch of 256
DATA_STEPS = 8  # 4 workers x 2 batches of 256
DATA_WIRE = 128
DATA_RUNS = [  # phase 14 (d): name, extra flags
    ("224", []),
    (f"wire {DATA_WIRE}", ["--wire-size", str(DATA_WIRE)]),
    ("224 aug", ["--aug-cfg", "color_jitter=0.4", "re_prob=0.25"]),
]
DECODE_MEAN_LIMIT, DECODE_CORR_LIMIT = 3.0, 0.99  # two decoders of the same crop
SPIN_MS = 1000.0  # work queued on the caller's stream ahead of a decode (phase 14 (b))


def data_shards(name: str, repeat: int) -> str:
    """The fixture's shard pattern ``name`` listed ``repeat`` times as one '::' source list."""
    return "::".join([os.path.join(DATA_DIR, name)] * repeat)


def image_agreement(got, want) -> list:
    """Per image (mean |got - want|, Pearson correlation) of two uint8 [N, S, S, 3] batches;
    an image that is constant in both correlates 1.0 when equal."""
    out = []
    for g, w in zip(np.asarray(got, np.float64), np.asarray(want, np.float64)):
        g, w = g.ravel(), w.ravel()
        mean = float(np.abs(g - w).mean())
        if g.std() == 0 or w.std() == 0:
            corr = 1.0 if np.array_equal(g, w) else 0.0
        else:
            corr = float(np.corrcoef(g, w)[0, 1])
        out.append((mean, corr))
    return out


def resample_bound(taps: int, read_bytes: int, out_bytes: int) -> tuple:
    """(ms, what sets it) of the resample pair: ``taps`` float32 multiply-adds (2 operations
    each, on the CUDA cores) over 67 TFLOP/s, or the bytes the function needs over the memory
    rate: the tapped rows and columns of each decoded image read once (``plan``'s
    ``read_bytes``) and the uint8 output written once. The weight and tap tables are this
    design's, not inputs of the resample, and stay out of it."""
    t_ops = 2 * taps / PEAK_FLOPS["float32"]
    t_bytes = (read_bytes + out_bytes) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def plan_table_bytes(host_plan: dict) -> int:
    """Bytes of a resample plan's descriptor, tap and weight tables, at their own dtypes."""
    return sum(int(host_plan[k].nbytes) for k in ("desc", "bx", "by", "wx", "wy"))


def probe_host() -> None:
    """Phase 14 (a): what the host offers a JPEG decoder: the host compiler, libjpeg's
    header and library, the shared libraries the loader knows, and nvJPEG beside nvcc."""
    import tempfile

    from multimodal_tpu_torch.ops import _build

    def sh(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=120)
        return proc.returncode, (proc.stdout + proc.stderr).strip()

    print(f"  g++: {sh(['g++', '--version'])[1].splitlines()[0]}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cc")
        with open(src, "w") as f:
            f.write("#include <cstdio>\n#include <jpeglib.h>\n"
                    "int main() { jpeg_decompress_struct c; (void)c; return 0; }\n")
        rc, out = sh(["g++", src, "-o", os.path.join(tmp, "probe"), "-ljpeg"])
    print(f"  libjpeg: a program including <jpeglib.h> and linking -ljpeg "
          f"{'builds' if rc == 0 else 'does not build: ' + out.splitlines()[0]}", flush=True)
    rc, out = sh(["ldconfig", "-p"])
    libs = sorted({ln.split()[0] for ln in out.splitlines()
                   if "libjpeg" in ln or "libnvjpeg" in ln})
    print(f"  ldconfig: {libs}", flush=True)
    header = os.path.join(os.path.dirname(os.path.dirname(_build.nvcc_path())), "include",
                          "nvjpeg.h")
    print(f"  nvjpeg.h {'found' if os.path.isfile(header) else 'missing'} at {header}; "
          f"os.cpu_count() {os.cpu_count()}", flush=True)


def decode_vs_fixture(torch, card):
    """Phase 14 (b): the card's decode of the fixture's photo shard at 64 px, eval and train
    (seeds 0..N-1), against the committed outputs of the host pipeline."""
    from multimodal_tpu_torch.data import preprocess
    from multimodal_tpu_torch.data.wds import decode_images, iter_tar_samples
    from multimodal_tpu_torch.native import bindings as native

    with open(os.path.join(DATA_DIR, "photos.json")) as f:
        meta = json.load(f)
    samples = list(iter_tar_samples(os.path.join(DATA_DIR, "photos-000000.tar")))
    bufs = [s.get("jpg", s.get("png")) for s in samples]
    is_jpeg = np.array([native.is_jpeg(b) for b in bufs])
    size, n = meta["size"], len(bufs)
    for mode, train in (("eval", False), ("train", True)):
        want = np.load(os.path.join(DATA_DIR, f"expected_{mode}64.npy"))
        kw = ({"seeds": np.arange(n, dtype=np.uint64), "rng": np.random.default_rng(0)}
              if train else {})
        out, ok = decode_images(bufs, size, train, device="cuda", **kw)
        got = out.cpu().numpy()
        want_ok = np.array(meta[f"ok_{mode}"]) & (is_jpeg | preprocess._HAS_PIL)
        agree = image_agreement(got[ok], want[ok])
        worst_mean = max(m for m, _ in agree)
        worst_corr = min(c for _, c in agree)
        print(f"  {mode} {size} px: {int(ok.sum())} of {n} decoded ({int(is_jpeg.sum())} JPEG "
              f"members; the corrupt JPEG ok={bool(ok[~np.array(meta[f'ok_{mode}'])].any())}, "
              f"the PNG ok={bool(ok[~is_jpeg].all())} with PIL "
              f"{'present' if preprocess._HAS_PIL else 'absent'}); per image against the host "
              f"pipeline's outputs: worst mean |diff| {worst_mean:.3f} (need < "
              f"{DECODE_MEAN_LIMIT}), worst correlation {worst_corr:.5f} (need > "
              f"{DECODE_CORR_LIMIT}) [{card}]", flush=True)
        if not np.array_equal(ok, want_ok):
            fail(f"{mode} decode ok flags {ok.tolist()}, need {want_ok.tolist()}")
        if worst_mean >= DECODE_MEAN_LIMIT or worst_corr <= DECODE_CORR_LIMIT:
            fail(f"the card's {mode} decode is off the host pipeline's outputs")


def decode_off_the_step(torch, card) -> None:
    """Phase 14 (b): the card's decode waits for none of the work queued on the caller's
    stream (a training step, in the CLI): with SPIN_MS of spinning queued there,
    ``decode_images`` returns on the host well before it ends, and its output, read on that
    stream after it, is the unloaded decode's."""
    from multimodal_tpu_torch.data.wds import decode_images, iter_tar_samples

    bufs = [s["jpg"] for s in iter_tar_samples(os.path.join(DATA_DIR, "val-000000.tar"))]
    want, _ = decode_images(bufs, 224, False, device="cuda")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    torch.cuda._sleep(int(SPIN_MS * 10**7 / start.elapsed_time(end)))
    t0 = time.perf_counter()
    got, _ = decode_images(bufs, 224, False, device="cuda")
    host_ms = (time.perf_counter() - t0) * 1e3
    busy = not torch.cuda.current_stream().query()
    same = torch.equal(got, want)
    print(f"  decode of {len(bufs)} JPEGs at 224 px behind {SPIN_MS:.0f} ms queued on the "
          f"caller's stream: returned on the host in {host_ms:.2f} ms (need < "
          f"{SPIN_MS / 2:.0f}), the caller's stream {'still busy' if busy else 'IDLE'} then, "
          f"output {'the unloaded decode' if same else 'DIFFERS'} [{card}]", flush=True)
    if host_ms >= SPIN_MS / 2 or not busy or not same:
        fail("the card's decode waits for the caller's stream, or is not ordered before it")


def resample_kernel_case(torch, card) -> dict:
    """Phase 14 (b): the resample pair at the main path's shape (the fixture's 256 shapes
    JPEGs, train crops at 224) against its plain version on the same decoded images, both
    launched twice for the same bits; CUDA-event times and the bound."""
    from multimodal_tpu_torch.data.wds import iter_tar_samples
    from multimodal_tpu_torch.native import bindings as native
    from multimodal_tpu_torch.ops import resample as rs

    bufs = [s["jpg"] for shard in ("train-000000.tar", "train-000001.tar")
            for s in iter_tar_samples(os.path.join(DATA_DIR, shard))]
    arena, dims, off, ok = rs.decode_full(bufs, "cuda")
    seeds = np.random.default_rng(0).integers(0, 2**63, len(bufs), dtype=np.uint64)
    worst, timing = 0, None
    for size, train in ((224, True), (DATA_WIRE, True), (224, False)):
        boxes = np.zeros((len(bufs), 4))
        boxes[ok] = native.crop_boxes(dims[ok], size, train, seeds[ok] if train else None)
        host = rs.plan(dims, off, boxes, ok, size)
        dev = rs.to_device(host, "cuda")
        k1 = rs.launch(arena, dev).clone()
        k2 = rs.launch(arena, dev).clone()

        def plain():
            return torch.stack([
                rs.resample_reference(arena[off[i]:off[i] + dims[i, 0] * dims[i, 1] * 3]
                                      .view(int(dims[i, 0]), int(dims[i, 1]), 3), boxes[i], size)
                for i in range(len(bufs))])

        p = plain()
        err = int((k1.int() - p.int()).abs().max())
        worst = max(worst, err)
        ms = cuda_ms(lambda: rs.launch(arena, dev))
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        b_ms, b_by = resample_bound(host["taps"], host["read_bytes"], k1.numel())
        print(f"  resample B={len(bufs)} {'train' if train else 'eval'} {size} px from "
              f"{int(dims[:, 0].min())}-{int(dims[:, 0].max())} px: max |kernel - plain| {err} "
              f"(need <= 1), second launch {'same bits' if torch.equal(k1, k2) else 'DIFFERS'}; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}: "
              f"{host['read_bytes']} tapped source bytes + {k1.numel()} output bytes) "
              f"of_bound={b_ms / ms:.3f} GB/s={(host['read_bytes'] + k1.numel()) / ms / 1e6:.1f}; "
              f"the design's tables, outside the bound: {plan_table_bytes(host)} bytes "
              f"[{card}]", flush=True)
        if err > 1 or not torch.equal(k1, k2):
            fail("the resample kernel disagrees with its plain version")
        if size == 224 and train:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None}
    del arena
    torch.cuda.empty_cache()
    return {"worst": float(worst), "timing": timing}


def data_cli(torch, tally, card, bf16_rate: float, cli_rate: float):
    """Phase 14 (d): the training CLI in this process from the fixture's shapes shards,
    ViT-B/32 bfloat16 at B=256, DATA_STEPS steps each of DATA_RUNS: finite losses and
    validation metrics, exact launch counts, rates beside phase 13's and phase 6's."""

    logs = os.path.abspath(CLI_LOGS)
    shutil.rmtree(logs, ignore_errors=True)
    common = ["--dataset-type", "webdataset", "--train-data", data_shards(DATA_TRAIN, DATA_REPEAT),
              "--dataset-resampled", "--workers", "4",
              "--val-data", data_shards("val-000000.tar", DATA_VAL_REPEAT),
              "--model", MODEL, "--batch-size", str(CLI_BATCH),
              "--train-num-samples", str(DATA_STEPS * CLI_BATCH), "--epochs", "1",
              "--warmup", "100", "--lr", "1e-3", "--wd", "0.1", "--grad-clip-norm", "1.0",
              "--log-every-n-steps", str(DATA_STEPS // 2), "--seed", "0",
              "--precision", "amp_bf16", "--no-save-on-preemption", "--logs", logs]
    need = with_wgrad({"block_attention_fwd": 24 * DATA_STEPS + 24,
                       "block_attention_bwd": 24 * DATA_STEPS, "resample": DATA_STEPS + 1})
    try:
        for name, extra in DATA_RUNS:
            tag = "data-" + name.replace(" ", "-")
            t0 = time.perf_counter()
            tally.start()
            rc = cli_main(common + extra + ["--name", tag])
            torch.cuda.synchronize()
            counts = tally.stop()
            secs = time.perf_counter() - t0
            records = cli_records(logs, tag)
            train = [r for r in records if "loss" in r]
            evals = [r for r in records if "val_loss" in r]
            losses = [r["loss"] for r in train]
            metrics = {k: v for k, v in (evals[-1] if evals else {}).items()
                       if isinstance(v, float)}
            last = train[-1] if train else {}
            print(f"  CLI real data {name}: rc {rc}, {secs:.1f} s in all; logged losses "
                  f"{[round(v, 5) for v in losses]}; samples/s (steps {DATA_STEPS // 2 + 1}-"
                  f"{DATA_STEPS}) {last.get('samples_per_s', float('nan')):.1f}, data_time "
                  f"{last.get('data_time', float('nan')):.4f} s, batch_time "
                  f"{last.get('batch_time', float('nan')):.4f} s (averages over the epoch); "
                  f"beside phase 13's synthetic CLI rate {cli_rate:.1f} "
                  f"({last.get('samples_per_s', 0) / cli_rate:.3f}x) and phase 6's bfloat16 step "
                  f"rate {bf16_rate:.1f} ({last.get('samples_per_s', 0) / bf16_rate:.3f}x); "
                  f"val_loss "
                  f"{metrics.get('val_loss', float('nan')):.5f}, image_to_text R@1 "
                  f"{metrics.get('image_to_text_R@1', float('nan')):.4f}; launches "
                  f"{({k: v for k, v in counts.items() if v})} (need {need}) [{card}]", flush=True)
            if rc != 0 or len(train) != 2 or not np.isfinite(losses).all():
                fail(f"the real-data CLI run {name} did not log finite losses")
            if not metrics or not np.isfinite(list(metrics.values())).all():
                fail(f"the real-data CLI run {name} logged no finite validation metrics")
            if {k: v for k, v in counts.items() if v} != need:
                fail(f"the real-data CLI run {name} launched {counts}, need {need}")
            shutil.rmtree(os.path.join(logs, tag), ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(logs, ignore_errors=True)


def wire_upsample_case(torch, card):
    """Phase 14 (e): the --wire-size upsample, B=256 at DATA_WIRE -> 224 in float32, on the
    card against the same function on the CPU."""
    from multimodal_tpu_torch.data.preprocess import normalize_images
    from multimodal_tpu_torch.data.resize import bicubic

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (CLI_BATCH, DATA_WIRE, DATA_WIRE, 3), dtype=np.uint8))
    want = bicubic(normalize_images(x), 224)
    xc = normalize_images(x.cuda())
    got = bicubic(xc, 224).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    ms = cuda_ms(lambda: bicubic(xc, 224))
    print(f"  wire upsample B={CLI_BATCH} {DATA_WIRE} -> 224 float32: {ms:.4f} ms on the card "
          f"(CUDA events); max |card - CPU| {err:.3e} x max|CPU| (need <= 1e-5) [{card}]",
          flush=True)
    if err > 1e-5:
        fail("the card's wire upsample disagrees with the CPU's")


def data_serving(torch, tally, card, kind):
    """Phase 14 (f): ViT-B/32 float32 served with wire_size=DATA_WIRE over HTTP: JPEG requests
    (``images_b64``, at the model's size and with ``"wire": true``) against the ``images_u8``
    route on the pixels the same decode produced; p50 latency and encodes/s at bucket 256."""
    from multimodal_tpu_torch.data.wds import decode_images, iter_tar_samples
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.serving import EmbeddingService, make_server

    bufs = [s["jpg"] for s in iter_tar_samples(os.path.join(DATA_DIR, "val-000000.tar"))]
    model = create_model(MODEL, seed=0)
    svc = EmbeddingService(model, max_batch=CLI_BATCH, max_wait_ms=5.0, wire_size=DATA_WIRE)
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        b64 = [base64.b64encode(b).decode() for b in bufs[:8]]
        for wire, size in ((True, DATA_WIRE), (False, model.cfg.vision.image_size)):
            tally.start()
            code, out = post(url + "/v1/embed/image", {"images_b64": b64, "wire": wire})
            code_s, sim = post(url + "/v1/similarity",
                               {"texts": CAPTIONS, "images_b64": b64, "wire": wire})
            counts = tally.stop()
            pixels, ok = decode_images(bufs[:8], size, False, device="cuda")
            u8 = [base64.b64encode(a.tobytes()).decode() for a in pixels.cpu().numpy()]
            code_u, ref = post(url + "/v1/embed/image", {"images_u8": u8, "size": size})
            if (code, code_s, code_u) != (200, 200, 200) or not all(out["decoded"]):
                fail(f"JPEG serving (wire={wire}) answered {code}/{code_s}/{code_u}: "
                     f"{out.get('error') or sim.get('error') or ref.get('error')}")
            emb = check_embeddings("image", out["embeddings"], len(b64), model.cfg.embed_dim)
            want = check_embeddings("image", ref["embeddings"], len(b64), model.cfg.embed_dim)
            cos = float(np.sum(emb * want, -1).min())
            sims = np.asarray(sim["similarity"], np.float32)
            print(f"  JPEG requests wire={wire} ({size} px decode): min cosine to the images_u8 "
                  f"route on the same pixels {cos:.7f} (need >= 0.9999); similarity "
                  f"{sims.shape}; launches {({k: v for k, v in counts.items() if v})} "
                  f"[{card}]", flush=True)
            if cos < 0.9999 or sims.shape != (len(b64), len(CAPTIONS)):
                fail(f"JPEG serving (wire={wire}) disagrees with the images_u8 route")
            if counts["resample"] < 2 or counts["block_attention_fwd"] < 12 * 3:
                fail(f"JPEG serving (wire={wire}) did not run the resample and block kernels")
        lat = []
        for _ in range(21):
            t0 = time.perf_counter()
            code, _ = post(url + "/v1/embed/image", {"images_b64": b64[:1], "wire": True})
            lat.append((time.perf_counter() - t0) * 1e3)
            if code != 200:
                fail(f"JPEG latency probe returned {code}")
        batch = (bufs * (CLI_BATCH // len(bufs) + 1))[:CLI_BATCH]
        rates = {}
        for wire in (True, False):
            svc.embed_image_bytes(batch, wire=wire)
            t0 = time.perf_counter()
            for _ in range(5):
                svc.embed_image_bytes(batch, wire=wire)
            rates[wire] = 5 * CLI_BATCH / (time.perf_counter() - t0)
        print(f"  {MODEL} float32 JPEG serving ({kind}): single-request wire p50 latency "
              f"{float(np.median(lat[1:])):.2f} ms; encodes/s at bucket {CLI_BATCH} from JPEG "
              f"bytes (decode included, host clock) wire {rates[True]:.1f}, "
              f"{model.cfg.vision.image_size} px "
              f"{rates[False]:.1f} [{card}]", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)
    del model, svc
    torch.cuda.empty_cache()


def phase_data(torch, tally, card, kind, bf16_rate: float, cli_rate: float) -> dict:
    """Phase 14: the real-data input path on the card."""
    from multimodal_tpu_torch.data import bench_pipeline
    from multimodal_tpu_torch.native import bindings as native

    print("  (a) the host", flush=True)
    probe_host()
    t0 = time.perf_counter()
    host_lib = native.build("host")
    print(f"  data library 'host' (tar index, crop boxes) built in {time.perf_counter() - t0:.2f}"
          f" s -> {host_lib}", flush=True)
    try:
        print(f"  data library 'jpeg' (host libjpeg decode) -> {native.build('jpeg')}", flush=True)
    except RuntimeError as e:
        why = next((ln for ln in str(e).splitlines() if "error" in ln), str(e).splitlines()[-1])
        print(f"  data library 'jpeg' (host libjpeg decode) does not build here, so JPEGs "
              f"decode on the card: {why[:200]}", flush=True)
    print("  (b) the card's decode against the host pipeline's committed outputs", flush=True)
    decode_vs_fixture(torch, card)
    decode_off_the_step(torch, card)
    kernel = resample_kernel_case(torch, card)
    print(f"  (c) bench_pipeline on the fixture's shards (beside phase 6's bfloat16 step rate "
          f"{bf16_rate:.1f} samples/s) [{card}]", flush=True)
    bench_pipeline.main(["--shards", data_shards(DATA_TRAIN, DATA_REPEAT), "--device", "cuda",
                         "--threads", "1,4,8,16", "--workers", "4", "--wire-size",
                         str(DATA_WIRE), "--model-rate", str(bf16_rate)])
    print(f"  (d) the CLI from the shards, {MODEL} bfloat16 B={CLI_BATCH}, {DATA_STEPS} steps "
          "each", flush=True)
    data_cli(torch, tally, card, bf16_rate, cli_rate)
    print("  (e) the wire upsample", flush=True)
    wire_upsample_case(torch, card)
    print(f"  (f) serving JPEG requests, wire_size={DATA_WIRE}", flush=True)
    data_serving(torch, tally, card, kind)
    return kernel


EVAL_STEPS = 8  # phase 15: one epoch of 8 steps at CLI_BATCH before the evaluations
EVAL_CIFAR = 1000  # CIFAR-10 test images, and as many train images (5 batches of 200)
EVAL_FOLDER = (10, 20, 160)  # --imagenet-val: classes, JPEGs a class, their size in px
EVAL_FLOWERS = 204  # Flowers-102 test JPEGs (two a class), at 160 px
EVAL_COCO = 128  # COCO-val JPEGs, 5 captions each
EVAL_SERVED = 64  # JPEGs posted to the served checkpoint
EVAL_RATE_IMAGES = 4096  # Embedder.embed_images over this many uint8 images at bucket 256
EVAL_PROBE_EPOCHS = 20
EVAL_CLI_EXTRA: list = []  # flags every phase-15 CLI run adds (a CPU rehearsal: --device cpu)
EVAL_FOLDER_CLASSES = ["tench", "goldfish", "great white shark", "tiger shark", "hammerhead",
                       "electric ray", "stingray", "cock", "hen", "ostrich"]
COCO_WORDS = ["a", "dog", "cat", "red", "car", "on", "the", "street", "two", "people",
              "walking", "near", "water", "with", "an", "umbrella", "small", "bird", "tree"]


def eval_sets(root: str, rng) -> dict:
    """Phase 15 (a): the eval sets in their stock layouts under ``root``, made with numpy and
    PIL (and ``scipy.io.savemat`` for Flowers-102 where scipy imports). Returns flag -> path
    (``flowers`` only with scipy)."""
    import pickle

    from PIL import Image

    def jpeg(path, size):
        arr = rng.integers(0, 256, (size, size + size // 4, 3), dtype=np.uint8)
        arr[: size // 2] //= 2  # some structure: a darker upper half
        Image.fromarray(arr).save(path, quality=90)

    sets = {}
    d = os.path.join(root, "cifar", "cifar-10-batches-py")
    os.makedirs(d)
    data = rng.integers(0, 256, (2 * EVAL_CIFAR, 3072), dtype=np.uint8)
    labels = rng.integers(0, 10, 2 * EVAL_CIFAR).tolist()
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({"data": data[:EVAL_CIFAR], "labels": labels[:EVAL_CIFAR]}, f)
    per = EVAL_CIFAR // 5
    for i in range(5):
        lo = EVAL_CIFAR + i * per
        with open(os.path.join(d, f"data_batch_{i + 1}"), "wb") as f:
            pickle.dump({"data": data[lo:lo + per], "labels": labels[lo:lo + per]}, f)
    with open(os.path.join(d, "batches.meta"), "wb") as f:
        pickle.dump({"label_names": ["airplane", "automobile", "bird", "cat", "deer", "dog",
                                     "frog", "horse", "ship", "truck"]}, f)
    sets["cifar10"] = os.path.join(root, "cifar")
    n_cls, n_img, size = EVAL_FOLDER
    for c in range(n_cls):
        cls_dir = os.path.join(root, "folder", EVAL_FOLDER_CLASSES[c % len(EVAL_FOLDER_CLASSES)])
        os.makedirs(cls_dir)
        for i in range(n_img):
            jpeg(os.path.join(cls_dir, f"{i:03d}.jpg"), size)
    sets["imagenet_val"] = os.path.join(root, "folder")
    try:
        from scipy.io import savemat
    except ImportError:
        savemat = None
    if savemat is not None:
        d = os.path.join(root, "flowers", "flowers-102")
        os.makedirs(os.path.join(d, "jpg"))
        ids = np.arange(1, EVAL_FLOWERS + 1)
        savemat(os.path.join(d, "imagelabels.mat"), {"labels": (ids % 102 + 1)[None, :]})
        savemat(os.path.join(d, "setid.mat"), {"trnid": ids[None, :4], "valid": ids[None, 4:8],
                                               "tstid": ids[None, :]})
        for i in ids:
            jpeg(os.path.join(d, "jpg", f"image_{i:05d}.jpg"), EVAL_FOLDER[2])
        sets["flowers"] = os.path.join(root, "flowers")
    coco = coco_set(root, rng, EVAL_COCO)
    sets["coco_retrieval"] = coco
    return sets


def eval_cli(logs: str, name: str, argv: list, card: str, tally=None) -> tuple:
    """Run the training CLI on ``argv``: without ``tally`` as users do, ``python -m
    multimodal_tpu_torch.train.run`` in a child process, its evaluation lines (each with its
    seconds) printed from its log; with ``tally`` in this process (``cli_main``, which logs to
    this output), every launch count set to 0 just before it and read just after. Returns
    (seconds, its results records, the counts or None)."""
    argv = argv + ["--logs", logs, "--name", name] + EVAL_CLI_EXTRA
    counts = None
    t0 = time.perf_counter()
    if tally is not None:
        tally.start()
        rc = cli_main(argv)
        counts = tally.stop()
        secs = time.perf_counter() - t0
        if rc != 0:
            fail(f"the CLI run {name} in this process returned {rc}")
        return secs, cli_records(logs, name), counts
    log_path = os.path.join(logs, name, "out.log")
    seen = os.path.getsize(log_path) if os.path.exists(log_path) else 0  # a resumed run appends
    proc = subprocess.run([sys.executable, "-m", "multimodal_tpu_torch.train.run"] + argv,
                          capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
        fail(f"the CLI run {name} exited {proc.returncode}")
    with open(log_path) as f:
        f.seek(seen)
        for line in f:
            if re.search(r"zero-shot |retrieval |linear probe:|done: \d+ steps", line):
                print(f"  [{name}] {line.split(' | ')[-1].strip()} [{card}]", flush=True)
    return secs, cli_records(logs, name), counts


def eval_only_need(sets: dict, vision_layers: int, text_layers: int) -> dict:
    """The exact launches of the eval-only run over ``sets`` at batch ``CLI_BATCH``: one
    ``block_attention_fwd`` per block of every encode and one ``resample`` per decode of
    JPEGs. Zero-shot: a text encode per 10 classes (``build_zero_shot_classifier``'s
    ``batch_classes``) and an image encode per batch; retrieval: the COCO images' chunks (one
    decode of them all) and their 5 captions' chunks; the probe: the CIFAR train and test
    splits' batches."""
    def chunks(n):
        return -(-n // CLI_BATCH)

    n_cls, n_img, _ = EVAL_FOLDER
    zero_shot = {"cifar10": (10, EVAL_CIFAR, False), "imagenet_val": (n_cls, n_cls * n_img, True),
                 "flowers": (102, EVAL_FLOWERS, True)}
    text = chunks(5 * EVAL_COCO)
    image = chunks(EVAL_COCO) + 2 * chunks(EVAL_CIFAR)
    resample = 1
    for flag, (classes, images, jpeg) in zero_shot.items():
        if flag in sets:
            text += -(-classes // 10)
            image += chunks(images)
            resample += chunks(images) if jpeg else 0
    return {"block_attention_fwd": vision_layers * image + text_layers * text,
            "resample": resample}


def check_eval_metrics(record: dict, zero_shot_sets: list, probe: bool, what: str) -> dict:
    """The metrics the reference's names give, each finite and in [0, 1]."""
    want = [f"{s}-zeroshot-top{k}" for s in zero_shot_sets for k in (1, 5)]
    want += [f"coco_retrieval-{d}_R@{k}" for d in ("text_to_image", "image_to_text")
             for k in (1, 5, 10)]
    if probe:
        want += ["linear_probe_accuracy", "linear_probe_mean_per_class"]
    bad = {k: record.get(k) for k in want
           if not (isinstance(record.get(k), float) and 0.0 <= record[k] <= 1.0)}
    if bad:
        fail(f"{what}: metrics missing, non-finite or outside [0, 1]: {bad}")
    return {k: record[k] for k in want}


def eval_kernel_vs_plain(torch, mods, tally, card, model, cifar_root: str):
    """Phase 15 (c): one CIFAR batch's image features and the CIFAR-10 zero-shot classifier
    through the kernels, and again with every block's attention on its plain version."""
    from multimodal_tpu_torch.data.eval_sets import open_eval_dataset
    from multimodal_tpu_torch.eval.metadata import classnames, templates
    from multimodal_tpu_torch.eval.zero_shot import build_zero_shot_classifier
    from multimodal_tpu_torch.inference import model_mode
    from multimodal_tpu_torch.train.engine import batch_images

    ds = open_eval_dataset("cifar10", cifar_root, batch_size=CLI_BATCH,
                           image_size=model.cfg.vision.image_size, device="cuda")
    images, _ = next(iter(ds))
    x = torch.from_numpy(images).to("cuda")

    def run():
        with model_mode(model, False), torch.inference_mode():
            feats = model.encode_image(batch_images({"image": x}, model), normalize=True)
            clf = build_zero_shot_classifier(
                lambda t: model.encode_text(t, normalize=True), classnames("cifar10"),
                templates("openai"), context_length=model.cfg.text.context_length,
                device="cuda")
            return feats, clf

    tally.start()
    feats, clf = run()
    torch.cuda.synchronize()
    counts = tally.stop()
    with plain_attention(mods):
        p_feats, p_clf = run()
    cos_f = float((feats * p_feats).sum(-1).min())
    cos_c = float((clf * p_clf).sum(0).min())
    agree = float(((feats @ clf).argmax(-1) == (p_feats @ p_clf).argmax(-1)).float().mean())
    print(f"  (c) one CIFAR batch (B={len(images)}) kernel vs plain path: image features min "
          f"cosine {cos_f:.7f}, classifier columns min cosine {cos_c:.7f} (need >= 0.9999); "
          f"top-1 agreement {agree:.4f}; launches {({k: v for k, v in counts.items() if v})} "
          f"(need block_attention_fwd >= 24) [{card}]", flush=True)
    if min(cos_f, cos_c) < 0.9999 or counts["block_attention_fwd"] < 24:
        fail("the evaluation's encodes disagree with the plain path or skipped the kernel")


def eval_serving(torch, tally, card, ckpt: str, coco_root: str, phase5_rate: float):
    """Phase 15 (d): the checkpoint served through ``serving.load_serving_weights`` (as
    ``serving --checkpoint DIR --ema`` loads it), against an Embedder over a model loaded by
    hand from the checkpoint's EMA weights; the trained weights served beside it; a
    ``normalize=False`` service; the windowed ``Embedder`` rate."""
    from multimodal_tpu_torch.inference import Embedder
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.serving import EmbeddingService, load_serving_weights, make_server
    from multimodal_tpu_torch.train.checkpoints import CheckpointManager

    paths = sorted(os.path.join(coco_root, "val2017", f)
                   for f in os.listdir(os.path.join(coco_root, "val2017")))[:EVAL_SERVED]
    bufs = [open(p, "rb").read() for p in paths]
    b64 = [base64.b64encode(b).decode() for b in bufs]
    saved, _ = CheckpointManager(ckpt).restore()
    direct = create_model(MODEL, seed=7)
    with torch.no_grad():
        direct.load_state_dict(saved["model"])
        for n, p in direct.named_parameters():
            p.copy_(saved["ema"][n])
    ref = Embedder(direct, batch_size=CLI_BATCH)
    want_t = ref.embed_texts(CAPTIONS)
    want_i, _ = ref.embed_image_bytes(bufs, direct.cfg.vision.image_size)
    del direct, ref, saved
    replies = {}
    for ema in (True, False):
        model = create_model(MODEL, seed=1)
        loaded = load_serving_weights(model, ckpt, ema=ema)
        svc = EmbeddingService(model, max_batch=CLI_BATCH, max_wait_ms=5.0)
        srv = make_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            tally.start()
            code_t, text = post(url + "/v1/embed/text", {"texts": CAPTIONS})
            code_i, image = post(url + "/v1/embed/image", {"images_b64": b64})
            counts = tally.stop()
            if (code_t, code_i) != (200, 200) or not all(image["decoded"]):
                fail(f"serving the checkpoint (ema={ema}) answered {code_t}/{code_i}: "
                     f"{text.get('error')} {image.get('error')}")
            t = check_embeddings("text", text["embeddings"], len(CAPTIONS), model.cfg.embed_dim)
            i = check_embeddings("image", image["embeddings"], len(b64), model.cfg.embed_dim)
            replies[ema] = (t, i)
            print(f"  (d) served step {loaded['step']} ({'EMA' if loaded['ema'] else 'trained'}"
                  f" weights): {len(CAPTIONS)} texts, {len(b64)} JPEGs; launches "
                  f"{({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
            if counts["block_attention_fwd"] < 24 or counts["resample"] < 1:
                fail("serving the checkpoint did not run the block and resample kernels")
            if ema:
                raw = EmbeddingService(model, max_batch=CLI_BATCH, normalize=False)
                try:
                    norms = np.linalg.norm(raw.embed_image_bytes(bufs[:8])[0], axis=-1)
                finally:
                    raw.close()
                emb = Embedder(model, batch_size=CLI_BATCH)
                size = model.cfg.vision.image_size
                imgs = np.random.default_rng(3).integers(
                    0, 256, (EVAL_RATE_IMAGES, size, size, 3), dtype=np.uint8)
                emb.embed_images(imgs[:CLI_BATCH])
                torch.cuda.synchronize()
                tally.start()
                t0 = time.perf_counter()
                emb.embed_images(imgs)
                rate = EVAL_RATE_IMAGES / (time.perf_counter() - t0)
                window = tally.stop()
                del imgs
                need = {"block_attention_fwd": model.cfg.vision.layers
                        * -(-EVAL_RATE_IMAGES // CLI_BATCH)}
                if {k: v for k, v in window.items() if v} != need:
                    fail(f"the windowed embed_images launched {window}, need {need}")
        finally:
            srv.shutdown()
            srv.server_close()
            svc.close()
            thread.join(timeout=10)
        del model, svc
        torch.cuda.empty_cache()
    cos_t = float(np.sum(replies[True][0] * want_t, -1).min())
    cos_i = float(np.sum(replies[True][1] * want_i, -1).min())
    diff = float(np.abs(replies[True][1] - replies[False][1]).max())
    print(f"  served --ema vs an Embedder over the checkpoint's EMA weights loaded by hand: min "
          f"cosine text {cos_t:.7f}, image {cos_i:.7f} (need >= 0.9999); EMA vs trained replies "
          f"max |diff| {diff:.5f} (need > 1e-4); normalize=False row norms "
          f"{float(norms.min()):.4f}-{float(norms.max()):.4f} (need not all 1)", flush=True)
    if min(cos_t, cos_i) < 0.9999 or diff <= 1e-4 or np.allclose(norms, 1.0, atol=1e-3):
        fail("the served checkpoint disagrees with its direct load, or the EMA and trained "
             "replies do not differ, or normalize=False normalized")
    print(f"  Embedder.embed_images over {EVAL_RATE_IMAGES} uint8 images at bucket {CLI_BATCH} "
          f"(3 chunks in flight, float32, host clock incl. transfer): {rate:.1f} encodes/s, "
          f"beside phase 5's single-bucket encode_images {phase5_rate:.1f} in this call "
          f"(information); launches {need} [{card}]", flush=True)


def eval_optional_packages(torch, card):
    """Phase 15 (e): whether tensorstore and transformers import; where one does, the port's
    use of it on a tiny case; either way, the port's ImportError naming it when it is absent
    (hidden here through ``sys.modules``)."""
    import tempfile

    from multimodal_tpu_torch.data.semantic import HFSentenceEncoder
    from multimodal_tpu_torch.models import read_orbax_params

    def raises_naming(name, fn):
        real = sys.modules.get(name)
        sys.modules[name] = None
        try:
            fn()
        except ImportError as e:
            return name in str(e)
        finally:
            if real is None:
                del sys.modules[name]
            else:
                sys.modules[name] = real
        return False

    found = {}
    for name in ("tensorstore", "transformers"):
        try:
            __import__(name)
            found[name] = True
        except ImportError:
            found[name] = False
    tmp = tempfile.mkdtemp(prefix="phase15_pkgs_")
    try:
        ok_ts = raises_naming("tensorstore", lambda: read_orbax_params(tmp))
        ok_tf = raises_naming("transformers", lambda: HFSentenceEncoder(tmp, device="cuda"))
        print(f"  (e) tensorstore imports: {found['tensorstore']}; transformers imports: "
              f"{found['transformers']}; the port's ImportError names tensorstore: {ok_ts}, "
              f"transformers: {ok_tf}", flush=True)
        if not (ok_ts and ok_tf):
            fail("a missing optional package was not named by the port's ImportError")
        if found["tensorstore"]:
            import tensorstore as ts

            store = os.path.join(tmp, "ocdbt")
            want = {"params.a.kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                    "params.a.bias": np.float32([0.5, -1.0, 2.0, 3.0]),
                    "params.logit_scale": np.float32(2.6592)}
            for path, arr in want.items():
                t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                           "base": "file://" + store},
                             "path": path, "metadata": {"shape": list(arr.shape),
                                                        "dtype": "<f4"}},
                            create=True).result()
                t.write(arr).result()
            tree = read_orbax_params(store)
            got = {"params.a.kernel": tree["params"]["a"]["kernel"],
                   "params.a.bias": tree["params"]["a"]["bias"],
                   "params.logit_scale": tree["params"]["logit_scale"]}
            same = all(np.array_equal(got[k], v) for k, v in want.items())
            print(f"  tensorstore: an OCDBT zarr set written here with tensorstore itself (not "
                  f"Orbax's writer, which needs JAX) read back by read_orbax_params: "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            if not same:
                fail("read_orbax_params misread the OCDBT zarr set")
        if found["transformers"]:
            from transformers import BertConfig, BertModel, BertTokenizer

            snap = os.path.join(tmp, "bert")
            os.makedirs(snap)
            words = ["a", "photo", "of", "the", "cat", "dog", "two", "in", "snow", "red", "car"]
            with open(os.path.join(snap, "vocab.txt"), "w") as f:
                f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words))
            BertTokenizer(os.path.join(snap, "vocab.txt")).save_pretrained(snap)
            torch.manual_seed(0)
            BertModel(BertConfig(vocab_size=16, hidden_size=32, num_hidden_layers=2,
                                 num_attention_heads=2, intermediate_size=64)).save_pretrained(
                snap)
            texts = CAPTIONS[:3]
            on_card = HFSentenceEncoder(snap, device="cuda")(texts)
            on_cpu = HFSentenceEncoder(snap, device="cpu")(texts)
            err = float(np.abs(on_card - on_cpu).max())
            print(f"  transformers: HFSentenceEncoder on a tiny BertModel, card vs CPU max |diff| "
                  f"{err:.2e} (need <= 1e-4), rows {on_card.shape} [{card}]", flush=True)
            if err > 1e-4 or not np.allclose(np.linalg.norm(on_card, axis=1), 1, atol=1e-5):
                fail("HFSentenceEncoder on the card disagrees with the CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_eval(torch, mods, tally, card, phase5_rate: float):
    """Phase 15: train with --model-ema and evaluate through the CLI in a child process,
    evaluate again from the checkpoint in eval-only mode in this process with exact launch
    counts, hold the evaluation's encodes to the plain path, serve the
    checkpoint, probe the optional packages."""
    import tempfile

    from multimodal_tpu_torch.models import create_model, get_model_config
    from multimodal_tpu_torch.serving import load_serving_weights

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase15_")
    try:
        t0 = time.perf_counter()
        sets = eval_sets(root, np.random.default_rng(0))
        print(f"  (a) eval sets made in {time.perf_counter() - t0:.1f} s: CIFAR-10 pickle "
              f"batches ({EVAL_CIFAR} test, {EVAL_CIFAR} train, 32 px), {EVAL_FOLDER[0]} "
              f"folders x {EVAL_FOLDER[1]} JPEGs ({EVAL_FOLDER[2]} px), "
              + (f"Flowers-102 ({EVAL_FLOWERS} JPEGs, .mat files), " if "flowers" in sets
                 else "no Flowers-102 (scipy does not import here), ")
              + f"COCO val ({EVAL_COCO} JPEGs x 5 captions)", flush=True)
        if "flowers" not in sets:
            from multimodal_tpu_torch.data.eval_sets import flowers102

            try:
                flowers102(root, batch_size=1)
                fail("flowers102 read .mat files without scipy")
            except ImportError as e:
                if "scipy" not in str(e):
                    fail(f"the missing scipy is not named: {e}")
        zs_sets = [k for k in ("cifar10", "imagenet_val", "flowers") if k in sets]
        evals = sum(([f"--{k.replace('_', '-')}", v] for k, v in sets.items()), [])
        evals += ["--linear-probe-train", sets["cifar10"], "--linear-probe-epochs",
                  str(EVAL_PROBE_EPOCHS)]
        logs = os.path.join(root, "logs")
        common = ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size",
                  str(CLI_BATCH), "--train-num-samples", str(EVAL_STEPS * CLI_BATCH),
                  "--warmup", "2", "--lr", "1e-3", "--wd", "0.1", "--seed", "0",
                  "--precision", "amp_bf16", "--model-ema", "--log-every-n-steps", "4"] + evals
        print(f"  (b) python -m multimodal_tpu_torch.train.run: {MODEL} bfloat16 B={CLI_BATCH}, "
              f"1 epoch of {EVAL_STEPS} steps with --model-ema, --zeroshot-frequency 1 "
              "--retrieval-frequency 1, then --epochs 0 --resume latest", flush=True)
        secs, records, _ = eval_cli(logs, "train", common + [
            "--epochs", "1", "--zeroshot-frequency", "1", "--retrieval-frequency", "1"], card)
        train = [r for r in records if "loss" in r]
        last = {}
        for r in records:
            last.update({k: v for k, v in r.items() if "zeroshot" in k or "R@" in k})
        got = check_eval_metrics(last, zs_sets, False, "the training run's evaluation")
        if not train or not np.isfinite([r["loss"] for r in train]).all():
            fail("the phase-15 training run logged no finite loss")
        print(f"  training run: {secs:.1f} s in all (child process); losses "
              f"{[round(r['loss'], 5) for r in train]}; {got} [{card}]", flush=True)
        cfg = get_model_config(MODEL)
        need = eval_only_need(sets, cfg.vision.layers, cfg.text.layers)
        secs, records, counts = eval_cli(logs, "train", common + ["--epochs", "0", "--resume",
                                                                  "latest"], card, tally)
        gc.collect()
        torch.cuda.empty_cache()
        again = check_eval_metrics(records[-1], zs_sets, True, "the eval-only run")
        counts = {k: v for k, v in counts.items() if v}
        print(f"  eval-only run from the checkpoint (the CLI in this process): {secs:.1f} s in "
              f"all; linear probe accuracy {again['linear_probe_accuracy']:.4f}, mean per "
              f"class {again['linear_probe_mean_per_class']:.4f}; launches {counts} (need "
              f"{need}) [{card}]", flush=True)
        if counts != need:
            fail(f"the eval-only run launched {counts}, need {need}")
        differ = {k: (v, again[k]) for k, v in got.items() if again[k] != v}
        if differ:
            fail(f"the eval-only run's metrics differ from the training run's last: {differ}")
        print("  eval-only zero-shot and retrieval metrics equal the training run's last "
              "evaluation", flush=True)
        ckpt = os.path.join(logs, "train", "checkpoints")
        model = create_model(MODEL, seed=1)
        load_serving_weights(model, ckpt, ema=True)
        eval_kernel_vs_plain(torch, mods, tally, card, model, sets["cifar10"])
        del model
        torch.cuda.empty_cache()
        eval_serving(torch, tally, card, ckpt, sets["coco_retrieval"], phase5_rate)
        eval_optional_packages(torch, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


CAPTION_BATCH = 32  # phase 16 (a): the reference decoder's training and decode batch
CAPTION_LEN = 40  # caption tokens in training, and the decode's max_len
CAPTION_STEPS = 4
CAPTION_IMAGES = 256  # synthetic images whose ViT-B/32 features feed the decoder
CAPTION_MARGIN = 1e-4  # (a): tokens must agree where the plain path's top-2 margin is above it
CAPTION_CLI_EPOCHS = 3  # the CLI's --captioning-epochs default
PROFILE_STEPS = 2  # (d): --profile-steps of a 4-step CLI run
EM_POINTS, EM_DIM, EM_K, EM_ITERS = 50_000, 512, 10, 20  # (e)
EM_RTOL = 1e-4
BENCH_RTOL = 1e-4  # (f)
BENCH_STEPS = 1000  # (f): run_loss_bench's default, the CPU's trajectory
BENCH_CHECKS = (0, 250, 500, 750, 999)  # (f): the CPU's steps taken once more on the card
BENCH_CARD_STEPS = 200  # (f): the card's free run, a fifth of the default, for the script's time


def caption_cli_need(n_items: int, vision_layers: int, batch: int, mapper_layers: int = 2,
                     epochs: int = CAPTION_CLI_EPOCHS) -> dict:
    """The exact launches of ``--epochs 0 --captioning-eval`` over ``n_items`` images at
    ``--batch-size`` ``batch``: two image encodes (the train and the held-out split, each in
    chunks of ``batch``, one resample per decode), the mapper's blocks forward and backward in
    every decoder step (``range(0, n - bs + 1, bs)`` steps an epoch at bs = min(32, n)), and
    forward in each decode batch of 32."""
    n_eval = max(8, n_items // 10)
    n_train = n_items - n_eval
    bs = min(32, n_train)
    steps = epochs * len(range(0, n_train - bs + 1, bs))
    encodes = -(-n_train // batch) + -(-n_eval // batch)
    decodes = -(-n_eval // bs)
    return {"block_attention_fwd": vision_layers * encodes + mapper_layers * (steps + decodes),
            "block_attention_bwd": mapper_layers * steps, "resample": 2}


def decode_agreement(tokens, plain_tokens, plain_logits) -> tuple[bool, list]:
    """Greedy tokens of the kernel path against the plain path's, row by row, up to the first
    step at which the plain path's top-2 logit margin is under ``CAPTION_MARGIN`` (a near
    tie that a sum-order difference may flip). Returns (agree, each row's first such step or
    None)."""
    top2 = np.sort(np.asarray(plain_logits, np.float64), axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]  # [B, steps]
    firsts, agree = [], True
    for row in range(margin.shape[0]):
        small = np.flatnonzero(margin[row] < CAPTION_MARGIN)
        upto = int(small[0]) if small.size else margin.shape[1]
        firsts.append(int(small[0]) if small.size else None)
        agree = agree and bool(np.array_equal(tokens[row, :upto], plain_tokens[row, :upto]))
    return agree, firsts


def profile_family_launches(summary: dict) -> dict:
    """Kernel launches of a ``trace_op_summary`` device entry, by ``profile_step`` family."""
    from multimodal_tpu_torch.profile_step import family_of

    out: dict = {}
    for name, n in summary["launches"].items():
        fam = family_of(name)
        out[fam] = out.get(fam, 0) + n
    return out


def family_count(families: dict, prefix: str) -> int:
    return sum(n for fam, n in families.items() if fam.startswith(prefix))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())


def caption_decoder(torch, mods, tally, card):
    """Phase 16 (a): the reference's decoder at full width (``ClipCaptionModel()``: GPT-2 base,
    an 8-layer mapper at W=768, S=20) on ViT-B/32 features of synthetic images: float32 AdamW
    steps through the kernels against the plain path, then the greedy decode."""
    from multimodal_tpu_torch.inference import Embedder
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.models.captioner import ClipCaptionModel

    encoder = create_model(MODEL, seed=0)
    size = encoder.cfg.vision.image_size
    images = np.random.default_rng(5).integers(0, 256, (CAPTION_IMAGES, size, size, 3),
                                               dtype=np.uint8)
    tally.start()
    feats = Embedder(encoder, batch_size=CAPTION_IMAGES).embed_images(images)
    counts = tally.stop()
    need = {"block_attention_fwd": encoder.cfg.vision.layers}
    if {k: v for k, v in counts.items() if v} != need:
        fail(f"the features' encode launched {counts}, need {need}")
    del encoder, images
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = ClipCaptionModel(clip_dim=feats.shape[1], seed=0)  # ViT-B/32's 512, the default
    print(f"  (a) ClipCaptionModel(): GPT-2 {model.gpt2}, mapper "
          f"{len(model.mapper.transformer.resblocks)} blocks at S="
          f"{model.mapper.clip_length + model.prefix_length}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M parameters, built in "
          f"{time.perf_counter() - t0:.1f} s; features of {CAPTION_IMAGES} synthetic images "
          f"(launches {need})", flush=True)
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, model.gpt2.vocab_size, (CAPTION_IMAGES, CAPTION_LEN))
    for row, n in enumerate(rng.integers(CAPTION_LEN // 2, CAPTION_LEN + 1, CAPTION_IMAGES)):
        tokens[row, n:] = 0
    feats_t = torch.from_numpy(feats).cuda()
    tokens_t = torch.from_numpy(tokens).cuda()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    per_step = {"block_attention_fwd": 8, "block_attention_bwd": 8}
    # the mapper's ReLU gates in step 1: a pre-activation within rounding of 0 may open on one
    # path and stay shut on the other, where the gradient jumps, so the plain path replays the
    # kernel path's gates (relu(h) = h * [h > 0] with the kernel path's [h > 0]) and the gates
    # it would have set itself are counted
    gates: dict = {"mode": None, "kernel": [], "plain": []}

    def gate(j):
        def act(h):
            if gates["mode"] == "record":
                gates["kernel"].append(h.detach() > 0)
            elif gates["mode"] == "replay":
                gates["plain"].append(h.detach() > 0)
                return h * gates["kernel"][j].to(h.dtype)
            return torch.relu(h)
        return act

    for j, blk in enumerate(model.mapper.transformer.resblocks):
        blk.mlp.act = gate(j)

    def steps(count: bool = False, timed: bool = False):
        """CAPTION_STEPS AdamW steps from ``start``: each step's (loss, grad norm), the launch
        counts, step 1's gradients; ``timed``: nothing read back until the end, samples/s
        over steps 2 on."""
        model.load_state_dict(start)
        opt = torch.optim.AdamW(model.parameters(), lr=2e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        out, counts, grads, t_start = [], [], None, None
        torch.cuda.synchronize()
        for i in range(CAPTION_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            sl = slice(i * CAPTION_BATCH, (i + 1) * CAPTION_BATCH)
            if count:
                tally.start()
            if i == 0 and not timed:
                gates["mode"] = "record" if count else "replay"
            loss = model(feats_t[sl], tokens_t[sl])
            gates["mode"] = None
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if count:
                torch.cuda.synchronize()
                counts.append(tally.stop())
            if not timed:
                norm = torch.sqrt(sum(p.grad.double().square().sum() for p in model.parameters()))
                if i == 0:
                    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
                out.append((float(loss.detach()), float(norm)))
            opt.step()
        torch.cuda.synchronize()
        return out, counts, grads, (CAPTION_STEPS - 1) * CAPTION_BATCH / (
            time.perf_counter() - t_start)

    got, counts, g_kernel, _ = steps(count=True)
    check_launches(counts, per_step, "the caption decoder's steps")
    with plain_attention(mods):
        want, _, g_plain, _ = steps()
    rates = {"kernel": [], "plain": []}  # in turns: kernel, plain, plain, kernel
    for path in ("kernel", "plain", "plain", "kernel"):
        with plain_attention(mods) if path == "plain" else contextlib.nullcontext():
            rates[path].append(steps(timed=True)[3])
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got[:2], want[:2]))
    norm_rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(got[:2], want[:2]))
    # phase 6's leaf measure: the scale has a floor of 1e-3 x the model's largest gradient (the
    # mapper's key biases have an exact gradient of 0 and hold rounding noise on both sides)
    g_max = max(float(g.abs().max()) for g in g_plain.values())
    leaf_dist = {n: float((g_kernel[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * g_max)
                 for n, g in g_plain.items()}
    flips = [int((a != b).sum()) for a, b in zip(gates["kernel"], gates["plain"])]
    leaf_rel = max(leaf_dist.values())
    worst = sorted(leaf_dist, key=leaf_dist.get)[-3:][::-1]
    finite = all(np.isfinite(v).all() for v in (got, want))
    print(f"  float32 AdamW steps at B={CAPTION_BATCH}, caption length {CAPTION_LEN}: losses "
          f"{[round(a, 6) for a, _ in got]} (plain {[round(b, 6) for b, _ in want]}); first 2 "
          f"steps loss rel {loss_rel:.3e} (need <= 1e-5), grad norm rel {norm_rel:.3e} (need "
          f"<= 1e-4); step 1 every leaf max|kernel - plain| / max|plain| {leaf_rel:.3e} (need "
          f"<= 1e-3; the plain path replays the kernel path's ReLU gates, {flips} of "
          f"{int(gates['plain'][0].numel())} a block of which it would have set otherwise; "
          f"the largest: "
          + ", ".join(f"{n} {leaf_dist[n]:.2e} (max|plain| {float(g_plain[n].abs().max()):.2e})"
                      for n in worst)
          + f"; the model's largest gradient {g_max:.2e}); launches per step {per_step}; "
          f"samples/s over steps 2-{CAPTION_STEPS}, runs in turns (kernel, plain, plain, "
          f"kernel): kernel path {[round(r, 1) for r in rates['kernel']]}, plain path "
          f"{[round(r, 1) for r in rates['plain']]} [{card}]", flush=True)
    if not finite or loss_rel > 1e-5 or norm_rel > 1e-4 or leaf_rel > 1e-3:
        fail("the caption decoder's kernel path disagrees with the plain path")
    del g_kernel, g_plain
    model.load_state_dict(start)
    emb = feats_t[:CAPTION_BATCH]
    model.generate(emb[:2], max_len=2)  # warm
    torch.cuda.synchronize()
    tally.start()
    t0 = time.perf_counter()
    toks, logits = model.generate(emb, max_len=CAPTION_LEN, return_logits=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = tally.stop()
    with plain_attention(mods):
        p_toks, p_logits = model.generate(emb, max_len=CAPTION_LEN, return_logits=True)
    first = torch.nn.functional.cosine_similarity(logits[:, 0].double(),
                                                  p_logits[:, 0].double(), dim=-1)
    agree, firsts = decode_agreement(toks.cpu().numpy(), p_toks.cpu().numpy(),
                                     p_logits.cpu().numpy())
    near = sorted({f for f in firsts if f is not None})
    print(f"  greedy generate(max_len={CAPTION_LEN}) at B={CAPTION_BATCH}: {secs * 1e3:.1f} ms, "
          f"{CAPTION_BATCH * CAPTION_LEN / secs:.1f} tokens/s (one token a step against the "
          f"static cache); first-step logits min cosine {float(first.min()):.7f} (need >= "
          f"0.9999); tokens equal to the plain path's up to each row's first near tie: {agree}"
          f" (steps with a plain top-2 margin < {CAPTION_MARGIN:g}: {near or 'none'}); tokens "
          f"differing anywhere {int((toks != p_toks).sum())}; launches {counts} [{card}]",
          flush=True)
    if float(first.min()) < 0.9999 or not agree or counts["block_attention_fwd"] != 8:
        fail("the decode disagrees with the plain path or skipped the mapper's kernels")
    del model, feats_t, logits, p_logits
    torch.cuda.empty_cache()


def caption_vs_hf(torch, card):
    """Phase 16 (b): the port's GPT-2 at base width against ``transformers.GPT2LMHeadModel``
    from the same random weights, on the card."""
    import transformers

    from multimodal_tpu_torch.models.captioner import GPT2, GPT2Config, load_hf_gpt2

    torch.manual_seed(0)
    hf_cfg = transformers.GPT2Config(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    with torch.device("cuda"):  # drawn on the card: a CPU init of GPT-2 base takes seconds
        hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    cfg = GPT2Config()
    model = GPT2(cfg)
    model.load_state_dict(load_hf_gpt2(hf.state_dict(), cfg))
    model = model.cuda()
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 64)))
    tokens = tokens.cuda()
    with torch.no_grad():
        want = hf(tokens).logits.float()
        got, _ = model(model.embed(tokens))
    err = (got - want).abs()
    bad = int((err > 2e-4 + 2e-3 * want.abs()).sum())
    print(f"  (b) GPT-2 base ({cfg}) vs transformers.GPT2LMHeadModel, random weights through "
          f"load_hf_gpt2, 4 x 64 tokens: max |diff| {float(err.max()):.3e} over max |logit| "
          f"{float(want.abs().max()):.3e}; elements outside atol 2e-4 + rtol 2e-3: {bad} "
          f"[{card}]", flush=True)
    if bad:
        fail("the port's GPT-2 disagrees with transformers' GPT2LMHeadModel")
    del hf, model
    torch.cuda.empty_cache()


def coco_set(root: str, rng, n: int) -> str:
    """A COCO-val layout under ``root``: ``n`` JPEGs at 240 px, 5 captions each."""
    from PIL import Image

    coco = os.path.join(root, "coco")
    os.makedirs(os.path.join(coco, "val2017"))
    os.makedirs(os.path.join(coco, "annotations"))
    images, anns = [], []
    for i in range(n):
        fn = f"{i:012d}.jpg"
        arr = rng.integers(0, 256, (240, 300, 3), dtype=np.uint8)
        arr[:120] //= 2
        Image.fromarray(arr).save(os.path.join(coco, "val2017", fn), quality=90)
        images.append({"id": i, "file_name": fn})
        for j in range(5):
            words = rng.choice(COCO_WORDS, 6)
            anns.append({"image_id": i, "caption": f"{' '.join(words)} {i} {j}"})
    with open(os.path.join(coco, "annotations", "captions_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return coco


def caption_cli(torch, tally, card, root: str):
    """Phase 16 (c): ``--epochs 0 --captioning-eval`` on a COCO-val layout, the CLI's main in
    this process, its launches counted exactly."""
    from multimodal_tpu_torch.models import get_model_config

    coco = coco_set(root, np.random.default_rng(8), EVAL_COCO)
    logs = os.path.join(root, "logs")
    argv = ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size", str(CLI_BATCH),
            "--epochs", "0", "--captioning-eval", coco, "--seed", "0",
            "--no-save-on-preemption"]
    secs, records, counts = eval_cli(logs, "caption", argv, card, tally)
    record = records[-1]
    need = caption_cli_need(EVAL_COCO, get_model_config(MODEL).vision.layers, CLI_BATCH)
    counts = {k: v for k, v in counts.items() if v}
    bleu, n_eval = record.get("caption_bleu"), record.get("caption_num_eval")
    print(f"  (c) --epochs 0 --captioning-eval ({EVAL_COCO} COCO JPEGs, decoder width 256, 4 "
          f"layers, {CAPTION_CLI_EPOCHS} epochs): caption_bleu {bleu}, caption_num_eval "
          f"{n_eval} (need {max(8, EVAL_COCO // 10)}); the run {secs:.1f} s; launches {counts} "
          f"(need {need}) [{card}]", flush=True)
    with open(os.path.join(logs, "caption", "out.log")) as f:
        for line in f:
            if "captioning eval" in line or "caption epoch" in line:
                print(f"  [caption] {line.split(' | ')[-1].strip()} [{card}]", flush=True)
    if not (isinstance(bleu, float) and 0.0 <= bleu <= 1.0) or n_eval != max(8, EVAL_COCO // 10):
        fail(f"the captioning evaluation returned {record}")
    if counts != need:
        fail(f"the captioning evaluation launched {counts}, need {need}")


def profile_cli(torch, card, root: str):
    """Phase 16 (d): ``--profile-steps 2`` on a synthetic ViT-B/32 CLI run of 4 steps."""
    from multimodal_tpu_torch.profiling import trace_line_summary, trace_op_summary

    logs = os.path.join(root, "logs")
    argv = ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size", str(CLI_BATCH),
            "--train-num-samples", str(4 * CLI_BATCH), "--epochs", "1", "--precision",
            "amp_bf16", "--profile-steps", str(PROFILE_STEPS), "--no-save-on-preemption",
            "--logs", logs, "--name", "profile"] + EVAL_CLI_EXTRA
    t0 = time.perf_counter()
    if cli_main(argv) != 0:
        fail("the --profile-steps run failed")
    secs = time.perf_counter() - t0
    trace_dir = os.path.join(logs, "profile", "profile")
    files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    if len(files) != 1:
        fail(f"--profile-steps wrote {files} under {trace_dir}, need one trace")
    ops = trace_op_summary(trace_dir, "cuda")
    lines = trace_line_summary(trace_dir, "cuda")
    with open(os.path.join(trace_dir, files[0])) as f:
        spans = sum(1 for e in json.load(f)["traceEvents"]  # the host's; the card has its own
                    if e.get("name") == "train_step" and e.get("cat") == "user_annotation")
    (dev,) = ops
    fam = profile_family_launches(ops[dev])
    # the block backward's dQ: the mma.sync pass, or the wgmma kernel's block form (bfloat16)
    fwd = family_count(fam, "forward attention core")
    bwd = family_count(fam, "backward dQ") + family_count(fam, "block backward dQ")
    need = PROFILE_STEPS * 24
    over = {ln: (v["occupancy_ms"], v["sum_ms"]) for ln, v in lines[dev].items()
            if v["occupancy_ms"] > v["sum_ms"] * (1 + 1e-9)}  # float sums of ~1e4 terms
    top = ", ".join(f"{n[:60]} {ms:.2f}" for n, ms in ops[dev]["ops"][:4])
    print(f"  (d) --profile-steps {PROFILE_STEPS} on a 4-step bf16 B={CLI_BATCH} run ({secs:.1f} "
          f"s): trace {files[0]} ({os.path.getsize(os.path.join(trace_dir, files[0])) / 2**20:.1f}"
          f" MiB), {spans} train_step spans; {dev} kernel time {ops[dev]['total_ms']:.1f} ms in "
          f"{sum(ops[dev]['launches'].values())} launches; block forward cores {fwd}, backward "
          f"dQ passes {bwd} (need {need} each); streams {len(lines[dev])}, occupancy over sum "
          f"on {over or 'none'}; top: {top} [{card}]", flush=True)
    if spans != PROFILE_STEPS or fwd != need or bwd != need or over:
        fail("the --profile-steps trace does not hold exactly the traced steps' kernels")


def em_on_card(torch, card):
    """Phase 16 (e): vMF EM at 50,000 x 512, K=10, 20 iterations on the card against the same
    fit on the CPU from the same initial means."""
    from multimodal_tpu_torch.research import vmf_mixture

    rng = np.random.default_rng(9)
    centers = rng.standard_normal((EM_K, EM_DIM)).astype(np.float32)
    labels = rng.integers(0, EM_K, EM_POINTS)
    x = centers[labels] + np.float32(0.6) * rng.standard_normal((EM_POINTS, EM_DIM),
                                                                dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    init = vmf_mixture._kmeanspp_init(torch.Generator(device="cuda").manual_seed(0),
                                      torch.from_numpy(x).cuda(), EM_K).cpu().numpy()
    fits, per_iter = {}, {}
    for side, device in (("card", "cuda"), ("cpu", "cpu")):
        kw = dict(n_components=EM_K, tol=0.0, device=device)  # tol 0: every iteration runs
        vmf_mixture.VMFMixtureEM(max_iter=1, **kw).fit(x, init_means=init)
        t0 = time.perf_counter()
        vmf_mixture.VMFMixtureEM(max_iter=1, **kw).fit(x, init_means=init)
        one = time.perf_counter() - t0
        t0 = time.perf_counter()
        fits[side] = vmf_mixture.VMFMixtureEM(max_iter=EM_ITERS, **kw).fit(x, init_means=init)
        per_iter[side] = (time.perf_counter() - t0 - one) / (EM_ITERS - 1)
    g, c = fits["card"], fits["cpu"]
    errs = {"weights": rel_err(g.weights, c.weights),
            "kappas": rel_err(g.concentrations, c.concentrations),
            "log-likelihoods": rel_err(g.log_likelihoods_, c.log_likelihoods_)}
    print(f"  (e) vMF EM, {EM_POINTS} x {EM_DIM}, K={EM_K}, {EM_ITERS} iterations from the same "
          f"k-means++ means: card {per_iter['card'] * 1e3:.2f} ms/iteration, CPU "
          f"{per_iter['cpu'] * 1e3:.2f} ms/iteration ({per_iter['cpu'] / per_iter['card']:.1f}x;"
          f" host clock, the fit's upload beside the first iteration subtracted); final LL "
          f"{g.log_likelihoods_[-1]:.6f} (CPU {c.log_likelihoods_[-1]:.6f}); kappas "
          f"{np.round(g.concentrations, 2).tolist()}; card vs CPU max rel "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (need <= {EM_RTOL:g}) [{card}]",
          flush=True)
    if max(errs.values()) > EM_RTOL:
        fail("vMF EM on the card disagrees with the CPU")


def loss_bench_cpu(path: str) -> int:
    """Phase 16 (f)'s CPU side, in a child process that sees no card (this script with
    ``--bench-child``): for each distribution ``run_loss_bench``'s trajectory at its defaults
    (``BENCH_STEPS``) from a CPU generator seeded 0, with the state and the generator's state
    before, and the stats and the state after, each step of ``BENCH_CHECKS``, the stats after
    step ``BENCH_CARD_STEPS`` and the seconds; saved with ``torch.save`` to ``path``."""
    import torch

    from multimodal_tpu_torch.research import loss_bench as lb

    torch.set_num_threads(1)  # 20 points: one core, beside the card's phases
    out = {}
    for dist in lb.DISTRIBUTIONS:
        gen = torch.Generator().manual_seed(0)
        t0 = time.perf_counter()
        state = lb.initial_state(20, 2, 0.1, gen, "cpu")
        saved, after, short = {}, {}, None
        for i in range(BENCH_STEPS):
            if i in BENCH_CHECKS:
                saved[i] = (tuple(t.clone() for t in state), gen.get_state())
            state, stats = lb.bench_step(dist, state, gen)
            if i in BENCH_CHECKS:
                after[i] = ({k: float(v) for k, v in stats.items()}, state)
            if i == BENCH_CARD_STEPS - 1:
                short = {k: float(v) for k, v in stats.items()}
        out[dist] = {"saved": saved, "after": after, "short": short,
                     "final": {k: float(v) for k, v in stats.items()},
                     "secs": time.perf_counter() - t0}
    torch.save(out, path + ".part")
    os.replace(path + ".part", path)
    return 0


class LossBenchCpu:
    """Phase 16 (f)'s CPU trajectories (``loss_bench_cpu``), computed by a child process that
    the script starts at phase 15, so that its ~60 s of one CPU core run beside phases 15 and
    16 (a)-(e) on the card; (f) waits for it. The child is killed at exit if still running."""

    def __init__(self):
        import atexit
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="loss_bench_")
        self.path = os.path.join(self.dir, "cpu.pt")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--bench-child", self.path],
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        atexit.register(self.close)

    def result(self, torch) -> tuple[dict, float]:
        """The child's output and the seconds (f) waited for it."""
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            fail("the loss bench's CPU trajectories took more than 600 s past phase 16 (f)")
        waited = time.perf_counter() - t0
        if rc != 0:
            fail(f"the loss bench's CPU child exited {rc}")
        out = torch.load(self.path)
        self.close()
        return out, waited

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def loss_bench_on_card(torch, card, cpu: LossBenchCpu):
    """Phase 16 (f): ``run_loss_bench`` at its defaults but ``BENCH_CARD_STEPS`` steps for every
    distribution on the card (its seconds and final statistics); the CPU's trajectory at its
    defaults (``BENCH_STEPS``) from a CPU generator, from ``cpu``'s child, and at
    ``BENCH_CHECKS`` one card step from the CPU's state with the CPU's draws (the generator's
    state carried across) held to the CPU's step, the late steps included, where the
    concentrations have grown. The free runs are not held to each other: float32 steps of this
    map amplify rounding (``tests/test_torch_loss_bench.py``: a 1e-7 nudge of the initial points
    moves the gradient norm by more than 1e-4 within 150 steps on the CPU alone)."""
    from multimodal_tpu_torch.research import loss_bench as lb

    runs, waited = cpu.result(torch)
    print(f"  (f) the CPU's trajectories ({BENCH_STEPS} steps each, a child process started at "
          f"phase 15): waited {waited:.1f} s for them here", flush=True)
    worst = {}
    for dist in lb.DISTRIBUTIONS:
        run = runs[dist]
        t0 = time.perf_counter()
        res = lb.run_loss_bench(dist, steps=BENCH_CARD_STEPS, device="cuda")
        card_secs = time.perf_counter() - t0
        errs = []
        for i in BENCH_CHECKS:
            st, gstate = run["saved"][i]
            g = torch.Generator()
            g.set_state(gstate)
            new, stats = lb.bench_step(dist, tuple(t.to("cuda") for t in st), g)
            want, want_state = run["after"][i]
            rel = max(rel_err(float(v), want[k]) for k, v in stats.items() if k != "arc")
            arc = abs(float(stats["arc"]) - want["arc"])
            mu = max(float((a.cpu() - b).abs().max()) for a, b in zip(new[:2], want_state[:2]))
            conc = rel_err(new[2].cpu().numpy(), want_state[2].numpy())
            errs.append((i, rel, arc, mu, conc))
        worst[dist] = (max(e[1] for e in errs), max(e[2] for e in errs), max(e[3] for e in errs),
                       max(e[4] for e in errs))
        final = {"total": res.final_total_loss, "arc": res.final_arc_deg,
                 "conc_a": res.final_concentration_a, "grad_norm": res.grad_norm_last}
        short = run["short"]
        print(f"  (f) run_loss_bench({dist!r}) at its defaults but {BENCH_CARD_STEPS} steps: card "
              f"{card_secs:.2f} s (its own generator); card final "
              f"{ {k: round(v, 5) for k, v in final.items()} }, the CPU's at step "
              f"{BENCH_CARD_STEPS} from a CPU generator { {k: round(short[k], 5) for k in final} } "
              f"(not held: rounding grows over the run); the CPU's {BENCH_STEPS} steps "
              f"{run['secs']:.2f} s, final { {k: round(run['final'][k], 5) for k in final} }; one "
              f"card step from the CPU's state and draws at steps {list(BENCH_CHECKS)}: stats max "
              f"rel {worst[dist][0]:.2e}, arc max |diff| {worst[dist][1]:.2e} deg, points max "
              f"|diff| {worst[dist][2]:.2e}, concentrations max rel {worst[dist][3]:.2e} (need <= "
              f"{BENCH_RTOL:g}, 0.02 deg, 1e-5, {BENCH_RTOL:g}) [{card}]", flush=True)
        if not all(np.isfinite(list(final.values()))):
            fail(f"the loss bench on the card is not finite: {final}")
    if any(r > BENCH_RTOL or a > 0.02 or m > 1e-5 or c > BENCH_RTOL
           for r, a, m, c in worst.values()):
        fail(f"the loss bench's step on the card disagrees with the CPU's: {worst}")


def llama_on_card(torch, card, root: str):
    """Phase 16 (g): ``LlamaCaptioner`` over a tiny random local Llama snapshot written here,
    card captions against CPU captions."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    from multimodal_tpu_torch.models.llama_captioner import LlamaCaptioner

    snap = os.path.join(root, "llama")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        bos_token_id=1, eos_token_id=2)).save_pretrained(snap)
    words = ["<unk>", "<s>", "</s>", "A", "photo", "of", "a", "the", "cat", "dog", "red",
             "blue", "circle", "square", "on", "and", "small", "large"]
    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(snap)
    embeds = (np.random.default_rng(10).standard_normal((4, 32)) * 4).astype(np.float32)
    caps = {side: LlamaCaptioner(snap, clip_dim=32, max_new_tokens=8,
                                 device=device).generate_caption(embeds)
            for side, device in (("card", "cuda"), ("cpu", "cpu"))}
    print(f"  (g) LlamaCaptioner on a tiny random local Llama snapshot: card captions "
          f"{caps['card']} equal the CPU's: {caps['card'] == caps['cpu']} [{card}]", flush=True)
    if caps["card"] != caps["cpu"]:
        fail(f"LlamaCaptioner's card captions {caps['card']} differ from the CPU's {caps['cpu']}")


def phase_captioning(torch, mods, tally, card, cpu_bench: LossBenchCpu | None = None):
    """Phase 16: the caption decoder, GPT-2 against transformers, the captioning evaluation
    through the CLI, --profile-steps, vMF EM, the loss bench (its CPU side from ``cpu_bench``,
    started here when not given) and the Llama adapter."""
    import tempfile

    cpu_bench = cpu_bench or LossBenchCpu()
    t_phase = time.perf_counter()
    parts = {}
    root = tempfile.mkdtemp(prefix="phase16_")
    try:
        for name, run in (("a", lambda: caption_decoder(torch, mods, tally, card)),
                          ("b", lambda: caption_vs_hf(torch, card)),
                          ("c", lambda: caption_cli(torch, tally, card, root)),
                          ("d", lambda: profile_cli(torch, card, root)),
                          ("e", lambda: em_on_card(torch, card)),
                          ("f", lambda: loss_bench_on_card(torch, card, cpu_bench)),
                          ("g", lambda: llama_on_card(torch, card, root))):
            t0 = time.perf_counter()
            run()
            parts[name] = round(time.perf_counter() - t0, 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s (by part {parts}) [{card}]",
          flush=True)


DIST_STEPS = 6  # phase 17 (a) and (b): bf16 rates over steps 2-6, as phase 6's
DIST_CLI_SAMPLES = 2 * CLI_BATCH  # phase 17 (a): two CLI steps at B=256
DIST_LOGS = "chip_smoke_logs_dist"  # under the checkout; removed at the end of phase 17
RING_SHAPE = (2, 8192, 8, 64)  # phase 17 (c): B, S, H, D of the sequence
RING_BLOCKS = 4


def ring_visits(n: int, causal: bool) -> int:
    """The blocks the ring's schedule visits over n blocks of a sequence, each a flash call
    per pass: all n x n, or causal the n (n + 1) / 2 not wholly in the future."""
    return n * (n + 1) // 2 if causal else n * n


def torchrun(argv: list, timeout: int = 600) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --nproc-per-node 1`` on ``argv`` (a free port on
    localhost), its output captured."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))  # the checkout: the port's package
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                           "1", "--master-port", str(port)] + argv,
                          capture_output=True, text=True, timeout=timeout, env=env)


def dp_child(logs: str) -> int:
    """Phase 17 (a) in a process of its own under torchrun: the NCCL process group (world 1),
    the DP step through ``make_train_step(mesh=...)`` against the single-card step from the
    same start (float32, phase 6's limits, exact launch counts), the DP step's bf16 rate, then
    the CLI's ``main`` on each of ``DIST_CLI_RUNS`` in the same process group (the launcher's
    own parser would read a ``--logs`` after ``-m module`` as its ``--logs-specs`` in torch
    2.11). Writes its launch counts and numbers to ``<logs>/dp_child.json``."""
    import torch
    import torch.distributed as dist

    from multimodal_tpu_torch.ops import launches
    from multimodal_tpu_torch.ops import (  # noqa: F401 - each registers its launch counts
        block_attention, block_mlp, flash_attention, fused_attention, quant, resample)
    from multimodal_tpu_torch.parallel import create_mesh, init_process_group

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    device = init_process_group("cuda")
    try:
        mesh = create_mesh()
        x = torch.arange(4.0, device=device)
        dist.all_reduce(x)
        gathered = torch.empty(4, device=device)
        dist.all_gather_into_tensor(gathered, x)
        torch.cuda.synchronize()
        if not torch.equal(gathered, torch.arange(4.0, device=device)):
            fail("NCCL all_reduce / all_gather_into_tensor at world 1 changed the values")
        print(f"  backend {dist.get_backend()}, world {dist.get_world_size()}, mesh "
              f"{mesh.mesh_dim_names} on {device}; NCCL all_reduce and all_gather_into_tensor "
              "ok", flush=True)
        tally = Tally(launches)
        need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
        model = build_model(torch, MODEL, torch.float32)
        batch = make_batch(torch, model.cfg, TRAIN_BATCH)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        single = one_step(torch, tally, model, batch, start)
        meshed = one_step(torch, tally, model, batch, start, mesh=mesh)
        check_launches([single["counts"]], need, "single-card float32 step")
        check_launches([meshed["counts"]], need, "DP float32 step")
        hold_step(torch, f"DP step over NCCL (world 1) vs the single-card step, float32 "
                  f"B={TRAIN_BATCH}", meshed, single)
        del model, batch, start, single, meshed
        torch.cuda.empty_cache()
        model = build_model(torch, MODEL, torch.bfloat16)
        batch = make_batch(torch, model.cfg, TRAIN_BATCH)
        run = train_steps(torch, tally, model, batch, DIST_STEPS, step_kw={"mesh": mesh})
        check_launches(run["counts"], with_wgrad(need), "DP bfloat16 step")
        losses = [m["loss"] for m in run["metrics"]]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"DP bfloat16 losses {losses}: not finite or not falling")
        rate = (DIST_STEPS - 1) * TRAIN_BATCH / run["time"]
        del model, batch, run
        torch.cuda.empty_cache()
        cli_secs = {}
        for name in DIST_CLI_RUNS:
            t0 = time.perf_counter()
            if cli_main(dist_cli_argv(logs, name)) != 0:
                fail(f"the CLI run {name} failed")
            cli_secs[name] = time.perf_counter() - t0
        with open(os.path.join(logs, "dp_child.json"), "w") as f:
            json.dump({"counts": tally.total, "bf16_rate": rate, "cli_secs": cli_secs}, f)
    finally:
        dist.destroy_process_group()
    return 0


DIST_CLI_RUNS = {"fsdp": ["--fsdp"], "ring": ["--contrastive-impl", "ring"]}  # phase 17 (a)


def dist_cli_argv(logs: str, name: str) -> list:
    """Two steps of the CLI, ViT-B/32 bf16 at B=256, with ``DIST_CLI_RUNS[name]``."""
    return ["--dataset-type", "synthetic", "--model", MODEL, "--batch-size", str(CLI_BATCH),
            "--train-num-samples", str(DIST_CLI_SAMPLES), "--epochs", "1", "--precision",
            "amp_bf16", "--seed", "0", "--warmup", "2", "--lr", "1e-3", "--log-every-n-steps",
            "1", "--logs", os.path.join(logs, name),
            "--no-save-on-preemption"] + DIST_CLI_RUNS[name]


def check_dist_cli(logs: str, name: str, secs: float, card: str):
    """One of phase 17 (a)'s CLI runs: finite losses, one experiment directory (the name
    rank 0 chose), the step-2 checkpoint."""
    root = os.path.join(logs, name)
    dirs = os.listdir(root)
    if len(dirs) != 1:
        fail(f"the CLI run {name} made {dirs}, not one experiment directory")
    losses = [r["loss"] for r in cli_records(root, dirs[0])]
    ckpt = os.path.join(root, dirs[0], "checkpoints", "2", "state.pt")
    print(f"  CLI {' '.join(DIST_CLI_RUNS[name])} (2 steps, bf16 B={CLI_BATCH}): experiment "
          f"{dirs[0]}, losses {[round(v, 6) for v in losses]}, checkpoint step 2 "
          f"{os.path.getsize(ckpt) / 2**20:.1f} MiB, {secs:.1f} s [{card}]", flush=True)
    if len(losses) != 2 or not np.isfinite(losses).all():
        fail(f"the CLI run {name}: losses {losses}")


def offload_runs(torch, tally, card, bf16_rate: float):
    """Phase 17 (b): ``offload_opt_state`` on ViT-B/32 at B=256. float32: three steps with the
    moments on the card and three with them offloaded, from the same start: the metrics at
    phase 6's limits, the parameters after them compared, the moments' device bytes between
    steps, and the drop in allocated and peak memory beside the moments' size. Then the
    offloaded step's bf16 samples/s beside phase 6's."""
    from multimodal_tpu_torch.train import (TrainState, make_optimizer, make_schedule,
                                            make_train_step)

    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    model = build_model(torch, MODEL, torch.float32)
    batch = make_batch(torch, model.cfg, TRAIN_BATCH)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for offload in (False, True):
        model.load_state_dict(start)
        opt = make_optimizer(model.named_parameters(),
                             make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
                             weight_decay=0.1, grad_clip_norm=1.0)
        step = make_train_step(model, opt, offload_opt_state=offload)
        state = TrainState.create(model, opt)
        generator = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, counts, between = [], [], []
        for _ in range(3):
            tally.start()
            m = step(state, batch, generator)
            torch.cuda.synchronize()
            counts.append(tally.stop())
            metrics.append({k: float(v) for k, v in m.items()})
            between.append(torch.cuda.memory_allocated())
        moments = [t for slot in (opt.mu, opt.nu) for t in slot.values()]
        runs[offload] = {
            "metrics": metrics, "counts": counts, "between": max(between),
            "peak": torch.cuda.max_memory_allocated(),
            "moment_bytes": sum(t.numel() * t.element_size() for t in moments),
            "device_moment_bytes": sum(t.numel() * t.element_size() for t in moments
                                       if t.is_cuda),
            "pinned": all(t.is_pinned() for t in moments if not t.is_cuda),
            # kept on the host: a copy on the card would sit in the next run's memory figures
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
        del opt, step, state, moments
        torch.cuda.empty_cache()
    dev, off = runs[False], runs[True]
    for r, what in ((dev, "moments on the card"), (off, "moments offloaded")):
        check_launches(r["counts"], need, f"float32 step, {what}")
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss_rel = max(rel(a["loss"], b["loss"]) for a, b in zip(off["metrics"], dev["metrics"]))
    norm_rel = max(rel(a["grad_norm"], b["grad_norm"])
                   for a, b in zip(off["metrics"], dev["metrics"]))
    param_rel = max(((off["params"][n] - p).abs().max() / p.abs().max().clamp(min=1e-30)).item()
                    for n, p in dev["params"].items())
    print(f"  float32 B={TRAIN_BATCH}, 3 steps: offloaded vs on the card: loss rel diff "
          f"{loss_rel:.3e} (need <= 1e-5), grad norm rel diff {norm_rel:.3e} (need <= 1e-4), "
          f"parameters after step 3 rel diff {param_rel:.3e} x max|leaf| (need <= 1e-3); "
          f"losses {[round(m['loss'], 7) for m in off['metrics']]}", flush=True)
    print(f"  moments {off['moment_bytes'] / 2**20:.1f} MiB, on the card between steps "
          f"{off['device_moment_bytes']} bytes (pinned host: {off['pinned']}); allocated "
          f"between steps {dev['between'] / 2**30:.3f} -> {off['between'] / 2**30:.3f} GiB "
          f"(drop {(dev['between'] - off['between']) / 2**20:.1f} MiB), max_memory_allocated "
          f"{dev['peak'] / 2**30:.3f} -> {off['peak'] / 2**30:.3f} GiB (drop "
          f"{(dev['peak'] - off['peak']) / 2**20:.1f} MiB) [{card}]", flush=True)
    if off["device_moment_bytes"] or not off["pinned"]:
        fail("offloaded moments on the card, or not pinned, between steps")
    if loss_rel > 1e-5 or norm_rel > 1e-4 or param_rel > 1e-3:
        fail("the offloaded step disagrees with the step whose moments stay on the card")
    del model, batch, start, runs, dev, off
    torch.cuda.empty_cache()
    model = build_model(torch, MODEL, torch.bfloat16)
    batch = make_batch(torch, model.cfg, TRAIN_BATCH)
    run = train_steps(torch, tally, model, batch, DIST_STEPS,
                      step_kw={"offload_opt_state": True})
    check_launches(run["counts"], with_wgrad(need), "offloaded bfloat16 step")
    losses = [m["loss"] for m in run["metrics"]]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"offloaded bfloat16 losses {losses}: not finite or not falling")
    rate = (DIST_STEPS - 1) * TRAIN_BATCH / run["time"]
    print(f"  {MODEL} bfloat16 B={TRAIN_BATCH} with the moments offloaded: {rate:.1f} "
          f"samples/s (steps 2-{DIST_STEPS}, host clock; phase 6 bfloat16 {bf16_rate:.1f}, "
          f"ratio {rate / bf16_rate:.3f}); peak memory {run['peak'] / 2**30:.2f} GiB [{card}]",
          flush=True)
    del model, batch, run
    torch.cuda.empty_cache()


def ring_schedule(torch, tally, card):
    """Phase 17 (c): the ring's schedule on the flash kernels over RING_BLOCKS blocks of a
    RING_SHAPE sequence, full and causal, float32 and bfloat16, against one flash call over the
    whole sequence: forward and q / k / v gradients at phase 3's limits (1e-4 and 2e-2 x
    max|whole|), exact launch counts, and ms of forward + backward beside the whole call."""
    from multimodal_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_tpu_torch.ops.ring_attention import ring_attention_blocks

    b, s, h, d = RING_SHAPE
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dtype).replace("torch.", "")
        for causal in (False, True):
            g = torch.Generator(device="cuda").manual_seed(s + causal)
            q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
                       .requires_grad_(True) for _ in range(3))
            ct = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)

            def ring():
                out = ring_attention_blocks(q, k, v, RING_BLOCKS, causal=causal)
                return (out, *torch.autograd.grad(out, (q, k, v), ct))

            def whole():
                out = flash_attention(q, k, v, causal=causal)
                return (out, *torch.autograd.grad(out, (q, k, v), ct))

            torch.cuda.synchronize()
            tally.start()
            got = ring()
            torch.cuda.synchronize()
            counts = tally.stop()
            visits = ring_visits(RING_BLOCKS, causal)
            check_launches([counts], {"flash_attention_fwd": visits, "flash_attention_dq": visits,
                                      "flash_attention_dkv": visits}, f"ring {name}")
            want = whole()
            errs = [((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
                    for a, w in zip(got, want)]
            ok = max(errs) <= limit and all(bool(torch.isfinite(a).all()) for a in got)
            del got, want
            ring_ms, whole_ms = cuda_ms(ring, iters=3, warmup=1), cuda_ms(whole, iters=3, warmup=1)
            print(f"  ring {RING_BLOCKS} blocks B={b} S={s} H={h} D={d} causal={causal} {name}: "
                  f"err/max|whole| out={errs[0]:.2e} dq={errs[1]:.2e} dk={errs[2]:.2e} "
                  f"dv={errs[3]:.2e} (tol {limit:g}) {'ok' if ok else 'MISMATCH'}; "
                  f"forward + backward {ring_ms:.3f} ms, one flash call {whole_ms:.3f} ms "
                  f"(ratio {ring_ms / whole_ms:.3f}); {visits} visits [{card}]", flush=True)
            if not ok:
                fail(f"the ring schedule breaks its limit ({name}, causal={causal})")
            del q, k, v, ct
            torch.cuda.empty_cache()


def phase_distributed(torch, tally, card, bf16_rate: float):
    """Phase 17: the distributed layer on one card (world size 1 over NCCL), the moments'
    offload, and the ring's schedule on the flash kernels."""
    t_phase = time.perf_counter()
    logs = os.path.abspath(DIST_LOGS)
    shutil.rmtree(logs, ignore_errors=True)
    os.makedirs(logs)
    try:
        print(f"  (a) the DP step over NCCL at world size 1 in a torchrun child: {MODEL} "
              f"B={TRAIN_BATCH}", flush=True)
        t0 = time.perf_counter()
        proc = torchrun([os.path.abspath(__file__), "--dp-child", logs])
        for line in proc.stdout.splitlines():
            if line.startswith("  "):
                print(line, flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
            fail(f"the DP child exited {proc.returncode}")
        with open(os.path.join(logs, "dp_child.json")) as f:
            child = json.load(f)
        for k, n in child["counts"].items():
            tally.total[k] += n
        print(f"  DP bfloat16 B={TRAIN_BATCH} over NCCL (world 1): {child['bf16_rate']:.1f} "
              f"samples/s (steps 2-{DIST_STEPS}, host clock), phase 6 bfloat16 {bf16_rate:.1f} "
              f"(ratio {child['bf16_rate'] / bf16_rate:.3f}); the child "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        for name, secs in child["cli_secs"].items():
            check_dist_cli(logs, name, secs, card)
        print(f"  (b) --opt-state-offload: {MODEL} B={TRAIN_BATCH}", flush=True)
        offload_runs(torch, tally, card, bf16_rate)
        print(f"  (c) the ring's schedule on the flash kernels: {RING_BLOCKS} blocks of B, S, "
              f"H, D = {RING_SHAPE}", flush=True)
        ring_schedule(torch, tally, card)
    finally:
        shutil.rmtree(logs, ignore_errors=True)
    print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


def block_need(name: str) -> tuple[dict, dict, dict]:
    """The block launches of the shipped config ``name``: (one train step, one encode of the
    image tower, one of the text tower). Each tower runs every layer through the LN-fold pair
    where its S (patches + 1, or the context length) is above ``LN_FOLD_MIN_SEQ``, else
    through the non-LN pair; a step runs each layer forward and backward."""
    from multimodal_tpu_torch.models import get_model_config
    from multimodal_tpu_torch.ops.block_attention import LN_FOLD_MIN_SEQ

    cfg = get_model_config(name)
    towers = (((cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1, cfg.vision.layers),
              (cfg.text.context_length, cfg.text.layers))
    encodes = [{f"block_attention{'_ln' if seq > LN_FOLD_MIN_SEQ else ''}_fwd": layers}
               for seq, layers in towers]
    step = {}
    for enc in encodes:
        for k, v in enc.items():
            for key in (k, k.replace("_fwd", "_bwd")):
                step[key] = step.get(key, 0) + v
    return step, encodes[0], encodes[1]


def int8_need(name: str) -> dict:
    """A train step's launches with ``int8_forward=True``: the blocks', and for each of the
    two dense layers of every block's MLP four quantizes and two products."""
    step = block_need(name)[0]
    layers = sum(v for k, v in step.items() if k.endswith("_fwd"))
    return {**step, "quantize_rows": 2 * 4 * layers, "int8_gemm": 2 * 2 * layers}


def one_step_fits(torch, tally, model, n: int, **step_kw) -> tuple[bool, str]:
    """One bfloat16 step of ``model`` (a fresh optimizer, nothing counted) at batch ``n``:
    whether it ran, and its peak memory or the out-of-memory error."""
    for p in model.parameters():
        p.grad = None
    try:
        run = train_steps(torch, tally, model, make_batch(torch, model.cfg, n), 1, count=False,
                          **step_kw)
        return True, f"peak memory {run['peak'] / 2**30:.2f} GiB"
    except torch.cuda.OutOfMemoryError as e:
        return False, f"out of memory ({str(e).splitlines()[0][:120]})"
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def bf16_largest_run(torch, tally, card, name: str, batch: int, need: dict, stats: dict,
                     prove=True, after=None, **run_kw) -> int:
    """``kernel_path_run`` in bfloat16 for ``TRAIN_STEPS`` steps, finite and falling, at
    ``batch``; then (``prove``) one step of the same model at the next larger of
    ``LARGE_CANDIDATES``, which must run out of memory for ``batch`` to be the largest that
    fits: where it runs, the whole run again at that batch. Where the run itself runs out of
    memory (its launches not counted), the next smaller candidate. ``after(model, batch)`` as
    in ``kernel_path_run``. Returns the batch that ran."""
    too_big = max(LARGE_CANDIDATES) + 1
    while True:
        larger = [b for b in LARGE_CANDIDATES if batch < b < too_big]
        verdict = {}

        def check(model, data):
            if after is not None:
                after(model, data)
            if prove and larger:
                fits, what = one_step_fits(torch, tally, model, larger[0],
                                           state_dtype=run_kw.get("state_dtype"))
                verdict["fits"] = fits
                print(f"  {name} bfloat16 one step at the next candidate, B={larger[0]}: {what}"
                      f"{'' if fits else f'; B={batch} is the largest that fits'} [{card}]",
                      flush=True)

        try:
            kernel_path_run(torch, tally, card, name, torch.bfloat16, batch, TRAIN_STEPS, need,
                            falling=True, stats=stats, after=check, **run_kw)
        except torch.cuda.OutOfMemoryError as e:
            err = str(e).splitlines()[0][:160]
            gc.collect()
            torch.cuda.empty_cache()
            smaller = [b for b in LARGE_CANDIDATES if b < batch]
            print(f"  {name} bfloat16 at B={batch}: out of memory ({err}); next "
                  f"B={smaller[-1] if smaller else None}", flush=True)
            if not smaller:
                fail(f"{name}: no bfloat16 batch of {LARGE_CANDIDATES} runs")
            too_big, batch = batch, smaller[-1]
            continue
        if not verdict.get("fits"):
            return batch
        batch = larger[0]


def large_vit(torch, mods, tally, card, kind, name: str, after_compare=None) -> dict:
    """Phase 18 (a) and (b) for one large ViT: served as in phases 4-5 at its bucket; trained
    in float32, kernel path against plain path at its comparison batch with phase 6's limits
    and exact launches (``after_compare(res)`` runs on its result, the kernel path's metrics
    and step 1's gradients in it); then bfloat16 for 6 steps at the largest batch the kernel
    path holds (``bf16_largest_run``; with the model's moments dtype), finite and falling,
    and, where the moments are bfloat16, one more step of the same model and batch with
    float32 moments for its peak memory (or the out-of-memory error). Returns the bfloat16
    run's stats."""
    t0 = time.perf_counter()
    spec = LARGE_VITS[name]
    need, need_image, need_text = block_need(name)
    print(f"  (a) {name} served, float32 at bucket {spec['bucket']}", flush=True)
    model = build_model(torch, name, torch.float32)  # served, then trained in (b)
    phase_serving(torch, mods, tally, card, kind, name, need_text=need_text,
                  need_image=need_image, bucket=spec["bucket"], model=model)
    print(f"  (b) {name} trained: float32 kernel vs plain path at B={spec['compare']} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    res = compare_paths(torch, mods, tally, card, name, spec["compare"], TRAIN_STEPS, need,
                        model=model, keep_grads=after_compare is not None)
    del model
    del res["model"]
    torch.cuda.empty_cache()
    if after_compare is not None:
        after_compare(res)
    float32_rate = res["rate"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    moments = getattr(torch, spec["moments"])
    print(f"  (b) {name} bfloat16 ({spec['moments']} moments) at the largest batch that fits, "
          f"from B={spec['train']} [{time.perf_counter() - t0:.1f} s]", flush=True)
    stats = {}

    def float32_moments(model, data):
        n = data["image"].shape[0]
        what = one_step_fits(torch, tally, model, n)[1]
        print(f"  {name} bfloat16 one step with float32 moments at B={n}: {what} (bfloat16 "
              f"moments: peak memory {stats['peak'] / 2**30:.2f} GiB) [{card}]", flush=True)

    batch = bf16_largest_run(torch, tally, card, name, spec["train"], need, stats,
                             state_dtype=moments,
                             after=float32_moments if moments != torch.float32 else None)
    if batch != spec["train"]:
        print(f"  {name}: bfloat16 at B={batch}, phase 3 timed its block shapes at "
              f"B={spec['train']}", flush=True)
    torch.cuda.empty_cache()
    return dict(stats, batch=batch, float32_rate=float32_rate)


def int8_compare(torch, mods, tally, card, reference: dict):
    """Phase 18 (c), float32: ViT-L/14 with ``int8_forward=True``, the int8 kernel path against
    the plain path at phase 12's limits (the codes' flips counted, the limits widened by each
    quantity's int8-vs-float distance from the same start; the float run is ``reference``,
    (b)'s float32 kernel path at the same batch and start)."""
    name = "ViT-L-14"
    print(f"  (c) {name} with int8_forward=True, float32 kernel vs plain path at "
          f"B={LARGE_VITS[name]['compare']}", flush=True)
    need = int8_need(name)
    code_flips = CodeFlips(mods["q"], per_step=need["quantize_rows"])
    del compare_paths(torch, mods, tally, card, name, LARGE_VITS[name]["compare"], TRAIN_STEPS,
                      need, model_kw=INT8, code_flips=code_flips,
                      int8_reference=reference)["model"]
    torch.cuda.empty_cache()


def int8_bf16(torch, tally, card, bf16: dict):
    """Phase 18 (c), bfloat16: ViT-L/14 with ``int8_forward=True`` for 6 steps, finite and
    falling, at (b)'s bfloat16 batch (or the next smaller that fits), its rate beside (b)'s."""
    name = "ViT-L-14"
    print(f"  (c) {name} with int8_forward=True, bfloat16", flush=True)
    stats = {}
    batch = bf16_largest_run(torch, tally, card, name, bf16["batch"], int8_need(name), stats,
                             prove=False, model_kw=INT8)
    print(f"  {name} bfloat16 int8 at B={batch} vs (b)'s bfloat16 at B={bf16['batch']}: "
          f"{stats['rate']:.1f} vs {bf16['rate']:.1f} samples/s "
          f"({stats['rate'] / bf16['rate']:.3f}x; information) [{card}]", flush=True)


def other_config(torch, mods, tally, card, name: str):
    """Phase 18 (d) for one shipped config at full width and depth: two float32 steps, kernel
    path against plain path at phase 6's limits with exact launches; one encode of each tower
    through ``Embedder`` (the serving encoder) with its launches, at cosine >= 0.9999 to the
    plain-version encode; one bfloat16 step, finite."""
    from multimodal_tpu_torch.data.tokenizer import tokenize
    from multimodal_tpu_torch.inference import Embedder

    need, need_image, need_text = block_need(name)
    res = compare_paths(torch, mods, tally, card, name, OTHER_BATCH, 2, need)
    model = res.pop("model")
    size, ctx = model.cfg.vision.image_size, model.cfg.text.context_length
    images = np.random.default_rng(0).integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    tokens = tokenize(CAPTIONS, ctx)
    emb = Embedder(model, batch_size=len(images))
    tally.start()
    img = emb.encode_images(images)
    counts_image = tally.stop()
    tally.start()
    txt = emb.encode_tokens(tokens)
    counts_text = tally.stop()
    with plain_attention(mods):
        p_img, p_txt = emb.encode_images(images), emb.encode_tokens(tokens)
    cos = min(float(np.sum(p_img * img, -1).min()), float(np.sum(p_txt * txt, -1).min()))
    print(f"  {name} encode: launches image {({k: counts_image[k] for k in need_image})} text "
          f"{({k: counts_text[k] for k in need_text})} (need {need_image}, {need_text}); min "
          f"cosine to the plain-version encode {cos:.7f} (need >= 0.9999)", flush=True)
    if any(counts_image[k] != v for k, v in need_image.items()) or any(
            counts_text[k] != v for k, v in need_text.items()):
        fail(f"{name}: the encode did not run its kernel in every block")
    if not cos >= 0.9999:
        fail(f"{name}: the encode disagrees with the plain-version encode")
    del model, emb, res
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, name, torch.bfloat16, OTHER_BATCH, 1, need)


def phase_large_vits(torch, mods, tally, card, kind):
    """Phase 18: ViT-L/14, ViT-H/14 and ViT-g/14 at full width and depth, served and trained,
    ViT-L/14 with int8 beside its float runs ((c)'s float32 comparison after (b)'s, whose
    kernel path it is widened by; its bfloat16 run after (b)'s); the other four shipped
    configs built, encoded and stepped."""
    t_phase = time.perf_counter()
    bf16 = {}
    for name in LARGE_VITS:
        t0 = time.perf_counter()
        after = None
        if name == "ViT-L-14":
            after = lambda res: int8_compare(torch, mods, tally, card, res)  # noqa: E731
        bf16[name] = large_vit(torch, mods, tally, card, kind, name, after_compare=after)
        if name == "ViT-L-14":
            int8_bf16(torch, tally, card, bf16[name])
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in OTHER_CONFIGS:
        t0 = time.perf_counter()
        print(f"  (d) {name} at full width and depth, B={OTHER_BATCH}", flush=True)
        other_config(torch, mods, tally, card, name)
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, st in bf16.items():
        print(f"  {name}: float32 {st['float32_rate']:.1f} samples/s at "
              f"B={LARGE_VITS[name]['compare']}, bfloat16 {st['rate']:.1f} at B={st['batch']} "
              f"({LARGE_VITS[name]['moments']} moments), peak {st['peak'] / 2**30:.2f} GiB "
              f"[{card}]", flush=True)
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()

    def header(text: str, flush: bool = True):
        """A phase's first line, with the seconds since the script started."""
        print(f"{text} [{time.perf_counter() - t_start:.1f} s into the script]", flush=flush)

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

    from multimodal_tpu_torch.models import layers
    from multimodal_tpu_torch.ops import _build, attention, launches
    from multimodal_tpu_torch.ops import block_attention as ba
    from multimodal_tpu_torch.ops import block_mlp as bm
    from multimodal_tpu_torch.ops import flash_attention as fl
    from multimodal_tpu_torch.ops import fused_attention as fa
    from multimodal_tpu_torch.ops import quant as q
    from multimodal_tpu_torch.ops import resample  # noqa: F401 - registers its launch count

    mods = {"ba": ba, "fa": fa, "bm": bm, "fl": fl, "q": q, "layers": layers,
            "attention": attention}
    tally = Tally(launches)

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> {lib_path}", flush=True)
    for ln in ptxas_report(log):
        print(f"  ptxas {ln}")
    for ln in pass_smem_report():
        print(f"  smem {ln}")
    sass = read_sass(lib_path)
    if sass is None:
        print("  sass: cuobjdump not found beside nvcc, SASS not read", flush=True)
    else:
        print(f"  sass {sass_report(sass)}")
        for ln in hmma_report(sass):
            print(f"  sass {ln}", flush=True)
        faults = gemm_hmma_faults(sass)
        if faults:
            fail(f"GEMM instantiations off their tensor-core form: {faults}")
        faults = flash_wgmma_faults(sass)
        if faults:
            fail(f"bfloat16 flash instantiations off wgmma: {faults}")
        faults = fused_wgmma_faults(sass)
        if faults:
            fail(f"fused attention instantiations off their tensor-core form: {faults}")
        faults = mlp_wgmma_faults(sass)
        if faults:
            fail(f"bfloat16 fused-MLP GEMM instantiations off wgmma: {faults}")
        faults = block_wgmma_faults(sass)
        if faults:
            fail(f"bfloat16 block-attention instantiations off wgmma: {faults}")
        gmma = int8_gmma_counts(sass)
        print(f"  sass int8_gemm_kernel wgmma (GMMA) instructions by instantiation: {gmma}",
              flush=True)
        if not gmma or min(gmma.values()) == 0:
            fail(f"int8 GEMM instantiations without wgmma: {gmma}")

    header("phase 3 kernel vs plain on the card", flush=True)
    kernels = phase_kernels(torch, ba, fa, bm, fl)
    qkv_repeats(torch, ba)
    err = flash_long_error(torch, fl)
    kernels["worst_f32"]["flash_attention_fwd"] = max(kernels["worst_f32"]["flash_attention_fwd"],
                                                      err)
    flash_crossover(torch, attention.attention, card)
    int8_kernels = phase_quant_kernels(torch, q)
    for part in ("worst_f32", "timing"):
        kernels[part].update(int8_kernels[part])

    header("phase 4 serving, phase 5 throughput", flush=True)
    serving_rates = phase_serving(torch, mods, tally, card, kind, MODEL,
                                  need_text={"block_attention_fwd": 12},
                                  need_image={"block_attention_fwd": 12})

    header("phase 6 training", flush=True)
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need)
    full_opt_bytes, float_rate = res["opt_bytes"], res["rate"]
    del res
    torch.cuda.empty_cache()
    bf16_stats = {}
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS, need,
                    falling=True, stats=bf16_stats)

    header(f"phase 7 shared trunk: {SHARED_MODEL} at full width", flush=True)
    phase_serving(torch, mods, tally, card, kind, SHARED_MODEL,
                  need_text={"block_attention_fwd": 12},
                  need_image={"block_attention_ln_fwd": 12})
    need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
            "block_attention_fwd": 12, "block_attention_bwd": 12}
    res = compare_paths(torch, mods, tally, card, SHARED_MODEL, SHARED_COMPARE_BATCH,
                        TRAIN_STEPS, need)
    del res["model"]
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, res["peak"], res["params"], SHARED_COMPARE_BATCH)
    if rate_batch != SHARED_COMPARE_BATCH:
        kernel_path_run(torch, tally, card, SHARED_MODEL, torch.float32, rate_batch,
                        TRAIN_STEPS, need)
    kernel_path_run(torch, tally, card, SHARED_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True)

    # the same model with head scales: the vision pass (S=197) goes through attention() to
    # the fused pair; the text pass (S=77) is below the fused window and runs the plain path
    register_variant(SCALE_HEADS_MODEL, SHARED_MODEL, vision={"scale_heads": True})
    print(f"  {SCALE_HEADS_MODEL}: {SHARED_MODEL} with vision.scale_heads", flush=True)
    need = {"fused_attention_fwd": 12, "fused_attention_bwd": 12}
    compare_paths(torch, mods, tally, card, SCALE_HEADS_MODEL, SHARED_COMPARE_BATCH,
                  TRAIN_STEPS, need)
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, SCALE_HEADS_MODEL, torch.bfloat16, SHARED_COMPARE_BATCH,
                    TRAIN_STEPS, need, falling=True)

    header(f"phase 8 fused MLP branch: {SHARED_MODEL} at full width with block_mlp=True",
          flush=True)
    attn_need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
                 "block_attention_fwd": 12, "block_attention_bwd": 12}
    phase_serving(torch, mods, tally, card, kind, SHARED_MODEL,
                  need_text={"block_attention_fwd": 12, "block_mlp_fwd": 12},
                  need_image={"block_attention_ln_fwd": 12, "block_mlp_fwd": 12},
                  block_mlp=True)
    need = {**attn_need, "block_mlp_fwd": 24, "block_mlp_bwd": 24}
    res = compare_paths(torch, mods, tally, card, SHARED_MODEL, SHARED_COMPARE_BATCH,
                        TRAIN_STEPS, need, block_mlp=True)
    del res["model"]
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, res["peak"], res["params"], SHARED_COMPARE_BATCH)
    metrics = kernel_path_run(torch, tally, card, SHARED_MODEL, torch.float32, rate_batch,
                              TRAIN_STEPS, need, block_mlp=True)
    kernel_path_run(torch, tally, card, SHARED_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True, block_mlp=True)
    # per-block remat: every forward kernel runs again inside the backward, and nothing else
    # changes, so the losses repeat those of the run above
    register_variant(REMAT_MODEL, SHARED_MODEL, remat=True)
    print(f"  {REMAT_MODEL}: {SHARED_MODEL} with remat", flush=True)
    remat_need = {k: v * (2 if k.endswith("fwd") else 1) for k, v in need.items()}
    remat_metrics = kernel_path_run(torch, tally, card, REMAT_MODEL, torch.float32,
                                    rate_batch, TRAIN_STEPS, remat_need, block_mlp=True)
    remat_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(remat_metrics[:2], metrics[:2]))
    print(f"  remat vs no remat at B={rate_batch}: loss rel diff over the first 2 steps "
          f"{remat_rel:.3e} (need <= 1e-6); launches per step {remat_need}", flush=True)
    if remat_rel > 1e-6:
        fail("the remat run's losses differ from the run without remat")

    register_variant(LONG_MODEL, MODEL, text={"context_length": LONG_CONTEXT})
    header(f"phase 9 long context: {LONG_MODEL} ({MODEL}, text context_length {LONG_CONTEXT}) "
          f"at full width", flush=True)
    flash_need = {"flash_attention_fwd": 12, "flash_attention_dq": 12, "flash_attention_dkv": 12}
    phase_serving(torch, mods, tally, card, kind, LONG_MODEL,
                  need_text={"flash_attention_fwd": 12}, need_image={"block_attention_fwd": 12},
                  bucket=LONG_BUCKET)
    need = {"block_attention_fwd": 12, "block_attention_bwd": 12, **flash_need}
    res = compare_paths(torch, mods, tally, card, LONG_MODEL, LONG_COMPARE_BATCH, TRAIN_STEPS,
                        need)
    del res["model"]
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, res["peak"], res["params"], LONG_COMPARE_BATCH,
                               candidates=(8, 16, 32))
    if rate_batch != LONG_COMPARE_BATCH:
        kernel_path_run(torch, tally, card, LONG_MODEL, torch.float32, rate_batch, TRAIN_STEPS,
                        need)
    kernel_path_run(torch, tally, card, LONG_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True)
    # cosine attention keeps the vision blocks on the plain attention path and the pooler's
    # cross-attention (256 queries over 50 tokens) is plain too: only the text tower's block
    # kernels launch
    register_variant(OPTIONS_MODEL, MODEL, vision={"scaled_cosine": True,
                                                   "attentional_pool": True})
    print(f"  {OPTIONS_MODEL}: {MODEL} with vision.scaled_cosine and vision.attentional_pool",
          flush=True)
    kernel_path_run(torch, tally, card, OPTIONS_MODEL, torch.float32, 64, TRAIN_STEPS,
                    {"block_attention_fwd": 12, "block_attention_bwd": 12}, falling=True)

    header(f"phase 10 variational CLIP: {MODEL} at full width and depth, a concentration token "
          "on each tower (vision S=51, text S=78 causal)", flush=True)
    phase_vclip_encode(torch, mods, tally, card, TRAIN_BATCH)
    phase_vclip_train(torch, mods, tally, card)

    header(f"phase 11 the rest of the model family: {MODEL} at full width and depth", flush=True)
    print(f"  LoRA fine-tune (r={LORA['lora_rank']}, alpha {LORA['lora_alpha']:g}) of a loaded "
          "base", flush=True)
    phase_lora(torch, mods, tally, card, full_opt_bytes)
    print(f"  {MOE_MODEL}: {MODEL} with vision {MOE_VISION}", flush=True)
    phase_moe(torch, mods, tally, card)
    print(f"  SigLIP: {MODEL} with siglip=True, loss_type siglip", flush=True)
    phase_siglip(torch, mods, tally, card)
    print(f"  {MODEL} with force_image_size={HIRES['force_image_size']}: vision S=145 through "
          "the LN-fold kernels", flush=True)
    phase_hires(torch, mods, tally, card)

    header(f"phase 12 int8: {MODEL} at full width and depth with int8_forward=True, and the W8A8 "
          "encoders", flush=True)
    phase_int8(torch, mods, tally, card, kind, float_rate)

    header(f"phase 13 the training CLI: {MODEL} at full width and depth", flush=True)
    cli_rate = phase_cli(torch, tally, card, bf16_stats["rate"])

    header(f"phase 14 real data: JPEG shards through the readers and the card's decode, {MODEL} "
          "trained and served", flush=True)
    data = phase_data(torch, tally, card, kind, bf16_stats["rate"], cli_rate)
    kernels["worst_f32"]["resample"] = data["worst"]
    kernels["timing"][("resample", "resample-B256-train224", "float32")] = data["timing"]

    header(f"phase 15 train, evaluate and serve: {MODEL} at full width and depth through the "
          "CLI's evaluations and a served checkpoint", flush=True)
    cpu_bench = LossBenchCpu()  # phase 16 (f)'s CPU side, beside phases 15 and 16
    phase_eval(torch, mods, tally, card, serving_rates["image"])

    header("phase 16 captioning, the research toolkit and the profiler", flush=True)
    phase_captioning(torch, mods, tally, card, cpu_bench)

    header("phase 17 the distributed layer on one card: DP over NCCL, the CLI's mesh flags, "
          "optimizer-state offload, the ring's schedule", flush=True)
    phase_distributed(torch, tally, card, bf16_stats["rate"])

    header("phase 18 the large-ViT family at full width and depth (ViT-L/14, ViT-H/14, "
           "ViT-g/14) and the other shipped configs", flush=True)
    phase_large_vits(torch, mods, tally, card, kind)

    entries = []
    for name, (source, replaces, case) in KERNELS.items():
        if tally.total[name] == 0:
            fail(f"the main path never launched {name}")
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": tally.total[name],
                        "max_abs_err": kernels["worst_f32"][name],
                        **kernels["timing"][(name, case, KERNEL_DTYPES.get(name, "float32"))]})
    header("done")
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-child"]:  # phase 17 (a), started by the script itself
        sys.exit(dp_child(sys.argv[2]))
    if sys.argv[1:2] == ["--bench-child"]:  # phase 16 (f)'s CPU side, started at phase 15
        sys.exit(loss_bench_cpu(sys.argv[2]))
    sys.exit(main())
