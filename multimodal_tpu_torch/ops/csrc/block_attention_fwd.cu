// Whole-block attention forward for short sequences (S <= 320), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel multimodal_tpu/ops/block_attention.py:_fwd_kernel in both
// its forms: the non-LN form (reached through _block_attention) and the LN-fold form with
// the in-kernel residual (reached through _block_attention_ln at S > 128). For x [B,S,W]
// and the four [W,W] weights in the JAX [in,out] layout it computes
//
//   xn    = LN(x)                       LN-fold form only (else xn = x): f32 statistics,
//                                       compute-dtype arithmetic rounding after every
//                                       operation; never written to device memory
//   q,k,v = xn @ Wq|Wk|Wv + b           f32 accumulation, bias added in f32, rounded to T
//   p     = softmax(q_h k_h^T / sqrt(D)) per head, f32, finite -1e30 causal mask (col <= row),
//           row max subtracted, then rounded to T
//   attn  = p @ v_h                     f32 accumulation, rounded to T
//   y     = attn @ Wo + bo              as the projections; with the residual, y is rounded
//                                       to T first and y + x rounds again
//
// in three launches: one tiled GEMM for q, k and v (gridDim.z = 3), one attention kernel
// per (query tile, head, image), one tiled GEMM for the output projection. The LN-fold form
// adds a small row-statistics launch in front (two f32 numbers per row); the q/k/v GEMM then
// normalizes each element of its A tile as it loads it, and the output GEMM's epilogue adds
// the raw x, so neither LN(x) nor a separate add pass touches device memory. The projection
// products are float FMAs on the CUDA cores (for bf16 the operands are widened to float in
// shared memory), so float32 is true float32 with no TF32 anywhere; the attention core
// (attention_passes.cuh) runs bfloat16 on the tensor cores and float32 on register tiles.
//
// What bounds it on the card: the four [B*S,W]x[W,W] projections carry ~97% of the FLOPs at
// ViT-B/32 shapes (S=50, W=768), so the kernel is compute-bound on the GEMMs. The design
// keeps them on a 128x128 output tile per block with an 8x8 register micro-tile per thread
// (16 FMAs per shared-memory load), which is the standard way to reach a useful share of
// the float32 FMA rate without tensor cores. The attention core owns a 64-row query tile per
// block and walks the keys in tiles with an online softmax, so no [B,H,S,S] tensor ever
// reaches device memory and no [rows, S] logits buffer sits in shared memory. The TPU
// kernel's image grouping (_images_per_program) is VMEM plumbing and has no counterpart here.
// Tensor-core GEMMs and a single fused launch are later work.

#include "attention_passes.cuh"

namespace {

// The three stages after the optional statistics launch. ln != nullptr selects the LN-fold
// form: `ln` carries the row statistics, gamma and beta for the q/k/v GEMM's A-tile load, and
// `residual` (the raw x, or null) rides the output projection's epilogue.
template <typename T>
cudaError_t launch(const void* x, const GemmOperands* ln, const void* residual,
                   const void* const* wts, const void* const* biases, void* qkv, void* attn,
                   void* y, int b, int s, int w, int heads, int causal, cudaStream_t stream) {
  const int m = b * s, d = w / heads;
  const size_t plane = (size_t)m * w;
  const dim3 gemm_grid(w / kBN, (m + kBM - 1) / kBM, 3);

  GemmOperands qkv_ops = qkv_operands<T>(wts, biases, qkv, plane);
  if (ln != nullptr) {
    qkv_ops.ln_mean = ln->ln_mean;
    qkv_ops.ln_inv = ln->ln_inv;
    qkv_ops.ln_gamma = ln->ln_gamma;
    qkv_ops.ln_beta = ln->ln_beta;
    gemm_bias_kernel<T, true><<<gemm_grid, kGemmThreads, 0, stream>>>(
        static_cast<const T*>(x), qkv_ops, m, w, w);
  } else {
    gemm_bias_kernel<T, false><<<gemm_grid, kGemmThreads, 0, stream>>>(
        static_cast<const T*>(x), qkv_ops, m, w, w);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = (float)std::pow((double)d, -0.5);  // as the reference's d ** -0.5
  const T* qp = static_cast<const T*>(qkv);
  err = launch_attention_core<T>(qp, qp + plane, qp + 2 * plane, static_cast<T*>(attn), b, s,
                                 w, heads, d, scale, causal, stream);
  if (err != cudaSuccess) return err;

  GemmOperands out_ops = {};
  out_ops.b[0] = wts[3];
  out_ops.bias[0] = biases[3];
  out_ops.c[0] = y;
  out_ops.residual = residual;
  gemm_bias_kernel<T, false><<<dim3(w / kBN, (m + kBM - 1) / kBM, 1), kGemmThreads, 0, stream>>>(
      static_cast<const T*>(attn), out_ops, m, w, w);
  return cudaGetLastError();
}

// LN-fold form: one statistics launch (mean and rsqrt(var + eps) per row, f32), then the
// three stages with the normalization folded into the q/k/v GEMM's loads.
template <typename T>
cudaError_t launch_ln(const void* x, const void* gamma, const void* beta,
                      const void* const* wts, const void* const* biases, float* ln_stats,
                      void* qkv, void* attn, void* y, int b, int s, int w, int heads, int causal,
                      int residual, float eps, cudaStream_t stream) {
  const int m = b * s;
  cudaError_t err =
      launch_ln_stats<T>(static_cast<const T*>(x), ln_stats, ln_stats + m, m, w, eps, stream);
  if (err != cudaSuccess) return err;
  GemmOperands ln = {};
  ln.ln_mean = ln_stats;
  ln.ln_inv = ln_stats + m;
  ln.ln_gamma = gamma;
  ln.ln_beta = beta;
  return launch<T>(x, &ln, residual ? x : nullptr, wts, biases, qkv, attn, y, b, s, w, heads,
                   causal, stream);
}

bool shape_ok(int b, int s, int w, int heads) {
  if (b < 1 || s < 1 || s > kMaxSeq || heads < 1 || w % 128 != 0 || w % heads != 0) return false;
  const int d = w / heads;
  return d <= kMaxHeadDim && d % 8 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. wts = {Wq, Wk, Wv, Wo} [W,W] ([in,out]); biases [W].
// qkv: scratch [3, B*S, W]; attn: scratch [B*S, W]; y: output [B, S, W]. All contiguous on
// one device; launches on `stream` without synchronising. Returns a cudaError_t.
int mmt_block_attention_fwd(int dtype, const void* x, const void* wq, const void* bq,
                            const void* wk, const void* bk, const void* wv, const void* bv,
                            const void* wo, const void* bo, void* qkv, void* attn, void* y,
                            int b, int s, int w, int heads, int causal, void* stream) {
  if (!shape_ok(b, s, w, heads)) return (int)cudaErrorInvalidValue;
  const void* wts[4] = {wq, wk, wv, wo};
  const void* biases[4] = {bq, bk, bv, bo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, nullptr, nullptr, wts, biases, qkv, attn, y, b, s, w, heads,
                              causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, nullptr, nullptr, wts, biases, qkv, attn, y, b, s, w,
                                      heads, causal, st);
  return (int)cudaErrorInvalidValue;
}

// The LN-fold form: x is the pre-LN residual stream, gamma and beta [W] (of the compute
// dtype) the LayerNorm's scale and bias; y = attn(LN(x)), plus x when residual != 0.
// ln_stats: float32 scratch [2, B*S]. Otherwise as mmt_block_attention_fwd.
int mmt_block_attention_ln_fwd(int dtype, const void* x, const void* gamma, const void* beta,
                               const void* wq, const void* bq, const void* wk, const void* bk,
                               const void* wv, const void* bv, const void* wo, const void* bo,
                               void* ln_stats, void* qkv, void* attn, void* y, int b, int s,
                               int w, int heads, int causal, int residual, float eps,
                               void* stream) {
  if (!shape_ok(b, s, w, heads)) return (int)cudaErrorInvalidValue;
  const void* wts[4] = {wq, wk, wv, wo};
  const void* biases[4] = {bq, bk, bv, bo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(ln_stats);
  if (dtype == 0)
    return (int)launch_ln<float>(x, gamma, beta, wts, biases, stats, qkv, attn, y, b, s, w,
                                 heads, causal, residual, eps, st);
  if (dtype == 1)
    return (int)launch_ln<__nv_bfloat16>(x, gamma, beta, wts, biases, stats, qkv, attn, y, b, s,
                                         w, heads, causal, residual, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* mmt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
