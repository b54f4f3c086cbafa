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
// in three launches: the q/k/v projections (three weight sets, one launch), the attention core,
// the output projection. The LN-fold form adds a small row-statistics launch in front (two f32
// numbers per row); the q/k/v GEMM then normalizes the A tiles it lands in shared memory (its LN
// load transform), and the output GEMM's store adds the raw x (its residual store: bias, one
// rounding to T, + x, a second rounding), so neither LN(x) nor a separate add pass touches
// device memory.
//
//   * bfloat16: the GEMMs are wgmma_gemm.cuh's wgmma GEMM fed by TMA in its block-attention
//     instantiations (three operand sets: the tensor maps of x and Wq, Wk, Wv in one launch,
//     set z owning its own tiles of C); the attention core is fused_attention.cu's wgmma forward
//     (fused_fwd_kernel, the same function: both round the normalised p before p v) on the
//     q/k/v planes at S >= 128 and D in {32, 64, 128}, where its 128-row passes fill, and
//     attention_passes.cuh's mma.sync core below S = 128 (its 64-row tiles pad less there) and
//     at other head dims;
//   * float32: mma_gemm.cuh's 3xTF32 GEMM (about 2^-20 relative a product, within the 1e-4 x
//     max|plain| limit of the on-card check) and the register-tile core.
// The backward's recompute of q, k and v runs the same GEMM mainloop over the same A values (x,
// or ln_out, which the backward writes with the LN load's own function), so it repeats these q,
// k and v bit for bit (chip_smoke.py phase 3 checks it).
//
// What bounds it on the card: the four [B*S,W]x[W,W] projections carry ~97% of the FLOPs at
// ViT-B/32 shapes (S=50, W=768), so the kernel is bound by operations, on the tensor cores;
// bfloat16 runs them on wgmma at 450-500 TFLOP/s (PERF.md). No [B,H,S,S] tensor reaches device
// memory. The TPU kernel's image grouping (_images_per_program) is VMEM plumbing and has no
// counterpart here.

#include "attention_passes.cuh"
#include "wgmma_gemm.cuh"

// fused_attention.cu's wgmma attention core (the fused forward on q, k, v with a row stride)
extern "C" int mmt_block_attention_core_wgmma(const void* q, const void* k, const void* v,
                                              void* out, int b, int s, int heads, int d, int ld,
                                              int causal, float scale, void* stream);

namespace {

// whether the bfloat16 attention core runs the wgmma kernel (else attention_mma_kernel): head
// dims of its tiles, and S >= 128, where a 128-row pass fills; the mma.sync core's 64-row tiles
// pad less below it
bool core_on_wgmma(int s, int d) { return s >= 128 && (d == 32 || d == 64 || d == 128); }

// The three stages after the optional statistics launch. ln_stats != nullptr selects the
// LN-fold form: the row statistics ([2, B*S]: mean, inv), gamma and beta feed the q/k/v GEMM's
// load transform, and `residual` (the raw x, or null) rides the output projection's store.
template <typename T>
cudaError_t launch(const void* x, const float* ln_stats, const void* gamma, const void* beta,
                   const void* residual, const void* const* wts, const void* const* biases,
                   void* qkv, void* attn, void* y, int b, int s, int w, int heads, int causal,
                   cudaStream_t stream) {
  const int m = b * s, d = w / heads;
  const size_t plane = (size_t)m * w;
  const float scale = (float)std::pow((double)d, -0.5);  // as the reference's d ** -0.5
  const T* qp = static_cast<const T*>(qkv);
  cudaError_t err;

  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // wgmma_gemm.cuh's GEMM, block form
    WgmmaGemmArgs proj = {};
    for (int z = 0; z < 3; ++z) {
      proj.bias[z] = static_cast<const T*>(biases[z]);
      proj.c[z] = static_cast<T*>(qkv) + z * plane;
    }
    if (ln_stats != nullptr) {
      proj.ln_mean = ln_stats;
      proj.ln_inv = ln_stats + m;
      proj.ln_gamma = static_cast<const T*>(gamma);
      proj.ln_beta = static_cast<const T*>(beta);
      err = launch_block_gemm<T, kFormNN, kLoadLn, kStoreRound>(&x, wts, 3, m, w, proj, stream);
    } else {
      err = launch_block_gemm<T, kFormNN, kLoadPlain, kStoreRound>(&x, wts, 3, m, w, proj,
                                                                   stream);
    }
    if (err != cudaSuccess) return err;
    if (core_on_wgmma(s, d))
      err = static_cast<cudaError_t>(mmt_block_attention_core_wgmma(
          qp, qp + plane, qp + 2 * plane, attn, b, s, heads, d, w, causal, scale, stream));
    else
      err = launch_attention_core<T>(qp, qp + plane, qp + 2 * plane, static_cast<T*>(attn), b,
                                     s, w, heads, d, scale, causal, stream);
    if (err != cudaSuccess) return err;
    WgmmaGemmArgs out = {};
    out.bias[0] = static_cast<const T*>(biases[3]);
    out.c[0] = y;
    const void* a_out = attn;
    if (residual == nullptr)
      return launch_block_gemm<T, kFormNN, kLoadPlain, kStoreRound>(&a_out, wts + 3, 1, m, w,
                                                                    out, stream);
    out.residual = static_cast<const T*>(residual);
    return launch_block_gemm<T, kFormNN, kLoadPlain, kStoreResidual>(&a_out, wts + 3, 1, m, w,
                                                                     out, stream);
  } else {  // float32: mma_gemm.cuh's 3xTF32 GEMM, the register-tile core
    MmaGemmArgs proj = {};
    proj.a[0] = x;
    for (int z = 0; z < 3; ++z) {
      proj.b[z] = wts[z];
      proj.bias[z] = biases[z];
      proj.c[z] = static_cast<T*>(qkv) + z * plane;
    }
    proj.m = m, proj.n = w, proj.kseg = w, proj.nseg = 1;
    if (ln_stats != nullptr) {
      proj.ln_mean = ln_stats;
      proj.ln_inv = ln_stats + m;
      proj.ln_gamma = gamma;
      proj.ln_beta = beta;
      err = launch_mma_gemm<T, T, kFormNN, kLoadLn, kStoreResidual>(proj, 3, stream);
    } else {
      err = launch_mma_gemm<T, T, kFormNN, kLoadPlain, kStoreResidual>(proj, 3, stream);
    }
    if (err != cudaSuccess) return err;
    err = launch_attention_core<T>(qp, qp + plane, qp + 2 * plane, static_cast<T*>(attn), b, s,
                                   w, heads, d, scale, causal, stream);
    if (err != cudaSuccess) return err;
    MmaGemmArgs out = {};
    out.a[0] = attn;
    out.b[0] = wts[3];
    out.bias[0] = biases[3];
    out.c[0] = y;
    out.residual = residual;
    out.m = m, out.n = w, out.kseg = w, out.nseg = 1;
    return launch_mma_gemm<T, T, kFormNN, kLoadPlain, kStoreResidual>(out, 1, stream);
  }
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
  return launch<T>(x, ln_stats, gamma, beta, residual ? x : nullptr, wts, biases, qkv, attn, y,
                   b, s, w, heads, causal, stream);
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
    return (int)launch<float>(x, nullptr, nullptr, nullptr, nullptr, wts, biases, qkv, attn, y,
                              b, s, w, heads, causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, nullptr, nullptr, nullptr, nullptr, wts, biases, qkv,
                                      attn, y, b, s, w, heads, causal, st);
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
