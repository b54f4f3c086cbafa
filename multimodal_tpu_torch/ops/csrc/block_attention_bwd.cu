// Whole-block attention backward for short sequences (S <= 320), hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/block_attention.py:_bwd_kernel and
// _bwd_kernel_large (both launched by _block_attention_bwd; _bwd_kernel in its LN form by
// _block_attention_ln_bwd). The two compute the same outputs and differ only in how they
// budget the TPU's VMEM (S <= 128 and 128 < S <= 320); this one design covers every S <= 320
// with D <= 128. For x and dy [B,S,W] and the four [W,W] weights in the JAX [in,out] layout
// it computes
//
//   q,k,v   = x @ Wq|Wk|Wv + b               recomputed: f32 accumulation, bias in f32, one
//                                             rounding to T (the forward's function)
//   do      = dy @ Wo^T                       f32 accumulation, rounded to T
//   p       = softmax(q_h k_h^T / sqrt(D))    as the forward, rounded to T
//   attnpre = p @ v_h                         rounded to T
//   dv      = p^T @ do_h                      rounded to T
//   dp      = do_h @ v_h^T                    f32
//   ds      = p * (dp - rowsum(dp * p))       rounded to T
//   dq      = (ds @ k_h) * scale, dk = (ds^T @ q_h) * scale    scaled in f32, rounded to T
//   dx      = [dq | dk | dv] @ [Wq; Wk; Wv]^T one f32 accumulator over K = 3W, rounded once
//
// in five launches: the q/k/v recompute (three weight sets, one launch); do (the NT form); the
// attention half, a dQ launch that walks the key tiles in sweeps, writes attnpre and dq and saves
// each query row's statistics, then a dK/dV launch that rebuilds p and ds from them; and the NT
// form over three K segments for dx. No [B,H,S,S] tensor reaches device memory.
//
//   * bfloat16: the GEMMs are wgmma_gemm.cuh's wgmma GEMM fed by TMA (the block-attention
//     instantiations with three operand sets: q, k, v's weight sets in one launch, and dx's three
//     segments [dq | dk | dv] and [Wq; Wk; Wv] walked as one stream of K-steps into one f32
//     accumulator, each operand through its own tensor map); at D in {32, 64, 128} the attention
//     half is fused_attention.cu's wgmma dQ and dK/dV kernels in their block form (persistent
//     over the (image, head) items, an item's K/V or Q/dO resident; the rounded probabilities;
//     two items a pass at S <= 64; stats [2, B*H*S]: lse in log2 units, delta), at D = 80, 88
//     and 96 attention_passes.cuh's mma.sync passes (stats [3, B*H*S]);
//   * float32: mma_gemm.cuh's 3xTF32 GEMM (within 2^-20 of true float32 a product) and
//     attention_passes.cuh's register-tile passes.
//
// The LN form (mmt_block_attention_ln_bwd; x is the pre-LN residual stream) adds
//
//   ln_out  = LN(x)                           recomputed (f32 mean and inv kept), written in T
//                                             for the whole-batch weight-gradient products
//   g       = [dq | dk | dv] @ [Wq; Wk; Wv]^T the gradient of ln_out, kept in *float32*
//   xhat32  = (x32 - mean) * inv              f32, not the forward's compute-dtype xhat
//   dgamma, dbeta partials = sum_rows(g * xhat32), sum_rows(g)   one f32 [W] row per block
//   dx      = inv * (g gamma - mean(g gamma) - xhat32 * mean(g gamma xhat32)) [+ dy]
//                                             all in f32, + dy32 with the residual, one rounding
//
// as a statistics launch and an elementwise launch for ln_out in front (in bfloat16 by
// ln_bf16x8, the function of the forward's LN load, so that the recomputed q, k and v are the
// forward's bits), the five launches above run on ln_out with the last GEMM writing float32, and
// a row kernel behind. The GEMM owns 128 columns of a row while the LN vjp needs means over all
// W, hence the f32 scratch [B*S, W] between them (155 MB at B=256, S=197, W=768). The partial
// sums are written one row per block, in a fixed order, and summed outside: no float atomics,
// so a result never differs from run to run.
//
// What bounds it on the card: the five [B*S,W]x[W,W]-sized GEMM equivalents (q, k, v, do and
// the K = 3W dx product) carry ~90% of the FLOPs at ViT-B/32 shapes, so it is bound by
// operations, on the tensor cores. The design choices that matter:
//   * dK and dV sum over every query row of an (image, head); blocks run in parallel and carry
//     nothing between them, so the sums run in a second launch, FlashAttention-2 style, where
//     each block owns key tiles and keeps their dK/dV rows in registers.
//   * Both launches rebuild p from the same saved statistics with the same expression, and dp
//     the same way, so dq and dv see the same probabilities up to the order of a product's sum.
//   * The TPU kernel's image groups (_images_per_program) and its stacked [H*S, S] buffers
//     exist for VMEM and have no counterpart here.
//   * The recomputed q, k and v share their bits with the forward's: both run the same NN
//     mainloop over the same A values in the same order, and add the bias and round alike.
//     chip_smoke.py phase 3 compares the two q/k/v scratch buffers bit for bit.

#include "attention_passes.cuh"
#include "wgmma_gemm.cuh"

// fused_attention.cu's wgmma dQ and dK/dV kernels in their block form (rounded p, attnpre)
extern "C" int mmt_block_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                             const void* dout, void* stats, void* attnpre,
                                             void* dq, void* dk, void* dv, int b, int s,
                                             int heads, int d, int ld, int causal, float scale,
                                             void* stream);

namespace {

// ----------------------------------------------------------------------------- LN form
// ln_out = LN(x) in T, elementwise over groups of four columns.
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ inv, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ out, int m, int w) {
  const size_t groups = (size_t)m * (w / 4);
  for (size_t e = (size_t)blockIdx.x * kLnThreads + threadIdx.x; e < groups;
       e += (size_t)gridDim.x * kLnThreads) {
    const int row = (int)(e / (w / 4)), col = (int)(e % (w / 4)) * 4;
    const float mean_t = round_to<T>(mean[row]), inv_t = round_to<T>(inv[row]);
    float v[4], g[4], bt[4];
    load4(x + (size_t)row * w + col, v);
    load4(gamma + col, g);
    load4(beta + col, bt);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = ln_apply<T>(v[i], mean_t, inv_t, g[i], bt[i]);
    store4(out + (size_t)row * w + col, v);
  }
}

// bfloat16: eight columns at a time by ln_bf16x8, the function of the forward's LN load
// (wgmma_gemm.cuh), so that the recomputed q, k and v are the forward's bits
__global__ void __launch_bounds__(kLnThreads)
ln_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ inv, const __nv_bfloat16* __restrict__ gamma,
                    const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ out,
                    int m, int w) {
  const size_t groups = (size_t)m * (w / 8);
  for (size_t e = (size_t)blockIdx.x * kLnThreads + threadIdx.x; e < groups;
       e += (size_t)gridDim.x * kLnThreads) {
    const int row = (int)(e / (w / 8)), col = (int)(e % (w / 8)) * 8;
    const float2 st = make_float2(round_to<__nv_bfloat16>(mean[row]),
                                  round_to<__nv_bfloat16>(inv[row]));
    const size_t at = (size_t)row * w + col;
    *reinterpret_cast<uint4*>(out + at) = ln_bf16x8(
        *reinterpret_cast<const uint4*>(x + at), st, *reinterpret_cast<const uint4*>(gamma + col),
        *reinterpret_cast<const uint4*>(beta + col));
  }
}

// Scratch and outputs of one backward call. ln == false: the non-LN form, where xin is the
// kernel's input and dx the rounded K=3W product. ln == true: the fields below it are used.
struct BwdBuffers {
  void* qkv;      // [3, B*S, W] T
  void* dout;     // [B*S, W] T
  float* stats;   // [3, B*H*S] f32
  void *dx, *dq, *dk, *dv, *attnpre;  // outputs [B, S, W] T
  // LN form
  float* ln_stats;  // [2, B*S] f32: mean, inv
  float* g32;       // [B*S, W] f32: d(ln_out)
  void* ln_out;     // output [B, S, W] T
  float* dg_part;   // outputs [ceil(B*S / kLnBwdRows), W] f32
  float* db_part;
};

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* const* wts, const void* const* biases, const BwdBuffers& buf,
                       int b, int s, int w, int heads, int causal, bool ln, int residual,
                       float eps, cudaStream_t stream) {
  const int m = b * s, d = w / heads;
  const size_t plane = (size_t)m * w;
  cudaError_t err;

  // LN form: recompute the statistics and write ln_out, the input of everything below
  const T* xin = static_cast<const T*>(x);
  if (ln) {
    float* mean = buf.ln_stats;
    float* inv = buf.ln_stats + m;
    err = launch_ln_stats<T>(xin, mean, inv, m, w, eps, stream);
    if (err != cudaSuccess) return err;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      const size_t groups = plane / 8;
      ln_rows_bf16_kernel<<<(int)((groups + kLnThreads - 1) / kLnThreads), kLnThreads, 0,
                            stream>>>(xin, mean, inv, static_cast<const T*>(gamma),
                                      static_cast<const T*>(beta), static_cast<T*>(buf.ln_out),
                                      m, w);
    } else {
      const size_t groups = plane / 4;
      ln_rows_kernel<T><<<(int)((groups + kLnThreads - 1) / kLnThreads), kLnThreads, 0,
                          stream>>>(xin, mean, inv, static_cast<const T*>(gamma),
                                    static_cast<const T*>(beta), static_cast<T*>(buf.ln_out), m,
                                    w);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xin = static_cast<const T*>(buf.ln_out);
  }

  const float scale = (float)std::pow((double)d, -0.5);  // as the forward's
  const T* qp = static_cast<const T*>(buf.qkv);
  const void* grads[3] = {buf.dq, buf.dk, buf.dv};
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // wgmma_gemm.cuh's GEMM, block form
    // q, k, v recomputed as the forward computes them: the same NN instantiation over the same
    // K order, on x or on ln_out (the forward's LN load's values)
    const void* a_in = xin;
    WgmmaGemmArgs qkv = {};
    for (int z = 0; z < 3; ++z) {
      qkv.bias[z] = static_cast<const T*>(biases[z]);
      qkv.c[z] = static_cast<T*>(buf.qkv) + z * plane;
    }
    err = launch_block_gemm<T, kFormNN, kLoadPlain, kStoreRound>(&a_in, wts, 3, m, w, qkv,
                                                                 stream);
    if (err != cudaSuccess) return err;
    // do = dy @ Wo^T: the NT form over one segment
    WgmmaGemmArgs dout = {};
    dout.c[0] = buf.dout;
    err = launch_block_gemm<T, kFormNT, kLoadPlain, kStoreRound>(&dy, wts + 3, 1, m, w, dout,
                                                                 stream);
    if (err != cudaSuccess) return err;
    if (d == 32 || d == 64 || d == 128)
      err = static_cast<cudaError_t>(mmt_block_attention_bwd_wgmma(
          qp, qp + plane, qp + 2 * plane, buf.dout, buf.stats, buf.attnpre, buf.dq, buf.dk,
          buf.dv, b, s, heads, d, w, causal, scale, stream));
    else  // D = 80, 88, 96: attention_passes.cuh's mma.sync passes
      err = launch_attention_bwd_passes<T>(
          qp, qp + plane, qp + 2 * plane, static_cast<const T*>(buf.dout), buf.stats,
          static_cast<T*>(buf.attnpre), static_cast<T*>(buf.dq), static_cast<T*>(buf.dk),
          static_cast<T*>(buf.dv), b, s, w, heads, d, scale, causal, stream);
    if (err != cudaSuccess) return err;
    // [dq | dk | dv] @ [Wq; Wk; Wv]^T: the NT form over three segments, one accumulator; dx
    // itself, or g in f32
    WgmmaGemmArgs dx = {};
    dx.c[0] = ln ? static_cast<void*>(buf.g32) : buf.dx;
    if (!ln) return launch_block_gemm<T, kFormNT, kLoadPlain, kStoreRound>(grads, wts, 3, m, w,
                                                                            dx, stream);
    err = launch_block_gemm<float, kFormNT, kLoadPlain, kStoreRound>(grads, wts, 3, m, w, dx,
                                                                     stream);
    if (err != cudaSuccess) return err;
  } else {  // float32: mma_gemm.cuh's 3xTF32 GEMM, the register-tile passes
    MmaGemmArgs qkv = {};
    qkv.a[0] = xin;
    for (int z = 0; z < 3; ++z) {
      qkv.b[z] = wts[z];
      qkv.bias[z] = biases[z];
      qkv.c[z] = static_cast<T*>(buf.qkv) + z * plane;
    }
    qkv.m = m, qkv.n = w, qkv.kseg = w, qkv.nseg = 1;
    err = launch_mma_gemm<T, T, kFormNN>(qkv, 3, stream);
    if (err != cudaSuccess) return err;

    MmaGemmArgs dout = {};
    dout.a[0] = dy;
    dout.b[0] = wts[3];
    dout.c[0] = buf.dout;
    dout.m = m, dout.n = w, dout.kseg = w, dout.nseg = 1;
    err = launch_mma_gemm<T, T, kFormNT>(dout, 1, stream);
    if (err != cudaSuccess) return err;

    err = launch_attention_bwd_passes<T>(
        qp, qp + plane, qp + 2 * plane, static_cast<const T*>(buf.dout), buf.stats,
        static_cast<T*>(buf.attnpre), static_cast<T*>(buf.dq), static_cast<T*>(buf.dk),
        static_cast<T*>(buf.dv), b, s, w, heads, d, scale, causal, stream);
    if (err != cudaSuccess) return err;

    MmaGemmArgs dx = {};
    for (int z = 0; z < 3; ++z) {
      dx.a[z] = grads[z];
      dx.b[z] = wts[z];
    }
    dx.m = m, dx.n = w, dx.kseg = w, dx.nseg = 3;
    if (!ln) {
      dx.c[0] = buf.dx;
      return launch_mma_gemm<T, T, kFormNT>(dx, 1, stream);
    }
    dx.c[0] = buf.g32;
    err = launch_mma_gemm<T, float, kFormNT>(dx, 1, stream);
    if (err != cudaSuccess) return err;
  }

  ln_bwd_kernel<T, T><<<(m + kLnBwdRows - 1) / kLnBwdRows, kLnThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), buf.g32, buf.ln_stats,
      buf.ln_stats + m, static_cast<const T*>(gamma), static_cast<T*>(buf.dx), buf.dg_part,
      buf.db_part, nullptr, residual, m, w);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd(int dtype, const void* x, const void* dy, const void* gamma,
                         const void* beta, const void* const* wts, const void* const* biases,
                         const BwdBuffers& buf, int b, int s, int w, int heads, int causal,
                         bool ln, int residual, float eps, void* stream) {
  if (b < 1 || s < 1 || s > kMaxSeq || heads < 1 || w % 128 != 0 || w % heads != 0)
    return cudaErrorInvalidValue;
  const int d = w / heads;
  if (d > kMaxHeadDim || d % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, dy, gamma, beta, wts, biases, buf, b, s, w, heads, causal, ln,
                             residual, eps, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dy, gamma, beta, wts, biases, buf, b, s, w, heads,
                                     causal, ln, residual, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, dy [B,S,W]; wts = {Wq, Wk, Wv, Wo} [W,W] ([in,out]);
// biases [W]. Scratch: qkv [3, B*S, W], dout [B*S, W] (T), stats [3, B*H*S] float32.
// Outputs dx, dq, dk, dv, attnpre [B,S,W]. All contiguous on one device; launches on
// `stream` without synchronising. Returns a cudaError_t.
int mmt_block_attention_bwd(int dtype, const void* x, const void* dy, const void* wq,
                            const void* bq, const void* wk, const void* bk, const void* wv,
                            const void* bv, const void* wo, const void* bo, void* qkv,
                            void* dout, void* stats, void* dx, void* dq, void* dk, void* dv,
                            void* attnpre, int b, int s, int w, int heads, int causal,
                            void* stream) {
  const void* wts[4] = {wq, wk, wv, wo};
  const void* biases[4] = {bq, bk, bv, bo};
  BwdBuffers buf = {};
  buf.qkv = qkv;
  buf.dout = dout;
  buf.stats = static_cast<float*>(stats);
  buf.dx = dx, buf.dq = dq, buf.dk = dk, buf.dv = dv, buf.attnpre = attnpre;
  return (int)dispatch_bwd(dtype, x, dy, nullptr, nullptr, wts, biases, buf, b, s, w, heads,
                           causal, false, 0, 0.f, stream);
}

// The LN form: x is the pre-LN residual stream, gamma and beta [W] of the compute dtype.
// Further scratch: ln_stats [2, B*S] and g32 [B*S, W], float32. Further outputs: ln_out
// [B,S,W] (T) and the dgamma and dbeta partial sums, float32 [rows_of_partials, W] with
// rows_of_partials = mmt_ln_bwd_partial_rows(B*S). With residual != 0, dx includes dy.
int mmt_block_attention_ln_bwd(int dtype, const void* x, const void* dy, const void* gamma,
                               const void* beta, const void* wq, const void* bq,
                               const void* wk, const void* bk, const void* wv, const void* bv,
                               const void* wo, const void* bo, void* ln_stats, void* qkv,
                               void* dout, void* stats, void* g32, void* dx, void* dq, void* dk,
                               void* dv, void* attnpre, void* ln_out, void* dg_part,
                               void* db_part, int b, int s, int w, int heads, int causal,
                               int residual, float eps, void* stream) {
  const void* wts[4] = {wq, wk, wv, wo};
  const void* biases[4] = {bq, bk, bv, bo};
  BwdBuffers buf = {};
  buf.qkv = qkv;
  buf.dout = dout;
  buf.stats = static_cast<float*>(stats);
  buf.dx = dx, buf.dq = dq, buf.dk = dk, buf.dv = dv, buf.attnpre = attnpre;
  buf.ln_stats = static_cast<float*>(ln_stats);
  buf.g32 = static_cast<float*>(g32);
  buf.ln_out = ln_out;
  buf.dg_part = static_cast<float*>(dg_part);
  buf.db_part = static_cast<float*>(db_part);
  return (int)dispatch_bwd(dtype, x, dy, gamma, beta, wts, biases, buf, b, s, w, heads, causal,
                           true, residual, eps, stream);
}

// Rows of the dgamma/dbeta partial-sum outputs for m = B*S token rows.
int mmt_ln_bwd_partial_rows(int m) { return (m + kLnBwdRows - 1) / kLnBwdRows; }

}  // extern "C"
