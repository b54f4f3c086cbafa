// Whole-block attention backward for short sequences (S <= 320), hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/block_attention.py:_bwd_kernel and
// _bwd_kernel_large (both launched by _block_attention_bwd; _bwd_kernel in its LN form by
// _block_attention_ln_bwd). The two compute the same outputs and differ only in how they
// budget the TPU's VMEM (S <= 128 and 128 < S <= 320); this one design covers every S <= 320
// with D <= 128. For x and dy [B,S,W] and the four [W,W] weights in the JAX [in,out] layout
// it computes
//
//   q,k,v   = x @ Wq|Wk|Wv + b               as the forward (f32 accumulation, bias in f32,
//                                             one rounding to T)
//   do      = dy @ Wo^T                       f32 accumulation, rounded to T
//   p       = softmax(q_h k_h^T / sqrt(D))    as the forward, rounded to T
//   attnpre = p @ v_h                         rounded to T
//   dv      = p^T @ do_h                      rounded to T
//   dp      = do_h @ v_h^T                    f32
//   ds      = p * (dp - rowsum(dp * p))       rounded to T
//   dq      = (ds @ k_h) * scale, dk = (ds^T @ q_h) * scale    scaled in f32, rounded to T
//   dx      = [dq | dk | dv] @ [Wq; Wk; Wv]^T one f32 accumulator over K = 3W, rounded once
//
// in five launches: the forward's projection GEMM for q, k and v (gridDim.z = 3); a GEMM
// with transposed weights for do; a dQ pass, one block per (16-row query tile, head, image),
// that streams keys and values in 32-row chunks, writes attnpre and dq and saves three f32
// numbers per query row (the row max, the row sum of exp and rowsum(dp * p)); a dK/dV pass,
// one block per (16-key tile, head, image), that streams the query rows in 32-row chunks and
// rebuilds p and ds from the saved row numbers; and the transposed-weight GEMM for dx. No
// [B,H,S,S] tensor reaches device memory.
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
// as a statistics launch and an elementwise launch for ln_out in front, the five launches
// above run on ln_out with the last GEMM writing float32, and a row kernel behind. The GEMM
// owns 128 columns of a row while the LN vjp needs means over all W, hence the f32 scratch
// [B*S, W] between them (155 MB at B=256, S=197, W=768). The partial sums are written one
// row per block, in a fixed order, and summed outside: no float atomics, so a result never
// differs from run to run.
//
// What bounds it on the card: the five [B*S,W]x[W,W]-sized GEMM equivalents (q, k, v, do
// and the K = 3W dx product) carry ~90% of the FLOPs at ViT-B/32 shapes, so like the
// forward it is compute-bound on CUDA-core float FMAs; the attention passes are bound by
// shared-memory loads (two per FMA, no register tiling yet). The design choices that matter:
//   * dK and dV sum over every query row of an (image, head). Blocks run in parallel and
//     carry nothing between them, and two f32 [S, D] accumulators at S=320, D=128 (320 KB)
//     exceed a block's shared memory. So the sums run in a second pass, FlashAttention-2
//     style, where each block owns a key tile and keeps its dK/dV rows in registers.
//   * p must be bit-identical in both passes, so that dq and dv see the same rounded
//     probabilities: both passes compute each logit as one in-order fmaf chain over D, then
//     __fmul_rn by the scale (never contracted into the exp's subtraction), then
//     expf(logit - max) / sum with the same saved max and sum. dp is rebuilt the same way,
//     so ds agrees too.
//   * The TPU kernel's image groups (_images_per_program) and its stacked [H*S, S] buffers
//     exist for VMEM and have no counterpart here.
// Every product is a float FMA on the CUDA cores (bf16 operands are widened in shared
// memory), so float32 is true float32. wgmma, TMA and fewer launches are later work.

#include "attention_passes.cuh"

namespace {

// ----------------------------------------------------------------------------- GEMM, W^T
// C[M,N] = sum_{z < nseg} A_z[M,kseg] @ W_z[N,kseg]^T with one f32 accumulator and one
// rounding to TOut (none when TOut is float: the LN form keeps this product in f32), no
// bias. A_z row-major; W_z row-major [N, kseg], i.e. a [W_in, W_out] weight read as its
// transpose. Requires N % 128 == 0 and kseg % 16 == 0; M is ragged and masked.
struct NtOperands {
  const void* a[3];
  const void* w[3];
};

template <typename T, typename TOut>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(NtOperands ops, TOut* __restrict__ c, int m, int n, int kseg, int nseg) {
  __shared__ float as[kBK][kBM];  // A tile, transposed: as[kk][row]
  __shared__ float bs[kBK][kBN];  // W tile, transposed: bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int z = 0; z < nseg; ++z) {
    const T* __restrict__ a = static_cast<const T*>(ops.a[z]);
    const T* __restrict__ wt = static_cast<const T*>(ops.w[z]);
    for (int k0 = 0; k0 < kseg; k0 += kBK) {
      // A: 128 rows x 16 cols, W: 128 rows (output columns) x 16 cols; two groups of 4 each
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = tid + h * kGemmThreads;  // 0..511
        const int row = e / 4, col = (e % 4) * 4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m0 + row < m) load4(a + (size_t)(m0 + row) * kseg + k0 + col, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) as[col + i][row] = v[i];
        float u[4];
        load4(wt + (size_t)(n0 + row) * kseg + k0 + col, u);
#pragma unroll
        for (int i = 0; i < 4; ++i) bs[col + i][row] = u[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m) continue;
    store4(c + (size_t)row * n + n0 + tx * 4, acc[i]);
    store4(c + (size_t)row * n + n0 + 64 + tx * 4, acc[i] + 4);
  }
}

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
  const dim3 gemm_grid(w / kBN, (m + kBM - 1) / kBM, 1);
  cudaError_t err;

  // LN form: recompute the statistics and write ln_out, the input of everything below
  const T* xin = static_cast<const T*>(x);
  if (ln) {
    float* mean = buf.ln_stats;
    float* inv = buf.ln_stats + m;
    err = launch_ln_stats<T>(xin, mean, inv, m, w, eps, stream);
    if (err != cudaSuccess) return err;
    const size_t groups = plane / 4;
    const int blocks = (int)((groups + kLnThreads - 1) / kLnThreads);
    ln_rows_kernel<T><<<blocks, kLnThreads, 0, stream>>>(
        xin, mean, inv, static_cast<const T*>(gamma), static_cast<const T*>(beta),
        static_cast<T*>(buf.ln_out), m, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xin = static_cast<const T*>(buf.ln_out);
  }

  // q, k, v recomputed exactly as the forward computed them
  GemmOperands qkv_ops = qkv_operands<T>(wts, biases, buf.qkv, plane);
  gemm_bias_kernel<T, false><<<dim3(gemm_grid.x, gemm_grid.y, 3), kGemmThreads, 0, stream>>>(
      xin, qkv_ops, m, w, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // do = dy @ Wo^T
  NtOperands do_ops = {};
  do_ops.a[0] = dy;
  do_ops.w[0] = wts[3];
  gemm_nt_kernel<T, T><<<gemm_grid, kGemmThreads, 0, stream>>>(
      do_ops, static_cast<T*>(buf.dout), m, w, w, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = (float)std::pow((double)d, -0.5);  // as the forward's
  const T* qp = static_cast<const T*>(buf.qkv);
  err = launch_attention_bwd_passes<T, false>(
      qp, qp + plane, qp + 2 * plane, static_cast<const T*>(buf.dout), buf.stats,
      static_cast<T*>(buf.attnpre), static_cast<T*>(buf.dq), static_cast<T*>(buf.dk),
      static_cast<T*>(buf.dv), b, s, w, heads, d, scale, causal, stream);
  if (err != cudaSuccess) return err;

  // [dq | dk | dv] @ [Wq; Wk; Wv]^T, one accumulator over K = 3W: dx itself, or g in f32
  NtOperands dx_ops;
  const void* grads[3] = {buf.dq, buf.dk, buf.dv};
  for (int z = 0; z < 3; ++z) {
    dx_ops.a[z] = grads[z];
    dx_ops.w[z] = wts[z];
  }
  if (!ln) {
    gemm_nt_kernel<T, T><<<gemm_grid, kGemmThreads, 0, stream>>>(
        dx_ops, static_cast<T*>(buf.dx), m, w, w, 3);
    return cudaGetLastError();
  }
  gemm_nt_kernel<T, float><<<gemm_grid, kGemmThreads, 0, stream>>>(dx_ops, buf.g32, m, w, w, 3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

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
