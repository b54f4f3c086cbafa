// The MLP half of a pre-LN residual block, y = x + act(LN(x) @ W1 + b1) @ W2 + b2, forward
// and backward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/block_mlp.py:_fwd_kernel and
// _bwd_kernel. For x and dy [T,W] (T = B*S tokens, ragged), W1 [W,H], W2 [H,W] in the JAX
// [in,out] layout, gamma and beta [W], and act one of quick_gelu and tanh-gelu, the forward
// computes
//
//   ln = LN(x)                      f32 statistics, compute-dtype arithmetic rounding after
//                                   every operation; never written to device memory
//   h  = ln @ W1 + b1               f32 accumulation, bias added in f32, rounded to T; written
//                                   (the backward reads it instead of repeating the product)
//   g  = act(f32(h))                evaluated in f32 from the rounded h, rounded to T; never
//                                   written to device memory
//   y  = g @ W2 + b2 [+ x]          one f32 sum, rounded to T once
//
// and the backward, from x, dy and the saved h,
//
//   dg   = dy @ W2^T                f32
//   dh32 = dg * act'(f32(h))        f32;  db1 = colsum(dh32), the unrounded values
//   dh   = round_T(dh32)            written to a [T,H] scratch for the two products below
//   dln  = dh @ W1^T                f32 [T,W] scratch
//   dW2  = g^T @ dy                 g recomputed from h as the forward formed it
//   dW1  = ln_b^T @ dh              ln_b = round_T((x32 - mean) * inv) * gamma_T + beta_T: the
//                                   backward's form of LN(x), which in bf16 is not bit for bit
//                                   the forward's (x - mean_T) * inv_T * gamma_T + beta_T
//   db2  = colsum(dy32); dgamma = colsum(dln * xhat32); dbeta = colsum(dln)
//   dx   = inv * (dln gamma32 - mean(dln gamma32) - xhat32 mean(dln gamma32 xhat32)) [+ dy32]
//                                   all in f32 with the f32 gamma, rounded once
//
// What bounds it on the card: the two (forward) and four (backward) [T,W]x[W,H]-sized
// products are all of the FLOPs, so both kernels are compute-bound on CUDA-core float FMAs.
// What the design does. The TPU kernel is one program per tile of tokens that holds both
// weight matrices and an f32 [M,H] hidden tile in VMEM and carries the f32 weight-gradient
// sums across a sequential grid; an SM has 227 KB and blocks run in parallel, so here every
// product is a tiled GEMM of its own (128x128 output tile, 8x8 register micro-tile, as the
// block-attention projections) and the elementwise work rides the GEMMs' loads and
// epilogues:
//   forward, 3 launches: row statistics; c_fc with LN in its A-tile loads and h written from
//     its epilogue (gemm_bias_kernel<T, true>); c_proj with round_T(act(f32(h))) applied as
//     the A tile is loaded and + b2 + x in a single-rounding epilogue.
//   backward, 6 launches: row statistics; dy @ W2^T with act'(h) in the epilogue, which
//     writes dh and one partial db1 row per 128-token tile; dh @ W1^T into f32; the LN vjp
//     row kernel (dx and partial dgamma, dbeta, db2 rows per 32 tokens); dW2 and dW1 as
//     products over K = T whose A-tile loads recompute g from h and ln_b from x, split over
//     the token rows into f32 partial sums (the output tiles alone, 144 at W=768 and H=3072,
//     do not fill 132 SMs evenly), summed in order and cast outside.
// Writing dh [T,H] to device memory is what the TPU kernel avoids; on this card that
// traffic (2 T H elements) is small beside the products. Rows past a ragged T are masked in
// every load and every column sum. The column sums go to partial rows in a fixed order and
// are summed outside: no float atomics, so a result never differs from run to run. float32
// is true float32. Tensor cores and fewer launches are later work.

#include "block_attention_common.cuh"

namespace {

constexpr int kActQuickGelu = 0, kActGelu = 1;
constexpr float kSqrt2OverPi = 0.7978845608028654f, kGeluC = 0.044715f;

__device__ __forceinline__ float sigmoid_f(float z) { return 1.f / (1.f + expf(-z)); }

// act(h) in f32
__device__ __forceinline__ float act_fwd(float h, int act) {
  if (act == kActQuickGelu) return h * sigmoid_f(1.702f * h);
  const float u = kSqrt2OverPi * (h + kGeluC * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

// d act / d h in f32
__device__ __forceinline__ float act_bwd(float h, int act) {
  if (act == kActQuickGelu) {
    const float s = sigmoid_f(1.702f * h);
    return s + h * 1.702f * s * (1.f - s);
  }
  const float u = kSqrt2OverPi * (h + kGeluC * h * h * h);
  const float t = tanhf(u);
  const float du = kSqrt2OverPi * (1.f + 3.f * kGeluC * h * h);
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
}

// ----------------------------------------------------------------------------- tiles
// A 128 x 16 tile of a row-major [R, ld] matrix, rows r0.. (masked at rmax) and columns
// k0..k0+15, into s[kk][row] (transposed). f(v, row, col) transforms four loaded values.
template <typename T, typename F>
__device__ __forceinline__ void load_rows_tile(const T* __restrict__ a, int ld, int r0,
                                               int rmax, int k0, float (*s)[kBM], int tid,
                                               F f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = tid + h * kGemmThreads;  // 0..511
    const int row = e / 4, col = (e % 4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + row < rmax) {
      load4(a + (size_t)(r0 + row) * ld + k0 + col, v);
      f(v, r0 + row, k0 + col);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[col + i][row] = v[i];
  }
}

// A 16 x 128 tile of a row-major [K, ld] matrix, rows k0..k0+15 (masked at kmax) and
// columns c0..c0+127, into s[kk][col]. f as above.
template <typename T, typename F>
__device__ __forceinline__ void load_cols_tile(const T* __restrict__ b, int ld, int k0,
                                               int kmax, int c0, float (*s)[kBN], int tid,
                                               F f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = tid + h * kGemmThreads;
    const int row = e / 32, col = (e % 32) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + row < kmax) {
      load4(b + (size_t)(k0 + row) * ld + c0 + col, v);
      f(v, k0 + row, c0 + col);
    }
    *reinterpret_cast<float4*>(&s[row][col]) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

struct Identity {
  __device__ __forceinline__ void operator()(float*, int, int) const {}
};

// acc += as^T bs over the 16-deep tile: thread (tx, ty) owns rows {ty*4..+3, 64+ty*4..+3}
// and columns {tx*4..+3, 64+tx*4..+3}
__device__ __forceinline__ void tile_fma(float (*as)[kBM], float (*bs)[kBN], int tx, int ty,
                                         float acc[8][8]) {
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
}

__device__ __forceinline__ void zero_acc(float acc[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// the tile row of accumulator row i
__device__ __forceinline__ int acc_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
}

// ----------------------------------------------------------------------------- forward c_proj
// y[M,N] = round_T(act(f32(h))) @ W2 + b2 [+ res], one f32 sum rounded to T once. h [M,K],
// W2 [K,N] row major; N % 128 == 0, K % 16 == 0; M ragged and masked.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
mlp_proj_kernel(const T* __restrict__ h, const T* __restrict__ w2, const T* __restrict__ bias,
                const T* __restrict__ res, T* __restrict__ y, int m, int n, int k, int act) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[8][8];
  zero_acc(acc);

  auto activate = [act](float* v, int, int) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = round_to<T>(act_fwd(v[i], act));
  };
  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_rows_tile(h, k, m0, m, k0, as, tid, activate);
    load_cols_tile(w2, n, k0, k, n0, bs, tid, Identity());
    __syncthreads();
    tile_fma(as, bs, tx, ty, acc);
    __syncthreads();
  }

  float bv[8];
  load4(bias + n0 + tx * 4, bv);
  load4(bias + n0 + 64 + tx * 4, bv + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + acc_row(ty, i);
    if (row >= m) continue;
    float out[8], rv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (res != nullptr) {
      load4(res + (size_t)row * n + n0 + tx * 4, rv);
      load4(res + (size_t)row * n + n0 + 64 + tx * 4, rv + 4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[j] = __fadd_rn(acc[i][j], bv[j]);
      if (res != nullptr) out[j] = __fadd_rn(out[j], rv[j]);
    }
    store4(y + (size_t)row * n + n0 + tx * 4, out);
    store4(y + (size_t)row * n + n0 + 64 + tx * 4, out + 4);
  }
}

// ----------------------------------------------------------------------------- backward, W^T
// C[M,N] = A[M,K] @ Wt[N,K]^T in f32 (Wt row major, i.e. an [in,out] weight read as its
// transpose). N % 128 == 0, K % 16 == 0; M ragged and masked.
//   kActGrad: A = dy, Wt = W2; the epilogue multiplies by act'(f32(h[M,N])), writes the
//     product rounded to T (dh) and the tile's column sums of the unrounded values as row
//     blockIdx.y of `part` [ceil(M/128), N] (db1's partial sums).
//   else: A = dh, Wt = W1; the epilogue writes the f32 sums (dln).
template <typename T, bool kActGrad>
__global__ void __launch_bounds__(kGemmThreads)
mlp_nt_kernel(const T* __restrict__ a, const T* __restrict__ wt, const T* __restrict__ h,
              T* __restrict__ dh, float* __restrict__ part, float* __restrict__ c32, int m,
              int n, int k, int act) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[8][8];
  zero_acc(acc);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_rows_tile(a, k, m0, m, k0, as, tid, Identity());
    load_rows_tile(wt, k, n0, n, k0, bs, tid, Identity());
    __syncthreads();
    tile_fma(as, bs, tx, ty, acc);
    __syncthreads();
  }

  float colsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + acc_row(ty, i);
    if (row >= m) continue;
    const size_t at = (size_t)row * n + n0;
    if constexpr (kActGrad) {
      float hv[8], out[8];
      load4(h + at + tx * 4, hv);
      load4(h + at + 64 + tx * 4, hv + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[j] = __fmul_rn(acc[i][j], act_bwd(hv[j], act));
        colsum[j] += out[j];
      }
      store4(dh + at + tx * 4, out);
      store4(dh + at + 64 + tx * 4, out + 4);
    } else {
      store4(c32 + at + tx * 4, acc[i]);
      store4(c32 + at + 64 + tx * 4, acc[i] + 4);
    }
  }
  if constexpr (kActGrad) {
    // the 16 row groups of the tile, summed in order by one thread per column; `as` is free
    // after the loop's last barrier
    float (*red)[kBM] = as;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[ty][tx * 4 + j] = colsum[j];
      red[ty][64 + tx * 4 + j] = colsum[4 + j];
    }
    __syncthreads();
    if (tid < kBN) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < kGemmThreads / 16; ++g) sum += red[g][tid];
      part[(size_t)blockIdx.y * n + n0 + tid] = sum;
    }
  }
}

// ----------------------------------------------------------------------------- weight grads
// C_z[M,N] = A'[K_z,M]^T @ B[K_z,N] in f32, where block z of gridDim.z owns the token rows
// K_z = [z * k_per_split, (z + 1) * k_per_split) of K = T (ragged, masked): one f32 partial
// [M,N] per split, summed over z in order and rounded outside. The split is there because
// M N / 128^2 output tiles alone (144 at W=768, H=3072) do not fill 132 SMs evenly, while K
// is tens of thousands of rows long. M % 128 == 0, N % 128 == 0, k_per_split % 16 == 0.
//   kLn: A = x [T,W], A' = round_T((x32 - mean) * inv) * gamma_T + beta_T, rounding to T
//     after every operation (the backward's form of LN(x)); B = dh. C = dW1 [W,H].
//   else: A = h [T,H], A' = round_T(act(f32(h))); B = dy. C = dW2 [H,W].
template <typename T, bool kLn>
__global__ void __launch_bounds__(kGemmThreads)
mlp_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ c,
                 const float* __restrict__ mean, const float* __restrict__ inv,
                 const T* __restrict__ gamma, const T* __restrict__ beta, int kdim,
                 int k_per_split, int m, int n, int act) {
  __shared__ __align__(16) float as[kBK][kBM];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split, k_end = min(kdim, k_begin + k_per_split);
  float acc[8][8];
  zero_acc(acc);

  // kLn: gamma and beta of this thread's four A columns (the same in both of its tile rows)
  float gm[4] = {0.f, 0.f, 0.f, 0.f}, bt[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kLn) {
    load4(gamma + m0 + (tid % 32) * 4, gm);
    load4(beta + m0 + (tid % 32) * 4, bt);
  }
  auto transform = [&](float* v, int row, int) {
    if constexpr (kLn) {
      const float mu = mean[row], iv = inv[row];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xhat = round_to<T>(__fmul_rn(__fsub_rn(v[i], mu), iv));
        v[i] = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(xhat, gm[i])), bt[i]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = round_to<T>(act_fwd(v[i], act));
    }
  };
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    load_cols_tile(a, m, k0, k_end, m0, as, tid, transform);
    load_cols_tile(b, n, k0, k_end, n0, bs, tid, Identity());
    __syncthreads();
    tile_fma(as, bs, tx, ty, acc);
    __syncthreads();
  }
  float* cz = c + (size_t)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t at = (size_t)(m0 + acc_row(ty, i)) * n + n0;
    store4(cz + at + tx * 4, acc[i]);
    store4(cz + at + 64 + tx * 4, acc[i] + 4);
  }
}

// ----------------------------------------------------------------------------- launches
template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, const void* w1,
                       const void* b1, const void* w2, const void* b2, float* ln_stats, void* h,
                       void* y, int t, int w, int hid, int act, int residual, float eps,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  cudaError_t err = launch_ln_stats<T>(xp, ln_stats, ln_stats + t, t, w, eps, stream);
  if (err != cudaSuccess) return err;
  const int row_tiles = (t + kBM - 1) / kBM;

  GemmOperands fc = {};
  fc.b[0] = w1;
  fc.bias[0] = b1;
  fc.c[0] = h;
  fc.ln_mean = ln_stats;
  fc.ln_inv = ln_stats + t;
  fc.ln_gamma = gamma;
  fc.ln_beta = beta;
  gemm_bias_kernel<T, true><<<dim3(hid / kBN, row_tiles, 1), kGemmThreads, 0, stream>>>(
      xp, fc, t, hid, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mlp_proj_kernel<T><<<dim3(w / kBN, row_tiles), kGemmThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2), static_cast<const T*>(b2),
      residual ? xp : nullptr, static_cast<T*>(y), t, w, hid, act);
  return cudaGetLastError();
}

struct MlpBwdBuffers {
  float* ln_stats;  // scratch [2, T] f32: mean, inv
  void* dh;         // scratch [T, H] T
  float* dln;       // scratch [T, W] f32
  void* dx;         // output [T, W] of T
  float *dw1_part, *dw2_part;  // outputs [splits, W, H] and [splits, H, W] f32
  float* db1_part;  // output [ceil(T / 128), H] f32
  float* col_part;  // output [3, ceil(T / kLnBwdRows), W] f32: dgamma, dbeta, db2
};

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* h, const void* gamma,
                       const void* beta, const float* gamma32, const void* w1, const void* w2,
                       const MlpBwdBuffers& buf, int t, int w, int hid, int act, int residual,
                       int splits, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const T* hp = static_cast<const T*>(h);
  T* dhp = static_cast<T*>(buf.dh);
  float* mean = buf.ln_stats;
  float* inv = buf.ln_stats + t;
  const int row_tiles = (t + kBM - 1) / kBM;
  cudaError_t err = launch_ln_stats<T>(xp, mean, inv, t, w, eps, stream);
  if (err != cudaSuccess) return err;

  // dh = round_T((dy @ W2^T) * act'(h)), db1 partials
  mlp_nt_kernel<T, true><<<dim3(hid / kBN, row_tiles), kGemmThreads, 0, stream>>>(
      dyp, static_cast<const T*>(w2), hp, dhp, buf.db1_part, nullptr, t, hid, w, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dln = dh @ W1^T, f32
  mlp_nt_kernel<T, false><<<dim3(w / kBN, row_tiles), kGemmThreads, 0, stream>>>(
      dhp, static_cast<const T*>(w1), nullptr, nullptr, nullptr, buf.dln, t, w, hid, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dx, and the dgamma, dbeta and db2 partials
  const int part_rows = (t + kLnBwdRows - 1) / kLnBwdRows;
  const size_t plane = (size_t)part_rows * w;
  ln_bwd_kernel<T, float><<<part_rows, kLnThreads, 0, stream>>>(
      xp, dyp, buf.dln, mean, inv, gamma32, static_cast<T*>(buf.dx), buf.col_part,
      buf.col_part + plane, buf.col_part + 2 * plane, residual, t, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dW2 = g^T dy and dW1 = ln_b^T dh over K = T, `splits` partial sums each
  const int k_per_split = ((t + splits - 1) / splits + kBK - 1) / kBK * kBK;
  mlp_wgrad_kernel<T, false><<<dim3(w / kBN, hid / kBM, splits), kGemmThreads, 0, stream>>>(
      hp, dyp, buf.dw2_part, nullptr, nullptr, nullptr, nullptr, t, k_per_split, hid, w, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_wgrad_kernel<T, true><<<dim3(hid / kBN, w / kBM, splits), kGemmThreads, 0, stream>>>(
      xp, dhp, buf.dw1_part, mean, inv, static_cast<const T*>(gamma),
      static_cast<const T*>(beta), t, k_per_split, w, hid, act);
  return cudaGetLastError();
}

bool mlp_shape_ok(int t, int w, int hid, int act) {
  return t >= 1 && w >= 128 && hid >= 128 && w % 128 == 0 && hid % 128 == 0 &&
         (act == kActQuickGelu || act == kActGelu);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = quick_gelu, 1 = tanh-gelu. x [T,W]; gamma, beta
// [W] of the compute dtype; w1 [W,H], b1 [H], w2 [H,W], b2 [W]. Scratch: ln_stats [2,T]
// float32. Outputs: h [T,H] (the pre-activation) and y [T,W], y including x when
// residual != 0. All contiguous on one device; launches on `stream` without synchronising.
// Returns a cudaError_t.
int mmt_block_mlp_fwd(int dtype, const void* x, const void* gamma, const void* beta,
                      const void* w1, const void* b1, const void* w2, const void* b2,
                      void* ln_stats, void* h, void* y, int t, int w, int hid, int act,
                      int residual, float eps, void* stream) {
  if (!mlp_shape_ok(t, w, hid, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(ln_stats);
  if (dtype == 0)
    return (int)launch_fwd<float>(x, gamma, beta, w1, b1, w2, b2, stats, h, y, t, w, hid, act,
                                  residual, eps, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, stats, h, y, t, w,
                                          hid, act, residual, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: x, dy [T,W] and the saved h [T,H]; gamma, beta [W] of the compute dtype and
// gamma32 [W] float32. Scratch: ln_stats [2,T] and dln [T,W] float32, dh [T,H] of the
// compute dtype. Outputs: dx [T,W] of the compute dtype, and float32 partial sums to be
// summed over their first dimension: dw1_part [splits,W,H] and dw2_part [splits,H,W] (one
// per split of the token rows, 1 <= splits <= 65535; a split past the last row holds zeros), db1_part
// [mmt_block_mlp_db1_partial_rows(T), H] and col_part [3, mmt_ln_bwd_partial_rows(T), W]
// (dgamma, dbeta, db2).
int mmt_block_mlp_bwd(int dtype, const void* x, const void* dy, const void* h,
                      const void* gamma, const void* beta, const void* gamma32, const void* w1,
                      const void* w2, void* ln_stats, void* dh, void* dln, void* dx,
                      void* dw1_part, void* dw2_part, void* db1_part, void* col_part, int t,
                      int w, int hid, int act, int residual, int splits, float eps,
                      void* stream) {
  if (!mlp_shape_ok(t, w, hid, act) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpBwdBuffers buf = {};
  buf.ln_stats = static_cast<float*>(ln_stats);
  buf.dh = dh;
  buf.dln = static_cast<float*>(dln);
  buf.dx = dx;
  buf.dw1_part = static_cast<float*>(dw1_part);
  buf.dw2_part = static_cast<float*>(dw2_part);
  buf.db1_part = static_cast<float*>(db1_part);
  buf.col_part = static_cast<float*>(col_part);
  const float* g32 = static_cast<const float*>(gamma32);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, dy, h, gamma, beta, g32, w1, w2, buf, t, w, hid, act,
                                  residual, splits, eps, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, dy, h, gamma, beta, g32, w1, w2, buf, t, w, hid,
                                          act, residual, splits, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of the db1 partial-sum output for t token rows.
int mmt_block_mlp_db1_partial_rows(int t) { return (t + kBM - 1) / kBM; }

}  // extern "C"
