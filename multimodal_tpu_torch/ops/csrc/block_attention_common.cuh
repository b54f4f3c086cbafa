// Shared pieces of the kernels (block_attention_fwd.cu, block_attention_bwd.cu,
// fused_attention.cu, block_mlp.cu): dtype conversions, 4-wide loads and stores, the row-wise
// LayerNorm (f32 statistics, compute-dtype arithmetic) with the row kernel of its vjp, and
// the projection GEMM with bias (C = A @ B +
// bias, f32 accumulation, one rounding), which can normalize its A tile as it loads it and
// add a residual in its epilogue. Everything lives in an anonymous namespace, so each source
// that includes it gets its own copy and the objects link into one library.

#pragma once

#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSeq = 320;
constexpr int kMaxHeadDim = 128;

// ----------------------------------------------------------------------------- conversions
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened again: the rounding point of a compute-dtype operation
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// four consecutive elements (16-byte aligned for float, 8-byte for bf16)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// ----------------------------------------------------------------------------- LayerNorm
// The reference's _ln_rows: mean and var = max(E[x^2] - mean^2, 0) in f32, inv = rsqrt(var +
// eps) in f32; then mean and inv are cast to the compute dtype T and
// ((x - mean) * inv) * gamma + beta rounds to T after every operation. A float pipeline that
// rounds once at the end is a different function in bf16.
constexpr int kLnThreads = 256;  // one warp per row, eight rows per block

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ inv,
                int m, int w, float eps) {
  const int row = blockIdx.x * (kLnThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + (size_t)row * w;
  float sum = 0.f, sq = 0.f;
  for (int c = lane * 4; c < w; c += 128) {  // w % 128 == 0
    float v[4];
    load4(xr + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum += v[i];
      sq = fmaf(v[i], v[i], sq);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  if (lane == 0) {
    const float mu = sum / (float)w;
    mean[row] = mu;
    inv[row] = rsqrtf(fmaxf(sq / (float)w - mu * mu, 0.f) + eps);
  }
}

template <typename T>
cudaError_t launch_ln_stats(const T* x, float* mean, float* inv, int m, int w, float eps,
                            cudaStream_t stream) {
  const int rows_per_block = kLnThreads / 32;
  ln_stats_kernel<T><<<(m + rows_per_block - 1) / rows_per_block, kLnThreads, 0, stream>>>(
      x, mean, inv, m, w, eps);
  return cudaGetLastError();
}

// one element; mean_t and inv_t are the statistics already rounded to T
template <typename T>
__device__ __forceinline__ float ln_apply(float x, float mean_t, float inv_t, float gamma,
                                          float beta) {
  float y = round_to<T>(__fsub_rn(x, mean_t));
  y = round_to<T>(__fmul_rn(y, inv_t));
  y = round_to<T>(__fmul_rn(y, gamma));
  return round_to<T>(__fadd_rn(y, beta));
}

// The LN vjp over g = d(LN(x)) (float32), one block per kLnBwdRows rows. First one warp per
// row: the two row means, then dx = inv * (g gamma - mean(g gamma) - xhat mean(g gamma xhat))
// in f32 with xhat = (x32 - mean) * inv, plus dy with `residual`, rounded once. Then one
// thread per column: the block's partial dgamma = sum(g xhat) and dbeta = sum(g), summed over
// its rows in order, and with `dy_part` the partial column sum of dy as well. gamma is of
// type TG: the compute dtype for block attention, float32 for the MLP branch.
constexpr int kLnBwdRows = 32;

template <typename T, typename TG>
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ g,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const TG* __restrict__ gamma, T* __restrict__ dx, float* __restrict__ dg_part,
              float* __restrict__ db_part, float* __restrict__ dy_part, int residual, int m,
              int w) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kLnBwdRows;
  const int rows = min(kLnBwdRows, m - r0);

  for (int r = warp; r < rows; r += kLnThreads / 32) {
    const size_t at = (size_t)(r0 + r) * w;
    const float mu = mean[r0 + r], iv = inv[r0 + r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 4; c < w; c += 128) {
      float xv[4], gv[4], gm[4];
      load4(x + at + c, xv);
      load4(g + at + c, gv);
      load4(gamma + c, gm);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(xv[i], mu), iv);
        const float dxhat = __fmul_rn(gv[i], gm[i]);
        s1 += dxhat;
        s2 = fmaf(dxhat, xhat, s2);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / (float)w, m2 = s2 / (float)w;
    for (int c = lane * 4; c < w; c += 128) {
      float xv[4], gv[4], gm[4], out[4], dyv[4] = {0.f, 0.f, 0.f, 0.f};
      load4(x + at + c, xv);
      load4(g + at + c, gv);
      load4(gamma + c, gm);
      if (residual) load4(dy + at + c, dyv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(xv[i], mu), iv);
        const float dxhat = __fmul_rn(gv[i], gm[i]);
        out[i] = __fmul_rn(iv, __fsub_rn(__fsub_rn(dxhat, m1), __fmul_rn(xhat, m2)));
        if (residual) out[i] = __fadd_rn(out[i], dyv[i]);
      }
      store4(dx + at + c, out);
    }
  }

  for (int c = tid; c < w; c += kLnThreads) {
    float dg = 0.f, db = 0.f, dys = 0.f;
    for (int r = 0; r < rows; ++r) {
      const size_t at = (size_t)(r0 + r) * w + c;
      const float gv = g[at];
      const float xhat = __fmul_rn(__fsub_rn(to_float(x[at]), mean[r0 + r]), inv[r0 + r]);
      dg = fmaf(gv, xhat, dg);
      db += gv;
      if (dy_part != nullptr) dys += to_float(dy[at]);
    }
    dg_part[(size_t)blockIdx.x * w + c] = dg;
    db_part[(size_t)blockIdx.x * w + c] = db;
    if (dy_part != nullptr) dy_part[(size_t)blockIdx.x * w + c] = dys;
  }
}

// ----------------------------------------------------------------------------- projections
// C[z] = A @ B[z] + bias[z] for up to three weight sets sharing one A [M,K]; B [K,N] row
// major, C [M,N] row major. Requires N % 128 == 0 and K % 16 == 0 (W % 128 == 0 in the
// caller); M is ragged and masked. With kLN, A is the pre-LN stream and every element is
// normalized as it enters shared memory (ln_apply with the row's saved statistics), so
// LN(A) never reaches device memory. With `residual` ([M,N], so N == K), the epilogue
// rounds A @ B + bias to T first and then adds the residual, rounding again.
constexpr int kBM = 128, kBN = 128, kBK = 16, kGemmThreads = 256;

struct GemmOperands {
  const void* b[3];
  const void* bias[3];
  void* c[3];
  const void* residual;  // null, or [M,N] of T added in the epilogue
  const float* ln_mean;  // kLN only: [M] row means and rsqrt(var + eps), f32
  const float* ln_inv;
  const void* ln_gamma;  // kLN only: [K] of T
  const void* ln_beta;
};

template <typename T, bool kLN>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const T* __restrict__ a, GemmOperands ops, int m, int n, int k) {
  const T* __restrict__ b = static_cast<const T*>(ops.b[blockIdx.z]);
  const T* __restrict__ bias = static_cast<const T*>(ops.bias[blockIdx.z]);
  T* __restrict__ c = static_cast<T*>(ops.c[blockIdx.z]);
  const T* __restrict__ res = static_cast<const T*>(ops.residual);

  __shared__ float as[kBK][kBM];  // A tile, transposed: as[kk][row]
  __shared__ float bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // kLN: the statistics of this thread's two A rows, rounded to T as _ln_rows casts them
  float mean_t[2] = {0.f, 0.f}, inv_t[2] = {0.f, 0.f};
  if constexpr (kLN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + (tid + h * kGemmThreads) / 4;
      if (row < m) {
        mean_t[h] = round_to<T>(ops.ln_mean[row]);
        inv_t[h] = round_to<T>(ops.ln_inv[row]);
      }
    }
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A: 128 rows x 16 cols, two groups of 4 per thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * kGemmThreads;  // 0..511
      const int row = e / 4, col = (e % 4) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 + row < m) {
        load4(a + (size_t)(m0 + row) * k + k0 + col, v);
        if constexpr (kLN) {
          float g[4], bt[4];
          load4(static_cast<const T*>(ops.ln_gamma) + k0 + col, g);
          load4(static_cast<const T*>(ops.ln_beta) + k0 + col, bt);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = ln_apply<T>(v[i], mean_t[h], inv_t[h], g[i], bt[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) as[col + i][row] = v[i];
    }
    // B: 16 rows x 128 cols, two groups of 4 per thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * kGemmThreads;
      const int row = e / 32, col = (e % 32) * 4;
      float v[4];
      load4(b + (size_t)(k0 + row) * n + n0 + col, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) bs[row][col + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      // rows {ty*4..+3, 64+ty*4..+3}, cols {tx*4..+3, 64+tx*4..+3}: conflict-free float4 reads
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

  // epilogue: + bias in f32, one rounding to T; then + residual, rounded again
  float bv[8];
  load4(bias + n0 + tx * 4, bv);
  load4(bias + n0 + 64 + tx * 4, bv + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m) continue;
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = acc[i][j] + bv[j];
      hi[j] = acc[i][4 + j] + bv[4 + j];
    }
    if (res != nullptr) {
      float rl[4], rh[4];
      load4(res + (size_t)row * n + n0 + tx * 4, rl);
      load4(res + (size_t)row * n + n0 + 64 + tx * 4, rh);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = __fadd_rn(round_to<T>(lo[j]), rl[j]);
        hi[j] = __fadd_rn(round_to<T>(hi[j]), rh[j]);
      }
    }
    store4(c + (size_t)row * n + n0 + tx * 4, lo);
    store4(c + (size_t)row * n + n0 + 64 + tx * 4, hi);
  }
}

// q, k and v as three weight sets of one launch (gridDim.z = 3) into a [3, M, W] scratch
template <typename T>
GemmOperands qkv_operands(const void* const* wts, const void* const* biases, void* qkv,
                          size_t plane) {
  GemmOperands ops = {};
  for (int z = 0; z < 3; ++z) {
    ops.b[z] = wts[z];
    ops.bias[z] = biases[z];
    ops.c[z] = static_cast<T*>(qkv) + z * plane;
  }
  return ops;
}

}  // namespace
