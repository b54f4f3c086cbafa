// Shared pieces of the kernels (block_attention_fwd.cu, block_attention_bwd.cu,
// fused_attention.cu, block_mlp.cu): dtype conversions, 4-wide loads and stores, the row-wise
// LayerNorm (f32 statistics, compute-dtype arithmetic) with the row kernel of its vjp. The
// block kernels' projection GEMM is mma_gemm.cuh. Everything lives in an anonymous namespace, so
// each source that includes it gets its own copy and the objects link into one library.

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

// dynamic shared memory above the default 48 KB must be allowed per kernel before a launch
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

}  // namespace
