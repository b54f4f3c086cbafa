// Shared pieces of the block-attention kernels (block_attention_fwd.cu and
// block_attention_bwd.cu): dtype conversions, 4-wide loads and stores, the projection GEMM
// with bias (C = A @ B + bias, f32 accumulation, one rounding) and the tile sizes of the
// attention kernels. Everything lives in an anonymous namespace, so each source that
// includes it gets its own copy and the two objects link into one library.

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

// ----------------------------------------------------------------------------- projections
// C[z] = A @ B[z] + bias[z] for up to three weight sets sharing one A [M,K]; B [K,N] row
// major, C [M,N] row major. Requires N % 128 == 0 and K % 16 == 0 (W % 128 == 0 in the
// caller); M is ragged and masked.
constexpr int kBM = 128, kBN = 128, kBK = 16, kGemmThreads = 256;

struct GemmOperands {
  const void* b[3];
  const void* bias[3];
  void* c[3];
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const T* __restrict__ a, GemmOperands ops, int m, int n, int k) {
  const T* __restrict__ b = static_cast<const T*>(ops.b[blockIdx.z]);
  const T* __restrict__ bias = static_cast<const T*>(ops.bias[blockIdx.z]);
  T* __restrict__ c = static_cast<T*>(ops.c[blockIdx.z]);

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

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A: 128 rows x 16 cols, two groups of 4 per thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * kGemmThreads;  // 0..511
      const int row = e / 4, col = (e % 4) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (m0 + row < m) load4(a + (size_t)(m0 + row) * k + k0 + col, v);
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

  // epilogue: + bias in f32, one rounding to T
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
    store4(c + (size_t)row * n + n0 + tx * 4, lo);
    store4(c + (size_t)row * n + n0 + 64 + tx * 4, hi);
  }
}

// attention tiles: 16 query rows per block, keys and values streamed in 32-row chunks
constexpr int kBQ = 16, kChunk = 32, kAttnThreads = 128;

}  // namespace
