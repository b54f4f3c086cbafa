// The pieces shared by the bfloat16 attention kernels that run wgmma fed by TMA:
// flash_attention.cu's forward, dQ and dK/dV (flash_*_kernel<WgmmaOps>) and fused_attention.cu's
// forward, dQ and dK/dV (fused_*_kernel, which the block-attention kernels' attention half runs
// too).
//
//   * the block: two consumer warpgroups of 64 rows and one producer warp, 288 threads, one
//     block an SM; a release of a ring stage is one arrival from each consumer warp;
//   * the tiles: TMA boxes of 64 columns (128 bytes, one swizzle atom) x rows of one (head,
//     batch) of a 4-D tensor map over a [B, S, H, D] tensor (or any row stride), in the
//     128-byte swizzle wgmma reads; a head dim above 64 is two boxes side by side, each a
//     [rows][64] sub-tile of its own; zeros land past D and past S;
//   * the descriptors of such a tile as a K-major or an MN-major operand, with a compile-time
//     offset for each k-step;
//   * the forward's mask on unscaled logits and its online-softmax step with sm_scale folded
//     into the exponent.
//
// Like the other headers this one lives in an anonymous namespace: each source that includes
// it gets its own copy.

#pragma once

#include "attention_passes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 2 * kWgThreads + 32;  // two consumer warpgroups, a producer warp
constexpr int kConsumerWarps = 8;                    // arrivals that release a stage
constexpr int kRowBytes = 128;                       // a sub-tile's row: 64 bf16

// Descriptors: one per tile, and a compile-time offset (in the descriptor's 16-byte units) for
// each k-step, so that no descriptor is rebuilt in the loops (the address field cannot carry:
// shared memory ends below 2^18 bytes).
// A K-major operand (rows of M or N, the head dim along a row) of a [kParts][rows][64] tile,
// from row `row0`; k-step kk is columns 16kk..16kk+15, in part kk / 4
__device__ __forceinline__ uint64_t k_major(const unsigned char* tile, int row0) {
  return sw128_desc(tile + row0 * kRowBytes);
}
template <int kRows>
__device__ __forceinline__ constexpr uint64_t k_step(int kk) {
  return ((kk / 4) * kRows * kRowBytes + (kk % 4) * 32) >> 4;
}
// An MN-major operand (rows along the contraction) of a [kParts][rows][64] tile, its 64-column
// parts kRows rows apart; k-step kk is rows 16kk..16kk+15
template <int kRows>
__device__ __forceinline__ uint64_t mn_major(const unsigned char* tile) {
  return sw128_desc(tile, kRows * kRowBytes, 8 * kRowBytes);
}
__device__ __forceinline__ constexpr uint64_t mn_step(int kk) { return (kk * 16 * kRowBytes) >> 4; }

// The forward's logits stay unscaled, t = q k^T: a masked entry (key >= kmax, or under the
// causal mask key > row; row_g is the sequence row of c[.][0], key_t the key of c[0][0]) takes
// the finite -1e30
template <int kNT>
__device__ __forceinline__ void mask_logits(float (&sf)[kNT][4], int row_g, int key_t, int kmax,
                                            int causal) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key_t + 8 * n + (e & 1), row = row_g + 8 * (e >> 1);
      if (!(key < kmax && (!causal || key <= row))) sf[n][e] = kNegInf;
    }
}

// One online-softmax step on unscaled logits t for the warp's rows g and g + 8, sm_scale folded
// into the exponent: p = 2^(t c - m c) with c = sm_scale log2(e) and m the running max of t,
// which is exp(s - max s) for s = t sm_scale (sm_scale > 0 keeps the max in place; the one
// rounding of t sm_scale is gone, a difference of about one float32 ulp in the exponent).
// alpha[h] is the factor the sums kept so far take; l, a per-lane partial of the sum of the
// unrounded p, takes it here. A masked t (-1e30) gives p = 0, as does the first tile's rescale.
template <int kNT>
__device__ __forceinline__ void online_softmax_scaled(float (&sf)[kNT][4], float (&m)[2],
                                                      float (&l)[2], float (&alpha)[2], float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < kNT; ++n) mx = fmaxf(mx, fmaxf(sf[n][2 * h], sf[n][2 * h + 1]));
    const float m_new = fmaxf(m[h], quad_max(mx)), off = m_new * c;
    alpha[h] = ex2(fmaf(m[h], c, -off));
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sf[n][2 * h] = ex2(fmaf(sf[n][2 * h], c, -off));
      sf[n][2 * h + 1] = ex2(fmaf(sf[n][2 * h + 1], c, -off));
      sum += sf[n][2 * h] + sf[n][2 * h + 1];
    }
    l[h] = fmaf(l[h], alpha[h], sum);
    m[h] = m_new;
  }
}

// a bfloat16 tensor of `heads` heads of d columns a row, row stride `ld` elements, rows of one
// batch entry `s` rows apart ([B, S, heads, d] when ld = heads d), as a 4-D tensor map (d
// innermost), boxes of 64 columns x `rows` rows of one head and batch in the 128-byte swizzle;
// columns past d and rows past S land as zeros. TMA needs the base 16-byte aligned and ld a
// multiple of 8.
bool encode_heads(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b, int s,
                  int heads, int d, int rows, size_t ld) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = 2ull * ld;
  const cuuint64_t strides[3] = {2ull * d, row, row * s};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
