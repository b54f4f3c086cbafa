// Register-tiled products on the CUDA cores of the float32 attention passes
// (attention_passes.cuh). A block of 256 threads works on 64-row tiles held as floats in shared
// memory: thread (ty, tx) of a 16 x 16 grid owns a 4x4 tile of a [64][64] logits product (rows
// ty*4+i, columns tx+16*j) and a 4 x D/16 tile of a [64][D] accumulator (rows ty*4+i, four
// neighbouring columns in every group of 64), and reads its operands as float4, so one
// shared-memory load feeds 4 to 16 FMAs. Products are true float32: no tensor core, no TF32.

#pragma once

#include "block_attention_common.cuh"

namespace {

constexpr int kTile = 64;          // query rows and key rows per tile
constexpr int kTileThreads = 256;  // 16 x 16: thread (ty, tx) = (threadIdx.x / 16, % 16)
constexpr int kPLd = kTile + 4;    // row stride of a [kTile][kTile] probability tile

// rows x d floats from src (row stride `stride` elements) into dst [kTile][ld], rows at or past
// `rows` zero-filled. d % 4 == 0 and ld % 4 == 0.
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t stride, int rows,
                                          int d, int ld) {
  const int d4 = d / 4;
  for (int e = threadIdx.x; e < kTile * d4; e += kTileThreads) {
    const int r = e / d4, c = (e - r * d4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) load4(src + (size_t)r * stride + c, v);
    *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// s[i][j] = sum_c a[ty*4+i][c] * b[tx+16*j][c] over c < d, a and b [kTile][ld] in shared memory.
// Only the column groups j < jlive are formed (a ragged last tile has fewer than four); the
// others stay 0.
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int d, int ld, int ty,
                                         int tx, float s[4][4], int jlive = 4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* ar = a + ty * 4 * ld;
  const float* br = b + tx * ld;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(ar + i * ld + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < jlive) bv[j] = *reinterpret_cast<const float4*>(br + 16 * j * ld + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < jlive) {
          s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
          s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
          s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
          s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
        }
  }
}

// first of the four neighbouring accumulator columns thread tx owns in 64-column group g
__device__ __forceinline__ int own_col(int tx, int g) { return g * 64 + tx * 4; }

__device__ __forceinline__ void fma4(float acc[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][4*g+e] += sum_c p[ty*4+i][c] * b[c][own_col(tx, g)+e] over the tile's first `clive`
// rows c of b (rounded up to 4; a full tile by default), in rising order; p [kTile][kPLd], b
// [kTile][ld]; column groups at or past d are left alone (d % 4 == 0).
template <int kDC>
__device__ __forceinline__ void tile_accumulate(const float* p, const float* b, int d, int ld,
                                                int ty, int tx, float acc[4][kDC],
                                                int clive = kTile) {
  const float* pr = p + ty * 4 * kPLd;
#pragma unroll 2
  for (int c = 0; c < clive; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(pr + i * kPLd + c);
#pragma unroll
    for (int g = 0; g < kDC / 4; ++g) {
      const int col = own_col(tx, g);
      if (col < d) {
        const float4 b0 = *reinterpret_cast<const float4*>(b + c * ld + col);
        const float4 b1 = *reinterpret_cast<const float4*>(b + (c + 1) * ld + col);
        const float4 b2 = *reinterpret_cast<const float4*>(b + (c + 2) * ld + col);
        const float4 b3 = *reinterpret_cast<const float4*>(b + (c + 3) * ld + col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma4(acc[i] + 4 * g, pv[i].x, b0);
          fma4(acc[i] + 4 * g, pv[i].y, b1);
          fma4(acc[i] + 4 * g, pv[i].z, b2);
          fma4(acc[i] + 4 * g, pv[i].w, b3);
        }
      }
    }
  }
}

// The transposed product: acc[i][4*g+e] += sum_r p[r][ty*4+i] * b[r][own_col(tx, g)+e] over
// the tile's first `rlive` rows r, in rising order; p [kTile][kPLd], b [kTile][ld].
template <int kDC>
__device__ __forceinline__ void tile_accumulate_t(const float* p, const float* b, int d, int ld,
                                                  int ty, int tx, float acc[4][kDC], int rlive) {
#pragma unroll 2
  for (int r = 0; r < rlive; ++r) {
    const float4 p4 = *reinterpret_cast<const float4*>(p + r * kPLd + ty * 4);
#pragma unroll
    for (int g = 0; g < kDC / 4; ++g) {
      const int col = own_col(tx, g);
      if (col < d) {
        const float4 bv = *reinterpret_cast<const float4*>(b + r * ld + col);
        fma4(acc[0] + 4 * g, p4.x, bv);
        fma4(acc[1] + 4 * g, p4.y, bv);
        fma4(acc[2] + 4 * g, p4.z, bv);
        fma4(acc[3] + 4 * g, p4.w, bv);
      }
    }
  }
}

// acc[i][4*g+e] of a thread's accumulator to out[(ty*4+i) * stride + own_col(tx, g)+e]; rows at
// or past `rows` and column groups at or past d are skipped
template <int kDC>
__device__ __forceinline__ void store_rows(float* out, size_t stride, int rows, int d, int ty,
                                           int tx, const float acc[4][kDC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int g = 0; g < kDC / 4; ++g) {
      const int col = own_col(tx, g);
      if (col < d) store4(out + (size_t)r * stride + col, acc[i] + 4 * g);
    }
  }
}

// reductions over the 16 threads (one half-warp) that share a query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
