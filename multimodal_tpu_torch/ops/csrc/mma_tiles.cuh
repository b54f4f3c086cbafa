// Warp-level tensor-core pieces of the bfloat16 attention passes (attention_passes.cuh), with
// the 16-byte asynchronous copies and ldmatrix loads that the float32 flash kernels
// (flash_attention.cu) and projection GEMM (mma_gemm.cuh) share: copies into shared memory,
// ldmatrix fragment loads and the mma.sync.m16n8k16 product (bf16 operands, f32 accumulation).
//
// A block of four warps owns a 64-row tile; warp w owns its rows 16w..16w+15. Tiles sit in
// shared memory as bf16, row-major, with a row stride of kDP + 8 elements, where kDP is the
// head dim rounded up to 64 or 128: the stride is an odd multiple of 16 bytes, so the eight
// row addresses of one ldmatrix 8x8 block fall into eight different 16-byte bank groups and
// the loads are free of bank conflicts without a swizzle. Within a warp, lane = 4 g + t:
//   A fragment (16 x 16, four registers): rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9
//   B fragment (16 x 8, two registers):   k = 2t, 2t+1 and 2t+8, 2t+9, column g
//   C fragment (16 x 8, four floats):     rows g and g+8, columns 2t, 2t+1
// so two neighbouring C fragments, packed to bf16 pairs, are the A fragment of the next
// product: probabilities never pass through shared memory.

#pragma once

#include "block_attention_common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device memory to shared memory without passing through registers;
// when `live` is false nothing is read and zeros are written
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most kPending of this thread's committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a @ b: a 16x16 (row), b 16x8 (col), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// `nrows` rows of a head's d columns from src (row stride `stride` elements) into dst
// [nrows][kDP + 8]: 16-byte asynchronous copies of 8 elements; rows at or past `live_rows` and
// the columns from d up to d16 (d rounded up to a k-step of 16) are zero-filled, columns past
// d16 are never read and not touched. The caller commits the group.
template <int kDP>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                size_t stride, int nrows, int live_rows, int d,
                                                int d16) {
  constexpr int kChunks = kDP / 8, kLd = kDP + 8;  // kChunks is a power of two: shifts below
  for (int e = threadIdx.x; e < nrows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    if (c >= d16) continue;
    const bool live = r < live_rows && c < d;
    cp_async16(dst + r * kLd + c, live ? src + (size_t)r * stride + c : src, live);
  }
}

// the A fragment of rows row0..row0+15, columns col0..col0+15 of a tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                       int row0, int col0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (row0 + (j & 1) * 8 + r) * ld + col0 + (j >> 1) * 8);
}

// acc[n] += a @ tile[8n..8n+7][col0..col0+15]^T for the n-tiles below `live`: the contraction
// runs over 16 columns of the tile and output column 8n+c is tile row 8n+c. Tiles are taken
// in pairs, so an odd `live` computes one tile more, from rows that hold data or zeros.
template <int kNT>
__device__ __forceinline__ void mma_rows(float (&acc)[kNT][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int ld, int col0, int live,
                                         int lane) {
  const int j = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = tile + ((j >> 1) * 8 + r) * ld + col0 + (j & 1) * 8;
#pragma unroll
  for (int n = 0; n < kNT; n += 2) {
    if (n < live) {
      uint32_t b[4];
      ldsm_x4(b, p + n * 8 * ld);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += a @ tile[row0..row0+15][8n..8n+7] for the n-tiles whose first column is below
// `ncols`: the contraction runs over 16 rows of the tile (loaded transposed) and output column
// 8n+c is tile column 8n+c. Pairs again: columns up to ncols rounded up to 16 must hold data
// or zeros.
template <int kNT>
__device__ __forceinline__ void mma_cols(float (&acc)[kNT][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int ld, int row0, int ncols,
                                         int lane) {
  const int j = lane >> 3, r = lane & 7;
  const __nv_bfloat16* p = tile + (row0 + (j & 1) * 8 + r) * ld + (j >> 1) * 8;
#pragma unroll
  for (int n = 0; n < kNT; n += 2) {
    if (n * 8 < ncols) {
      uint32_t b[4];
      ldsm_x4_trans(b, p + n * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// the A fragment of key (or query) step kk of the next product from a [.][4] tile of C
// fragments: columns 16kk..16kk+15 are C tiles 2kk and 2kk+1
template <int kNT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[kNT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// a warp's [16][d] accumulator to out (row stride `stride`), rows at or past `rows` and
// columns at or past d skipped; each value is multiplied in f32 by its row's factor (mul[0]
// for row g, mul[1] for row g + 8) and rounded once
template <int kNT>
__device__ __forceinline__ void store_c(__nv_bfloat16* out, size_t stride, int row0, int rows,
                                        int d, const float (&mul)[2], const float (&acc)[kNT][4],
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n * 8 >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * stride + n * 8 + 2 * t) =
            __floats2bfloat162_rn(__fmul_rn(acc[n][2 * h], mul[h]),
                                  __fmul_rn(acc[n][2 * h + 1], mul[h]));
    }
  }
}

template <int kN>
__device__ __forceinline__ void zero_acc(float (&acc)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// sum (or max) over the four lanes that share a row of a C fragment
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

}  // namespace
