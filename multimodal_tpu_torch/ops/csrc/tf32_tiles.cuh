// Warp-level tensor-core pieces of the float32 flash kernels (flash_attention.cu) and
// projection GEMM (mma_gemm.cuh): float32 products to about float32 accuracy as three TF32
// products on mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 ("3xTF32"), with f32 tiles
// in shared memory filled by 16-byte cp.async.
//
// The split. Every float32 operand x becomes big = rna_tf32(x) (10 explicit mantissa bits,
// round to nearest, ties away: cvt.rna.tf32.f32's rounding) and small = x - big, exact in
// float32 and at most 2^-11 |x|; the tensor core reads a TF32 operand's top 19 bits, so small
// enters the product truncated, within 2^-21 |x|. Then a b ~ small_a big_b + big_a small_b +
// big_a big_b, summed in f32 in that order (the small terms first), to about 2^-20 relative:
// the size of the summation-order differences the float32 kernels are allowed (1e-4 x
// max|plain| on the card). A single TF32 product (2^-11 a factor) is not: the logits carry its
// error into exp. Each fragment value is split once where it is loaded into registers and then
// feeds all three products. The rounding of big is two integer operations on the bits (add
// half an ulp of TF32, clear the 13 dropped bits): cvt.rna.tf32.f32 for big and small gives
// the same error and was slower (PERF.md).
//
// Fragment layouts of m16n8k8 .tf32 (lane = 4 g + t):
//   A (16 x 8, four registers): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, two registers):   b0 (k = t, column g), b1 (k = t+4, column g)
//   C (16 x 8, four floats):    c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//
// From C to A without a shuffle. The second product of each flash kernel (p v, ds k, p^T do, ds^T
// q) takes the first one's C fragments as its A operand, whose lane holds columns 2t and 2t+1 where
// A wants t and t+4. The contraction index of a product may be permuted at will as long as A and B
// are permuted alike, so k-step j of such a product takes the eight keys (or query rows) of C tile
// j in the order 0, 2, 4, 6, 1, 3, 5, 7: C's (g, 2t) and (g, 2t+1) are then A's (g, t) and (g, t+4)
// as they stand, and the B fragment reads tile rows 8j + 2t and 8j + 2t + 1. The two __shfl_sync a
// value (or a round trip through shared memory) that the natural order needs are not spent at all.
//
// Tiles sit in shared memory as floats, row-major, with a row stride of kDP + 4 floats, where
// kDP is the head dim rounded up to 64 or 128 (68 or 132: 4 mod 32 banks, an odd multiple of
// 16 bytes). Then every fragment read is free of bank conflicts: ldmatrix reads eight 16-byte
// rows in eight different bank groups (an A fragment, or B fragments whose tile rows are the
// output columns, are 8 x 4 blocks of 32-bit values, which ldmatrix moves as 8 x 8 blocks of
// b16 without .trans); the 32-bit reads of the permuted B above hit bank (8t + g) mod 32.
// ldmatrix .trans moves 16-bit elements, so it cannot serve a B fragment whose tile rows are
// the contraction index.

#pragma once

#include "mma_tiles.cuh"

namespace {

// x rounded to TF32 (finite x), as the b32 register an mma takes: its low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small as two mma operands (the header note)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int kN>
__device__ __forceinline__ void split_frag(const uint32_t (&raw)[kN], uint32_t (&big)[kN],
                                           uint32_t (&small)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) split_tf32(__uint_as_float(raw[i]), big[i], small[i]);
}

// c += a @ b: a 16x8 (row), b 8x8 (col), TF32 operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one of the three products of 3xTF32 into c: round 0 small_a big_b, 1 big_a small_b, 2 big_a
// big_b. Each accumulator takes them in that order (the small terms first), in three rounds
// over all the accumulators of a fragment step, so that no mma waits on the one before it.
__device__ __forceinline__ void mma_round(float (&c)[4], int round, const uint32_t (&a_big)[4],
                                          const uint32_t (&a_small)[4], uint32_t b0_big,
                                          uint32_t b1_big, uint32_t b0_small, uint32_t b1_small) {
  if (round == 0)
    mma_tf32(c, a_small, b0_big, b1_big);
  else if (round == 1)
    mma_tf32(c, a_big, b0_small, b1_small);
  else
    mma_tf32(c, a_big, b0_big, b1_big);
}

// `nrows` rows of a head's d floats from src (row stride `stride` elements) into dst
// [nrows][kDP + 4] by 16-byte asynchronous copies; rows at or past `live_rows` are zero-filled,
// columns at or past d (a multiple of 8) are never read and not touched. The caller commits.
template <int kDP>
__device__ __forceinline__ void load_tile_async_f32(float* dst, const float* src, size_t stride,
                                                    int nrows, int live_rows, int d) {
  constexpr int kChunks = kDP / 4, kLd = kDP + 4;
  for (int e = threadIdx.x; e < nrows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    if (c >= d) continue;
    const bool live = r < live_rows;
    cp_async16(dst + r * kLd + c, live ? src + (size_t)r * stride + c : src, live);
  }
}

// the A fragment (raw f32 bits) of rows row0..row0+15, columns col0..col0+7 of a float tile
__device__ __forceinline__ void load_a_f32(uint32_t (&a)[4], const float* tile, int ld, int row0,
                                           int col0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  ldsm_x4(a, tile + (row0 + (j & 1) * 8 + r) * ld + col0 + (j >> 1) * 4);
}

// acc[m][n] += a[m] @ tile[8n..8n+7][col0..col0+7]^T for the warp's kM m-tiles of 16 rows and
// the n-tiles below `live`, from split A fragments: output column 8n+c is tile row 8n+c. Each
// B fragment is loaded and split once for all kM m-tiles. Pairs, as mma_rows: an odd `live`
// computes one tile more, from rows that hold data or zeros.
template <int kM, int kNT>
__device__ __forceinline__ void mma_rows_3xtf32(float (&acc)[kM][kNT][4],
                                                const uint32_t (&a_big)[kM][4],
                                                const uint32_t (&a_small)[kM][4],
                                                const float* tile, int ld, int col0, int live,
                                                int lane) {
  const int j = lane >> 3, r = lane & 7;
  const float* p = tile + ((j >> 1) * 8 + r) * ld + col0 + (j & 1) * 4;
#pragma unroll
  for (int n = 0; n < kNT; n += 2) {
    if (n < live) {
      uint32_t b[4], big[4], small[4];
      ldsm_x4(b, p + n * 8 * ld);
      split_frag(b, big, small);
#pragma unroll
      for (int round = 0; round < 3; ++round)
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_round(acc[m][n], round, a_big[m], a_small[m], big[0], big[1], small[0], small[1]);
          mma_round(acc[m][n + 1], round, a_big[m], a_small[m], big[2], big[3], small[2],
                    small[3]);
        }
    }
  }
}

// acc[m][n] += c[m] @ tile[.][8n..8n+7] over the tile's rows below `nrows` (rounded up to 8),
// for the column n-tiles below d: c, the warp's kM x [16][8 kNT] values in C fragments, is the
// A operand with the contraction order of the header note (k-step j: tile rows 8j + 2t and
// 8j + 2t + 1); each B fragment is loaded and split once for all kM m-tiles. The n-tiles go in
// pairs: where d / 8 is odd the last pair's second tile reads columns past d, which hold no
// data, into accumulator columns that are never stored.
template <int kDN, int kM, int kNT>
__device__ __forceinline__ void accumulate_rows_3xtf32(float (&acc)[kM][kDN][4],
                                                       const float (&c)[kM][kNT][4],
                                                       const float* tile, int ld, int nrows, int d,
                                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    if (j * 8 < nrows) {
      uint32_t a_big[kM][4], a_small[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        split_tf32(c[m][j][0], a_big[m][0], a_small[m][0]);  // (g, 2t)     as A's (g, t)
        split_tf32(c[m][j][2], a_big[m][1], a_small[m][1]);  // (g + 8, 2t) as (g + 8, t)
        split_tf32(c[m][j][1], a_big[m][2], a_small[m][2]);  // (g, 2t + 1) as (g, t + 4)
        split_tf32(c[m][j][3], a_big[m][3], a_small[m][3]);  // (g + 8, 2t + 1)
      }
      const float* p = tile + (8 * j + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < kDN; n += 2)  // n-tiles in pairs (see the note above)
        if (n * 8 < d) {
          uint32_t big[2][2], small[2][2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            split_tf32(p[(n + u) * 8], big[u][0], small[u][0]);
            split_tf32(p[ld + (n + u) * 8], big[u][1], small[u][1]);
          }
#pragma unroll
          for (int round = 0; round < 3; ++round)
#pragma unroll
            for (int m = 0; m < kM; ++m)
#pragma unroll
              for (int u = 0; u < 2; ++u)
                mma_round(acc[m][n + u], round, a_big[m], a_small[m], big[u][0], big[u][1],
                          small[u][0], small[u][1]);
        }
    }
}

// a warp's [16][d] float accumulator to out (row stride `stride`), rows at or past `rows` and
// columns at or past d skipped, each value times its row's factor (mul[0] for row g, mul[1] for
// g + 8): the float32 counterpart of store_c
template <int kNT>
__device__ __forceinline__ void store_c(float* out, size_t stride, int row0, int rows, int d,
                                        const float (&mul)[2], const float (&acc)[kNT][4],
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    if (n * 8 >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < rows)
        *reinterpret_cast<float2*>(out + (size_t)row * stride + n * 8 + 2 * t) =
            make_float2(__fmul_rn(acc[n][2 * h], mul[h]), __fmul_rn(acc[n][2 * h + 1], mul[h]));
    }
  }
}

}  // namespace
