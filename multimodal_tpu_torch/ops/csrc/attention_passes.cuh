// The attention passes shared by the block-attention kernels (block_attention_fwd.cu,
// block_attention_bwd.cu) and the fused whole-sequence attention pair (fused_attention.cu):
// the forward core softmax(q k^T * scale) v, and the backward's dQ pass and dK/dV pass. All
// three read q, k and v through separate pointers with a row stride of `w` elements and the
// head's columns at head * d, so they serve both a [3, B*S, W] projection scratch and three
// packed [B, S, H*D] tensors. d is a multiple of 8 up to 128, w a multiple of 8 and every
// base pointer 16-byte aligned (the wrappers check). Like the common header this one lives
// in an anonymous namespace: each source that includes it gets its own copy.
//
// What the passes port: the attention halves of the Pallas TPU kernels
// multimodal_tpu/ops/block_attention.py:_fwd_kernel, _bwd_kernel and _bwd_kernel_large, and
// the whole of multimodal_tpu/ops/fused_attention.py:_fwd_kernel and _bwd_kernel. The
// backward passes are templated on kExactProbs, the one numeric difference between the two
// TPU backward kernels: the block backward forms rowsum(dp * p) and ds from the
// probabilities *rounded* to the compute dtype and widened again, and emits attnpre = p v;
// the fused backward forms them from the exact float32 probabilities, uses the rounded ones
// for dv only, and has no attnpre. In float32 the two agree; in bfloat16 they do not.
//
// What bounds them on the card: 4 B H S^2 D FLOPs forward and 10 backward over a handful of
// [B, S, H*D] tensors. At S=197, D=64 float32 is bound by operations (CUDA-core FMAs; a
// single TF32 product would break the 1e-4 limit the kernels are held to) and bfloat16 by
// bytes, with the tensor cores far from busy. So the design spends products to save memory
// traffic (the backward forms the logits three times) and keeps every operand tile in shared
// memory in its own dtype:
//
//   * A block owns 64 query rows of one (image, head) and walks the keys in tiles; no
//     [rows, S] buffer of logits exists any more, in shared or in device memory. The forward
//     is one sweep with an online softmax: a running row max m and sum of exp l, the
//     accumulator rescaled by exp(m_old - m_new) whenever m moves, one division by l at the
//     end. The dQ pass is two sweeps: that same online sweep, which also yields delta, then
//     one that forms p = exp(logit - m) / l, ds = round(p (dp - delta)) and dq += ds k. The
//     dK/dV pass owns 64 keys, streams the query rows once and rebuilds p and ds from three
//     saved f32 numbers per row (max, sum of exp, delta; `stats` is [3][B*H*S]). Every sum
//     has one owner and a fixed order, so no atomics and the same bits twice.
//   * Which rounding points moved. The plain versions round the *normalised* p before p v.
//     The online sweep rounds exp(logit - m) against the running max and normalises the f32
//     accumulator afterwards: each p carries the same relative rounding error (2^-9 in
//     bfloat16) at another point, and out and attnpre differ from the plain versions by single
//     bf16 steps (held to the same 2e-2 x max|plain| on the card). delta: in the fused form
//     (kExactProbs) the running sum of exp(logit - m) dp in f32, rescaled like l and divided
//     by l at the end, so it still sees the exact probabilities; in the block form rowsum(do *
//     attnpre) from attnpre's f32 accumulator, which equals rowsum(dp * p) for the rounded p
//     the accumulator was built from. ds and dv use p = exp(logit - m) / l from the final m
//     and l, rounded to the compute dtype (dv always; ds in the block form only), exactly as
//     the plain versions do. In float32 rounding p is the identity and all of this is a matter
//     of summation order.
//   * bfloat16 (the *_mma_kernel family): products on the tensor cores by mma.sync m16n8k16
//     with f32 accumulation, which is the TPU kernel's own arithmetic. Four warps of 16 rows;
//     Q (and dO) fragments stay in registers for the whole block; K and V tiles stream as
//     bf16 through two shared-memory stages filled by 16-byte cp.async, so the next tile
//     loads while this one multiplies; ldmatrix reads are conflict-free through the padded
//     row stride (mma_tiles.cuh). Probabilities go from accumulator to A operand in
//     registers. The dK/dV pass forms the transposed logits k q^T directly, so p^T and ds^T
//     come out in the accumulator layout and feed dv += p^T do and dk += ds^T q. exp(x - m)
//     / l is one FMA and one ex2 (the row's offset m log2(e) + log2(l) is formed once), and
//     only a tile that holds a masked entry pays for the mask tests. mma.sync rather than
//     wgmma: a head's problem is small, the same passes serve S=50 and S=77, and warp-level
//     fragments are what lets p skip shared memory.
//   * float32 (the *_f32_kernel family): 64 x 64 tiles, 256 threads, a 4x4 logits tile and a
//     4 x D/16 accumulator tile a thread, float4 shared-memory loads (register_tiles.cuh).
//     True float32 throughout; delta = rowsum(do * out) from the online sweep in both forms.
//   * Ragged shapes are masked in the loads (zero rows, zero columns from d to the next
//     multiple of 16) and in the logits (the finite -1e30 sentinel, col <= row under the
//     causal mask, so a fully masked tile contributes exactly 0); n-tiles, column groups and
//     k-steps past the last live key, warps without a live row and key tiles above the
//     diagonal are skipped.

#pragma once

#include <type_traits>

#include "mma_tiles.cuh"
#include "register_tiles.cuh"

namespace {

// =============================================================================== bfloat16
// Template parameter kDP: the head dim rounded up to 64 or 128 (fragment arrays and the
// shared-memory row stride are sized by it, steps past the true d are skipped at run time).
// The streamed tiles hold kKT = 32 rows: with 64 the logits' fragments push the backward
// passes past 128 registers a thread at D <= 64, three blocks an SM instead of four, and these
// passes are bound by latency, so the occupancy is worth more than the longer steps (measured:
// the backward is 1.26x faster at B=256 S=197). The launch bounds pin that budget: four blocks
// an SM up to D = 64, three above (at D = 128 the backward spills ~100 bytes a thread for it).

constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaRows = 64;      // rows of the tile a block owns, 16 a warp
constexpr int kKT = 32;           // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (about 2 ulp; -inf and anything below -126 give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) / l as one FMA and one ex2: off = m log2(e) + log2(l) (l = 1 while m still runs)
__device__ __forceinline__ float prob(float x, float off) { return ex2(fmaf(x, kLog2e, -off)); }

// The warp's logits of one tile times `scale`. With `edge` (the tile holds a key at or past
// kmax or, under the causal mask, past one of the warp's rows) the sentinel goes on every such
// entry; an inner tile skips the tests. row_g is the sequence row of c[.][0] (c[.][2] is
// row_g + 8), key_t the key of c[0][0].
template <int kNT>
__device__ __forceinline__ void scale_logits(float (&sf)[kNT][4], float scale, bool edge,
                                             int row_g, int key_t, int kmax, int causal) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_t + 8 * n + (e & 1), row = row_g + 8 * (e >> 1);
        const bool ok = key < kmax && (!causal || key <= row);
        sf[n][e] = ok ? __fmul_rn(sf[n][e], scale) : kNegInf;
      }
  } else {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sf[n][e] = __fmul_rn(sf[n][e], scale);
  }
}

// whether a tile of `tile_keys` keys at c0 needs the tests of scale_logits for a warp whose
// first row is `row`
__device__ __forceinline__ bool edge_tile(int c0, int tile_keys, int kmax, int row, int causal) {
  return c0 + tile_keys > kmax || (causal && c0 + tile_keys - 1 > row);
}

// One online-softmax step for the warp's rows g and g+8: the running max m is brought up to
// date with the tile's logits, which become exp(logit - m); alpha[h] = exp(m_old - m_new) is
// the factor every sum kept so far must take; l, a per-lane partial of the sum of exp (the
// four lanes of a row share m, so their partials add up at the end), takes it here.
template <int kNT>
__device__ __forceinline__ void online_softmax(float (&sf)[kNT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < kNT; ++n) mx = fmaxf(mx, fmaxf(sf[n][2 * h], sf[n][2 * h + 1]));
    const float m_new = fmaxf(m[h], quad_max(mx)), off = m_new * kLog2e;
    alpha[h] = prob(m[h], off);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sf[n][2 * h] = prob(sf[n][2 * h], off);
      sf[n][2 * h + 1] = prob(sf[n][2 * h + 1], off);
      sum += sf[n][2 * h] + sf[n][2 * h + 1];
    }
    l[h] = fmaf(l[h], alpha[h], sum);
    m[h] = m_new;
  }
}

// acc = a_frags @ tile^T over the head dim: the logits q k^T or dp = do v^T of one tile
template <int kDP, int kNT>
__device__ __forceinline__ void head_product(float (&acc)[kNT][4],
                                             const uint32_t (&af)[kDP / 16][4],
                                             const __nv_bfloat16* tile, int d16, int live,
                                             int lane) {
  zero_acc(acc);
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk)
    if (kk * 16 < d16) mma_rows<kNT>(acc, af[kk], tile, kDP + 8, kk * 16, live, lane);
}

template <int kDP>
__device__ __forceinline__ void load_a_frags(uint32_t (&af)[kDP / 16][4],
                                             const __nv_bfloat16* tile, int row0, int d16,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk)
    if (kk * 16 < d16) load_a(af[kk], tile, kDP + 8, row0, kk * 16, lane);
}

// acc[n] += c @ tile over the tile's rows (keys or query rows) below `nrows`: c, the warp's
// [16][8 kNT] values in C fragments (kNT = kKT / 8 in the passes), is rounded to bf16 as it is
// packed into A fragments
template <int kDN, int kNT>
__device__ __forceinline__ void accumulate_rows(float (&acc)[kDN][4], const float (&c)[kNT][4],
                                                const __nv_bfloat16* tile, int ld, int nrows,
                                                int d, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk)
    if (kk * 16 < nrows) {
      uint32_t a[4];
      pack_a<kNT>(a, c, kk);
      mma_cols<kDN>(acc, a, tile, ld, kk * 16, d, lane);
    }
}

template <int kN>
__device__ __forceinline__ void scale_acc(float (&acc)[kN][4], const float (&mul)[2]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= mul[e >> 1];
}

// ----------------------------------------------------------------------------- forward core
// One block per (64-row query tile, head, image), one sweep over the key tiles. Tile i + 1
// loads while tile i multiplies.
template <int kDP>
__global__ void __launch_bounds__(kMmaThreads, kDP <= 64 ? 4 : 3)
attention_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kmat,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int s,
                     int w, int d, float scale, int causal) {
  constexpr int kLd = kDP + 8, kNT = kKT / 8, kDN = kDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMmaRows][kLd]
  __nv_bfloat16* ks = qs + kMmaRows * kLd;                         // [2][kKT][kLd]
  __nv_bfloat16* vs = ks + 2 * kKT * kLd;                          // [2][kKT][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kMmaRows, head = blockIdx.y, img = blockIdx.z;
  const int rows = min(kMmaRows, s - r0), wrow = warp * 16;
  const int d16 = (d + 15) & ~15;
  const size_t base = (size_t)img * s * w + (size_t)head * d;  // element (img, 0, head*d)
  // causal: no row of this tile attends past its last row, no row of this warp past the warp's
  const int kmax = causal ? min(s, r0 + rows) : s;
  const int wmax = wrow >= rows ? 0 : (causal ? min(kmax, r0 + wrow + 16) : kmax);
  const int steps = (kmax + kKT - 1) / kKT;

  auto prefetch = [&](int step) {
    const int c0 = step * kKT, stage = step & 1;
    load_tile_async<kDP>(ks + stage * kKT * kLd, kmat + base + (size_t)c0 * w, w, kKT, s - c0, d,
                         d16);
    load_tile_async<kDP>(vs + stage * kKT * kLd, v + base + (size_t)c0 * w, w, kKT, s - c0, d,
                         d16);
    cp_async_commit();
  };
  load_tile_async<kDP>(qs, q + base + (size_t)r0 * w, w, kMmaRows, rows, d, d16);
  prefetch(0);  // q rides the first group

  uint32_t qf[kDP / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[kDN][4];
  zero_acc(acc);

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      prefetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step == 0) load_a_frags<kDP>(qf, qs, wrow, d16, lane);
    const int c0 = step * kKT, stage = step & 1;
    const int live = min(kNT, (wmax - c0 + 7) / 8);  // n-tiles with a key this warp can see
    if (live > 0) {
      float sf[kNT][4];
      head_product<kDP, kNT>(sf, qf, ks + stage * kKT * kLd, d16, live, lane);
      scale_logits<kNT>(sf, scale, edge_tile(c0, kKT, kmax, r0 + wrow, causal), r0 + wrow + g,
                        c0 + 2 * t, kmax, causal);
      online_softmax<kNT>(sf, m, l, alpha);
      scale_acc(acc, alpha);
      accumulate_rows<kDN>(acc, sf, vs + stage * kKT * kLd, kLd, wmax - c0, d, lane);
    }
    __syncthreads();  // this stage is free for the load of step + 2
  }
  const float inv[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  store_c<kDN>(out + base + (size_t)r0 * w, w, wrow, rows, d, inv, acc, lane);
}

// ----------------------------------------------------------------------------- dQ pass
// One block per (64-row query tile, head, image), two sweeps over the key tiles. Steps [0, nt)
// are the forward's online sweep, which also yields delta: in the fused form (kExactProbs) as
// the running sum of exp(logit - m) dp, rescaled like the sum of exp, so delta sees the exact
// f32 probabilities; in the block form as rowsum(do * attnpre) from attnpre's f32 accumulator.
// Steps [nt, 2nt) form ds and dq. Writes the row max, the row sum of exp and delta of every
// query row to `stats` for the dK/dV pass.
template <int kDP, bool kExactProbs>
__global__ void __launch_bounds__(kMmaThreads, kDP <= 64 ? 4 : 3)
attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kmat,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ attnpre, __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ stats, int s, int w, int d, float scale, int causal) {
  constexpr int kLd = kDP + 8, kNT = kKT / 8, kDN = kDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMmaRows][kLd]
  __nv_bfloat16* dos = qs + kMmaRows * kLd;                        // [kMmaRows][kLd]
  __nv_bfloat16* ks = dos + kMmaRows * kLd;                        // [2][kKT][kLd]
  __nv_bfloat16* vs = ks + 2 * kKT * kLd;                          // [2][kKT][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kMmaRows, head = blockIdx.y, img = blockIdx.z;
  const int rows = min(kMmaRows, s - r0), wrow = warp * 16;
  const int d16 = (d + 15) & ~15;
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const size_t plane = (size_t)gridDim.z * gridDim.y * s;
  float* st = stats + ((size_t)img * gridDim.y + head) * s + r0;
  const int kmax = causal ? min(s, r0 + rows) : s;
  const int wmax = wrow >= rows ? 0 : (causal ? min(kmax, r0 + wrow + 16) : kmax);
  const int nt = (kmax + kKT - 1) / kKT, steps = 2 * nt;

  auto prefetch = [&](int step) {
    const int c0 = (step < nt ? step : step - nt) * kKT, stage = step & 1;
    load_tile_async<kDP>(ks + stage * kKT * kLd, kmat + base + (size_t)c0 * w, w, kKT, s - c0, d,
                         d16);
    load_tile_async<kDP>(vs + stage * kKT * kLd, v + base + (size_t)c0 * w, w, kKT, s - c0, d,
                         d16);
    cp_async_commit();
  };
  load_tile_async<kDP>(qs, q + base + (size_t)r0 * w, w, kMmaRows, rows, d, d16);
  load_tile_async<kDP>(dos, dout + base + (size_t)r0 * w, w, kMmaRows, rows, d, d16);
  prefetch(0);

  uint32_t qf[kDP / 16][4], dof[kDP / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, off[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f}, alpha[2];
  float acc[kDN][4];  // attnpre in the first sweep (block form), dq in the second
  zero_acc(acc);

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      prefetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step == 0) {
      load_a_frags<kDP>(qf, qs, wrow, d16, lane);
      load_a_frags<kDP>(dof, dos, wrow, d16, lane);
    }
    if (step == nt) {  // between the sweeps: the row numbers are final
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = quad_sum(l[h]);
        inv[h] = 1.f / l[h];
        off[h] = fmaf(m[h], kLog2e, __log2f(l[h]));
      }
      if constexpr (!kExactProbs) {
        // delta = rowsum(do * attnpre), attnpre still in f32; do in the C fragment's layout
        delta[0] = delta[1] = 0.f;
#pragma unroll
        for (int n = 0; n < kDN; ++n)
          if (n * 8 < d) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 dov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  dos + (wrow + g + 8 * h) * kLd + n * 8 + 2 * t));
              delta[h] = fmaf(dov.x, acc[n][2 * h], delta[h]);
              delta[h] = fmaf(dov.y, acc[n][2 * h + 1], delta[h]);
            }
          }
        store_c<kDN>(attnpre + base + (size_t)r0 * w, w, wrow, rows, d, inv, acc, lane);
        zero_acc(acc);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        delta[h] = quad_sum(delta[h]) * inv[h];
        const int row = wrow + g + 8 * h;
        if (t == 0 && row < rows) {
          st[row] = m[h];
          st[plane + row] = l[h];
          st[2 * plane + row] = delta[h];
        }
      }
    }
    const int c0 = (step < nt ? step : step - nt) * kKT, stage = step & 1;
    const __nv_bfloat16* kt = ks + stage * kKT * kLd;
    const __nv_bfloat16* vt = vs + stage * kKT * kLd;
    const int live = min(kNT, (wmax - c0 + 7) / 8);
    if (live > 0) {
      float sf[kNT][4];
      head_product<kDP, kNT>(sf, qf, kt, d16, live, lane);
      scale_logits<kNT>(sf, scale, edge_tile(c0, kKT, kmax, r0 + wrow, causal), r0 + wrow + g,
                        c0 + 2 * t, kmax, causal);
      if (step < nt) {
        online_softmax<kNT>(sf, m, l, alpha);
        if constexpr (kExactProbs) {
          float dp[kNT][4];
          head_product<kDP, kNT>(dp, dof, vt, d16, live, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              sum = fmaf(sf[n][2 * h], dp[n][2 * h], sum);
              sum = fmaf(sf[n][2 * h + 1], dp[n][2 * h + 1], sum);
            }
            delta[h] = fmaf(delta[h], alpha[h], sum);
          }
        } else {
          scale_acc(acc, alpha);
          accumulate_rows<kDN>(acc, sf, vt, kLd, wmax - c0, d, lane);
        }
      } else {
        float dp[kNT][4];
        head_product<kDP, kNT>(dp, dof, vt, d16, live, lane);
        // sf becomes ds = p (dp - delta); masked entries are exactly 0. Packing rounds ds; only
        // the block form, whose ds sees the rounded p, rounds p here
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = prob(sf[n][e], off[e >> 1]);
            if (!kExactProbs) p = round_to<__nv_bfloat16>(p);
            sf[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], delta[e >> 1]));
          }
        accumulate_rows<kDN>(acc, sf, kt, kLd, wmax - c0, d, lane);
      }
    }
    __syncthreads();
  }
  const float mul[2] = {scale, scale};
  store_c<kDN>(dq + base + (size_t)r0 * w, w, wrow, rows, d, mul, acc, lane);
}

// ----------------------------------------------------------------------------- dK/dV pass
// One block per (64-key tile, head, image); warp w owns keys 16w..16w+15 and the query rows
// stream through in kKT-row tiles with their three saved numbers. The logits are formed
// transposed (k q^T, keys as rows), so p^T and ds^T are A operands as they stand. Under the
// causal mask a row before the tile's first key sees none of its keys (p = ds = 0 exactly),
// so the stream starts at that key.
template <int kDP, bool kExactProbs>
__global__ void __launch_bounds__(kMmaThreads, kDP <= 64 ? 4 : 3)
attn_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kmat,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s,
                        int w, int d, float scale, int causal) {
  constexpr int kLd = kDP + 8, kNT = kKT / 8, kDN = kDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMmaRows][kLd]
  __nv_bfloat16* vs = ks + kMmaRows * kLd;                         // [kMmaRows][kLd]
  __nv_bfloat16* qs = vs + kMmaRows * kLd;                         // [2][kKT][kLd]
  __nv_bfloat16* dos = qs + 2 * kKT * kLd;                         // [2][kKT][kLd]
  float* rst = reinterpret_cast<float*>(dos + 2 * kKT * kLd);      // [2][3][kKT] max, sum, delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kMmaRows, head = blockIdx.y, img = blockIdx.z;
  const int keys = min(kMmaRows, s - j0), wrow = warp * 16;
  const int d16 = (d + 15) & ~15;
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const size_t plane = (size_t)gridDim.z * gridDim.y * s;
  const float* st = stats + ((size_t)img * gridDim.y + head) * s;
  const int q_begin = causal ? j0 : 0;
  const int steps = (s - q_begin + kKT - 1) / kKT;

  auto prefetch = [&](int step) {
    const int q0 = q_begin + step * kKT, stage = step & 1;
    load_tile_async<kDP>(qs + stage * kKT * kLd, q + base + (size_t)q0 * w, w, kKT, s - q0, d,
                         d16);
    load_tile_async<kDP>(dos + stage * kKT * kLd, dout + base + (size_t)q0 * w, w, kKT, s - q0, d,
                         d16);
    for (int e = threadIdx.x; e < 3 * kKT; e += kMmaThreads) {
      const int which = e / kKT, r = e % kKT;
      const bool live = q0 + r < s;
      cp_async4(rst + (stage * 3 + which) * kKT + r, live ? st + which * plane + q0 + r : st, live);
    }
    cp_async_commit();
  };
  load_tile_async<kDP>(ks, kmat + base + (size_t)j0 * w, w, kMmaRows, keys, d, d16);
  load_tile_async<kDP>(vs, v + base + (size_t)j0 * w, w, kMmaRows, keys, d, d16);
  prefetch(0);

  float acc_k[kDN][4], acc_v[kDN][4];
  zero_acc(acc_k);
  zero_acc(acc_v);

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      prefetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_begin + step * kKT, stage = step & 1;
    const __nv_bfloat16* qt = qs + stage * kKT * kLd;
    const __nv_bfloat16* dot = dos + stage * kKT * kLd;
    const float* rs = rst + stage * 3 * kKT;
    const int live = wrow >= keys ? 0 : min(kNT, (s - q0 + 7) / 8);  // n-tiles with a query row
    if (live > 0) {
      float pt[kNT][4], dst[kNT][4];  // k q^T then p^T; v do^T then ds^T
      zero_acc(pt);
      zero_acc(dst);
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk)
        if (kk * 16 < d16) {
          uint32_t a[4];
          load_a(a, ks, kLd, wrow, kk * 16, lane);
          mma_rows<kNT>(pt, a, qt, kLd, kk * 16, live, lane);
          load_a(a, vs, kLd, wrow, kk * 16, lane);
          mma_rows<kNT>(dst, a, dot, kLd, kk * 16, live, lane);
        }
      // an inner tile (every key and row live, no key past a row) skips the tests
      const bool edge = q0 + kKT > s || j0 + wrow + 16 > s || (causal && j0 + wrow + 15 > q0);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = 8 * n + 2 * t;  // this lane's two query rows of the tile: c, c + 1
        const float2 mx = *reinterpret_cast<const float2*>(rs + c);
        const float2 sum = *reinterpret_cast<const float2*>(rs + kKT + c);
        const float2 dl = *reinterpret_cast<const float2*>(rs + 2 * kKT + c);
        const float off0 = fmaf(mx.x, kLog2e, __log2f(sum.x));
        const float off1 = fmaf(mx.y, kLog2e, __log2f(sum.y));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = prob(__fmul_rn(pt[n][e], scale), (e & 1) ? off1 : off0);
          if (edge) {
            const int key = j0 + wrow + g + 8 * (e >> 1), row = q0 + c + (e & 1);
            p = key < s && row < s && (!causal || key <= row) ? p : 0.f;
          }
          if (!kExactProbs) p = round_to<__nv_bfloat16>(p);
          pt[n][e] = p;  // packing rounds it
          dst[n][e] = __fmul_rn(p, __fsub_rn(dst[n][e], (e & 1) ? dl.y : dl.x));
        }
      }
      // dv += p^T do, dk += ds^T q over this tile's query rows
      accumulate_rows<kDN>(acc_v, pt, dot, kLd, s - q0, d, lane);
      accumulate_rows<kDN>(acc_k, dst, qt, kLd, s - q0, d, lane);
    }
    __syncthreads();
  }
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_c<kDN>(dk + base + (size_t)j0 * w, w, wrow, keys, d, mul_k, acc_k, lane);
  store_c<kDN>(dv + base + (size_t)j0 * w, w, wrow, keys, d, mul_v, acc_v, lane);
}

// =============================================================================== float32
// kDC: accumulator columns a thread owns (4 up to D=64, 8 up to D=128). The same two sweeps as
// in bfloat16: the forward is one online sweep, normalised at the end; the
// dQ pass runs it first, takes delta = rowsum(do * out) from it (equal to rowsum(dp * p) up to
// the order of the sums) and attnpre = out, then forms ds and dq. A warp whose eight rows all
// lie past the tile's last row does no arithmetic, and a ragged last key tile forms only its
// live column groups. The launch bounds pin the registers at D <= 64, where shared memory lets
// several blocks share an SM: three blocks for the forward (80 registers, ~50 bytes spilled),
// two for the backward passes (128 registers; left to itself the block form's dQ pass takes
// 180 and runs one block an SM, which costs the block backward 7% at S=197). Above D = 64
// shared memory allows one block anyway.

// A thread's 4x4 logits of one tile, scaled, with the sentinel on every key at or past kmax
// and, under the causal mask, past its row
__device__ __forceinline__ void scale_mask_f32(float sc[4][4], float scale, int row0, int col0,
                                               int kmax, int causal) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + i, col = col0 + 16 * j;
      const bool ok = col < kmax && (!causal || col <= row);
      sc[i][j] = ok ? __fmul_rn(sc[i][j], scale) : kNegInf;
    }
}

__device__ __forceinline__ int live_groups(int n) { return min(4, (n + 15) / 16); }

// One sweep over the key tiles below kmax for the 64 query rows in qs: on return m and l are
// the row max and the sum of exp(logit - m) of the thread's four rows and acc the matching
// unnormalised sum of exp(logit - m) v. k and v point at the head's first row; ks, vs and ps
// are the tile buffers. `active` is false for a warp without a live row.
template <int kDC>
__device__ __forceinline__ void attend_f32(const float* qs, float* ks, float* vs, float* ps,
                                           const float* k, const float* v, size_t stride, int s,
                                           int d, int ld, int r0, int kmax, float scale,
                                           int causal, bool active, int ty, int tx, float m[4],
                                           float l[4], float acc[4][kDC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }
  for (int c0 = 0; c0 < kmax; c0 += kTile) {
    __syncthreads();  // the last tile's reads of ks, vs and ps are done
    load_tile(ks, k + (size_t)c0 * stride, stride, s - c0, d, ld);
    load_tile(vs, v + (size_t)c0 * stride, stride, s - c0, d, ld);
    __syncthreads();
    if (active) {
      float sc[4][4];
      tile_dot(qs, ks, d, ld, ty, tx, sc, live_groups(kmax - c0));
      scale_mask_f32(sc, scale, r0 + ty * 4, c0 + tx, kmax, causal);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
        const float m_new = fmaxf(m[i], row_max(mx));
        const float alpha = expf(__fsub_rn(m[i], m_new));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(__fsub_rn(sc[i][j], m_new));
          sum += p;
          ps[(ty * 4 + i) * kPLd + tx + 16 * j] = p;
        }
        l[i] = fmaf(l[i], alpha, row_sum(sum));
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
      }
    }
    __syncthreads();
    if (active) tile_accumulate<kDC>(ps, vs, d, ld, ty, tx, acc, min(kTile, kmax - c0));
  }
}

// ----------------------------------------------------------------------------- forward core
template <int kDC>
__global__ void __launch_bounds__(kTileThreads, kDC == 4 ? 3 : 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ kmat,
                     const float* __restrict__ v, float* __restrict__ out, int s, int w, int d,
                     float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* qs = smem;              // [kTile][ld]
  float* ks = qs + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  float* ps = vs + kTile * ld;   // [kTile][kPLd] exp(logit - m)

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = blockIdx.x * kTile, head = blockIdx.y, img = blockIdx.z;
  const int rows = min(kTile, s - r0);
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const int kmax = causal ? min(s, r0 + rows) : s;
  const bool active = (threadIdx.x / 32) * 8 < rows;

  load_tile(qs, q + base + (size_t)r0 * w, w, rows, d, ld);
  float m[4], l[4], acc[4][kDC];
  attend_f32<kDC>(qs, ks, vs, ps, kmat + base, v + base, w, s, d, ld, r0, kmax, scale, causal,
                  active, ty, tx, m, l, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = acc[i][j] / l[i];
  if (active) store_rows<kDC>(out + base + (size_t)r0 * w, w, rows, d, ty, tx, acc);
}

// ----------------------------------------------------------------------------- dQ pass
// kExactProbs only decides whether attnpre is written.
template <int kDC, bool kExactProbs>
__global__ void __launch_bounds__(kTileThreads, kDC == 4 ? 2 : 1)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ kmat,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       float* __restrict__ attnpre, float* __restrict__ dq,
                       float* __restrict__ stats, int s, int w, int d, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* qs = smem;               // [kTile][ld]
  float* dos = qs + kTile * ld;   // [kTile][ld]
  float* ks = dos + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;    // [kTile][ld]
  float* ps = vs + kTile * ld;    // [kTile][kPLd] exp(logit - m), then ds

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = blockIdx.x * kTile, head = blockIdx.y, img = blockIdx.z;
  const int rows = min(kTile, s - r0);
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const size_t plane = (size_t)gridDim.z * gridDim.y * s;
  float* st = stats + ((size_t)img * gridDim.y + head) * s + r0;
  const int kmax = causal ? min(s, r0 + rows) : s;
  const bool active = (threadIdx.x / 32) * 8 < rows;

  load_tile(qs, q + base + (size_t)r0 * w, w, rows, d, ld);
  load_tile(dos, dout + base + (size_t)r0 * w, w, rows, d, ld);
  float m[4], l[4], delta[4], acc[4][kDC];
  attend_f32<kDC>(qs, ks, vs, ps, kmat + base, v + base, w, s, d, ld, r0, kmax, scale, causal,
                  active, ty, tx, m, l, acc);
  if (active) {
    // out = acc / l; delta = rowsum(do * out) over the head's columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < kDC / 4; ++g) {
        const int col = own_col(tx, g);
        if (col < d) {
          const float4 dov = *reinterpret_cast<const float4*>(dos + (ty * 4 + i) * ld + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * g + e] = acc[i][4 * g + e] / l[i];
          part = fmaf(dov.x, acc[i][4 * g], part);
          part = fmaf(dov.y, acc[i][4 * g + 1], part);
          part = fmaf(dov.z, acc[i][4 * g + 2], part);
          part = fmaf(dov.w, acc[i][4 * g + 3], part);
        }
      }
      delta[i] = row_sum(part);
      const int r = ty * 4 + i;
      if (tx == 0 && r < rows) {
        st[r] = m[i];
        st[plane + r] = l[i];
        st[2 * plane + r] = delta[i];
      }
      l[i] = 1.f / l[i];
    }
    if (!kExactProbs)
      store_rows<kDC>(attnpre + base + (size_t)r0 * w, w, rows, d, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;

  // ds = p (dp - delta), dq += ds k
  for (int c0 = 0; c0 < kmax; c0 += kTile) {
    __syncthreads();
    load_tile(ks, kmat + base + (size_t)c0 * w, w, s - c0, d, ld);
    load_tile(vs, v + base + (size_t)c0 * w, w, s - c0, d, ld);
    __syncthreads();
    if (active) {
      float sc[4][4], dp[4][4];
      const int jlive = live_groups(kmax - c0);
      tile_dot(qs, ks, d, ld, ty, tx, sc, jlive);
      tile_dot(dos, vs, d, ld, ty, tx, dp, jlive);
      scale_mask_f32(sc, scale, r0 + ty * 4, c0 + tx, kmax, causal);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = __fmul_rn(expf(__fsub_rn(sc[i][j], m[i])), l[i]);
          ps[(ty * 4 + i) * kPLd + tx + 16 * j] = __fmul_rn(p, __fsub_rn(dp[i][j], delta[i]));
        }
    }
    __syncthreads();
    if (active) tile_accumulate<kDC>(ps, ks, d, ld, ty, tx, acc, min(kTile, kmax - c0));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = __fmul_rn(acc[i][j], scale);
  if (active) store_rows<kDC>(dq + base + (size_t)r0 * w, w, rows, d, ty, tx, acc);
}

// ----------------------------------------------------------------------------- dK/dV pass
// One block per (64-key tile, head, image). Thread (ty, tx) forms the (query row ty*4+i, key
// tx+16*j) entries of p and ds, which pass through shared memory, and owns the (key ty*4+i,
// columns own_col(tx, g)..+3) entries of dk and dv. The query stream starts at the tile's
// first key under the causal mask.
template <int kDC>
__global__ void __launch_bounds__(kTileThreads, kDC == 4 ? 2 : 1)
attn_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ kmat,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ stats, float* __restrict__ dk,
                        float* __restrict__ dv, int s, int w, int d, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* ks = smem;                 // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* qs = vs + kTile * ld;      // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ps = dos + kTile * ld;     // [kTile][kPLd] p, [query][key]
  float* dss = ps + kTile * kPLd;   // [kTile][kPLd] ds
  float* rst = dss + kTile * kPLd;  // [3][kTile] max, 1 / sum, delta of the query tile's rows

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * kTile, head = blockIdx.y, img = blockIdx.z;
  const int keys = min(kTile, s - j0);
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const size_t plane = (size_t)gridDim.z * gridDim.y * s;
  const float* st = stats + ((size_t)img * gridDim.y + head) * s;

  load_tile(ks, kmat + base + (size_t)j0 * w, w, keys, d, ld);
  load_tile(vs, v + base + (size_t)j0 * w, w, keys, d, ld);

  float acc_k[4][kDC], acc_v[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = causal ? j0 : 0; q0 < s; q0 += kTile) {
    const int nrows = min(kTile, s - q0);
    __syncthreads();
    load_tile(qs, q + base + (size_t)q0 * w, w, nrows, d, ld);
    load_tile(dos, dout + base + (size_t)q0 * w, w, nrows, d, ld);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool live = row < s;
      rst[threadIdx.x] = live ? st[row] : 0.f;
      rst[kTile + threadIdx.x] = live ? 1.f / st[plane + row] : 0.f;
      rst[2 * kTile + threadIdx.x] = live ? st[2 * plane + row] : 0.f;
    }
    __syncthreads();
    if (warp * 8 < nrows) {  // this warp's query rows
      float sc[4][4], dp[4][4];
      tile_dot(qs, ks, d, ld, ty, tx, sc, live_groups(keys));
      tile_dot(dos, vs, d, ld, ty, tx, dp, live_groups(keys));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + tx + 16 * j;
          const bool ok = row < s && col < s && (!causal || col <= row);
          const float p =
              ok ? __fmul_rn(expf(__fsub_rn(__fmul_rn(sc[i][j], scale), rst[r])), rst[kTile + r])
                 : 0.f;
          ps[r * kPLd + tx + 16 * j] = p;
          dss[r * kPLd + tx + 16 * j] = __fmul_rn(p, __fsub_rn(dp[i][j], rst[2 * kTile + r]));
        }
      }
    }
    __syncthreads();
    if (warp * 8 < keys) {  // this warp's keys: dv += p^T do, dk += ds^T q over the query rows
      tile_accumulate_t<kDC>(ps, dos, d, ld, ty, tx, acc_v, nrows);
      tile_accumulate_t<kDC>(dss, qs, d, ld, ty, tx, acc_k, nrows);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc_k[i][j] = __fmul_rn(acc_k[i][j], scale);
  store_rows<kDC>(dk + base + (size_t)j0 * w, w, keys, d, ty, tx, acc_k);
  store_rows<kDC>(dv + base + (size_t)j0 * w, w, keys, d, ty, tx, acc_v);
}

// =============================================================================== launches
constexpr size_t mma_smem(int dp, int resident_rows, int streamed_rows) {
  return sizeof(__nv_bfloat16) * (size_t)(resident_rows + 4 * streamed_rows) * (dp + 8);
}

template <int kDP>
cudaError_t launch_core_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                            __nv_bfloat16* out, dim3 grid, int s, int w, int d, float scale,
                            int causal, cudaStream_t stream) {
  constexpr size_t smem = mma_smem(kDP, kMmaRows, kKT);
  cudaError_t err = allow_smem(attention_mma_kernel<kDP>, smem);
  if (err != cudaSuccess) return err;
  attention_mma_kernel<kDP><<<grid, kMmaThreads, smem, stream>>>(q, k, v, out, s, w, d,
                                                                      scale, causal);
  return cudaGetLastError();
}

template <int kDC>
cudaError_t launch_core_f32(const float* q, const float* k, const float* v, float* out,
                            dim3 grid, int s, int w, int d, float scale, int causal,
                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * kTile * (d + 4) + kTile * kPLd);
  cudaError_t err = allow_smem(attention_f32_kernel<kDC>, smem);
  if (err != cudaSuccess) return err;
  attention_f32_kernel<kDC><<<grid, kTileThreads, smem, stream>>>(q, k, v, out, s, w, d, scale,
                                                                  causal);
  return cudaGetLastError();
}

// out = softmax(q k^T * scale) v per (image, head); q, k, v, out [B, S, w] with d columns
// per head. The instantiation follows the dtype and the head dim: up to 64, or up to 128.
template <typename T>
cudaError_t launch_attention_core(const T* q, const T* k, const T* v, T* out, int b, int s,
                                  int w, int heads, int d, float scale, int causal,
                                  cudaStream_t stream) {
  const dim3 grid((s + kTile - 1) / kTile, heads, b);  // kTile == kMmaRows
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (d <= 64) return launch_core_mma<64>(q, k, v, out, grid, s, w, d, scale, causal, stream);
    return launch_core_mma<128>(q, k, v, out, grid, s, w, d, scale, causal, stream);
  } else {
    if (d <= 64) return launch_core_f32<4>(q, k, v, out, grid, s, w, d, scale, causal, stream);
    return launch_core_f32<8>(q, k, v, out, grid, s, w, d, scale, causal, stream);
  }
}

template <int kDP, bool kExactProbs>
cudaError_t launch_bwd_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                           const __nv_bfloat16* dout, float* stats, __nv_bfloat16* attnpre,
                           __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, dim3 grid,
                           int s, int w, int d, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem_dq = mma_smem(kDP, 2 * kMmaRows, kKT);
  cudaError_t err = allow_smem(attn_bwd_dq_mma_kernel<kDP, kExactProbs>, smem_dq);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_mma_kernel<kDP, kExactProbs><<<grid, kMmaThreads, smem_dq, stream>>>(
      q, k, v, dout, attnpre, dq, stats, s, w, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_dkv = mma_smem(kDP, 2 * kMmaRows, kKT) + sizeof(float) * 6 * kKT;
  err = allow_smem(attn_bwd_dkv_mma_kernel<kDP, kExactProbs>, smem_dkv);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_mma_kernel<kDP, kExactProbs><<<grid, kMmaThreads, smem_dkv, stream>>>(
      q, k, v, dout, stats, dk, dv, s, w, d, scale, causal);
  return cudaGetLastError();
}

template <int kDC, bool kExactProbs>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           float* stats, float* attnpre, float* dq, float* dk, float* dv,
                           dim3 grid, int s, int w, int d, float scale, int causal,
                           cudaStream_t stream) {
  const size_t tile = sizeof(float) * kTile * (d + 4), probs = sizeof(float) * kTile * kPLd;
  const size_t smem_dq = 4 * tile + probs;
  cudaError_t err = allow_smem(attn_bwd_dq_f32_kernel<kDC, kExactProbs>, smem_dq);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_f32_kernel<kDC, kExactProbs><<<grid, kTileThreads, smem_dq, stream>>>(
      q, k, v, dout, attnpre, dq, stats, s, w, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv = 4 * tile + 2 * probs + sizeof(float) * 3 * kTile;
  err = allow_smem(attn_bwd_dkv_f32_kernel<kDC>, smem_dkv);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_f32_kernel<kDC><<<grid, kTileThreads, smem_dkv, stream>>>(
      q, k, v, dout, stats, dk, dv, s, w, d, scale, causal);
  return cudaGetLastError();
}

// The two backward passes in order: dq (and attnpre unless kExactProbs, where it may be
// null), then dk and dv. stats is a float32 scratch of [3, B*H*S].
template <typename T, bool kExactProbs>
cudaError_t launch_attention_bwd_passes(const T* q, const T* k, const T* v, const T* dout,
                                        float* stats, T* attnpre, T* dq, T* dk, T* dv, int b,
                                        int s, int w, int heads, int d, float scale, int causal,
                                        cudaStream_t stream) {
  const dim3 grid((s + kTile - 1) / kTile, heads, b);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (d <= 64)
      return launch_bwd_mma<64, kExactProbs>(q, k, v, dout, stats, attnpre, dq, dk, dv, grid,
                                                 s, w, d, scale, causal, stream);
    return launch_bwd_mma<128, kExactProbs>(q, k, v, dout, stats, attnpre, dq, dk, dv, grid,
                                                s, w, d, scale, causal, stream);
  } else {
    if (d <= 64)
      return launch_bwd_f32<4, kExactProbs>(q, k, v, dout, stats, attnpre, dq, dk, dv, grid, s, w,
                                            d, scale, causal, stream);
    return launch_bwd_f32<8, kExactProbs>(q, k, v, dout, stats, attnpre, dq, dk, dv, grid, s, w,
                                          d, scale, causal, stream);
  }
}

}  // namespace
