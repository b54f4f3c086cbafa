// Blocked online-softmax (flash) attention, forward and backward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/flash_attention.py:_fwd_kernel,
// _dq_kernel and _dkv_kernel: attention over separate q [B, Sq, H, D] and k, v [B, Sk, H, D]
// at any length, with no [B, H, Sq, Sk] tensor in device memory in either direction. Forward:
//
//   s    = (q_h k_h^T) * sm_scale          native operands, f32 sums; masked entries (key >=
//                                          Sk, or under `causal` key > query: top-left aligned)
//                                          take the finite -1e30
//   per key tile, in rising order: m_new = max(m, rowmax(s)); p = exp(s - m_new);
//          l = l * exp(m - m_new) + rowsum(p)            the *unrounded* p
//          acc = acc * exp(m - m_new) + round_T(p) @ v_h
//   out  = acc / l  (l == 0 guarded), lse = m + log(l)   lse [B, H, Sq] float32
//
// m starts at the finite -1e30, so the first tile's rescale factor is exp(-1e30 - m_new) = 0
// and a row whose entries in a live tile are all masked keeps m and adds 0; with -inf the same
// lines give NaN. Backward, from (q, k, v, do, lse, delta) with delta = rowsum(do * out)
// computed outside, as the TPU kernels take it:
//
//   p  = exp(s - lse)  f32, masked entries exactly 0;  dp = do_h v_h^T;
//   ds = round_T(p * (dp - delta))                    the *exact* p
//   dq = sm_scale * sum over keys of ds k_h                                  (dQ kernel)
//   dv = sum over queries of round_T(p)^T do_h
//   dk = sm_scale * sum over queries of ds^T q_h                             (dK/dV kernel)
//
// f32 sums, sm_scale applied once at the store, one rounding to T there.
//
// Designed for the card, not carried over block by block. The TPU wrapper transposes to
// [B, H, S, D] and pads Sq to 128 and Sk to 256 rows, and broadcasts lse and delta over 128
// lanes: all Mosaic tiling. Here the kernels read [B, S, H, D] in place (row stride H*D, head
// offset h*D) and mask the ragged tails in their loads; the TPU's sequential innermost grid
// axis (key tiles, or query tiles in the dK/dV kernel) is a loop inside the block. Every sum
// has one owner thread and a fixed order: no atomics, two runs give the same bits.
//
// What bounds the three kernels: 4 (forward: logits, p v), 6 (dQ: logits, dp, ds k) and 8
// (dK/dV: logits, dp, p^T do, ds^T q) x pairs x D FLOPs over q, k, v, do-sized traffic: at
// S=2048 several hundred FLOPs a byte, bound by operations in both dtypes, so all three run
// their products on the tensor cores with mma.sync (the passes' reasons against wgmma hold: a
// head's problem is small and warp-level fragments let p and ds skip shared memory):
//   * bfloat16: m16n8k16 on bf16 operands with f32 accumulation, the TPU kernel's own
//     arithmetic, from the pieces of the attention passes (attention_passes.cuh,
//     mma_tiles.cuh).
//   * float32: 3xTF32 on m16n8k8 (tf32_tiles.cuh): each operand split into two TF32 parts and
//     three products summed in f32, about 2^-20 relative a product, where one TF32 product
//     would break the 1e-4 x max|plain| limit the kernels are held to. It is the arithmetic
//     PyTorch's memory-efficient attention uses for float32 (CUTLASS's OpMultiplyAddFastF32),
//     and it passes the CUDA cores' 67 TFLOP/s: 495 / 3 TFLOP/s is its ceiling. Three times
//     the mma and the splits beside them set its pace (timing variants in PERF.md), so a
//     warp owns two m-tiles (32 rows) up to D=64, every B fragment loaded and split once for
//     both, and the three products of a step run in rounds over independent accumulators.
// One schedule serves both, through the operand struct (Bf16Ops, Tf32Ops) that says how a
// tile loads, how the products run and what stays in registers:
//   * forward: one block per (query tile, head, batch), four warps of 16 rows (bfloat16) or 32
//     (float32 up to D=64), the longest causal tiles first; K and V stream in tiles of 64 keys
//     (bfloat16) or 32 (float32) through two shared-memory stages filled by 16-byte cp.async, so
//     tile i + 1 loads while tile i multiplies; one online-softmax sweep up to the tile's causal
//     bound (and a warp's own bound below it): the logits come out as C fragments, the running max
//     m, the row sum l of the unrounded p = exp(s - m) and the accumulator rescaled as m moves, and
//     p goes from C fragment to the A operand of p @ V in registers (rounded to bf16 as it is
//     packed in bfloat16; float32 contracts over the keys in the permuted order of tf32_tiles.cuh).
//     The passes' forward core (attention_passes.cuh) is the same pattern for one sequence length
//     and no lse; this one has separate Sq and Sk bounds and stores lse.
//   * dQ: one block per (query tile, head, batch), warps and order as the forward; Q and dO
//     stay resident (in bfloat16 as A fragments in registers); K and V stream in 32-row tiles,
//     one sweep up to the tile's causal bound. The logits and dp come out as C
//     fragments, p = ex2(s log2(e) - lse log2(e)) is one FMA and one ex2, ds goes from C
//     fragment to the A operand of ds @ K in registers (bfloat16: two neighbouring C fragments
//     packed to bf16 pairs are an A fragment; float32: the contraction runs over the keys in a
//     permuted order in which a C fragment is an A fragment as it stands, tf32_tiles.cuh).
//   * dK/dV: one block per (key tile, head, batch), warp w owning the keys of its m-tiles; the
//     logits and dp are formed transposed (k q^T, v do^T), so p^T and ds^T come out as the A
//     operands of p^T do and ds^T q; the query rows stream with their lse and delta, and under
//     the causal mask the stream starts at the tile's first key (top-left: query >= key).
//   * Only a tile that holds a masked entry runs the mask tests. Sq and Sk are separate
//     bounds on the query and the key side. Head dims are multiples of 8 up to 128: the tiles'
//     row stride is set by the head dim rounded up to 64 or 128, and bfloat16's k-steps of 16
//     read zeros, filled by cp.async with a source size of 0, from d to the next multiple.
// The tile shapes were measured at B=8 S=2048 (PERF.md; those builds are not kept): the
// backward pair's four warps and 32-row streamed tiles against 64-row tiles and eight warps;
// the forward's 64 keys in bfloat16, 13% faster than 32, where float32 keeps 32 (64: 2%
// slower) and eight warps gain at most 3%.

#include "attention_passes.cuh"
#include "tf32_tiles.cuh"

namespace {

// element (batch, row 0, head, 0) of a [B, S, H, D] tensor
__device__ __forceinline__ size_t head_base(int batch, int s, int heads, int head, int d) {
  return ((size_t)batch * s * heads + head) * d;
}

// ----------------------------------------------------------------------------- the trio
constexpr int kFlashKT = 32;    // rows of the backward's streamed tiles (forward: Ops::kFwdKT)
constexpr int kFlashWarps = 4;  // warps of a block
constexpr int kFlashThreads = 32 * kFlashWarps;

// The operand structs. A warp owns kM m-tiles of 16 rows (query rows in the forward and dQ
// kernels, keys in the dK/dV kernel) and forms a step's head products over the head dim for its
// rows of the resident tiles against a streamed tile: in the backward two, x @ bx^T and y @ by^T
// (q and do, or k and v), interleaved k-step by k-step so that independent chains of
// accumulations are in flight, in the forward one (q); and the second product, acc += c @ tile
// over the streamed tile's rows, from the C fragments of the first.
//
// bfloat16: m16n8k16 products on bf16 tiles, the attention passes' helpers, one m-tile a warp.
// In the dQ kernel the warp's q and do A fragments stay in registers for the whole block up to
// D=64, 4% faster at S=2048 than reading them at each step (PERF.md; above, 32 more registers
// would cost the block its third slot on the SM); the dK/dV kernel reads k and v again at each
// step, as the passes do (held, they push it past 128 registers and into spills). Launch
// bounds: four blocks of four warps an SM up to D=64, three above.
template <int kDP_>
struct Bf16Ops {
  using T = __nv_bfloat16;
  static constexpr int kDP = kDP_, kLd = kDP + 8, kM = 1;
  static constexpr int kMinBlocks = kDP <= 64 ? 4 : 3;
  static constexpr int kFwdKT = 64;  // keys of the forward's streamed tiles
  static constexpr bool kHold = kDP <= 64;
  using Frags = uint32_t[kDP / 16][4];

  static __device__ __forceinline__ int d16(int d) { return (d + 15) & ~15; }
  static __device__ __forceinline__ void load(T* dst, const T* src, size_t stride, int nrows,
                                              int live_rows, int d) {
    load_tile_async<kDP>(dst, src, stride, nrows, live_rows, d, d16(d));
  }
  static __device__ __forceinline__ void hold(Frags& f, const T* tile, int row0, int d,
                                              int lane) {
    load_a_frags<kDP>(f, tile, row0, d16(d), lane);
  }
  // the head products from held fragments, over the n-tiles below `live`
  template <int kNT>
  static __device__ __forceinline__ void products_held(float (&ax)[1][kNT][4],
                                                       float (&ay)[1][kNT][4], const Frags& fx,
                                                       const Frags& fy, const T* bx,
                                                       const T* by, int d, int live, int lane) {
    zero_acc(ax[0]);
    zero_acc(ay[0]);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      if (kk * 16 < d16(d)) {
        mma_rows<kNT>(ax[0], fx[kk], bx, kLd, kk * 16, live, lane);
        mma_rows<kNT>(ay[0], fy[kk], by, kLd, kk * 16, live, lane);
      }
  }
  // the forward's one head product, x @ bx^T, from held fragments
  template <int kNT>
  static __device__ __forceinline__ void product_held(float (&ax)[1][kNT][4], const Frags& fx,
                                                      const T* bx, int d, int live, int lane) {
    head_product<kDP, kNT>(ax[0], fx, bx, d16(d), live, lane);
  }
  // the head products with the A fragments read from x and y at each k-step
  template <int kNT>
  static __device__ __forceinline__ void products(float (&ax)[1][kNT][4], float (&ay)[1][kNT][4],
                                                  const T* x, const T* y, int row0, const T* bx,
                                                  const T* by, int d, int live, int lane) {
    zero_acc(ax[0]);
    zero_acc(ay[0]);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      if (kk * 16 < d16(d)) {
        uint32_t a[4];
        load_a(a, x, kLd, row0, kk * 16, lane);
        mma_rows<kNT>(ax[0], a, bx, kLd, kk * 16, live, lane);
        load_a(a, y, kLd, row0, kk * 16, lane);
        mma_rows<kNT>(ay[0], a, by, kLd, kk * 16, live, lane);
      }
  }
  // acc += c @ tile over the tile's rows below nrows, c rounded to bf16 as it is packed
  template <int kNT>
  static __device__ __forceinline__ void accumulate(float (&acc)[1][kDP / 8][4],
                                                    const float (&c)[1][kNT][4], const T* tile,
                                                    int nrows, int d, int lane) {
    accumulate_rows<kDP / 8>(acc[0], c[0], tile, kLd, nrows, d, lane);
  }
};

// float32: 3xTF32 m16n8k8 products on f32 tiles (tf32_tiles.cuh). Up to D=64 a warp owns two
// m-tiles (32 rows), so that every B fragment, loaded and split once, feeds both (the splits
// and loads of B, not the tensor cores, set the pace with one m-tile); above, one. The
// resident A fragments are read again at each k-step (one ldmatrix, then the split): held,
// they would take 64 registers an m-tile at D=64. Launch bounds: two blocks of four warps an
// SM up to D=64 (104 KB of shared memory each), one above.
template <int kDP_>
struct Tf32Ops {
  using T = float;
  static constexpr int kDP = kDP_, kLd = kDP + 4, kM = kDP <= 64 ? 2 : 1;
  static constexpr int kMinBlocks = kDP <= 64 ? 2 : 1;
  static constexpr int kFwdKT = 32;
  static constexpr bool kHold = false;
  struct Frags {};  // nothing is held

  static __device__ __forceinline__ void load(T* dst, const T* src, size_t stride, int nrows,
                                              int live_rows, int d) {
    load_tile_async_f32<kDP>(dst, src, stride, nrows, live_rows, d);
  }
  // the forward's one head product, x @ bx^T, its A fragments read and split at each k-step
  template <int kNT>
  static __device__ __forceinline__ void product(float (&ax)[kM][kNT][4], const T* x, int row0,
                                                 const T* bx, int d, int live, int lane) {
#pragma unroll
    for (int m = 0; m < kM; ++m) zero_acc(ax[m]);
#pragma unroll
    for (int kk = 0; kk < kDP / 8; ++kk)
      if (kk * 8 < d) {
        uint32_t big[kM][4], small[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          uint32_t a[4];
          load_a_f32(a, x, kLd, row0 + 16 * m, kk * 8, lane);
          split_frag(a, big[m], small[m]);
        }
        mma_rows_3xtf32<kM, kNT>(ax, big, small, bx, kLd, kk * 8, live, lane);
      }
  }
  template <int kNT>
  static __device__ __forceinline__ void products(float (&ax)[kM][kNT][4],
                                                  float (&ay)[kM][kNT][4], const T* x,
                                                  const T* y, int row0, const T* bx,
                                                  const T* by, int d, int live, int lane) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      zero_acc(ax[m]);
      zero_acc(ay[m]);
    }
#pragma unroll
    for (int kk = 0; kk < kDP / 8; ++kk)
      if (kk * 8 < d) {
        uint32_t big[kM][4], small[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          uint32_t a[4];
          load_a_f32(a, x, kLd, row0 + 16 * m, kk * 8, lane);
          split_frag(a, big[m], small[m]);
        }
        mma_rows_3xtf32<kM, kNT>(ax, big, small, bx, kLd, kk * 8, live, lane);
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          uint32_t a[4];
          load_a_f32(a, y, kLd, row0 + 16 * m, kk * 8, lane);
          split_frag(a, big[m], small[m]);
        }
        mma_rows_3xtf32<kM, kNT>(ay, big, small, by, kLd, kk * 8, live, lane);
      }
  }
  template <int kNT>
  static __device__ __forceinline__ void accumulate(float (&acc)[kM][kDP / 8][4],
                                                    const float (&c)[kM][kNT][4], const T* tile,
                                                    int nrows, int d, int lane) {
    accumulate_rows_3xtf32<kDP / 8>(acc, c, tile, kLd, nrows, d, lane);
  }
};

// ----------------------------------------------------------------------------- forward
// One block per tile of 16 kM kFlashWarps query rows (64 in bfloat16, 128 in float32 up to
// D=64), head and batch, the longest causal tiles first; one online-softmax sweep over the key
// tiles (Ops::kFwdKT keys) below the tile's causal bound (and a warp's own bound below it),
// tile i + 1 loading while tile i multiplies. The lane's query rows are 16m + g and 16m + g + 8
// of its warp's. bfloat16 holds the warp's q fragments for the whole sweep (16 registers up to
// D=64, 32 above); float32 reads and splits them at each k-step, as the backward kernels do.
template <class Ops>
__global__ void __launch_bounds__(kFlashThreads, Ops::kMinBlocks)
flash_fwd_kernel(const typename Ops::T* __restrict__ q, const typename Ops::T* __restrict__ k,
                 const typename Ops::T* __restrict__ v, typename Ops::T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale, int causal) {
  using T = typename Ops::T;
  constexpr int kM = Ops::kM, kWarpRows = 16 * kM, kRows = kWarpRows * kFlashWarps;
  constexpr int kLd = Ops::kLd, kKT = Ops::kFwdKT, kNT = kKT / 8, kDN = Ops::kDP / 8;
  constexpr bool kHold = std::is_same_v<T, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kLd]
  T* ks = qs + kRows * kLd;                // [2][kKT][kLd]
  T* vs = ks + 2 * kKT * kLd;              // [2][kKT][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal tiles first
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d) + (size_t)r0 * stride;
  const size_t kbase = head_base(batch, sk, heads, head, d);
  const int rows = min(kRows, sq - r0), wrow = warp * kWarpRows;
  // top-left causal mask: no row of this tile sees a key past its last row, no row of this
  // warp past the warp's
  const int kmax = causal ? min(sk, r0 + rows) : sk;
  const int wmax = wrow >= rows ? 0 : (causal ? min(kmax, r0 + wrow + kWarpRows) : kmax);
  const int steps = (kmax + kKT - 1) / kKT;

  auto prefetch = [&](int step) {
    const int c0 = step * kKT, stage = step & 1;
    Ops::load(ks + stage * kKT * kLd, k + kbase + (size_t)c0 * stride, stride, kKT, sk - c0, d);
    Ops::load(vs + stage * kKT * kLd, v + kbase + (size_t)c0 * stride, stride, kKT, sk - c0, d);
    cp_async_commit();
  };
  Ops::load(qs, q + qbase, stride, kRows, rows, d);
  prefetch(0);  // q rides the first group

  typename Ops::Frags qf;  // held q fragments (bfloat16)
  float m[kM][2], l[kM][2], acc[kM][kDN][4];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
    zero_acc(acc[i]);
  }
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      prefetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kHold) {
      if (step == 0) Ops::hold(qf, qs, wrow, d, lane);
    }
    const int c0 = step * kKT, stage = step & 1;
    const T* kt = ks + stage * kKT * kLd;
    const T* vt = vs + stage * kKT * kLd;
    const int live = min(kNT, (wmax - c0 + 7) / 8);  // n-tiles with a key this warp sees
    if (live > 0) {
      float sf[kM][kNT][4];
      if constexpr (kHold)
        Ops::product_held(sf, qf, kt, d, live, lane);
      else
        Ops::product(sf, qs, wrow, kt, d, live, lane);
      const bool edge = edge_tile(c0, kKT, kmax, r0 + wrow, causal);
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        float alpha[2];
        scale_logits<kNT>(sf[i], scale, edge, r0 + wrow + 16 * i + g, c0 + 2 * t, kmax, causal);
        online_softmax<kNT>(sf[i], m[i], l[i], alpha);  // sf becomes the unrounded p
        scale_acc(acc[i], alpha);
      }
      Ops::accumulate(acc, sf, vt, wmax - c0, d, lane);  // p rounded to T as it is packed
    }
    __syncthreads();  // this stage is free for the load of step + 2
  }
  // out = acc / l and lse = m + log(l), l == 0 guarded (no row of a live tile has l == 0:
  // key 0 is live for every row)
  float* lse_rows = lse + ((size_t)batch * heads + head) * sq + r0;
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = quad_sum(l[i][h]), safe_l = sum == 0.f ? 1.f : sum;
      inv[h] = 1.f / safe_l;
      const int row = wrow + 16 * i + g + 8 * h;
      if (t == 0 && row < rows) lse_rows[row] = m[i][h] + logf(safe_l);
    }
    store_c<kDN>(out + qbase, stride, wrow + 16 * i, rows, d, inv, acc[i], lane);
  }
}

// ----------------------------------------------------------------------------- dQ
// One block per tile of 16 kM kFlashWarps query rows (64 in bfloat16, 128 in float32 up to
// D=64), head and batch; one sweep over the key tiles below the tile's causal bound. The lane's
// query rows are 16m + g and 16m + g + 8 of its warp's.
template <class Ops>
__global__ void __launch_bounds__(kFlashThreads, Ops::kMinBlocks)
flash_dq_kernel(const typename Ops::T* __restrict__ q, const typename Ops::T* __restrict__ k,
                const typename Ops::T* __restrict__ v, const typename Ops::T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                typename Ops::T* __restrict__ dq, int sq, int sk, int d, float scale,
                int causal) {
  using T = typename Ops::T;
  constexpr int kM = Ops::kM, kWarpRows = 16 * kM, kRows = kWarpRows * kFlashWarps;
  constexpr int kLd = Ops::kLd, kNT = kFlashKT / 8, kDN = Ops::kDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kLd]
  T* dos = qs + kRows * kLd;               // [kRows][kLd]
  T* ks = dos + kRows * kLd;               // [2][kFlashKT][kLd]
  T* vs = ks + 2 * kFlashKT * kLd;         // [2][kFlashKT][kLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal tiles first
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d) + (size_t)r0 * stride;
  const size_t kbase = head_base(batch, sk, heads, head, d);
  const int rows = min(kRows, sq - r0), wrow = warp * kWarpRows;
  // top-left causal mask: no row of this tile sees a key past its last row, no row of this
  // warp past the warp's
  const int kmax = causal ? min(sk, r0 + rows) : sk;
  const int wmax = wrow >= rows ? 0 : (causal ? min(kmax, r0 + wrow + kWarpRows) : kmax);
  const int steps = (kmax + kFlashKT - 1) / kFlashKT;

  // the lane's rows: lse in log2 units, and delta (0 for a row past sq: never stored)
  float off[kM][2], dl[kM][2];
  const size_t at = ((size_t)batch * heads + head) * sq + r0;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wrow + 16 * m + g + 8 * h;
      off[m][h] = row < rows ? lse[at + row] * kLog2e : 0.f;
      dl[m][h] = row < rows ? delta[at + row] : 0.f;
    }

  auto prefetch = [&](int step) {
    const int c0 = step * kFlashKT, stage = step & 1;
    Ops::load(ks + stage * kFlashKT * kLd, k + kbase + (size_t)c0 * stride, stride, kFlashKT,
              sk - c0, d);
    Ops::load(vs + stage * kFlashKT * kLd, v + kbase + (size_t)c0 * stride, stride, kFlashKT,
              sk - c0, d);
    cp_async_commit();
  };
  Ops::load(qs, q + qbase, stride, kRows, rows, d);
  Ops::load(dos, dout + qbase, stride, kRows, rows, d);
  prefetch(0);  // q and do ride the first group

  typename Ops::Frags qf, dof;  // held q and do fragments (Ops::kHold)
  float acc[kM][kDN][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) zero_acc(acc[m]);
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      prefetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = step * kFlashKT, stage = step & 1;
    const T* kt = ks + stage * kFlashKT * kLd;
    const T* vt = vs + stage * kFlashKT * kLd;
    const int live = min(kNT, (wmax - c0 + 7) / 8);  // n-tiles with a key this warp sees
    if constexpr (Ops::kHold) {
      if (step == 0) {
        Ops::hold(qf, qs, wrow, d, lane);
        Ops::hold(dof, dos, wrow, d, lane);
      }
    }
    if (live > 0) {
      float sf[kM][kNT][4], dp[kM][kNT][4];
      if constexpr (Ops::kHold)
        Ops::products_held(sf, dp, qf, dof, kt, vt, d, live, lane);
      else
        Ops::products(sf, dp, qs, dos, wrow, kt, vt, d, live, lane);
      const bool edge = edge_tile(c0, kFlashKT, kmax, r0 + wrow, causal);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        scale_logits<kNT>(sf[m], scale, edge, r0 + wrow + 16 * m + g, c0 + 2 * t, kmax, causal);
        // sf becomes ds = p (dp - delta) from the exact p; masked entries are exactly 0
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sf[m][n][e] = __fmul_rn(prob(sf[m][n][e], off[m][e >> 1]),
                                    __fsub_rn(dp[m][n][e], dl[m][e >> 1]));
      }
      Ops::accumulate(acc, sf, kt, wmax - c0, d, lane);
    }
    __syncthreads();  // this stage is free for the load of step + 2
  }
  const float mul[2] = {scale, scale};
#pragma unroll
  for (int m = 0; m < kM; ++m)
    store_c<kDN>(dq + qbase, stride, wrow + 16 * m, rows, d, mul, acc[m], lane);
}

// ----------------------------------------------------------------------------- dK/dV
// One block per tile of 16 kM kFlashWarps keys, head and batch; the query rows stream through in
// kFlashKT-row tiles with their lse and delta. The logits are formed transposed (keys as rows),
// so the lane's keys are 16m + g and 16m + g + 8 of its warp's and its query rows 8n + 2t and
// 8n + 2t + 1 of the tile.
template <class Ops>
__global__ void __launch_bounds__(kFlashThreads, Ops::kMinBlocks)
flash_dkv_kernel(const typename Ops::T* __restrict__ q, const typename Ops::T* __restrict__ k,
                 const typename Ops::T* __restrict__ v, const typename Ops::T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 typename Ops::T* __restrict__ dk, typename Ops::T* __restrict__ dv, int sq,
                 int sk, int d, float scale, int causal) {
  using T = typename Ops::T;
  constexpr int kM = Ops::kM, kWarpRows = 16 * kM, kRows = kWarpRows * kFlashWarps;
  constexpr int kLd = Ops::kLd, kNT = kFlashKT / 8, kDN = Ops::kDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                           // [kRows][kLd]
  T* vs = ks + kRows * kLd;                                         // [kRows][kLd]
  T* qs = vs + kRows * kLd;                                         // [2][kFlashKT][kLd]
  T* dos = qs + 2 * kFlashKT * kLd;                                 // [2][kFlashKT][kLd]
  float* rst = reinterpret_cast<float*>(dos + 2 * kFlashKT * kLd);  // [2][2][kFlashKT]: lse, delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kRows;  // under the causal mask the first tiles are the longest
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d);
  const size_t kbase = head_base(batch, sk, heads, head, d) + (size_t)j0 * stride;
  const float* lse_h = lse + ((size_t)batch * heads + head) * sq;
  const float* delta_h = delta + ((size_t)batch * heads + head) * sq;
  const int keys = min(kRows, sk - j0), wrow = warp * kWarpRows;
  // a query row before the tile's first key sees none of its keys (p = ds = 0 exactly)
  const int q_begin = causal ? j0 : 0;
  const int steps = q_begin < sq ? (sq - q_begin + kFlashKT - 1) / kFlashKT : 0;

  auto prefetch = [&](int step) {
    const int q0 = q_begin + step * kFlashKT, stage = step & 1;
    Ops::load(qs + stage * kFlashKT * kLd, q + qbase + (size_t)q0 * stride, stride, kFlashKT,
              sq - q0, d);
    Ops::load(dos + stage * kFlashKT * kLd, dout + qbase + (size_t)q0 * stride, stride, kFlashKT,
              sq - q0, d);
    for (int e = threadIdx.x; e < 2 * kFlashKT; e += kFlashThreads) {
      const int which = e / kFlashKT, r = e % kFlashKT;
      const float* src = which ? delta_h : lse_h;
      const bool live = q0 + r < sq;
      cp_async4(rst + (stage * 2 + which) * kFlashKT + r, live ? src + q0 + r : src, live);
    }
    cp_async_commit();
  };
  Ops::load(ks, k + kbase, stride, kRows, keys, d);
  Ops::load(vs, v + kbase, stride, kRows, keys, d);
  prefetch(0);

  float acc_k[kM][kDN][4], acc_v[kM][kDN][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    zero_acc(acc_k[m]);
    zero_acc(acc_v[m]);
  }
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) {
      prefetch(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_begin + step * kFlashKT, stage = step & 1;
    const T* qt = qs + stage * kFlashKT * kLd;
    const T* dot = dos + stage * kFlashKT * kLd;
    const float* rs = rst + stage * 2 * kFlashKT;
    const int live = wrow >= keys ? 0 : min(kNT, (sq - q0 + 7) / 8);  // n-tiles with a row
    if (live > 0) {
      float pt[kM][kNT][4], dst[kM][kNT][4];  // k q^T then p^T; v do^T then ds^T
      Ops::products(pt, dst, ks, vs, wrow, qt, dot, d, live, lane);
      // an inner tile (every key and row live, no key past a row) skips the tests
      const bool edge = q0 + kFlashKT > sq || j0 + wrow + kWarpRows > sk ||
                        (causal && j0 + wrow + kWarpRows - 1 > q0);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = 8 * n + 2 * t;  // this lane's two query rows of the tile: c, c + 1
        const float2 ls = *reinterpret_cast<const float2*>(rs + c);
        const float2 dl = *reinterpret_cast<const float2*>(rs + kFlashKT + c);
        const float off[2] = {ls.x * kLog2e, ls.y * kLog2e}, dlt[2] = {dl.x, dl.y};
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = prob(__fmul_rn(pt[m][n][e], scale), off[e & 1]);
            if (edge) {
              const int key = j0 + wrow + 16 * m + g + 8 * (e >> 1), row = q0 + c + (e & 1);
              p = key < sk && row < sq && (!causal || key <= row) ? p : 0.f;
            }
            pt[m][n][e] = p;  // the bfloat16 packing rounds it for dv; ds takes it exact
            dst[m][n][e] = __fmul_rn(p, __fsub_rn(dst[m][n][e], dlt[e & 1]));
          }
      }
      // dv += p^T do, dk += ds^T q over this tile's query rows
      Ops::accumulate(acc_v, pt, dot, sq - q0, d, lane);
      Ops::accumulate(acc_k, dst, qt, sq - q0, d, lane);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no step ran where no query sees these keys: the loads are unused
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    store_c<kDN>(dk + kbase, stride, wrow + 16 * m, keys, d, mul_k, acc_k[m], lane);
    store_c<kDN>(dv + kbase, stride, wrow + 16 * m, keys, d, mul_v, acc_v[m], lane);
  }
}

// ----------------------------------------------------------------------------- launches
bool flash_shape_ok(int b, int sq, int sk, int heads, int d) {
  return b >= 1 && b <= 65535 && sq >= 1 && sk >= 1 && heads >= 1 && heads <= 65535 && d >= 8 &&
         d <= kMaxHeadDim && d % 8 == 0;
}

dim3 tiles(int s, int heads, int b, int rows) { return dim3((s + rows - 1) / rows, heads, b); }

// rows of the tile a block owns (query rows, or keys in the dK/dV kernel); the shared memory
// of the forward (a resident tile, two stages of two streamed ones) and of the backward (two
// resident tiles, the streamed ones and, in the dK/dV kernel, the streamed rows' lse and delta)
template <class Ops>
constexpr int block_rows() {
  return 16 * Ops::kM * kFlashWarps;
}
template <class Ops>
constexpr size_t fwd_smem() {
  return sizeof(typename Ops::T) * (size_t)(block_rows<Ops>() + 4 * Ops::kFwdKT) * Ops::kLd;
}
template <class Ops>
constexpr size_t bwd_smem(bool dkv) {
  return sizeof(typename Ops::T) * (size_t)(2 * block_rows<Ops>() + 4 * kFlashKT) * Ops::kLd +
         (dkv ? sizeof(float) * 4 * kFlashKT : 0);
}

template <class Ops>
cudaError_t flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                      int sq, int sk, int heads, int d, int causal, float scale,
                      cudaStream_t stream) {
  using T = typename Ops::T;
  constexpr size_t smem = fwd_smem<Ops>();
  cudaError_t err = allow_smem(flash_fwd_kernel<Ops>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<Ops><<<tiles(sq, heads, b, block_rows<Ops>()), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <class Ops>
cudaError_t flash_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int b, int sq, int sk,
                     int heads, int d, int causal, float scale, cudaStream_t stream) {
  using T = typename Ops::T;
  constexpr size_t smem = bwd_smem<Ops>(false);
  cudaError_t err = allow_smem(flash_dq_kernel<Ops>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<Ops><<<tiles(sq, heads, b, block_rows<Ops>()), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <class Ops>
cudaError_t flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int b, int sq,
                      int sk, int heads, int d, int causal, float scale, cudaStream_t stream) {
  using T = typename Ops::T;
  constexpr size_t smem = bwd_smem<Ops>(true);
  cudaError_t err = allow_smem(flash_dkv_kernel<Ops>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<Ops><<<tiles(sk, heads, b, block_rows<Ops>()), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      d, scale, causal);
  return cudaGetLastError();
}

// the operand struct of the dtype, head dim rounded up to 64 or 128
#define MMT_FLASH_DISPATCH(fn, ...)                                      \
  do {                                                                   \
    if (dtype == 0 && d <= 64) return (int)fn<Tf32Ops<64>>(__VA_ARGS__); \
    if (dtype == 0) return (int)fn<Tf32Ops<128>>(__VA_ARGS__);           \
    if (dtype == 1 && d <= 64) return (int)fn<Bf16Ops<64>>(__VA_ARGS__); \
    if (dtype == 1) return (int)fn<Bf16Ops<128>>(__VA_ARGS__);           \
    return (int)cudaErrorInvalidValue;                                   \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, dout, out, dq: [B, Sq, heads, d]; k, v, dk, dv:
// [B, Sk, heads, d]; lse, delta: float32 [B, heads, Sq]. All contiguous on one device, d a
// multiple of 8 up to 128, every base pointer 16-byte aligned (the kernels load by 16-byte
// cp.async). Each entry is one launch on `stream`, does not synchronise and returns a
// cudaError_t.
int mmt_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            void* lse, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_fwd, q, k, v, out, static_cast<float*>(lse), b, sq, sk, heads, d,
                     causal, sm_scale, static_cast<cudaStream_t>(stream));
}

int mmt_flash_attention_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int b,
                           int sq, int sk, int heads, int d, int causal, float sm_scale,
                           void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_dq, q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dq, b, sq, sk, heads, d, causal, sm_scale,
                     static_cast<cudaStream_t>(stream));
}

int mmt_flash_attention_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_dkv, q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dk, dv, b, sq, sk, heads, d, causal,
                     sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
