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
// lanes: all Mosaic tiling. Here the kernels read [B, S, H, D] in place and mask the ragged
// tails themselves; the TPU's sequential innermost grid axis (key tiles, or query tiles in the
// dK/dV kernel) is a loop inside the block. Every sum has one owner thread and a fixed order:
// no atomics, two runs give the same bits.
//
// What bounds them: 4 (forward: logits, p v), 6 (dQ: logits, dp, ds k) and 8 (dK/dV: logits,
// dp, p^T do, ds^T q) x pairs x D FLOPs over q, k, v, do-sized traffic: at S=2048 several
// hundred FLOPs a byte, bound by operations in both dtypes, so every product runs on the
// tensor cores, and what decides the speed is how close the tensor cores come to their peak
// and how much of the softmax work (exp, max, sums, the rescale, the masks) hides behind them.
//
// bfloat16: wgmma fed by TMA rings (WgmmaOps; hopper.cuh, wgmma_attention.cuh). On mma.sync these
// kernels ran at 10-14% of their bound (PERF.md): its issue rate and cp.async copies by the threads
// cap the tensor cores well below their wgmma rate, and warp-level fragments were its one
// advantage, which wgmma keeps (its A operand can come from registers, so p and ds still skip
// shared memory). A block is two consumer warpgroups of 64 rows and one producer warp, 288 threads,
// one block an SM (ptxas gives such a block 168 registers a thread, its share rounded to whole
// warpgroups; setmaxnreg, moving the producer's registers to the consumers, changed neither the
// spills nor the times, PERF.md, and is not used). One producer thread issues every copy: TMA boxes
// of 64 columns x rows of one (head, batch) of a 4-D tensor map over the [B, S, H, D] tensor, in
// the 128-byte swizzle wgmma reads (a head dim above 64 is two boxes side by side), zeros past D
// and past S; each stage of a ring has an mbarrier for its arrival (the copies' bytes) and one for
// its release (an arrival from each consumer warp once its products have read it). What bounds them
// here is the issue of the softmax work (exp, max, sums, the rescale, the bf16 packing, the masks)
// beside the products, more than the tensor cores (PERF.md: per-phase clocks), so:
//   * no wgmma sits under a run-time condition, nor a branch (a barrier's wait) between the
//     wgmma fence and the wgmma: ptxas serialises every wgmma of a kernel that has one. Every
//     k-step over the head dim runs, columns past d being zeros, and every tile, the masks
//     zeroing what a row does not see;
//   * within a warpgroup the next tile's first products and this tile's second ones go to the
//     tensor cores together, and the next tile's softmax (or p and ds) runs as soon as its
//     products land, while this tile's second products still run (wait_group 1, then 0:
//     FlashAttention-3's intra-warpgroup overlap); no wgmma is in flight across a loop edge,
//     where the compiler may move accumulators;
//   * tiles sized so that the D=64 kernels (the main path's) compile without spills at the
//     168 registers a thread the launch gives; descriptors are built once a tile, each k-step
//     a constant offset; the threads' shared-memory reads are LDS (the aligned base is offset
//     arithmetic on the shared array), and edge tests are hoisted out of the element loops.
//   * forward (flash_fwd_kernel<WgmmaOps>): a block owns 128 query rows of one (head, batch),
//     the longest causal tiles first; the Q tile comes in once, K and V tiles of 128 keys (64
//     at D > 64) cycle through a ring of three stages (two at D > 64). Per tile and
//     warpgroup: S = Q K^T by wgmma.m64nNk16 with both operands K-major in shared memory, the
//     online softmax in registers (the mask tests on edge tiles only), and O += P V by
//     wgmma.m64nDk16 with P, rounded to bf16 as the S accumulator is packed, as its register A
//     operand and the V tile MN-major through the descriptor's transpose bit. The logits stay
//     unscaled and sm_scale rides in the exponent, p = 2^(t c - max(t) c), c = sm_scale log2(e)
//     (one FMA and one ex2 an element and no multiply: a quarter of the time at D=64,
//     PERF.md). The two warpgroups run unsynchronised (FlashAttention-3's ping-pong between
//     them, named barriers taking turns at issue, measured no faster). K and V have separate
//     arrival barriers, so the logits of a tile start before its V has landed. Keys past Sk land
//     as zeros (logit 0, not -1e30), so the last tile still takes the mask.
//   * dK/dV (flash_dkv_kernel<WgmmaOps>): a block owns 128 keys of one (head, batch), a
//     warpgroup 64 of them; their K and V tiles come in once and stay, the Q and dO tiles of 32
//     query rows (16 at D > 64) stream through a ring of six stages (three at D > 64), and the
//     producer warp loads the tile's lse (times log2 e) and delta into shared memory
//     beside them (a [B, H, Sq] row has a pitch TMA cannot describe when Sq % 4 != 0) and
//     arrives on the stage's barrier with the copies. Per tile: S^T = K Q^T and dP^T = V dO^T
//     by wgmma.m64n32k16 (m64n16k16 at D > 64) from shared memory, all K-major;
//     P^T = ex2(s^T log2 e - lse log2 e) with lse read per column; dS^T = P^T (dP^T - delta)
//     in registers; dV += round(P^T) dO and dK += round(dS^T) Q by wgmma with A from registers
//     and B MN-major. dS never reaches shared memory. Under the causal mask the stream starts
//     at the block's first key. Registers: the two accumulators take D a thread; with the
//     overlap S^T and dP^T of the next tile (rows a thread) are live beside the bf16 A
//     fragments of this one (rows / 2): 64 + 32 + 16 at D=64, no spill. At D=128 the
//     accumulators alone take 128: 16-row tiles and no overlap (a tile's products, p and ds,
//     then its gradient products, each waited for) keep at most 128 + 16 live beside the
//     addresses, and 96 bytes of spill stores remain (340 with the overlap; the ptxas report
//     of chip_smoke.py's phase 2 prints them; D=128 is off the main path).
//   * dQ (flash_dq_kernel<WgmmaOps>): a block owns 128 query rows of one (head, batch), the
//     longest causal tiles first; the Q and dO tiles come in once and stay, each row's lse
//     (times log2 e) and delta go to registers, and K and V tiles of 64 keys (32 at D > 64)
//     cycle through a ring of six stages (four at D > 64), the stream ending at the block's
//     diagonal. Per tile and warpgroup: S = Q K^T and dP = dO V^T by wgmma.m64nNk16 from shared
//     memory, all K-major; p = ex2(s sm_scale log2 e - lse log2 e) and dS = round(p (dP -
//     delta)) in registers, packed to bf16 as the register A operand of dQ += dS K, K MN-major
//     through the transpose bit. The next tile's S and dP go to the tensor cores with this
//     tile's dQ product, and its p and dS are formed as soon as they land (wait_group 1, then
//     0), as in dK/dV. Registers: dQ's accumulator takes D / 2 a thread, the next tile's S and
//     dP keys / 2 each, this tile's dS fragments keys / 4: 112 at D=64, 104 at D=128. dQ stays
//     its own kernel with one owner for every sum (no float atomics), so two launches give the
//     same bits.
//
// float32 keeps mma.sync for all three kernels through the operand struct Tf32Ops (one schedule,
// the struct saying how a tile loads and how the products run). float32 runs 3xTF32 on m16n8k8
// (tf32_tiles.cuh): each operand split into two TF32 parts and three products summed in f32, about
// 2^-20 relative a product, where one TF32 product would break the 1e-4 x max|plain| limit the
// kernels are held to (PyTorch's memory-efficient attention uses the same arithmetic for float32);
// wgmma takes tf32 operands K-major only, and P V reads V along its keys, the other major, so the
// float32 forms wait for a transposed V. They already beat SDPA's float32 (PERF.md).
//   * forward (float32): one block per (query tile, head, batch), four warps of 32 rows up to
//     D=64 (16 above), the longest causal tiles first; K and V stream in tiles of 32 keys through
//     two shared-memory stages filled by 16-byte cp.async, so tile i + 1 loads while tile i
//     multiplies; one online-softmax sweep up to the tile's causal bound (and a warp's own bound
//     below it), p going from C fragment to the A operand of p @ V in registers (contracting
//     over the keys in the permuted order of tf32_tiles.cuh).
//   * dQ (float32): one block per (query tile, head, batch), warps and order as the forward; Q
//     and dO stay resident; K and V stream in 32-row tiles, one sweep up to the tile's causal
//     bound. The logits and dp come out as C fragments, p = ex2(s log2(e) - lse log2(e)) is one
//     FMA and one ex2, ds goes from C fragment to the A operand of ds @ K in registers (the
//     contraction runs over the keys in a permuted order in which a C fragment is an A
//     fragment as it stands, tf32_tiles.cuh).
//   * dK/dV (float32): one block per (key tile, head, batch), warp w owning the keys of its
//     m-tiles; the logits and dp are formed transposed (k q^T, v do^T), so p^T and ds^T come
//     out as the A operands of p^T do and ds^T q; the query rows stream with their lse and
//     delta, and under the causal mask the stream starts at the tile's first key.
//   * Only a tile that holds a masked entry runs the mask tests. Head dims are multiples of 8
//     up to 128: the tiles' row stride is set by the head dim rounded up to 64 or 128.

#include <type_traits>

#include "tf32_tiles.cuh"
#include "wgmma_attention.cuh"

namespace {

// element (batch, row 0, head, 0) of a [B, S, H, D] tensor
__device__ __forceinline__ size_t head_base(int batch, int s, int heads, int head, int d) {
  return ((size_t)batch * s * heads + head) * d;
}

// ----------------------------------------------------------------------------- mma.sync
// the float32 trio
constexpr int kFlashKT = 32;    // rows of the backward's streamed tiles (forward: Ops::kFwdKT)
constexpr int kFlashWarps = 4;  // warps of a block
constexpr int kFlashThreads = 32 * kFlashWarps;

// The operand struct. A warp owns kM m-tiles of 16 rows (query rows in the forward and dQ
// kernels, keys in the dK/dV kernel) and forms a step's head products over the head dim for its
// rows of the resident tiles against a streamed tile: in the backward two, x @ bx^T and y @ by^T
// (q and do, or k and v), interleaved k-step by k-step so that independent chains of
// accumulations are in flight, in the forward one (q); and the second product, acc += c @ tile
// over the streamed tile's rows, from the C fragments of the first.
//
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
// float32. One block per tile of 16 kM kFlashWarps query rows (128 up to D=64, 64 above), head
// and batch, the longest causal tiles first; one online-softmax sweep over the key tiles
// (Ops::kFwdKT keys) below the tile's causal bound (and a warp's own bound below it), tile i + 1
// loading while tile i multiplies. The lane's query rows are 16m + g and 16m + g + 8 of its
// warp's; their q fragments are read and split at each k-step, as the backward kernels do.
template <class Ops>
__global__ void __launch_bounds__(kFlashThreads, Ops::kMinBlocks)
flash_fwd_kernel(const typename Ops::T* __restrict__ q, const typename Ops::T* __restrict__ k,
                 const typename Ops::T* __restrict__ v, typename Ops::T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale, int causal) {
  using T = typename Ops::T;
  constexpr int kM = Ops::kM, kWarpRows = 16 * kM, kRows = kWarpRows * kFlashWarps;
  constexpr int kLd = Ops::kLd, kKT = Ops::kFwdKT, kNT = kKT / 8, kDN = Ops::kDP / 8;
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
    const int c0 = step * kKT, stage = step & 1;
    const T* kt = ks + stage * kKT * kLd;
    const T* vt = vs + stage * kKT * kLd;
    const int live = min(kNT, (wmax - c0 + 7) / 8);  // n-tiles with a key this warp sees
    if (live > 0) {
      float sf[kM][kNT][4];
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
// float32. One block per tile of 16 kM kFlashWarps query rows (128 up to D=64, 64 above), head
// and batch; one sweep over the key tiles below the tile's causal bound. The lane's query rows
// are 16m + g and 16m + g + 8 of its warp's.
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
    if (live > 0) {
      float sf[kM][kNT][4], dp[kM][kNT][4];
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
// float32. One block per tile of 16 kM kFlashWarps keys, head and batch; the query rows stream
// through in kFlashKT-row tiles with their lse and delta. The logits are formed transposed (keys
// as rows), so the lane's keys are 16m + g and 16m + g + 8 of its warp's and its query rows
// 8n + 2t and 8n + 2t + 1 of the tile.
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

// ============================================================================ wgmma, bfloat16
// The three kernels in bfloat16: wgmma fed by TMA rings (the header says why). Each runs two
// consumer warpgroups of 64 rows (query rows in the forward and dQ, keys in dK/dV) and one
// producer warp. kDP is the head dim rounded up to 64 or 128: a row of a tile is kDP / 64
// boxes of 64 columns (128 bytes, one swizzle atom), each box a [rows][64] sub-tile of its own.
struct FlashMaps {  // 4-D tensor maps over [B, S, H, D] (fields a kernel does not read are unset)
  CUtensorMap q, k, v, dout;
};

template <int kDP_>
struct WgmmaOps {
  using Maps = FlashMaps;
  static constexpr int kDP = kDP_, kParts = kDP / 64, kDN = kDP / 8;
  // forward: 128 query rows against K and V tiles of 128 keys (64 at D=128, for registers);
  // three stages where they fit
  static constexpr int kFwdRows = 128, kFwdKeys = kDP == 64 ? 128 : 64;
  static constexpr int kFwdStages = kDP == 64 ? 3 : 2;
  // dK/dV: 128 keys against Q and dO tiles of 32 query rows (16 at D=128), for registers; at
  // D=128 a tile's steps run in turn (kDkvOverlap false), since the overlap keeps the next
  // tile's head products live beside this one's fragments and the accumulators take 128
  static constexpr int kDkvKeys = 128, kDkvRows = kDP == 64 ? 32 : 16;
  static constexpr bool kDkvOverlap = kDP == 64;
  static constexpr int kDkvStages = kDP == 64 ? 6 : 3;
  // dQ: 128 query rows against K and V tiles of 64 keys (32 at D=128), for registers
  static constexpr int kDqRows = 128, kDqKeys = kDP == 64 ? 64 : 32;
  static constexpr int kDqStages = kDP == 64 ? 6 : 4;
};

template <class Ops>
struct FwdSmem {  // Q | stages of (K, V) | barriers: q, k[stages], v[stages], free[stages]
  static constexpr int kQBytes = Ops::kParts * Ops::kFwdRows * kRowBytes;
  static constexpr int kTileBytes = Ops::kParts * Ops::kFwdKeys * kRowBytes;  // K or V
  static constexpr int kBarOffset = kQBytes + Ops::kFwdStages * 2 * kTileBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 3 * Ops::kFwdStages) + 1024;  // + align
};

template <class Ops>
struct DqSmem {  // Q | dO | stages of (K, V) | barriers: q and do, full[stages], free[stages]
  static constexpr int kQBytes = Ops::kParts * Ops::kDqRows * kRowBytes;    // Q or dO
  static constexpr int kTileBytes = Ops::kParts * Ops::kDqKeys * kRowBytes;  // K or V
  static constexpr int kBarOffset = 2 * kQBytes + Ops::kDqStages * 2 * kTileBytes;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * Ops::kDqStages) + 1024;  // + align
};

template <class Ops>
struct DkvSmem {  // K | V | stages of (Q, dO) | stages of (lse log2 e, delta) | barriers
  static constexpr int kKVBytes = Ops::kParts * Ops::kDkvKeys * kRowBytes;  // K or V
  static constexpr int kTileBytes = Ops::kParts * Ops::kDkvRows * kRowBytes;  // Q or dO
  static constexpr int kRowsOffset = 2 * kKVBytes + Ops::kDkvStages * 2 * kTileBytes;
  static constexpr int kBarOffset = kRowsOffset + Ops::kDkvStages * 2 * Ops::kDkvRows * 4;
  static constexpr int kBytes = kBarOffset + 8 * (1 + 2 * Ops::kDkvStages) + 1024;
};

// One block per 128 query rows (longest causal tiles first), head and batch. Warpgroup w owns
// rows 64w..64w+63 of the tile; the lane's rows are those of the warp's C fragments (16-row
// warps, rows g and g + 8). One online-softmax sweep over the key tiles below the block's
// causal bound.
template <class Ops>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_kernel(const __grid_constant__ typename Ops::Maps maps, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int d, float scale, int causal) {
  constexpr int kRows = Ops::kFwdRows, kKeys = Ops::kFwdKeys, kStages = Ops::kFwdStages;
  constexpr int kParts = Ops::kParts, kNT = kKeys / 8, kDN = Ops::kDN, kDP = Ops::kDP;
  using Smem = FwdSmem<Ops>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  auto ks = [&](int s) { return smem + Smem::kQBytes + s * 2 * Smem::kTileBytes; };
  auto vs = [&](int s) { return ks(s) + Smem::kTileBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Smem::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* freed = v_full + kStages;

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal tiles first
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const int rows = min(kRows, sq - r0);
  // top-left causal mask: no row of this tile sees a key past its last row
  const int kmax = causal ? min(sk, r0 + rows) : sk;
  const int tiles = (kmax + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&freed[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(q_full, Smem::kQBytes);
      for (int p = 0; p < kParts; ++p)
        tma_load_4d(qs + p * kRows * kRowBytes, &maps.q, q_full, 64 * p, head, r0, batch);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&freed[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&k_full[s], Smem::kTileBytes);
        for (int p = 0; p < kParts; ++p)
          tma_load_4d(ks(s) + p * kKeys * kRowBytes, &maps.k, &k_full[s], 64 * p, head,
                      j * kKeys, batch);
        mbar_expect_tx(&v_full[s], Smem::kTileBytes);
        for (int p = 0; p < kParts; ++p)
          tma_load_4d(vs(s) + p * kKeys * kRowBytes, &maps.v, &v_full[s], 64 * p, head,
                      j * kKeys, batch);
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWgThreads, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first row of the tile
  // m is the running max of the unscaled logits: the scale rides in the exponent
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2], acc[kDN][4], sf[kNT][4];
  uint32_t pa[kKeys / 16][4];  // p rounded to bf16: the A fragments of P V
  const float scale_log2e = scale * kLog2e;
  // S = Q K^T of tile j into sf, issued and committed, once its K tile has landed. Every
  // k-step runs (columns past d are zeros): a condition around a wgmma makes ptxas serialise
  // them all, and so does a branch (a barrier's wait) between the wgmma fence and the wgmma.
  const uint64_t q_desc = k_major(qs, wg * 64);
  auto logits = [&](int j) {
    const uint64_t k_desc = k_major(ks(j % kStages), 0);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      wgmma_bf16_ss<kKeys>(sf, q_desc + k_step<kRows>(kk), k_desc + k_step<kKeys>(kk), kk > 0);
    wgmma_commit();
  };
  // acc += P V of tile j, issued and committed (masked keys have p = 0 exactly)
  auto values = [&](int j) {
    const uint64_t v_desc = mn_major<kKeys>(vs(j % kStages));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_bf16_rs<kDP>(acc, pa[kk], v_desc + mn_step(kk), 1);
    wgmma_commit();
  };
  // the online softmax of tile j on its landed logits: sf becomes the unrounded p
  auto softmax = [&](int j) {
    const int c0 = j * kKeys;
    if (edge_tile(c0, kKeys, kmax, r0 + wrow, causal))
      mask_logits<kNT>(sf, r0 + wrow + g, c0 + 2 * t, kmax, causal);
    online_softmax_scaled<kNT>(sf, m, l, alpha, scale_log2e);
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) pack_a<kNT>(pa[kk], sf, kk);
  };
  auto release = [&](int j) {  // this warp is done with tile j's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[j % kStages]);
  };
  auto k_landed = [&](int j) { mbar_wait(&k_full[j % kStages], (j / kStages) & 1); };
  auto v_landed = [&](int j) { mbar_wait(&v_full[j % kStages], (j / kStages) & 1); };
  zero_acc(acc);
  mbar_wait(q_full, 0);
  k_landed(0);
  fence_acc(sf);
  wgmma_fence();
  logits(0);
  wgmma_wait<0>();
  fence_acc(sf);
  softmax(0);  // acc is 0: no rescale
  pack();
  // Per step: S of tile j + 1 and P V of tile j go to the tensor cores together; the softmax
  // of tile j + 1 runs as soon as its logits land, while P V still runs. Nothing is in flight
  // across the loop's edges, where the compiler may move the accumulators.
  for (int j = 0; j + 1 < tiles; ++j) {
    k_landed(j + 1);
    v_landed(j);
    fence_acc(sf);
    fence_acc(acc);
    fence_acc(pa);
    wgmma_fence();
    logits(j + 1);
    values(j);
    wgmma_wait<1>();  // S of tile j + 1
    fence_acc(sf);
    softmax(j + 1);
    wgmma_wait<0>();  // P V of tile j
    fence_acc(acc);
    fence_acc(pa);
    release(j);
    scale_acc(acc, alpha);
    pack();
  }
  v_landed(tiles - 1);
  fence_acc(acc);
  fence_acc(pa);
  wgmma_fence();
  values(tiles - 1);
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(pa);
  release(tiles - 1);
  // out = acc / l and lse = m + log(l), l == 0 guarded (no row of a live tile has l == 0:
  // key 0 is live for every row)
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d) + (size_t)r0 * stride;
  float* lse_rows = lse + ((size_t)batch * heads + head) * sq + r0;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = quad_sum(l[h]), safe_l = sum == 0.f ? 1.f : sum;
    inv[h] = 1.f / safe_l;
    const int row = wrow + g + 8 * h;
    if (t == 0 && row < rows) lse_rows[row] = __fmul_rn(m[h], scale) + logf(safe_l);
  }
  store_c<kDN>(out + qbase, stride, wrow, rows, d, inv, acc, lane);
}

// One block per 128 query rows (longest causal tiles first), head and batch. Warpgroup w owns
// rows 64w..64w+63 of the tile; the lane's rows are those of the warp's C fragments (16-row
// warps, rows g and g + 8). One sweep over the key tiles below the block's causal bound.
template <class Ops>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_dq_kernel(const __grid_constant__ typename Ops::Maps maps, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq, int sk,
                int d, float scale, int causal) {
  constexpr int kRows = Ops::kDqRows, kKeys = Ops::kDqKeys, kStages = Ops::kDqStages;
  constexpr int kParts = Ops::kParts, kNT = kKeys / 8, kDN = Ops::kDN, kDP = Ops::kDP;
  using Smem = DqSmem<Ops>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + Smem::kQBytes;
  auto ks = [&](int s) { return smem + 2 * Smem::kQBytes + s * 2 * Smem::kTileBytes; };
  auto vs = [&](int s) { return ks(s) + Smem::kTileBytes; };
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + Smem::kBarOffset);
  uint64_t* full = qdo_full + 1;
  uint64_t* freed = full + kStages;

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal tiles first
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const int rows = min(kRows, sq - r0);
  // top-left causal mask: no row of this tile sees a key past its last row
  const int kmax = causal ? min(sk, r0 + rows) : sk;
  const int tiles = (kmax + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&freed[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(qdo_full, 2 * Smem::kQBytes);
      for (int p = 0; p < kParts; ++p) {
        tma_load_4d(qs + p * kRows * kRowBytes, &maps.q, qdo_full, 64 * p, head, r0, batch);
        tma_load_4d(dos + p * kRows * kRowBytes, &maps.dout, qdo_full, 64 * p, head, r0, batch);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&freed[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * Smem::kTileBytes);
        for (int p = 0; p < kParts; ++p) {
          tma_load_4d(ks(s) + p * kKeys * kRowBytes, &maps.k, &full[s], 64 * p, head, j * kKeys,
                      batch);
          tma_load_4d(vs(s) + p * kKeys * kRowBytes, &maps.v, &full[s], 64 * p, head, j * kKeys,
                      batch);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWgThreads, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first row of the tile
  // the lane's rows: lse in log2 units, and delta (0 for a row past sq: its dO is zero, so its
  // ds is 0, and it is never stored)
  float off[2], dl[2];
  const size_t at = ((size_t)batch * heads + head) * sq + r0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + 8 * h;
    off[h] = row < rows ? lse[at + row] * kLog2e : 0.f;
    dl[h] = row < rows ? delta[at + row] : 0.f;
  }
  float acc[kDN][4];
  float sf[kNT][4], dp[kNT][4];  // q k^T then p; do v^T then ds
  uint32_t da[kKeys / 16][4];    // ds rounded to bf16: the A fragments of dS K
  // S = Q K^T into sf and dP = dO V^T into dp for key tile j, issued and committed, once the
  // tile has landed. Every k-step runs (columns past d are zeros), and every tile below the
  // block's bound, also one in which no row of this warpgroup sees a key (its p is masked to
  // 0): a condition around a wgmma makes ptxas serialise them all, and so does a branch (a
  // barrier's wait) between the wgmma fence and the wgmma.
  auto landed = [&](int j) { mbar_wait(&full[j % kStages], (j / kStages) & 1); };
  const uint64_t q_desc = k_major(qs, wg * 64), do_desc = k_major(dos, wg * 64);
  auto head_products = [&](int j) {
    const uint64_t k_desc = k_major(ks(j % kStages), 0), v_desc = k_major(vs(j % kStages), 0);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      wgmma_bf16_ss<kKeys>(sf, q_desc + k_step<kRows>(kk), k_desc + k_step<kKeys>(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      wgmma_bf16_ss<kKeys>(dp, do_desc + k_step<kRows>(kk), v_desc + k_step<kKeys>(kk), kk > 0);
    wgmma_commit();
  };
  // p and ds of a tile in place (ds into dp), from its landed head products; `masked`
  // (std::true_type): the tile holds a key past sk or, under the causal mask, past one of the
  // warp's rows, and every element is tested
  auto tile_ds = [&](int c0, auto masked) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = prob(__fmul_rn(sf[n][e], scale), off[e >> 1]);
        if constexpr (decltype(masked)::value) {
          const int key = c0 + 8 * n + 2 * t + (e & 1), row = r0 + wrow + g + 8 * (e >> 1);
          p = key < sk && (!causal || key <= row) ? p : 0.f;
        }
        dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], dl[e >> 1]));  // from the exact p
      }
  };
  auto probabilities = [&](int j) {
    const int c0 = j * kKeys;
    if (edge_tile(c0, kKeys, sk, r0 + wrow, causal))
      tile_ds(c0, std::true_type{});
    else
      tile_ds(c0, std::false_type{});
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) pack_a<kNT>(da[kk], dp, kk);
  };
  // dq += ds K over tile j's keys, issued and committed (masked keys have ds = 0 exactly)
  auto grads = [&](int j) {
    const uint64_t k_desc = mn_major<kKeys>(ks(j % kStages));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_bf16_rs<kDP>(acc, da[kk], k_desc + mn_step(kk), 1);
    wgmma_commit();
  };
  auto release = [&](int j) {  // this warp is done with tile j's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[j % kStages]);
  };
  auto fence_all = [&] {
    fence_acc(sf);
    fence_acc(dp);
    fence_acc(da);
    fence_acc(acc);
  };
  zero_acc(acc);
  mbar_wait(qdo_full, 0);
  landed(0);
  fence_all();
  wgmma_fence();
  head_products(0);
  wgmma_wait<0>();
  fence_all();
  probabilities(0);
  // Per step: the head products of tile j + 1 and dQ of tile j go to the tensor cores together;
  // p and ds of tile j + 1 are formed as soon as its products land, while dQ still runs.
  // Nothing is in flight across the loop's edges, where the compiler may move the accumulators.
  for (int j = 0; j + 1 < tiles; ++j) {
    pack();
    landed(j + 1);
    fence_all();
    wgmma_fence();
    head_products(j + 1);
    grads(j);
    wgmma_wait<1>();  // the head products of tile j + 1
    fence_acc(sf);
    fence_acc(dp);
    probabilities(j + 1);
    wgmma_wait<0>();  // dQ of tile j
    fence_all();
    release(j);
  }
  pack();
  fence_all();
  wgmma_fence();
  grads(tiles - 1);
  wgmma_wait<0>();
  fence_all();
  release(tiles - 1);
  // dq = sm_scale acc, rounded once
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d) + (size_t)r0 * stride;
  const float mul[2] = {scale, scale};
  store_c<kDN>(dq + qbase, stride, wrow, rows, d, mul, acc, lane);
}

// One block per 128 keys, head and batch; warpgroup w owns keys 64w..64w+63 of the block. The
// query rows stream through in tiles of kDkvRows with their lse and delta. The logits are formed
// transposed (keys as rows), so the lane's keys are rows g and g + 8 of its warp's 16 and its
// query rows 8n + 2t and 8n + 2t + 1 of the tile.
template <class Ops>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_dkv_kernel(const __grid_constant__ typename Ops::Maps maps, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int sq, int sk, int d, float scale,
                 int causal) {
  constexpr int kKeys = Ops::kDkvKeys, kRows = Ops::kDkvRows, kStages = Ops::kDkvStages;
  constexpr int kParts = Ops::kParts, kNT = kRows / 8, kDN = Ops::kDN, kDP = Ops::kDP;
  using Smem = DkvSmem<Ops>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + Smem::kKVBytes;
  auto qs = [&](int s) { return smem + 2 * Smem::kKVBytes + s * 2 * Smem::kTileBytes; };
  auto dos = [&](int s) { return qs(s) + Smem::kTileBytes; };
  // per stage: the rows' lse log2(e), then their delta
  auto row_stats = [&](int s) {
    return reinterpret_cast<float*>(smem + Smem::kRowsOffset) + s * 2 * kRows;
  };
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Smem::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* freed = full + kStages;

  const int j0 = blockIdx.x * kKeys;  // under the causal mask the first tiles are the longest
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const int keys = min(kKeys, sk - j0);
  // a query row before the block's first key sees none of its keys (p = ds = 0 exactly)
  const int q_begin = causal ? j0 : 0;
  const int tiles = q_begin < sq ? (sq - q_begin + kRows - 1) / kRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: lane 0's with the copies' bytes
      mbar_init(&freed[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * Smem::kKVBytes);
      for (int p = 0; p < kParts; ++p) {
        tma_load_4d(ks + p * kKeys * kRowBytes, &maps.k, kv_full, 64 * p, head, j0, batch);
        tma_load_4d(vs + p * kKeys * kRowBytes, &maps.v, kv_full, 64 * p, head, j0, batch);
      }
    }
    const float* lse_h = lse + ((size_t)batch * heads + head) * sq;
    const float* delta_h = delta + ((size_t)batch * heads + head) * sq;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % kStages, q0 = q_begin + i * kRows;
      if (i >= kStages) mbar_wait(&freed[s], (i / kStages - 1) & 1);
      float* rs = row_stats(s);
      for (int r = lane; r < kRows; r += 32) {  // 0 for a row past sq: masked
        const bool live = q0 + r < sq;
        rs[r] = live ? lse_h[q0 + r] * kLog2e : 0.f;
        rs[kRows + r] = live ? delta_h[q0 + r] : 0.f;
      }
      if (lane == 0) {  // its arrival carries the copies' bytes
        mbar_expect_tx(&full[s], 2 * Smem::kTileBytes);
        for (int p = 0; p < kParts; ++p) {
          tma_load_4d(qs(s) + p * kRows * kRowBytes, &maps.q, &full[s], 64 * p, head, q0, batch);
          tma_load_4d(dos(s) + p * kRows * kRowBytes, &maps.dout, &full[s], 64 * p, head, q0,
                      batch);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWgThreads, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int krow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first key of the block
  const int warp_key = j0 + krow;
  float acc_k[kDN][4], acc_v[kDN][4];
  float pt[kNT][4], dst[kNT][4];                  // k q^T then p^T; v do^T then ds^T
  uint32_t pa[kRows / 16][4], da[kRows / 16][4];  // p^T and ds^T rounded: A fragments
  // S^T = K Q^T into pt and dP^T = V dO^T into dst for query tile i, issued and committed,
  // once the tile has landed. Every k-step runs (columns past d are zeros), and every tile,
  // also one in which no row sees this warpgroup's keys (its p is masked to 0): a condition
  // around a wgmma makes ptxas serialise them all, and so does a branch (a barrier's wait)
  // between the wgmma fence and the wgmma.
  auto landed = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  const uint64_t k_desc = k_major(ks, wg * 64), v_desc = k_major(vs, wg * 64);
  auto head_products = [&](int i) {
    const uint64_t q_desc = k_major(qs(i % kStages), 0), do_desc = k_major(dos(i % kStages), 0);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      wgmma_bf16_ss<kRows>(pt, k_desc + k_step<kKeys>(kk), q_desc + k_step<kRows>(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk)
      wgmma_bf16_ss<kRows>(dst, v_desc + k_step<kKeys>(kk), do_desc + k_step<kRows>(kk), kk > 0);
    wgmma_commit();
  };
  // p^T and ds^T of a tile in place, from its landed head products and its rows' statistics;
  // `masked` (std::true_type): the tile holds a masked entry, and every element is tested
  auto tile_probabilities = [&](int q0, const float* rs, auto masked) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int c = 8 * n + 2 * t;  // this lane's two query rows of the tile: c, c + 1
      const float2 off = *reinterpret_cast<const float2*>(rs + c);
      const float2 dl = *reinterpret_cast<const float2*>(rs + kRows + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = prob(__fmul_rn(pt[n][e], scale), (e & 1) ? off.y : off.x);
        if constexpr (decltype(masked)::value) {
          const int key = warp_key + g + 8 * (e >> 1), row = q0 + c + (e & 1);
          p = key < sk && row < sq && (!causal || key <= row) ? p : 0.f;
        }
        pt[n][e] = p;  // the bfloat16 packing rounds it for dv; ds takes it exact
        dst[n][e] = __fmul_rn(p, __fsub_rn(dst[n][e], (e & 1) ? dl.y : dl.x));
      }
    }
  };
  auto probabilities = [&](int i) {
    const int q0 = q_begin + i * kRows;
    const float* rs = row_stats(i % kStages);
    // an inner tile (every key and row live, no key past a row) skips the tests
    if (q0 + kRows > sq || warp_key + 16 > sk || (causal && warp_key + 15 > q0))
      tile_probabilities(q0, rs, std::true_type{});
    else
      tile_probabilities(q0, rs, std::false_type{});
  };
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      pack_a<kNT>(pa[kk], pt, kk);
      pack_a<kNT>(da[kk], dst, kk);
    }
  };
  // dv += p^T do and dk += ds^T q over tile i's rows, issued and committed
  auto grads = [&](int i) {
    const uint64_t do_desc = mn_major<kRows>(dos(i % kStages));
    const uint64_t q_desc = mn_major<kRows>(qs(i % kStages));
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_bf16_rs<kDP>(acc_v, pa[kk], do_desc + mn_step(kk), 1);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_bf16_rs<kDP>(acc_k, da[kk], q_desc + mn_step(kk), 1);
    wgmma_commit();
  };
  auto release = [&](int i) {  // this warp is done with tile i's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&freed[i % kStages]);
  };
  auto fence_all = [&] {
    fence_acc(pt);
    fence_acc(dst);
    fence_acc(pa);
    fence_acc(da);
    fence_acc(acc_v);
    fence_acc(acc_k);
  };
  zero_acc(acc_k);
  zero_acc(acc_v);
  mbar_wait(kv_full, 0);
  if (!Ops::kDkvOverlap) {
    for (int i = 0; i < tiles; ++i) {
      landed(i);
      fence_all();
      wgmma_fence();
      head_products(i);
      wgmma_wait<0>();
      fence_all();
      probabilities(i);
      pack();
      fence_all();
      wgmma_fence();
      grads(i);
      wgmma_wait<0>();
      fence_all();
      release(i);
    }
  } else if (tiles > 0) {  // no query row sees these keys: dk = dv = 0
    landed(0);
    fence_all();
    wgmma_fence();
    head_products(0);
    wgmma_wait<0>();
    fence_all();
    probabilities(0);
    // Per step: the head products of tile i + 1 and dV, dK of tile i go to the tensor cores
    // together; p^T and ds^T of tile i + 1 are formed as soon as its products land, while dV
    // and dK still run. Nothing is in flight across the loop's edges, where the compiler may
    // move the accumulators.
    for (int i = 0; i + 1 < tiles; ++i) {
      pack();
      landed(i + 1);
      fence_all();
      wgmma_fence();
      head_products(i + 1);
      grads(i);
      wgmma_wait<1>();  // the head products of tile i + 1
      fence_acc(pt);
      fence_acc(dst);
      probabilities(i + 1);
      wgmma_wait<0>();  // dV and dK of tile i
      fence_all();
      release(i);
    }
    pack();
    fence_all();
    wgmma_fence();
    grads(tiles - 1);
    wgmma_wait<0>();
    fence_all();
    release(tiles - 1);
  }
  const size_t stride = (size_t)heads * d;
  const size_t kbase = head_base(batch, sk, heads, head, d) + (size_t)j0 * stride;
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_c<kDN>(dk + kbase, stride, krow, keys, d, mul_k, acc_k, lane);
  store_c<kDN>(dv + kbase, stride, krow, keys, d, mul_v, acc_v, lane);
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
  // the float32 template of the name (the bfloat16 one takes tensor maps)
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int, float, int) =
      flash_fwd_kernel<Ops>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(sq, heads, b, block_rows<Ops>()), kFlashThreads, smem, stream>>>(
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
  // the float32 template of the name (the bfloat16 one takes tensor maps)
  void (*kernel)(const T*, const T*, const T*, const T*, const float*, const float*, T*, int, int,
                 int, float, int) = flash_dq_kernel<Ops>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(sq, heads, b, block_rows<Ops>()), kFlashThreads, smem, stream>>>(
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
  void (*kernel)(const T*, const T*, const T*, const T*, const float*, const float*, T*, T*, int,
                 int, int, float, int) = flash_dkv_kernel<Ops>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(sk, heads, b, block_rows<Ops>()), kFlashThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      d, scale, causal);
  return cudaGetLastError();
}

template <class Ops>
cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                            int b, int sq, int sk, int heads, int d, int causal, float scale,
                            cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  FlashMaps maps = {};
  const size_t ld = (size_t)heads * d;
  if (!encode_heads(encode, &maps.q, q, b, sq, heads, d, Ops::kFwdRows, ld) ||
      !encode_heads(encode, &maps.k, k, b, sk, heads, d, Ops::kFwdKeys, ld) ||
      !encode_heads(encode, &maps.v, v, b, sk, heads, d, Ops::kFwdKeys, ld))
    return cudaErrorInvalidValue;
  constexpr size_t smem = FwdSmem<Ops>::kBytes;
  void (*kernel)(FlashMaps, __nv_bfloat16*, float*, int, int, int, float, int) =
      flash_fwd_kernel<Ops>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(sq, heads, b, Ops::kFwdRows), kHopperThreads, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), lse, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <class Ops>
cudaError_t flash_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, int b, int sq, int sk,
                           int heads, int d, int causal, float scale, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  FlashMaps maps = {};
  const size_t ld = (size_t)heads * d;
  if (!encode_heads(encode, &maps.q, q, b, sq, heads, d, Ops::kDqRows, ld) ||
      !encode_heads(encode, &maps.dout, dout, b, sq, heads, d, Ops::kDqRows, ld) ||
      !encode_heads(encode, &maps.k, k, b, sk, heads, d, Ops::kDqKeys, ld) ||
      !encode_heads(encode, &maps.v, v, b, sk, heads, d, Ops::kDqKeys, ld))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DqSmem<Ops>::kBytes;
  void (*kernel)(FlashMaps, const float*, const float*, __nv_bfloat16*, int, int, int, float,
                 int) = flash_dq_kernel<Ops>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(sq, heads, b, Ops::kDqRows), kHopperThreads, smem, stream>>>(
      maps, lse, delta, static_cast<__nv_bfloat16*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <class Ops>
cudaError_t flash_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv, int b,
                            int sq, int sk, int heads, int d, int causal, float scale,
                            cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  FlashMaps maps = {};
  const size_t ld = (size_t)heads * d;
  if (!encode_heads(encode, &maps.q, q, b, sq, heads, d, Ops::kDkvRows, ld) ||
      !encode_heads(encode, &maps.dout, dout, b, sq, heads, d, Ops::kDkvRows, ld) ||
      !encode_heads(encode, &maps.k, k, b, sk, heads, d, Ops::kDkvKeys, ld) ||
      !encode_heads(encode, &maps.v, v, b, sk, heads, d, Ops::kDkvKeys, ld))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DkvSmem<Ops>::kBytes;
  void (*kernel)(FlashMaps, const float*, const float*, __nv_bfloat16*, __nv_bfloat16*, int, int,
                 int, float, int) = flash_dkv_kernel<Ops>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(sk, heads, b, Ops::kDkvKeys), kHopperThreads, smem, stream>>>(
      maps, lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq, sk,
      d, scale, causal);
  return cudaGetLastError();
}

// the launcher of the dtype (fn32 with Tf32Ops, fn16 with WgmmaOps), head dim rounded up to 64
// or 128
#define MMT_FLASH_DISPATCH(fn32, fn16, ...)                                 \
  do {                                                                      \
    if (dtype == 0 && d <= 64) return (int)fn32<Tf32Ops<64>>(__VA_ARGS__);  \
    if (dtype == 0) return (int)fn32<Tf32Ops<128>>(__VA_ARGS__);            \
    if (dtype == 1 && d <= 64) return (int)fn16<WgmmaOps<64>>(__VA_ARGS__); \
    if (dtype == 1) return (int)fn16<WgmmaOps<128>>(__VA_ARGS__);           \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, dout, out, dq: [B, Sq, heads, d]; k, v, dk, dv:
// [B, Sk, heads, d]; lse, delta: float32 [B, heads, Sq]. All contiguous on one device, d a
// multiple of 8 up to 128, every base pointer 16-byte aligned (16-byte cp.async loads in
// float32, TMA tensor maps in bfloat16). Each entry is one launch on `stream`,
// does not synchronise and returns a cudaError_t.
int mmt_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            void* lse, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_fwd, flash_fwd_wgmma, q, k, v, out,
                     static_cast<float*>(lse), b, sq, sk, heads, d, causal, sm_scale,
                     static_cast<cudaStream_t>(stream));
}

int mmt_flash_attention_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int b,
                           int sq, int sk, int heads, int d, int causal, float sm_scale,
                           void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_dq, flash_dq_wgmma, q, k, v, dout,
                     static_cast<const float*>(lse), static_cast<const float*>(delta), dq, b, sq,
                     sk, heads, d, causal, sm_scale, static_cast<cudaStream_t>(stream));
}

int mmt_flash_attention_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_dkv, flash_dkv_wgmma, q, k, v, dout,
                     static_cast<const float*>(lse), static_cast<const float*>(delta), dk, dv, b,
                     sq, sk, heads, d, causal, sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
