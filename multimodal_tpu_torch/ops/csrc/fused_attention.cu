// Fused whole-sequence attention, forward and backward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/fused_attention.py:_fwd_kernel and
// _bwd_kernel: the attention core alone (no projections) over separate q, k and v packed as
// [B, S, H*D], for self-attention at 128 <= S <= 512 with D in {32, 64, 128}. Forward:
//
//   p   = softmax(q_h k_h^T * sm_scale) per head, f32, finite -1e30 causal mask (col <= row),
//         row max subtracted, rounded to T
//   out = p @ v_h                       f32 accumulation, rounded to T
//
// Backward, from (q, k, v, do) with the probabilities recomputed:
//
//   p32   = softmax(...)                exact f32 probabilities, p = p32 rounded to T
//   dv    = p^T @ do_h                  the *rounded* p, as the forward's product used
//   dp    = do_h @ v_h^T                f32
//   delta = rowsum(dp * p32)            the *exact* p32
//   ds    = p32 * (dp - delta)          rounded to T
//   dq    = (ds @ k_h) * sm_scale, dk = (ds^T @ q_h) * sm_scale    scaled in f32, rounded to T
//
// This is where the fused backward differs from the block-attention backward, which forms
// delta and ds from the rounded p. In float32 rounding is the identity, and delta = rowsum(do *
// out) from the forward's out equals rowsum(dp * p32) up to the order of the sums. The bfloat16
// kernels below serve the block-attention kernels too (block_attention_fwd.cu,
// block_attention_bwd.cu, through the C entries at the end of this file): the forward as their
// attention core at S >= 128, the backward's dQ and dK/dV kernels in their block form (the
// rounded p, attnpre, two items a pass at S <= 64; "The two forms" below), at D in {32, 64,
// 128}.
//
// One launch forward and two backward. The bfloat16 forward is fused_fwd_kernel below (wgmma
// fed by TMA); the float32 forward is attention_passes.cuh's forward core, which the block
// kernels share, and in float32 it also writes each row's log-sum-exp. The bfloat16 backward
// has kernels of its own, below: a dQ kernel that forms every query row's statistics (lse and
// the exact delta) in a first sweep over the keys, writes them to a [2][B*H*S] float32 scratch
// and forms dq, then a dK/dV kernel that reads them back; wgmma fed by TMA, persistent over the
// (image, head) items with each item's inputs resident. The float32 backward is the flash
// dQ and dK/dV kernels (flash_attention.cu, 3xTF32 on mma.sync through Tf32Ops) on the packed
// tensors read as [B, S, H, D], with the forward's lse and delta = rowsum(do * out) from
// fused_delta_kernel below: those kernels already take delta that way, and on the fused shapes
// they ran faster than a float32 pair of this file's own (PERF.md). Either way dK and dV need
// no atomics and no [B,H,S,S] tensor reaches device memory. The TPU kernel's 16-row sequence
// pad and its 128-lane head groups are Mosaic tiling and have no counterpart: the ragged last
// tile is masked. The loads need D a multiple
// of 8 (and 16-byte aligned tensors, which the wrapper checks).

#include "wgmma_attention.cuh"

namespace {

constexpr int kMaxFusedSeq = 512;

bool fused_shape_ok(int b, int s, int heads, int d) {
  return b >= 1 && b <= 65535 && s >= 1 && s <= kMaxFusedSeq && heads >= 1 && heads <= 65535 &&
         d >= 8 && d <= kMaxHeadDim && d % 8 == 0;
}

// ============================================================================ wgmma, bfloat16
// The forward in bfloat16 (fused_fwd_kernel): wgmma fed by TMA (hopper.cuh,
// wgmma_attention.cuh), its own kernel. What bounds it: 4 S^2 D FLOPs per (image, head) over q,
// k, v and out, each S D: at S=197, D=64 about 100 FLOPs a byte, a third of the card's
// balance point, so bytes bound it on paper (a call reads and writes 310 MB at B=256, H=12).
// In practice the work per key tile bounds it (PERF.md: the kernel runs as fast with every
// load an L2 hit): the S^2 exponentials of the softmax on the special-function unit and its
// other per-element instructions, beside the products. The mma.sync core
// (attention_mma_kernel, which the block kernels keep) gave a block 64 query rows and read K
// and V again for each of the four 64-row tiles of an (image, head), relying on L2 for the
// re-reads; its 32-key steps and copies by the threads held it at 28% of the byte bound. Here:
//   * persistent blocks, one an SM, walk the (image, head) items (block i takes items i, i +
//     grid, ...). An item is ceil(S / 128) passes of 128 query rows, a warpgroup owning 64 of
//     them; a non-persistent block would do a few microseconds of work against a block start
//     that costs about as much;
//   * K and V come in once per item by TMA into a ring of kSlots slots of one key tile each,
//     which holds every tile of an item up to S = 512 (256 at D > 64), and stay there while
//     every pass of the item goes through; the producer loads an item's tiles as soon as the
//     ring has room, one or two items ahead, and each pass's Q tile into one of three buffers
//     (two at D > 64; a third buffer, loaded two passes ahead, ran S=197 2-8% faster). Past
//     that length the ring streams each pass's tiles (loaded again from L2). Each slot has
//     arrival barriers for K and for V (so a tile's logits start before its V lands) and a
//     release barrier with an arrival from each consumer warp; in the resident form a slot is
//     released by the item's last pass, which sees every key;
//   * the key tile is chosen per call (fused_keys): 128, 112 or 96 keys at D <= 64, whichever
//     pads the keys least (S=197: two tiles of 112, 224 keys a pass instead of 256; S=257:
//     three of 96), since every tile costs its full width; 64 at D > 64, for registers;
//   * per pass and warpgroup: the flash forward's schedule (flash_attention.cu): S = Q K^T by
//     wgmma.m64nNk16 from shared memory, both K-major; the online softmax in registers with
//     sm_scale in the exponent; O += P V with P as the register A operand, rounded to bf16 as
//     it is packed, and V MN-major through the transpose bit; the next tile's S issued with
//     this tile's P V (wait_group 1, then 0). A whole row of logits at S <= 256 would need 128
//     registers a thread for S alone, beside P's fragments and O, past the 168 that a
//     288-thread block gets, so the softmax is the online form that the mma.sync kernel used
//     (p rounded against the running max, normalised at the end), not the normalised p of the
//     reference; the difference is single bf16 steps of out;
//   * out leaves through shared memory: each warpgroup writes its 64 rows, normalised and
//     rounded, into a buffer of its own in the 128-byte swizzle and one thread stores them by
//     TMA, which writes no row past S and no column past D (stores from the registers, 4
//     bytes of a row at a time, took about a third of a pass);
//   * no wgmma sits under a run-time condition or behind a branch after its fence, and none is
//     in flight across a loop edge (ptxas serialises every wgmma of such a kernel): every
//     k-step over the head dim runs (zero columns past D), every key tile below the pass's
//     bound, and both warpgroups take every pass, a warpgroup whose rows lie past S included.
//     A branch that skipped the softmax of a warp past S cost the kernel its spill-free
//     registers and serialised its wgmma;
//   * q, k, v and out are read and written through a row stride (ld elements: heads d for
//     packed [B, S, H*D]), as attention_passes.cuh's passes take them.
struct FusedMaps {  // 4-D tensor maps over [B, S, H, D] with the row stride
  CUtensorMap q, k, v, out;
};

template <int kDP_, int kKeys_>
struct FusedOps {
  static constexpr int kDP = kDP_, kParts = kDP / 64, kDN = kDP / 8;
  static constexpr int kRows = 128;     // a pass: two warpgroups of 64 rows
  static constexpr int kKeys = kKeys_;  // a key tile (fused_keys)
  static constexpr int kQBytes = kParts * kRows * kRowBytes;
  static constexpr int kTileBytes = kParts * kKeys * kRowBytes;  // K or V
  static constexpr int kOBytes = kParts * 64 * kRowBytes;          // a warpgroup's out rows
  // Q buffers: a pass's Q loads while the two passes before it run (two at D > 64, where shared
  // memory is short)
  static constexpr int kQBufs = kDP == 64 ? 3 : 2;
  static constexpr int kOOffset = kQBufs * kQBytes;
  // every slot that fits beside the Q and O buffers, barriers and the alignment in 227 KB: 5,
  // 5 and 6 at 128, 112 and 96 keys (4 at D > 64)
  static constexpr int kSlots =
      (232448 - kQBufs * kQBytes - 2 * kOBytes - 2048) / (2 * kTileBytes);
  static constexpr int kSlotOffset = kOOffset + 2 * kOBytes;
  static constexpr int kBarOffset = kSlotOffset + kSlots * 2 * kTileBytes;
  // barriers: q_full[kQBufs], q_free[kQBufs], k_full[kSlots], v_full[kSlots], kv_free[kSlots]
  static constexpr int kBytes = kBarOffset + 8 * (2 * kQBufs + 3 * kSlots) + 1024;  // + align
};

// A warp's [16][kDN 8] accumulator times its rows' factors, rounded to bf16, into rows row0..
// of a [kDN / 8][kPartRows][64] bf16 buffer in the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8); buf 1024-byte aligned): the lanes of one store fall into 32 different banks
template <int kDN, int kPartRows = 64>
__device__ __forceinline__ void stage_out(unsigned char* buf, int row0, const float (&mul)[2],
                                          const float (&acc)[kDN][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      unsigned char* at = buf + (n / 8) * kPartRows * kRowBytes + r * kRowBytes;
      *reinterpret_cast<uint32_t*>(at + (((n % 8) ^ (r & 7)) << 4) + 4 * t) =
          pack_bf16(__fmul_rn(acc[n][2 * h], mul[h]), __fmul_rn(acc[n][2 * h + 1], mul[h]));
    }
}

template <class Ops>
__global__ void __launch_bounds__(kHopperThreads, 1)
fused_fwd_kernel(const __grid_constant__ FusedMaps maps, int b, int s, int heads, float scale,
                 int causal) {
  constexpr int kRows = Ops::kRows, kKeys = Ops::kKeys, kSlots = Ops::kSlots;
  constexpr int kParts = Ops::kParts, kNT = kKeys / 8, kDN = Ops::kDN, kDP = Ops::kDP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto qs = [&](int buf) { return smem + buf * Ops::kQBytes; };
  auto ks = [&](int slot) { return smem + Ops::kSlotOffset + slot * 2 * Ops::kTileBytes; };
  auto vs = [&](int slot) { return ks(slot) + Ops::kTileBytes; };
  auto os = [&](int wg) { return smem + Ops::kOOffset + wg * Ops::kOBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Ops::kBarOffset);
  uint64_t* q_free = q_full + Ops::kQBufs;
  uint64_t* k_full = q_free + Ops::kQBufs;
  uint64_t* v_full = k_full + kSlots;
  uint64_t* kv_free = v_full + kSlots;

  const int items = b * heads, passes = (s + kRows - 1) / kRows;
  const int item_tiles = (s + kKeys - 1) / kKeys;
  // every tile of an item fits the ring: loaded once, kept for all its passes
  const bool resident = item_tiles <= kSlots;
  // the key tiles pass p sees (top-left causal mask: none past its last row)
  auto pass_tiles = [&](int p) {
    const int kmax = causal ? min(s, (p + 1) * kRows) : s;
    return (kmax + kKeys - 1) / kKeys;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < Ops::kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_free[i], kConsumerWarps);
    }
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&kv_free[i], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Producer and consumers count the same sequence: `loads` K/V tile loads (load n goes to slot
  // n % kSlots, its phase n / kSlots) and `npass` passes (Q buffer npass % kQBufs).
  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 2 * kWgThreads) {
      int loads = 0, npass = 0;
      auto load_q = [&](int batch, int head, int p) {
        const int buf = npass % Ops::kQBufs;
        if (npass >= Ops::kQBufs) mbar_wait(&q_free[buf], (npass / Ops::kQBufs - 1) & 1);
        mbar_expect_tx(&q_full[buf], Ops::kQBytes);
        for (int part = 0; part < kParts; ++part)
          tma_load_4d(qs(buf) + part * kRows * kRowBytes, &maps.q, &q_full[buf], 64 * part, head,
                      p * kRows, batch);
        ++npass;
      };
      auto load_kv = [&](int batch, int head, int tiles) {
        for (int j = 0; j < tiles; ++j, ++loads) {
          const int slot = loads % kSlots;
          if (loads >= kSlots) mbar_wait(&kv_free[slot], (loads / kSlots - 1) & 1);
          mbar_expect_tx(&k_full[slot], Ops::kTileBytes);
          for (int part = 0; part < kParts; ++part)
            tma_load_4d(ks(slot) + part * kKeys * kRowBytes, &maps.k, &k_full[slot], 64 * part,
                        head, j * kKeys, batch);
          mbar_expect_tx(&v_full[slot], Ops::kTileBytes);
          for (int part = 0; part < kParts; ++part)
            tma_load_4d(vs(slot) + part * kKeys * kRowBytes, &maps.v, &v_full[slot], 64 * part,
                        head, j * kKeys, batch);
        }
      };
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int batch = item / heads, head = item % heads;
        if (resident) {
          // the item's K and V first: they wait only for slots that items before the last one
          // hold, so they land an item or two ahead, and each Q waits for the pass before last
          load_kv(batch, head, item_tiles);
          for (int p = 0; p < passes; ++p) load_q(batch, head, p);
        } else {
          // a pass's tiles may wait for slots this pass releases: its Q comes first
          for (int p = 0; p < passes; ++p) {
            load_q(batch, head, p);
            load_kv(batch, head, pass_tiles(p));
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWgThreads, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first row of a pass
  const bool issuer = threadIdx.x % kWgThreads == 0;          // the warpgroup's TMA stores
  const float scale_log2e = scale * kLog2e;
  // m is the running max of the unscaled logits: the scale rides in the exponent
  float m[2], l[2], alpha[2], acc[kDN][4], sf[kNT][4];
  uint32_t pa[kKeys / 16][4];  // p rounded to bf16: the A fragments of P V
  int loads = 0, npass = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int batch = item / heads, head = item % heads;
    const int item_base = loads;  // the item's first load (resident)
    if (resident) loads += item_tiles;
    for (int p = 0; p < passes; ++p, ++npass) {
      const int r0 = p * kRows, rows = min(kRows, s - r0);
      const int kmax = causal ? min(s, r0 + rows) : s, tiles = (kmax + kKeys - 1) / kKeys;
      const int base = resident ? item_base : loads;  // load index of the pass's tile 0
      if (!resident) loads += tiles;
      // a slot is released after its last use: by every pass when each pass loads its own
      // tiles, by the item's last pass (which sees every key) when they stay
      const bool releases = !resident || p == passes - 1;
      const int buf = npass % Ops::kQBufs;
      auto slot = [&](int j) { return (base + j) % kSlots; };
      auto phase = [&](int j) { return ((base + j) / kSlots) & 1; };
      // S = Q K^T of tile j into sf, issued and committed, once its K tile has landed
      const uint64_t q_desc = k_major(qs(buf), wg * 64);
      auto logits = [&](int j) {
        const uint64_t k_desc = k_major(ks(slot(j)), 0);
#pragma unroll
        for (int kk = 0; kk < kDP / 16; ++kk)
          wgmma_bf16_ss<kKeys>(sf, q_desc + k_step<kRows>(kk), k_desc + k_step<kKeys>(kk),
                               kk > 0);
        wgmma_commit();
      };
      // acc += P V of tile j, issued and committed (masked keys have p = 0 exactly)
      auto values = [&](int j) {
        const uint64_t v_desc = mn_major<kKeys>(vs(slot(j)));
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
      auto release = [&](int j) {  // this warp is done with tile j's slot
        if (!releases) return;
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_free[slot(j)]);
      };
      auto k_landed = [&](int j) { mbar_wait(&k_full[slot(j)], phase(j)); };
      auto v_landed = [&](int j) { mbar_wait(&v_full[slot(j)], phase(j)); };
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      zero_acc(acc);
      mbar_wait(&q_full[buf], (npass / Ops::kQBufs) & 1);
      k_landed(0);
      fence_acc(sf);
      wgmma_fence();
      logits(0);
      wgmma_wait<0>();
      fence_acc(sf);
      softmax(0);  // acc is 0: no rescale
      pack();
      // Per step: S of tile j + 1 and P V of tile j go to the tensor cores together; the
      // softmax of tile j + 1 runs as soon as its logits land, while P V still runs.
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
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_free[buf]);  // this warp is done with the pass's Q
      // out = acc / l, rounded once (no row of a live pass has l == 0: key 0 is live for every
      // row), through the warpgroup's O buffer and one TMA store of its 64 rows, which writes
      // no row past s and no column past d
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = quad_sum(l[h]);
        inv[h] = 1.f / (sum == 0.f ? 1.f : sum);
      }
      if (issuer) bulk_wait_read<0>();  // the last pass's store has read the buffer
      named_bar_sync(1 + wg, kWgThreads);
      stage_out<kDN>(os(wg), wrow - wg * 64, inv, acc, lane);
      fence_proxy_async();
      named_bar_sync(1 + wg, kWgThreads);
      if (issuer) {
        for (int part = 0; part < kParts; ++part)
          tma_store_4d(&maps.out, os(wg) + part * 64 * kRowBytes, 64 * part, head, r0 + wg * 64,
                       batch);
        bulk_commit();
      }
    }
  }
  if (issuer) bulk_wait<0>();  // the last store is written
}

// The key tile of the D <= 64 forms: of 128, 112 and 96 keys, the one whose tiles pad the keys
// that the passes see the least (the tiles of a pass cover keys up to its causal bound), the
// widest on a tie. At S=197 a pass covers 224 keys in two tiles of 112 instead of 256 in two of
// 128: every key tile costs its full width in products and exponentials. Above D = 64 the
// accumulators leave room for 64 keys only.
int fused_keys(int s, int causal) {
  int best = 128, best_cost = 0;
  for (int keys : {128, 112, 96}) {
    int cost = 0;
    for (int r0 = 0; r0 < s; r0 += 128) {
      const int kmax = causal && r0 + 128 < s ? r0 + 128 : s;
      cost += (kmax + keys - 1) / keys * keys;
    }
    if (keys == 128 || cost < best_cost) {
      best = keys;
      best_cost = cost;
    }
  }
  return best;
}

// q, k, v, out: rows of `ld` elements, head h's d columns at h d, batch entries s rows apart
cudaError_t fused_fwd_wgmma(const void* q, const void* k, const void* v, void* out, int b, int s,
                            int heads, int d, size_t ld, float scale, int causal,
                            cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  FusedMaps maps = {};
  auto launch = [&](auto ops) -> cudaError_t {
    using Ops = decltype(ops);
    if (!encode_heads(encode, &maps.q, q, b, s, heads, d, Ops::kRows, ld) ||
        !encode_heads(encode, &maps.k, k, b, s, heads, d, Ops::kKeys, ld) ||
        !encode_heads(encode, &maps.v, v, b, s, heads, d, Ops::kKeys, ld) ||
        !encode_heads(encode, &maps.out, out, b, s, heads, d, 64, ld))
      return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(fused_fwd_kernel<Ops>, Ops::kBytes);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long items = static_cast<long long>(b) * heads;
    if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(items < sms ? items : sms));  // one block an SM
    fused_fwd_kernel<Ops><<<grid, kHopperThreads, Ops::kBytes, stream>>>(
        maps, b, s, heads, scale, causal);
    return cudaGetLastError();
  };
  if (d > 64) return launch(FusedOps<128, 64>{});
  switch (fused_keys(s, causal)) {
    case 96:
      return launch(FusedOps<64, 96>{});
    case 112:
      return launch(FusedOps<64, 112>{});
    default:
      return launch(FusedOps<64, 128>{});
  }
}

// lse (float32 only; may be null): each query row's log-sum-exp (natural log), which the
// float32 backward reads
template <typename T>
cudaError_t fused_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                      int s, int heads, int d, int causal, float sm_scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (lse != nullptr) return cudaErrorInvalidValue;
    return fused_fwd_wgmma(q, k, v, out, b, s, heads, d, (size_t)heads * d, sm_scale, causal,
                           stream);
  } else {
    return launch_attention_core<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(out), b, s,
                                    heads * d, heads, d, sm_scale, causal, stream, lse);
  }
}

// ============================================================================ backward
// The bfloat16 backward: two launches, a dQ kernel that also writes every query row's
// statistics, then a dK/dV kernel that reads them. Per (image, head) it computes the TPU
// kernel's arithmetic (fused_attention.py:_bwd_kernel):
//   * the dQ kernel sweeps the keys twice per pass of query rows. The first sweep forms the
//     logits and dP = dO V^T and the row statistics: the running max m and sum of exp l, and
//     the exact delta = rowsum(dp * p32) as a running f32 sum of exp(s - m) dp rescaled like l.
//     The second sweep forms p = exp(s - lse) from the final statistics,
//     ds = round(p (dp - delta)) and dq += ds k;
//   * each query row's lse (log2 units) and delta go to `stats` ([2][B H S] float32);
//   * the dK/dV kernel forms the logits transposed (k q^T, v do^T, keys as rows), so that
//     round(p)^T and round(ds)^T are the A operands of dv += p^T do and dk += ds^T q as they
//     stand, with every query row's lse and delta read back;
//   * dq, dk and dv are scaled in f32 and rounded once. Every sum has one owner and a fixed
//     order: no float atomics, two launches give the same bits.
// 9 products a (query, key) pair (logits and dp twice in the dQ kernel and again in dK/dV, dq,
// dv, dk). The float32 backward (fused_delta_kernel, then the flash pair: 7 products, lse from
// the forward) is launched from the C entry at the end of this file.
//
// bfloat16 (fused_dq_kernel, fused_dkv_kernel): wgmma fed by TMA, over wgmma_attention.cuh,
// the block of the flash kernels (two consumer warpgroups of 64 rows, one producer warp).
// attention_passes.cuh's mma.sync passes, which this replaces, gave a block one 64-row tile of
// one (image, head) and read the item's K and V again for each tile and each of its two
// sweeps, and Q and dO again for each 64-key tile (about 4x the bytes the bound counts, L2
// catching the rest), on 32-key mma.sync steps at 58 TFLOP/s. Here:
//   * persistent blocks, one an SM, walk the (image, head) items; at S = 197 a block of the
//     passes did a few microseconds of work against a block start of about as much;
//   * each input is read once an item: the dQ kernel keeps the item's K and V tiles resident
//     in a ring of slots for every pass and both sweeps (every slot that fits beside two
//     buffers of a pass's Q and dO: 10 of 64 keys at D <= 64, the whole of S <= 512), and the
//     dK/dV kernel keeps the item's Q and dO tiles and their rows' lse and delta resident (19
//     slots of 32 rows at D <= 64) while its passes of 128 keys go through. Past what fits (D =
//     128 at longer S) the ring streams each pass's tiles again (from L2);
//   * the dQ kernel's key tiles are 64 keys (32 above D = 64, for registers): at S = 197 tiles of
//     32 keys, which pad the keys less (224 instead of 256), ran the dQ kernel 16% slower, its
//     time set by the round trips of a tile's steps more than by the padded products
//     (PERF.md); the dK/dV kernel's query tiles are 32 rows (16 above D = 64);
//   * products as in the flash kernels: S and dP by wgmma.m64nNk16 from shared memory, both
//     operands K-major; p and ds in registers, rounded to bf16 as they are packed into the
//     register A operand of dQ += dS K (K MN-major through the descriptor's transpose bit) or
//     of dV += P^T dO and dK += dS^T Q; the next tile's S and dP go to the tensor cores with
//     this tile's gradient products (wait_group 1, then 0). The first sweep commits S and dP
//     as two groups, so that the exponentials of a tile run while its dP is formed;
//   * dq, dk and dv leave through shared memory: at the end of a pass each warpgroup writes its
//     64 rows, scaled and rounded, over its own rows of the pass's Q tile (dQ) or K and V tiles
//     (dK/dV), which only its own products read, in the 128-byte swizzle, and one thread stores
//     them by TMA (no row past S, no column past D) before the buffer is released (stores from
//     the registers, 4 bytes of a row at a time, took about a third of a forward pass in the
//     forward kernel above, and 14% of the dK/dV kernel here: PERF.md);
//   * no wgmma under a run-time condition or behind a branch after its fence, none in flight
//     across a loop edge: every k-step over the head dim runs (zero columns past D), every
//     tile below a pass's bound, both warpgroups every pass; ragged S and the causal diagonal
//     go through TMA's zero fill and the masks.
// The two forms of the backward kernels (a compile-time choice, Ops::kBlock):
//   * the fused form (kBlock = 0, above): delta from the exact probabilities, ds = round(p32 (dp -
//     delta));
//   * the block form (kBlock = 1), the attention half of block_attention_bwd.cu's backward, the
//     TPU's block_attention.py:_bwd_kernel and _bwd_kernel_large: p rounded to bf16 before every
//     use, delta = rowsum(dp round(p)), ds = round(round(p) (dp - delta)), and attnpre = round(p v)
//     emitted. Its dQ kernel's first sweep is the forward's online sweep (S = Q K^T, the online
//     softmax, acc += round(p) V, one sweep over the keys): it yields the row statistics, attnpre
//     = round(acc / l) and delta = rowsum(do * acc) / l, which equals rowsum(dp round(p)) for the
//     probabilities acc was built from (rounded against the running max, as the mma.sync pass of
//     attention_passes.cuh rounds them; single bf16 steps from the plain version's normalised p).
//     Its second sweep and the dK/dV kernel round p = 2^(t c - lse) before ds and dv.
// Both forms take q, k, v, do and their gradients through the tensor maps' row stride (ld
// elements): the block form reads the planes of its [3, B*S, W] q/k/v scratch and the [B*S, W]
// do, heads side by side, as the fused form reads [B, S, H*D].
//
// Short items (kPack = 1, S <= 64): a 128-row pass would leave more than half of its rows
// empty, so each warpgroup takes an (image, head) item of its own: a pass holds two items (the
// item pair 2u, 2u + 1), warpgroup w owning item 2u + w's rows (dQ) or keys (dK/dV) 0..63, its
// own tiles in the ring; an odd count's last pair repeats the last item in its second warpgroup,
// whose results are not stored. Every wgmma still runs in both warpgroups.
struct FusedBwdMaps {  // 4-D tensor maps over [B, S, H, D] with the row stride
  CUtensorMap q, k, v, dout;  // loads
  CUtensorMap dq, dk, dv;     // stores of 64 rows
};

template <int kDP_, int kKeys_, int kBlock_ = 0, int kPack_ = 0>
struct FusedDqOps {
  static constexpr int kDP = kDP_, kParts = kDP / 64, kDN = kDP / 8;
  static constexpr bool kBlock = kBlock_, kPack = kPack_;
  static constexpr int kRows = 128;     // a pass: two warpgroups of 64 query rows
  static constexpr int kKeys = kKeys_;  // a K / V tile
  static constexpr int kQBytes = kParts * kRows * kRowBytes;       // Q or dO of a pass
  static constexpr int kTileBytes = kParts * kKeys * kRowBytes;    // K or V
  static constexpr int kQBufs = 2;  // a pass's Q and dO load while the pass before runs
  static constexpr int kSlots = (232448 - kQBufs * 2 * kQBytes - 2048) / (2 * kTileBytes);
  static constexpr int kSlotOffset = kQBufs * 2 * kQBytes;
  static constexpr int kBarOffset = kSlotOffset + kSlots * 2 * kTileBytes;
  // barriers: q_full[kQBufs], q_free[kQBufs], kv_full[kSlots], kv_free[kSlots]
  static constexpr int kBytes = kBarOffset + 8 * (2 * kQBufs + 2 * kSlots) + 1024;  // + align
};

template <int kDP_, int kBlock_ = 0, int kPack_ = 0>
struct FusedDkvOps {
  static constexpr int kDP = kDP_, kParts = kDP / 64, kDN = kDP / 8;
  static constexpr bool kBlock = kBlock_, kPack = kPack_;
  static constexpr int kKeys = 128;                  // a pass: two warpgroups of 64 keys
  static constexpr int kRowsT = kDP == 64 ? 32 : 16;  // a Q / dO tile, for registers
  // at D = 128 dK and dV take 128 registers a thread: a tile's steps run in turn there
  static constexpr bool kOverlap = kDP == 64;
  static constexpr int kKVBytes = kParts * kKeys * kRowBytes;   // K or V of a pass
  static constexpr int kTileBytes = kParts * kRowsT * kRowBytes;  // Q or dO
  static constexpr int kKVBufs = 2;
  static constexpr int kSlots =
      (232448 - kKVBufs * 2 * kKVBytes - 2048) / (2 * kTileBytes + 8 * kRowsT);
  static constexpr int kSlotOffset = kKVBufs * 2 * kKVBytes;
  static constexpr int kStatsOffset = kSlotOffset + kSlots * 2 * kTileBytes;  // lse, delta
  static constexpr int kBarOffset = kStatsOffset + kSlots * 8 * kRowsT;
  // barriers: kv_full[kKVBufs], kv_free[kKVBufs], full[kSlots], freed[kSlots]
  static constexpr int kBytes = kBarOffset + 8 * (2 * kKVBufs + 2 * kSlots) + 1024;
};

// lo and hi rounded to bf16 together (one cvt.rn.bf16x2.f32) and widened again: two
// round_to<__nv_bfloat16> for the price of one conversion
__device__ __forceinline__ void round_pair(float& lo, float& hi) {
  const uint32_t pk = pack_bf16(lo, hi);
  lo = __uint_as_float(pk << 16);
  hi = __uint_as_float(pk & 0xffff0000u);
}

// A pass's unit of work: an (image, head) item, or with kPack an item pair, warpgroup w taking
// item 2u + w (the last item again past the end: `live` false, nothing stored)
struct PassItem {
  int batch, head;
  bool live;
};
template <bool kPack>
__device__ __forceinline__ PassItem pass_item(int unit, int w, int items, int heads) {
  const int want = kPack ? 2 * unit + w : unit;
  const int item = min(want, items - 1);
  return {item / heads, item % heads, want < items};
}

// One block an SM walks the units (items, or item pairs with kPack); an item is ceil(S / 128)
// passes of 128 query rows, warpgroup w owning rows 64w..64w+63 of a pass (with kPack, rows
// 0..63 of its own item), each pass two sweeps over the key tiles below its causal bound. The
// lane's rows are those of its warp's C fragments (rows g, g + 8).
template <class Ops>
__global__ void __launch_bounds__(kHopperThreads, 1)
fused_dq_kernel(const __grid_constant__ FusedBwdMaps maps, float* __restrict__ stats,
                __nv_bfloat16* __restrict__ attnpre, int ld, int b, int s, int heads, float scale,
                int causal) {
  constexpr int kRows = Ops::kRows, kKeys = Ops::kKeys, kSlots = Ops::kSlots;
  constexpr int kParts = Ops::kParts, kNT = kKeys / 8, kDN = Ops::kDN, kDP = Ops::kDP;
  constexpr int kQBufs = Ops::kQBufs;
  constexpr bool kPack = Ops::kPack;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto qs = [&](int buf) { return smem + buf * 2 * Ops::kQBytes; };
  auto dos = [&](int buf) { return qs(buf) + Ops::kQBytes; };
  auto ks = [&](int slot) { return smem + Ops::kSlotOffset + slot * 2 * Ops::kTileBytes; };
  auto vs = [&](int slot) { return ks(slot) + Ops::kTileBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Ops::kBarOffset);
  uint64_t* q_free = q_full + kQBufs;
  uint64_t* kv_full = q_free + kQBufs;
  uint64_t* kv_free = kv_full + kSlots;

  const int items = b * heads, units = kPack ? (items + 1) / 2 : items;
  const int passes = (s + kRows - 1) / kRows;  // 1 with kPack (S <= 64)
  const int item_tiles = (s + kKeys - 1) / kKeys;
  const int unit_tiles = (kPack ? 2 : 1) * item_tiles;
  // every tile of a unit fits the ring: loaded once, kept for all its passes and sweeps
  const bool resident = unit_tiles <= kSlots;
  auto pass_tiles = [&](int p) {  // the key tiles pass p sees (none past its last row)
    const int kmax = causal ? min(s, (p + 1) * kRows) : s;
    return (kmax + kKeys - 1) / kKeys;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_free[i], kConsumerWarps);
    }
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_free[i], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Producer and consumers count the same sequence: `loads` K/V tile loads (load n goes to slot
  // n % kSlots, its phase n / kSlots) and `npass` passes (Q and dO buffer npass % kQBufs).
  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 2 * kWgThreads) {
      int loads = 0, npass = 0;
      auto load_q = [&](int unit, int p) {
        const int buf = npass % kQBufs;
        if (npass >= kQBufs) mbar_wait(&q_free[buf], (npass / kQBufs - 1) & 1);
        mbar_expect_tx(&q_full[buf], 2 * Ops::kQBytes);
        for (int w = 0; w < (kPack ? 2 : 1); ++w) {  // kPack: a 64-row box for each warpgroup
          const PassItem it = pass_item<kPack>(unit, w, items, heads);
          const int off = w * 64 * kRowBytes, row = kPack ? 0 : p * kRows;
          for (int part = 0; part < kParts; ++part) {
            tma_load_4d(qs(buf) + part * kRows * kRowBytes + off, &maps.q, &q_full[buf],
                        64 * part, it.head, row, it.batch);
            tma_load_4d(dos(buf) + part * kRows * kRowBytes + off, &maps.dout, &q_full[buf],
                        64 * part, it.head, row, it.batch);
          }
        }
        ++npass;
      };
      auto load_kv = [&](int unit, int tiles) {
        for (int w = 0; w < (kPack ? 2 : 1); ++w) {
          const PassItem it = pass_item<kPack>(unit, w, items, heads);
          for (int j = 0; j < tiles; ++j, ++loads) {
            const int slot = loads % kSlots;
            if (loads >= kSlots) mbar_wait(&kv_free[slot], (loads / kSlots - 1) & 1);
            mbar_expect_tx(&kv_full[slot], 2 * Ops::kTileBytes);
            for (int part = 0; part < kParts; ++part) {
              tma_load_4d(ks(slot) + part * kKeys * kRowBytes, &maps.k, &kv_full[slot],
                          64 * part, it.head, j * kKeys, it.batch);
              tma_load_4d(vs(slot) + part * kKeys * kRowBytes, &maps.v, &kv_full[slot],
                          64 * part, it.head, j * kKeys, it.batch);
            }
          }
        }
      };
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        if (resident) {
          // the unit's K and V first: they wait only for slots that earlier units hold
          load_kv(unit, item_tiles);
          for (int p = 0; p < passes; ++p) load_q(unit, p);
        } else {
          // a pass's tiles, once for each sweep, may wait for slots this pass releases: its Q
          // and dO come first
          for (int p = 0; p < passes; ++p) {
            load_q(unit, p);
            load_kv(unit, pass_tiles(p));
            load_kv(unit, pass_tiles(p));
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWgThreads, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first row of a pass
  const bool issuer = threadIdx.x % kWgThreads == 0;  // the warpgroup's TMA stores
  const float c = scale * kLog2e;  // the logits stay unscaled: sm_scale rides in the exponent
  const size_t plane = (size_t)b * heads * s;
  float acc[kDN][4];
  float sf[kNT][4], dp[kNT][4];  // q k^T then p; do v^T then ds
  // the fused form's first sweep, its next tile: q k^T, do v^T
  float sn[Ops::kBlock ? 1 : kNT][4], dn[Ops::kBlock ? 1 : kNT][4];
  uint32_t da[kKeys / 16][4];    // ds (the block form's first sweep: p) rounded: A fragments
  int loads = 0, npass = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const PassItem it = pass_item<kPack>(unit, wg, items, heads);
    const int batch = it.batch, head = it.head;
    const int unit_base = loads;  // the unit's first load (resident)
    if (resident) loads += unit_tiles;
    const int wg_tiles = kPack ? wg * item_tiles : 0;  // this warpgroup's item's first tile
    for (int p = 0; p < passes; ++p, ++npass) {
      const int r0 = p * kRows, rows = min(kRows, s - r0);
      // the sequence row of pass row wrow + i is row0 + wrow + i (kPack: the item's own rows)
      const int row0 = kPack ? -64 * wg : r0;
      const int kmax = causal ? min(s, r0 + rows) : s, tiles = (kmax + kKeys - 1) / kKeys;
      // load index of tile 0 in each sweep
      const int base1 = resident ? unit_base + wg_tiles : loads;
      const int base2 = resident ? unit_base + wg_tiles : loads + tiles;
      if (!resident) loads += 2 * tiles;
      const int buf = npass % kQBufs;
      auto landed = [&](int base, int j) {
        mbar_wait(&kv_full[(base + j) % kSlots], ((base + j) / kSlots) & 1);
      };
      auto release = [&](int base, int j) {  // streamed: this warp is done with the tile
        if (resident) return;
        __syncwarp();
        if (lane == 0) mbar_arrive(&kv_free[(base + j) % kSlots]);
      };
      const uint64_t q_desc = k_major(qs(buf), wg * 64), do_desc = k_major(dos(buf), wg * 64);
      // S = Q K^T into s_ and dP = dO V^T into d_ of tile j, issued and committed as two
      // groups
      auto head_products = [&](int base, int j, float (&s_)[kNT][4], float (&d_)[kNT][4]) {
        const int slot = (base + j) % kSlots;
        const uint64_t k_desc = k_major(ks(slot), 0), v_desc = k_major(vs(slot), 0);
#pragma unroll
        for (int kk = 0; kk < kDP / 16; ++kk)
          wgmma_bf16_ss<kKeys>(s_, q_desc + k_step<kRows>(kk), k_desc + k_step<kKeys>(kk),
                               kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kDP / 16; ++kk)
          wgmma_bf16_ss<kKeys>(d_, do_desc + k_step<kRows>(kk), v_desc + k_step<kKeys>(kk),
                               kk > 0);
        wgmma_commit();
      };
      auto fence_all = [&] {
        fence_acc(sf);
        fence_acc(dp);
        fence_acc(da);
        fence_acc(acc);
      };
      mbar_wait(&q_full[buf], (npass / kQBufs) & 1);

      // first sweep: the row max m of the unscaled logits and the sum of exp l (per-lane
      // partials; the four lanes of a row share m); the fused form also the running sum of
      // exp(s - m) dp, the block form acc = sum round(exp(s - m)) v, rescaled as l is
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
      // the online step of tile j on its landed logits s_: s_ becomes exp(s - m), alpha the
      // factor of the sums kept so far
      auto row_max_sum = [&](int j, float (&s_)[kNT][4]) {
        const int c0 = j * kKeys;
        if (edge_tile(c0, kKeys, kmax, row0 + wrow, causal))
          mask_logits<kNT>(s_, row0 + wrow + g, c0 + 2 * t, kmax, causal);
        online_softmax_scaled<kNT>(s_, m, l, alpha, c);
      };
      // the row's lse in log2 units (p = 2^(t c - off)) and delta
      float off[2], dl[2];
      if constexpr (!Ops::kBlock) {
        float run[2] = {0.f, 0.f};
        auto row_delta = [&] {  // run = run alpha + rowsum(exp(s - m) dp) of the tile in sf, dp
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float sum = 0.f;
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              sum = fmaf(sf[n][2 * h], dp[n][2 * h], sum);
              sum = fmaf(sf[n][2 * h + 1], dp[n][2 * h + 1], sum);
            }
            run[h] = fmaf(run[h], alpha[h], sum);
          }
        };
        landed(base1, 0);
        fence_acc(sf);
        fence_acc(dp);
        wgmma_fence();
        head_products(base1, 0, sf, dp);
        wgmma_wait<1>();  // S of tile 0
        fence_acc(sf);
        row_max_sum(0, sf);
        wgmma_wait<0>();  // dP of tile 0
        fence_acc(dp);
        // Per step: the head products of tile j + 1 go to the tensor cores while tile j's
        // delta term is summed; tile j + 1's exponentials run while its dP is formed. Nothing
        // is in flight across the loop's edges.
        for (int j = 0; j + 1 < tiles; ++j) {
          landed(base1, j + 1);
          fence_acc(sn);
          fence_acc(dn);
          wgmma_fence();
          head_products(base1, j + 1, sn, dn);
          row_delta();
          release(base1, j);
          wgmma_wait<1>();  // S of tile j + 1
          fence_acc(sn);
          row_max_sum(j + 1, sn);
          wgmma_wait<0>();  // dP of tile j + 1
          fence_acc(dn);
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sf[n][e] = sn[n][e];
              dp[n][e] = dn[n][e];
            }
        }
        row_delta();
        release(base1, tiles - 1);
        // delta = rowsum(dp p32); rows past s are never stored (their dO is zero, so their ds
        // is 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sum = quad_sum(l[h]);
          off[h] = fmaf(m[h], c, __log2f(sum));
          dl[h] = quad_sum(run[h]) / sum;
        }
      } else {
        // S of tile j into sf, issued and committed
        auto logits = [&](int j) {
          const uint64_t k_desc = k_major(ks((base1 + j) % kSlots), 0);
#pragma unroll
          for (int kk = 0; kk < kDP / 16; ++kk)
            wgmma_bf16_ss<kKeys>(sf, q_desc + k_step<kRows>(kk), k_desc + k_step<kKeys>(kk),
                                 kk > 0);
          wgmma_commit();
        };
        // acc += P V of tile j, P rounded to bf16 as it was packed into da (masked keys: 0)
        auto values = [&](int j) {
          const uint64_t v_desc = mn_major<kKeys>(vs((base1 + j) % kSlots));
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk)
            wgmma_bf16_rs<kDP>(acc, da[kk], v_desc + mn_step(kk), 1);
          wgmma_commit();
        };
        auto pack_p = [&] {
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk) pack_a<kNT>(da[kk], sf, kk);
        };
        zero_acc(acc);
        landed(base1, 0);
        fence_acc(sf);
        wgmma_fence();
        logits(0);
        wgmma_wait<0>();
        fence_acc(sf);
        row_max_sum(0, sf);  // acc is 0: no rescale
        pack_p();
        // Per step: S of tile j + 1 and P V of tile j go to the tensor cores together; the
        // softmax of tile j + 1 runs as soon as its logits land, while P V still runs.
        for (int j = 0; j + 1 < tiles; ++j) {
          landed(base1, j + 1);
          fence_acc(sf);
          fence_acc(acc);
          fence_acc(da);
          wgmma_fence();
          logits(j + 1);
          values(j);
          wgmma_wait<1>();  // S of tile j + 1
          fence_acc(sf);
          row_max_sum(j + 1, sf);
          wgmma_wait<0>();  // P V of tile j
          fence_acc(acc);
          fence_acc(da);
          release(base1, j);
          scale_acc(acc, alpha);
          pack_p();
        }
        fence_acc(acc);
        fence_acc(da);
        wgmma_fence();
        values(tiles - 1);
        wgmma_wait<0>();
        fence_acc(acc);
        fence_acc(da);
        release(base1, tiles - 1);
        // attnpre = acc / l rounded once; delta = rowsum(do * acc) / l, do from the pass's dO
        // tile (zeros past d), the lane's columns 8n + 2t, + 1 of its rows
        float inv[2], dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sum = quad_sum(l[h]);
          off[h] = fmaf(m[h], c, __log2f(sum));
          inv[h] = 1.f / sum;
          const int r = wrow + g + 8 * h;  // the row in the dO tile
#pragma unroll
          for (int n = 0; n < kDN; ++n) {
            const unsigned char* at = dos(buf) + (n / 8) * kRows * kRowBytes + r * kRowBytes +
                                      (((n % 8) ^ (r & 7)) << 4) + 4 * t;
            const float2 dov =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
            dsum[h] = fmaf(dov.x, acc[n][2 * h], dsum[h]);
            dsum[h] = fmaf(dov.y, acc[n][2 * h + 1], dsum[h]);
          }
          dl[h] = quad_sum(dsum[h]) * inv[h];
        }
        if (it.live) {
          const int first = row0 + wrow;  // the warp's first sequence row
          const int d = ld / heads;
          store_c<kDN>(attnpre + ((size_t)batch * s + first) * ld + (size_t)head * d, ld, 0,
                       s - first, d, inv, acc, lane);
        }
      }
      if (it.live) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wrow + g + 8 * h;
          if (t == 0 && row < s) {
            const size_t at = ((size_t)batch * heads + head) * s + row;
            stats[at] = off[h];
            stats[plane + at] = dl[h];
          }
        }
      }

      // second sweep: p = 2^(t c - off) from the final statistics (the block form: rounded to
      // bf16), ds = p (dp - delta), rounded as it is packed, dq += ds K. `masked`
      // (std::true_type): the tile holds a key past s or, under the causal mask, past one of
      // the warp's rows
      auto tile_ds = [&](int c0, auto masked) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pr = ex2(fmaf(sf[n][e], c, -off[e >> 1]));
            if constexpr (decltype(masked)::value) {
              const int key = c0 + 8 * n + 2 * t + (e & 1);
              const int row = row0 + wrow + g + 8 * (e >> 1);
              pr = key < s && (!causal || key <= row) ? pr : 0.f;
            }
            sf[n][e] = pr;
          }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if constexpr (Ops::kBlock) {  // the block form's p, rounded to bf16
            round_pair(sf[n][0], sf[n][1]);
            round_pair(sf[n][2], sf[n][3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[n][e] = __fmul_rn(sf[n][e], __fsub_rn(dp[n][e], dl[e >> 1]));
        }
      };
      auto probabilities = [&](int j) {
        const int c0 = j * kKeys;
        if (edge_tile(c0, kKeys, kmax, row0 + wrow, causal))
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
        const uint64_t k_desc = mn_major<kKeys>(ks((base2 + j) % kSlots));
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_bf16_rs<kDP>(acc, da[kk], k_desc + mn_step(kk), 1);
        wgmma_commit();
      };
      zero_acc(acc);
      landed(base2, 0);
      fence_all();
      wgmma_fence();
      head_products(base2, 0, sf, dp);
      wgmma_wait<0>();
      fence_all();
      probabilities(0);
      // Per step: the head products of tile j + 1 and dQ of tile j go to the tensor cores
      // together; p and ds of tile j + 1 are formed as soon as its products land, while dQ
      // still runs. Nothing is in flight across the loop's edges.
      for (int j = 0; j + 1 < tiles; ++j) {
        pack();
        landed(base2, j + 1);
        fence_all();
        wgmma_fence();
        head_products(base2, j + 1, sf, dp);
        grads(j);
        wgmma_wait<1>();  // the head products of tile j + 1
        fence_acc(sf);
        fence_acc(dp);
        probabilities(j + 1);
        wgmma_wait<0>();  // dQ of tile j
        fence_all();
        release(base2, j);
      }
      pack();
      fence_all();
      wgmma_fence();
      grads(tiles - 1);
      wgmma_wait<0>();
      fence_all();
      release(base2, tiles - 1);
      // dq = sm_scale acc, rounded once, staged over the warpgroup's Q rows of the buffer and
      // stored by TMA; the buffer is released once the store has read it
      const float mul[2] = {scale, scale};
      unsigned char* out_rows = qs(buf) + wg * 64 * kRowBytes;
      named_bar_sync(1 + wg, kWgThreads);  // every warp of the warpgroup is past its products
      stage_out<kDN, kRows>(out_rows, wrow - wg * 64, mul, acc, lane);
      fence_proxy_async();
      named_bar_sync(1 + wg, kWgThreads);
      if (issuer) {
        if (it.live) {
          for (int part = 0; part < kParts; ++part)
            tma_store_4d(&maps.dq, out_rows + part * kRows * kRowBytes, 64 * part, head,
                         row0 + wg * 64, batch);
          bulk_commit();
        }
        bulk_wait_read<0>();
      }
      named_bar_sync(1 + wg, kWgThreads);
      if (lane == 0) mbar_arrive(&q_free[buf]);  // this warp is done with the pass's Q and dO
    }
    if (resident) {  // every pass of the unit is done with its K and V
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < unit_tiles; ++j) mbar_arrive(&kv_free[(unit_base + j) % kSlots]);
    }
  }
  if (issuer) bulk_wait<0>();  // the last store is written
}

// One block an SM walks the units (items, or item pairs with kPack); an item is ceil(S / 128)
// passes of 128 keys, warpgroup w owning keys 64w..64w+63 of a pass (with kPack, keys 0..63 of
// its own item), each pass one sweep over the Q and dO tiles of the rows that see its keys
// (under the causal mask from its first key). The lane's keys are rows g and g + 8 of its
// warp's 16 and its query rows 8n + 2t and 8n + 2t + 1 of the tile.
template <class Ops>
__global__ void __launch_bounds__(kHopperThreads, 1)
fused_dkv_kernel(const __grid_constant__ FusedBwdMaps maps, const float* __restrict__ stats,
                 int b, int s, int heads, float scale, int causal) {
  constexpr int kKeys = Ops::kKeys, kRows = Ops::kRowsT, kSlots = Ops::kSlots;
  constexpr int kParts = Ops::kParts, kNT = kRows / 8, kDN = Ops::kDN, kDP = Ops::kDP;
  constexpr int kKVBufs = Ops::kKVBufs;
  constexpr bool kPack = Ops::kPack;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto ks = [&](int buf) { return smem + buf * 2 * Ops::kKVBytes; };
  auto vs = [&](int buf) { return ks(buf) + Ops::kKVBytes; };
  auto qs = [&](int slot) { return smem + Ops::kSlotOffset + slot * 2 * Ops::kTileBytes; };
  auto dos = [&](int slot) { return qs(slot) + Ops::kTileBytes; };
  // per slot: its rows' lse (log2 units), then their delta
  auto row_stats = [&](int slot) {
    return reinterpret_cast<float*>(smem + Ops::kStatsOffset) + slot * 2 * kRows;
  };
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + Ops::kBarOffset);
  uint64_t* kv_free = kv_full + kKVBufs;
  uint64_t* full = kv_free + kKVBufs;
  uint64_t* freed = full + kSlots;

  const int items = b * heads, units = kPack ? (items + 1) / 2 : items;
  const int passes = (s + kKeys - 1) / kKeys;  // 1 with kPack (S <= 64)
  const int item_tiles = (s + kRows - 1) / kRows;
  const int unit_tiles = (kPack ? 2 : 1) * item_tiles;
  // every Q / dO tile of a unit fits the ring: loaded once, kept for all its passes
  const bool resident = unit_tiles <= kSlots;
  // the first tile pass p sees: under the causal mask no row before its first key sees it
  auto first_tile = [&](int p) { return causal ? p * kKeys / kRows : 0; };
  const size_t plane = (size_t)b * heads * s;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kKVBufs; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_free[i], kConsumerWarps);
    }
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(&full[i], 32);  // the producer warp's lanes: lane 0's with the copies' bytes
      mbar_init(&freed[i], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Producer and consumers count the same sequence: `loads` Q/dO tile loads (load n goes to
  // slot n % kSlots, its phase n / kSlots) and `npass` passes (K and V buffer npass % kKVBufs)
  if (threadIdx.x >= 2 * kWgThreads) {  // the producer warp: its lanes write the rows' stats
    const int lane = threadIdx.x & 31;
    int loads = 0, npass = 0;
    auto load_kv = [&](int unit, int p) {
      const int buf = npass % kKVBufs;
      if (npass >= kKVBufs) mbar_wait(&kv_free[buf], (npass / kKVBufs - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&kv_full[buf], 2 * Ops::kKVBytes);
        for (int w = 0; w < (kPack ? 2 : 1); ++w) {  // kPack: 64 keys of each warpgroup's item
          const PassItem it = pass_item<kPack>(unit, w, items, heads);
          const int off = w * 64 * kRowBytes, key = kPack ? 0 : p * kKeys;
          for (int part = 0; part < kParts; ++part) {
            tma_load_4d(ks(buf) + part * kKeys * kRowBytes + off, &maps.k, &kv_full[buf],
                        64 * part, it.head, key, it.batch);
            tma_load_4d(vs(buf) + part * kKeys * kRowBytes + off, &maps.v, &kv_full[buf],
                        64 * part, it.head, key, it.batch);
          }
        }
      }
      ++npass;
    };
    auto load_rows = [&](int unit, int i0) {
      for (int w = 0; w < (kPack ? 2 : 1); ++w) {
        const PassItem it = pass_item<kPack>(unit, w, items, heads);
        const size_t at = ((size_t)it.batch * heads + it.head) * s;
        for (int i = i0; i < item_tiles; ++i, ++loads) {
          const int slot = loads % kSlots, q0 = i * kRows;
          if (loads >= kSlots) mbar_wait(&freed[slot], (loads / kSlots - 1) & 1);
          float* rs = row_stats(slot);
          for (int r = lane; r < kRows; r += 32) {  // 0 for a row past s: masked
            const bool live = q0 + r < s;
            rs[r] = live ? stats[at + q0 + r] : 0.f;
            rs[kRows + r] = live ? stats[plane + at + q0 + r] : 0.f;
          }
          if (lane == 0) {  // its arrival carries the copies' bytes
            mbar_expect_tx(&full[slot], 2 * Ops::kTileBytes);
            for (int part = 0; part < kParts; ++part) {
              tma_load_4d(qs(slot) + part * kRows * kRowBytes, &maps.q, &full[slot], 64 * part,
                          it.head, q0, it.batch);
              tma_load_4d(dos(slot) + part * kRows * kRowBytes, &maps.dout, &full[slot],
                          64 * part, it.head, q0, it.batch);
            }
          } else {
            mbar_arrive(&full[slot]);
          }
        }
      }
    };
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      if (resident) {
        // the unit's rows first: they wait only for slots that earlier units hold
        load_rows(unit, 0);
        for (int p = 0; p < passes; ++p) load_kv(unit, p);
      } else {
        for (int p = 0; p < passes; ++p) {
          load_kv(unit, p);
          load_rows(unit, first_tile(p));
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / kWgThreads, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int krow = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // the warp's first key of a pass
  const bool issuer = threadIdx.x % kWgThreads == 0;         // the warpgroup's TMA stores
  const float c = scale * kLog2e;
  float acc_k[kDN][4], acc_v[kDN][4];
  float pt[kNT][4], dst[kNT][4];                  // k q^T then p^T; v do^T then ds^T
  uint32_t pa[kRows / 16][4], da[kRows / 16][4];  // p^T and ds^T rounded: A fragments
  int loads = 0, npass = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const PassItem it = pass_item<kPack>(unit, wg, items, heads);
    const int batch = it.batch, head = it.head;
    const int unit_base = loads;  // the unit's first load (resident)
    if (resident) loads += unit_tiles;
    const int wg_tiles = kPack ? wg * item_tiles : 0;  // this warpgroup's item's first tile
    for (int p = 0; p < passes; ++p, ++npass) {
      // the key of pass row krow + i is key0 + krow + i (kPack: the item's own keys)
      const int key0 = kPack ? -64 * wg : p * kKeys, warp_key = key0 + krow;
      const int i0 = first_tile(p), tiles = item_tiles - i0;
      // load index of the pass's tile 0
      const int base = resident ? unit_base + wg_tiles + i0 : loads;
      if (!resident) loads += tiles;
      const int buf = npass % kKVBufs;
      auto slot = [&](int i) { return (base + i) % kSlots; };
      auto landed = [&](int i) { mbar_wait(&full[slot(i)], ((base + i) / kSlots) & 1); };
      const uint64_t k_desc = k_major(ks(buf), wg * 64), v_desc = k_major(vs(buf), wg * 64);
      // S^T = K Q^T into pt and dP^T = V dO^T into dst for tile i, issued and committed
      auto head_products = [&](int i) {
        const uint64_t q_desc = k_major(qs(slot(i)), 0), do_desc = k_major(dos(slot(i)), 0);
#pragma unroll
        for (int kk = 0; kk < kDP / 16; ++kk)
          wgmma_bf16_ss<kRows>(pt, k_desc + k_step<kKeys>(kk), q_desc + k_step<kRows>(kk),
                               kk > 0);
#pragma unroll
        for (int kk = 0; kk < kDP / 16; ++kk)
          wgmma_bf16_ss<kRows>(dst, v_desc + k_step<kKeys>(kk), do_desc + k_step<kRows>(kk),
                               kk > 0);
        wgmma_commit();
      };
      // p^T and ds^T of a tile in place, from its landed head products and its rows'
      // statistics (the block form rounds p to bf16 first); `masked` (std::true_type): the
      // tile holds a masked entry
      auto tile_probabilities = [&](int q0, const float* rs, auto masked) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int cl = 8 * n + 2 * t;  // this lane's two query rows of the tile: cl, cl + 1
          const float2 off = *reinterpret_cast<const float2*>(rs + cl);
          const float2 dl = *reinterpret_cast<const float2*>(rs + kRows + cl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pr = ex2(fmaf(pt[n][e], c, -((e & 1) ? off.y : off.x)));
            if constexpr (decltype(masked)::value) {
              const int key = warp_key + g + 8 * (e >> 1), row = q0 + cl + (e & 1);
              pr = key < s && row < s && (!causal || key <= row) ? pr : 0.f;
            }
            pt[n][e] = pr;  // the bfloat16 packing rounds it for dv; the fused ds takes it exact
          }
          if constexpr (Ops::kBlock) {  // the block form's p, rounded to bf16
            round_pair(pt[n][0], pt[n][1]);
            round_pair(pt[n][2], pt[n][3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[n][e] = __fmul_rn(pt[n][e], __fsub_rn(dst[n][e], (e & 1) ? dl.y : dl.x));
        }
      };
      auto probabilities = [&](int i) {
        const int q0 = (i0 + i) * kRows;
        const float* rs = row_stats(slot(i));
        // an inner tile (every key and row live, no key past a row) skips the tests
        if (q0 + kRows > s || warp_key + 16 > s || (causal && warp_key + 15 > q0))
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
        const uint64_t do_mn = mn_major<kRows>(dos(slot(i))), q_mn = mn_major<kRows>(qs(slot(i)));
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_bf16_rs<kDP>(acc_v, pa[kk], do_mn + mn_step(kk), 1);
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          wgmma_bf16_rs<kDP>(acc_k, da[kk], q_mn + mn_step(kk), 1);
        wgmma_commit();
      };
      auto release = [&](int i) {  // streamed: this warp is done with tile i's slot
        if (resident) return;
        __syncwarp();
        if (lane == 0) mbar_arrive(&freed[slot(i)]);
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
      mbar_wait(&kv_full[buf], (npass / kKVBufs) & 1);
      if constexpr (!Ops::kOverlap) {
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
      } else {
        landed(0);
        fence_all();
        wgmma_fence();
        head_products(0);
        wgmma_wait<0>();
        fence_all();
        probabilities(0);
        // Per step: the head products of tile i + 1 and dV, dK of tile i go to the tensor
        // cores together; p^T and ds^T of tile i + 1 are formed as soon as its products land,
        // while dV and dK still run. Nothing is in flight across the loop's edges.
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
      // dk = sm_scale acc_k and dv = acc_v, rounded once, staged over the warpgroup's K and V
      // rows of the buffer and stored by TMA; the buffer is released once the stores have
      // read it
      const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
      unsigned char* k_rows = ks(buf) + wg * 64 * kRowBytes;
      unsigned char* v_rows = vs(buf) + wg * 64 * kRowBytes;
      named_bar_sync(1 + wg, kWgThreads);  // every warp of the warpgroup is past its products
      stage_out<kDN, kKeys>(k_rows, krow - wg * 64, mul_k, acc_k, lane);
      stage_out<kDN, kKeys>(v_rows, krow - wg * 64, mul_v, acc_v, lane);
      fence_proxy_async();
      named_bar_sync(1 + wg, kWgThreads);
      if (issuer) {
        if (it.live) {
          for (int part = 0; part < kParts; ++part) {
            tma_store_4d(&maps.dk, k_rows + part * kKeys * kRowBytes, 64 * part, head,
                         key0 + wg * 64, batch);
            tma_store_4d(&maps.dv, v_rows + part * kKeys * kRowBytes, 64 * part, head,
                         key0 + wg * 64, batch);
          }
          bulk_commit();
        }
        bulk_wait_read<0>();
      }
      named_bar_sync(1 + wg, kWgThreads);
      if (lane == 0) mbar_arrive(&kv_free[buf]);  // this warp is done with the pass's K and V
    }
    if (resident) {  // every pass of the unit is done with its Q and dO tiles
      __syncwarp();
      if (lane == 0)
        for (int i = 0; i < unit_tiles; ++i) mbar_arrive(&freed[(unit_base + i) % kSlots]);
    }
  }
  if (issuer) bulk_wait<0>();  // the last stores are written
}


// q, k, v, dout, dq, dk, dv: rows of `ld` elements, head h's d columns at h d, batch entries s
// rows apart ([B, S, heads d] packed, or the block kernels' planes); stats: float32 [2][B heads
// S]; attnpre: the block form's, as q (null in the fused form)
template <int kBlock>
cudaError_t bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                      float* stats, void* attnpre, void* dq, void* dk, void* dv, int b, int s,
                      int heads, int d, size_t ld, float scale, int causal,
                      cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(b) * heads;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  FusedBwdMaps maps = {};
  if (!encode_heads(encode, &maps.dq, dq, b, s, heads, d, 64, ld) ||
      !encode_heads(encode, &maps.dk, dk, b, s, heads, d, 64, ld) ||
      !encode_heads(encode, &maps.dv, dv, b, s, heads, d, 64, ld))
    return cudaErrorInvalidValue;
  auto encode_all = [&](int q_rows, int k_rows) {
    return encode_heads(encode, &maps.q, q, b, s, heads, d, q_rows, ld) &&
           encode_heads(encode, &maps.dout, dout, b, s, heads, d, q_rows, ld) &&
           encode_heads(encode, &maps.k, k, b, s, heads, d, k_rows, ld) &&
           encode_heads(encode, &maps.v, v, b, s, heads, d, k_rows, ld);
  };
  auto grid_of = [&](bool pack) {  // one block an SM, at most one a unit
    const long long units = pack ? (items + 1) / 2 : items;
    return dim3(static_cast<unsigned>(units < sms ? units : sms));
  };
  auto launch_dq = [&](auto ops) -> cudaError_t {
    using Ops = decltype(ops);
    if (!encode_all(Ops::kPack ? 64 : Ops::kRows, Ops::kKeys)) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(fused_dq_kernel<Ops>, Ops::kBytes);
    if (e != cudaSuccess) return e;
    fused_dq_kernel<Ops><<<grid_of(Ops::kPack), kHopperThreads, Ops::kBytes, stream>>>(
        maps, stats, static_cast<__nv_bfloat16*>(attnpre), static_cast<int>(ld), b, s, heads,
        scale, causal);
    return cudaGetLastError();
  };
  auto launch_dkv = [&](auto ops) -> cudaError_t {
    using Ops = decltype(ops);
    if (!encode_all(Ops::kRowsT, Ops::kPack ? 64 : Ops::kKeys)) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(fused_dkv_kernel<Ops>, Ops::kBytes);
    if (e != cudaSuccess) return e;
    fused_dkv_kernel<Ops><<<grid_of(Ops::kPack), kHopperThreads, Ops::kBytes, stream>>>(
        maps, stats, b, s, heads, scale, causal);
    return cudaGetLastError();
  };
  auto pair = [&](auto dq_ops, auto dkv_ops) {
    const cudaError_t e = launch_dq(dq_ops);
    return e != cudaSuccess ? e : launch_dkv(dkv_ops);
  };
  if constexpr (kBlock) {
    if (s <= 64) {  // two items a pass
      if (d > 64) return pair(FusedDqOps<128, 32, 1, 1>{}, FusedDkvOps<128, 1, 1>{});
      return pair(FusedDqOps<64, 64, 1, 1>{}, FusedDkvOps<64, 1, 1>{});
    }
  }
  if (d > 64) return pair(FusedDqOps<128, 32, kBlock>{}, FusedDkvOps<128, kBlock>{});
  return pair(FusedDqOps<64, 64, kBlock>{}, FusedDkvOps<64, kBlock>{});
}

// float32: delta = rowsum(dout * out) of every query row, into [B, heads, S] as the flash dQ and
// dK/dV kernels read it. A warp a row, its lanes over the row's d columns two at a time (one
// coalesced 256-byte load a tensor at d = 64), then a butterfly sum: every row one owner and one
// order. Plain torch took 0.30 ms for it on an H100 at B=256 S=197 H=12 D=64 (a product written
// out, a reduction and a transpose; PERF.md), where reading do and out once takes 0.09 ms at the
// card's byte rate.
constexpr int kDeltaWarps = 8;
__global__ void __launch_bounds__(32 * kDeltaWarps)
fused_delta_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                   float* __restrict__ delta, long long rows, int s, int heads, int d) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kDeltaWarps;
  for (long long r = (long long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5); r < rows;
       r += warps) {  // r = (batch s + row) heads + head
    const float* a = dout + r * d;
    const float* o = out + r * d;
    float sum = 0.f;
    for (int c = 2 * lane; c < d; c += 64) {
      const float2 x = *reinterpret_cast<const float2*>(a + c);
      const float2 y = *reinterpret_cast<const float2*>(o + c);
      sum = fmaf(x.x, y.x, sum);
      sum = fmaf(x.y, y.y, sum);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) {
      const long long head = r % heads, row = r / heads;  // row = batch s + query row
      delta[(row / s * heads + head) * s + row % s] = sum;
    }
  }
}

}  // namespace

extern "C" {

// flash_attention.cu's entries: the float32 backward is its dQ and dK/dV kernels on Tf32Ops
int mmt_flash_attention_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int b,
                           int sq, int sk, int heads, int d, int causal, float sm_scale,
                           void* stream);
int mmt_flash_attention_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream);

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: [B, S, heads*d], contiguous on one device.
// lse: null, or (float32 only) float32 [B*heads*S], each row's log-sum-exp of the scaled logits
// (natural log, as the flash kernels take it). Launches on `stream` without synchronising.
// Returns a cudaError_t.
int mmt_fused_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            void* lse, int b, int s, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!fused_shape_ok(b, s, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)fused_fwd<float>(q, k, v, out, lp, b, s, heads, d, causal, sm_scale, st);
  if (dtype == 1)
    return (int)fused_fwd<__nv_bfloat16>(q, k, v, out, lp, b, s, heads, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// dout: the cotangent of out; out and lse: the forward's (float32 only, null in bfloat16), lse
// each row's log-sum-exp [B*heads*S]. stats: float32 scratch, [2, B*heads*S] in bfloat16 (each
// row's lse and delta, written by the dQ kernel and read by the dK/dV kernel), [B*heads*S] in
// float32 (delta = rowsum(dout * out)). Outputs dq, dk, dv as q. Two launches in bfloat16; three
// in float32: the row deltas, then the flash dQ and dK/dV kernels on the packed tensors read as
// [B, S, heads, d].
int mmt_fused_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* out, const void* lse, void* stats,
                            void* dq, void* dk, void* dv, int b, int s, int heads, int d,
                            int causal, float sm_scale, void* stream) {
  if (!fused_shape_ok(b, s, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 1)
    return (int)bwd_wgmma<0>(q, k, v, dout, sp, nullptr, dq, dk, dv, b, s, heads, d,
                             (size_t)heads * d, sm_scale, causal, st);
  if (dtype != 0 || out == nullptr || lse == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * s * heads;
  const long long blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  fused_delta_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 32 * kDeltaWarps, 0, st>>>(
      static_cast<const float*>(dout), static_cast<const float*>(out), sp, rows, s, heads, d);
  int err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  err = mmt_flash_attention_dq(0, q, k, v, dout, lse, sp, dq, b, s, s, heads, d, causal, sm_scale,
                               stream);
  if (err != (int)cudaSuccess) return err;
  return mmt_flash_attention_dkv(0, q, k, v, dout, lse, sp, dk, dv, b, s, s, heads, d, causal,
                                 sm_scale, stream);
}

// The block-attention kernels' attention halves on wgmma (block_attention_fwd.cu,
// block_attention_bwd.cu), bfloat16, for D in {32, 64, 128}: q, k, v, dout and the outputs are
// rows of `ld` elements, head h's d columns at h d, batch entries s rows apart (the planes of
// the [3, B*S, W] q/k/v scratch, ld = W). The forward core is the fused forward (the same
// function: both round the normalised p before p v); the backward's dQ and dK/dV kernels run in
// their block form, with attnpre. stats: float32 [2, B*heads*S] scratch.
int mmt_block_attention_core_wgmma(const void* q, const void* k, const void* v, void* out, int b,
                                   int s, int heads, int d, int ld, int causal, float scale,
                                   void* stream) {
  return (int)fused_fwd_wgmma(q, k, v, out, b, s, heads, d, (size_t)ld, scale, causal,
                              static_cast<cudaStream_t>(stream));
}

int mmt_block_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                  const void* dout, void* stats, void* attnpre, void* dq,
                                  void* dk, void* dv, int b, int s, int heads, int d, int ld,
                                  int causal, float scale, void* stream) {
  return (int)bwd_wgmma<1>(q, k, v, dout, static_cast<float*>(stats), attnpre, dq, dk, dv, b, s,
                           heads, d, (size_t)ld, scale, causal,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
