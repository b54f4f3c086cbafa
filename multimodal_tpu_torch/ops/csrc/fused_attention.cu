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
// delta and ds from the rounded p: the passes in attention_passes.cuh are templated on that
// choice (kExactProbs) and this file instantiates the exact form.
//
// One launch forward and two backward (a dQ pass that saves three f32 numbers per query row,
// then a dK/dV pass that rebuilds p and ds from them), so dK and dV need no atomics and no
// [B,H,S,S] tensor reaches device memory. The backward and the float32 forward are the
// passes of attention_passes.cuh, shared with the block-attention kernels; that header says
// what bounds them on the card (float32 by CUDA-core operations, bfloat16 by bytes) and what
// their design does about it: a block per 64-row query tile that walks the keys with an
// online softmax instead of keeping a [rows, S] logits buffer (which moves the rounding of p
// from the normalised to the unnormalised probability; delta still sees the exact f32
// probabilities); in bfloat16 mma.sync tensor-core products on bf16 tiles that stream through
// shared memory by 16-byte cp.async, in float32 4x4 register tiles. The bfloat16 forward is
// this file's own kernel, fused_fwd_kernel below, on wgmma fed by TMA. The TPU kernel's
// 16-row sequence pad and its 128-lane head groups are Mosaic tiling and have no counterpart:
// the ragged last tile is masked. The loads need D a multiple of 8 (and 16-byte aligned
// tensors, which the wrapper checks).

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
// of a [kDN / 8][64][64] bf16 buffer in the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)): the lanes of one store fall into 32 different banks
template <int kDN>
__device__ __forceinline__ void stage_out(unsigned char* buf, int row0, const float (&mul)[2],
                                          const float (&acc)[kDN][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      unsigned char* at = buf + (n / 8) * 64 * kRowBytes + r * kRowBytes;
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

template <typename T>
cudaError_t fused_fwd(const void* q, const void* k, const void* v, void* out, int b, int s,
                      int heads, int d, int causal, float sm_scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return fused_fwd_wgmma(q, k, v, out, b, s, heads, d, (size_t)heads * d, sm_scale, causal,
                           stream);
  } else {
    return launch_attention_core<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(out), b, s,
                                    heads * d, heads, d, sm_scale, causal, stream);
  }
}

template <typename T>
cudaError_t fused_bwd(const void* q, const void* k, const void* v, const void* dout,
                      float* stats, void* dq, void* dk, void* dv, int b, int s, int heads, int d,
                      int causal, float sm_scale, cudaStream_t stream) {
  return launch_attention_bwd_passes<T, true>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), stats, static_cast<T*>(nullptr), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), b, s, heads * d, heads, d, sm_scale, causal,
      stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: [B, S, heads*d], contiguous on one device.
// Launches on `stream` without synchronising. Returns a cudaError_t.
int mmt_fused_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            int b, int s, int heads, int d, int causal, float sm_scale,
                            void* stream) {
  if (!fused_shape_ok(b, s, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)fused_fwd<float>(q, k, v, out, b, s, heads, d, causal, sm_scale, st);
  if (dtype == 1)
    return (int)fused_fwd<__nv_bfloat16>(q, k, v, out, b, s, heads, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// dout: the cotangent of out. stats: float32 scratch [3, B*heads*S]. Outputs dq, dk, dv as q.
int mmt_fused_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, void* stats, void* dq, void* dk, void* dv, int b,
                            int s, int heads, int d, int causal, float sm_scale, void* stream) {
  if (!fused_shape_ok(b, s, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)fused_bwd<float>(q, k, v, dout, sp, dq, dk, dv, b, s, heads, d, causal, sm_scale,
                                 st);
  if (dtype == 1)
    return (int)fused_bwd<__nv_bfloat16>(q, k, v, dout, sp, dq, dk, dv, b, s, heads, d, causal,
                                         sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
