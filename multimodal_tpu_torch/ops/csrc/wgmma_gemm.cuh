// The bfloat16 GEMM on Hopper's warpgroup tensor-core instructions, fed by TMA: every bf16 product
// of the fused MLP branch (block_mlp.cu: c_fc, c_proj forward; dh, dln, dW2, dW1 backward) and
// of the block-attention kernels (block_attention_fwd.cu, block_attention_bwd.cu: q/k/v, the out
// projection, do and dx, and the operator's four weight gradients). float32 keeps mma_gemm.cuh's
// 3xTF32 GEMM in the kernels and a float32 torch.matmul for the block weight gradients. The contract is
// mma_gemm.cuh's for the forms, load transforms and stores these launches use (that header
// spells them out):
//
//   NN  C_z = A' @ B_z + bias_z  A [M, K] K-major; B_z [K, N] row-major, so MN-major; up to
//       kSets weight sets in one launch (q, k, v = x @ Wq|Wk|Wv + b), set z its own tiles
//   NT  C = sum_z A_z @ W_z^T    A_z [M, K]; W_z [N, K], both K-major; up to kSets segments
//       walked as one stream of K-steps into one f32 sum (dx = [dq | dk | dv] @ [Wq; Wk; Wv]^T
//       over K = 3W)
//   TN  C_z = A'[K_z, M]^T @ B[K_z, N] over split z's token rows K_z (a multiple of the K-step
//       of 64 long, the last one ragged at T); A and B [K, .] row-major, both MN-major; one f32
//       partial [M, N] per split; or, with four operand sets and the serial store (the block
//       backward's weight gradients: dWq, dWk, dWv = a^T dq, a^T dk, a^T dv and dWo =
//       attnpre^T dy, set s its own A_s and B_s), C_s = sum over the splits z in order of
//       A_s[K_z]^T B_s[K_z], rounded once to bf16 by the kernel itself
//
// with the LN load (c_fc and the block forward's q/k/v: ln_bf16x8, the row's statistics rounded
// to bf16), the act load (dW2: g = round(act(f32(h))) from the saved h) and the LN-b load (dW1:
// ln_b_bf16x8 with the contraction row's f32 statistics), and the stores round (+ bias; float
// out for dln, the block LN backward's g and the TN partials), residual (the block forward's
// out projection with the residual: bias, one rounding to bf16, + x, a second rounding),
// bias-residual (c_proj: bias and residual added in f32, one rounding), round+act (c_fc: h,
// and g beside it by the same function dW2's act load runs, so the two g are the same bits) and
// act' (dh, with db1's column partials). Every store rounds where mma_gemm.cuh's does and the
// LN transforms are its bf16 arithmetic; the activation and its derivative are evaluated on
// the special-function unit (act_fwd_fast, act_bwd_fast: ex2.approx and an approximate
// reciprocal, a few ulp of f32 where act_fwd's expf and division are within one), because the
// act load evaluates T x H x N / 256 activations and ran at half the speed of the same product
// without it.
//
// kSets (1, 3 or 4) is the number of operand sets a launch can take: 1 for the MLP's products, 3
// for every block-attention product of the kernels (the q/k/v NN and the dx NT take three; the
// out projection and do run the same instantiations with one), 4 for the block backward's
// weight gradients (TN), so each block-attention GEMM is an instantiation of its own and a
// profile tells it from the MLP's. The sets' tensor maps travel in one __grid_constant__ struct
// (WgmmaMaps: up to eight 128-byte maps, 1 KB of the 4 KB parameter space), chosen per tile (NN,
// TN) or per K-step (NT) by selects on their addresses: no activation is copied into a
// concatenated buffer; the weight gradients' three q/k/v sets hold three maps of the same a. The block backward recomputes q, k and v by
// the NN form on ln_out, where the forward's LN form transforms x on its landed tiles: the two
// run the same mainloop over the same K order, and ln_rows_kernel writes ln_out with
// ln_bf16x8, the function of the LN load, so their q, k and v are the same bits.
//
// Design. A block is two consumer warpgroups (256 threads), each owning 64 rows of a 128 x kBN
// tile of C, its sum in registers (m64nNk16 with N = kBN: kBN / 2 floats a thread). K is walked in
// steps of 64 (128 bytes of bf16, one 128-byte swizzle atom) through a ring of stages: one thread
// copies each stage's A and B tiles by TMA 2-D boxes in the 128-byte swizzle (64 columns x 128
// (A) or kBN (B) rows for a K-major operand, boxes of 64 columns x 64 rows side by side for an
// MN-major one; rows past T and columns past N land as zeros), completion counted in bytes on
// the stage's mbarrier; each consumer warp arrives on the stage's release barrier once its
// products are done, and the copying thread refills the stage with the step a ring ahead as soon
// as all eight have. The products are four wgmma a step with both operands in shared memory:
// the descriptor's transpose bits take each operand as it lies (NN: A K-major, B MN-major; NT:
// both K-major; TN: both MN-major), so no operand is transposed in memory.
//
// Two tile widths (WgmmaLayout): kBN = 128, three 32 KB stages (103 KB), two blocks an SM,
// at most 128 registers a thread: c_fc, c_proj and dh, whose epilogues (act, a second output or
// h read, N = H wide) are long beside their K = W mainloops, so the other block's products run
// through them; kBN = 256, four 48 KB stages (201 KB), one block an SM: dln and the weight
// gradients, whose K is long (H, or a split's thousands of token rows) and whose A tile (the
// act and LN-b transforms) then serves twice the columns. Measured on the H100 (PERF.md):
// dln 0.44 -> 0.35 ms and dW2 0.92 -> 0.78 ms at 256; c_proj 0.43 -> 0.48 and c_fc 0.72 -> 0.82.
//
// The load transforms run on the landed A tile in shared memory, in place: each warpgroup
// transforms its own 64 rows (NN) or 64 columns (TN) of A, 16 bytes at a time (a thread owns
// 4 of the 512 chunks, a fixed column of 8 elements in 4 rows 16 apart, so its gamma and beta,
// or in TN its columns' gamma and beta, are one 16-byte load), then fence.proxy.async and a named
// barrier over the warpgroup, then its wgmma. The register operand (ldmatrix into the A fragment,
// the transform there, register-A wgmma) was the other way; it needs the same loads and
// arithmetic and a second instruction form for every operand layout, while the shared-memory
// transform leaves the products one form and costs one 16-byte store a chunk and a barrier.
// The statistics a step needs are read before its stage is waited for: c_fc's row statistics
// once a tile (four rows a thread), dW1's token rows (four a step). Rows past T:
// the NN / NT stores skip rows past M; in TN the LN-b transform skips the token rows past T
// (LN-b of a zero row would be beta), which stay the zeros TMA wrote, as do B's.
//
// Ordering rules ptxas imposes on wgmma (a kernel serialises all of its wgmma if one sits under
// a run-time condition, behind a branch between the wgmma fence and the wgmma, or in flight
// across a loop edge; keeping a step's products in flight into the next step, wait_group 1,
// drew C7518 and ran no faster): every wait (the stage's barrier, the transform's named
// barrier) precedes the fence; the accumulate flag of a step's first product is an operand, not
// a branch; each step waits for its own products (wait_group 0) before the loop's edge, and the
// other warpgroups on the SM keep the tensor cores busy across that wait. The blocks are
// persistent and walk their tiles (N fastest, so blocks running together share A's rows in L2)
// as one stream of K-steps, so the next tile's first copies are in flight while this tile's
// epilogue runs.
//
// The epilogue takes 16 columns at a time: each lane swaps one pair of sums with its neighbour
// (quad_values) so that it holds 4 consecutive values of each of its two rows, and a quad of
// lanes loads (bias, residual, h) and stores a row's 16 values whole: storing pairs, half
// sectors, ran c_fc at 1.24 ms against 0.72 (PERF.md). The tile's h (act') or residual
// (bias-residual) is read into registers before its last K-step, so that the loads' latency
// hides behind that step's products (dh 0.77 -> 0.65 ms). act' also forms db1's column partial of the
// unrounded products over the tile's 128 rows in a fixed order: each lane adds its two rows (row
// + 8 after row), a butterfly over the eight lanes of a column (lane ^ 4, ^ 8, ^ 16), then the
// eight warps' sums in row order through shared memory; row (the tile's M index) of col_part.
// No float atomics: a result never differs from run to run.
//
// The serial store (TN over four sets; the block weight gradients, whose W x W outputs are 72
// tiles of 128 x 256 at W = 768, too few for 132 SMs, over K = T = 12,800-50,432 token rows):
// the tiles run split by split (the split slowest, then the set, M and N), so that the blocks
// running together read the same token rows of every operand (a's rows serve three sets) and
// share them in L2. A tile of split z > 0 waits until split z - 1 of the same output tile has
// published its running sum (an int flag a tile, acquire / release at GPU scope), adds its own
// products to it (sum + partial, in split order) and writes it back through L2 (ld/st.cg), or
// rounds it to bf16 and stores the weight gradient if it is the last split. The flags count the
// splits done and are zeroed by the launcher; split z - 1 of a tile comes earlier in every
// block's tile order, so the earliest unfinished tile never waits and the chain always moves (a
// wait that outlasts ~2^24 polls traps, so a fault fails the launch instead of hanging the card).
// The order of every sum is fixed: no float atomics, a second launch gives the same bits.
//
// N % 128 == 0 and, in NN and NT, K % 64 == 0 (the MLP's W and H are multiples of 128).

#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "mma_gemm.cuh"

namespace {

constexpr int kWgmmaBM = 128, kWgmmaBK = 64;  // tile rows of C, K-step
constexpr int kWgmmaThreads = 256;              // two consumer warpgroups of 64 rows
constexpr int kWgmmaWarps = kWgmmaThreads / 32;  // arrivals that release a stage
constexpr int kWgmmaPartBytes = 64 * 128;       // [64 rows][64 bf16]: one 64-column box
constexpr int kWgmmaATileBytes = 2 * kWgmmaPartBytes;  // A's stage: 16 KB
// the serial store (mma_gemm.cuh's kStore values go up to 4): TN over four operand sets, the
// splits summed in order inside the kernel, one bf16 rounding
constexpr int kStoreSerial = 5;
static_assert(kWgmmaBM == kGemmBM, "db1's partial rows are one per 128-token tile in both dtypes");

// The shared memory of a tile kBN columns wide: a ring of stages (A, then B), the act' store's
// column sums [8 warps][kBN] and the barriers. 128 columns: three 32 KB stages, two blocks an SM;
// 256: four 48 KB stages, one block an SM
template <int kBN>
struct WgmmaLayout {
  static constexpr int kStages = kBN == 128 ? 3 : 4;
  static constexpr int kBlocksPerSm = kBN == 128 ? 2 : 1;
  static constexpr int kBTileBytes = kBN * 128;
  static constexpr int kStageBytes = kWgmmaATileBytes + kBTileBytes;
  static constexpr int kRedOffset = kStages * kStageBytes;
  static constexpr int kBarOffset = kRedOffset + kWgmmaWarps * kBN * 4;
  static constexpr int kBytes = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment
};

// d[64 x kBN] (+)= a . b over a k-step of 16, both operands in shared memory
template <int kBN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[kBN / 8][4], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (kBN == 128)
    wgmma_bf16_ss_t128<kTransA, kTransB>(d, da, db, accumulate);
  else
    wgmma_bf16_ss_t256<kTransA, kTransB>(d, da, db, accumulate);
}

// act(h), d act / d h and round(act(h)) in f32 on the special-function unit. Both activations
// are h sigmoid(z): z = 1.702 h for quick_gelu, z = 2u for tanh-gelu (0.5 h (1 + tanh u) with
// 1 + tanh u = 2 sigmoid(2u)); sigmoid(z) = 1 / (1 + 2^(-z log2 e)) by ex2.approx and the
// approximate reciprocal (0 once the sum passes 2^126), a few ulp of f32 from act_fwd and
// act_bwd, which evaluate expf, tanhf and the division to within one
__device__ __forceinline__ float sigmoid_fast(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}
__device__ __forceinline__ float act_z(float h, int act) {
  return act == kActQuickGelu ? 1.702f * h : 2.f * kSqrt2OverPi * (h + kGeluC * h * h * h);
}
__device__ __forceinline__ float act_fwd_fast(float h, int act) {
  return h * sigmoid_fast(act_z(h, act));
}
__device__ __forceinline__ float act_bwd_fast(float h, int act) {
  const float s = sigmoid_fast(act_z(h, act));
  const float dz =
      act == kActQuickGelu ? 1.702f : 2.f * kSqrt2OverPi * (1.f + 3.f * kGeluC * h * h);
  return s + h * dz * s * (1.f - s);
}
// g = round(act(f32(h))) of a rounded h: c_fc's store writes it, dW2's load forms it again
__device__ __forceinline__ float act_round_fast(float h, int act) {
  return round_to<__nv_bfloat16>(act_fwd_fast(h, act));
}
// act_round_fast of eight bf16 values in shared memory, in place
__device__ __forceinline__ void act_chunk_fast(__nv_bfloat16* p, int act) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(act_fwd_fast(f.x, act), act_fwd_fast(f.y, act));
  }
  *reinterpret_cast<uint4*>(p) = v;
}

// The sums of a lane's row h (0: row g, 1: row g + 8) in a 16-column group jj, as 4 consecutive
// values: the lane holds the pairs at columns 2t, 2t + 1 and 8 further (acc[2jj], acc[2jj + 1]);
// an even lane keeps its first pair and takes its odd neighbour's, an odd lane keeps its second
// and takes its even neighbour's, so that it holds columns quad .. quad + 3, quad = 2t (t even)
// or 2t + 6 (t odd), and a quad of lanes the group's 16 columns. Every lane takes part
template <int kN>
__device__ __forceinline__ void quad_values(const float (&acc)[kN][4], int jj, int h, bool odd,
                                            float (&v)[4]) {
  const float2 p0 = make_float2(acc[2 * jj][2 * h], acc[2 * jj][2 * h + 1]);
  const float2 p1 = make_float2(acc[2 * jj + 1][2 * h], acc[2 * jj + 1][2 * h + 1]);
  const float2 keep = odd ? p1 : p0, give = odd ? p0 : p1;
  const float gx = __shfl_xor_sync(0xffffffffu, give.x, 1);
  const float gy = __shfl_xor_sync(0xffffffffu, give.y, 1);
  v[0] = odd ? gx : keep.x, v[1] = odd ? gy : keep.y;
  v[2] = odd ? keep.x : gx, v[3] = odd ? keep.y : gy;
}

struct WgmmaGemmArgs {
  int m, n, k;           // C [m, n]; the contraction k (TN: the token rows T; NT: a segment's)
  int splits;            // TN: splits of the token rows (1 otherwise)
  int sets;              // NN: weight sets, NT: K segments (kSets = 3 only; 1 otherwise)
  int k_per_split;       // TN: token rows a split owns, a multiple of kWgmmaBK
  const float* ln_mean;  // LN: by row of A; LN-b: by token row, f32
  const float* ln_inv;
  const __nv_bfloat16* ln_gamma;  // LN: [k]; LN-b: [m]
  const __nv_bfloat16* ln_beta;
  const __nv_bfloat16* bias[3];   // NN: set z's [n] or null; otherwise bias[0] or null
  const __nv_bfloat16* residual;  // residual, bias-residual: [m, n]
  const __nv_bfloat16* h;         // act': the pre-activation [m, n]
  int act;                        // act load, round+act and act' stores
  void* c[3];                     // NN: set z's [m, n]; otherwise c[0] ([m, n]; TN: [splits,
                                  // m, n] f32; serial: [kSets, m, n] bf16)
  __nv_bfloat16* g_out;           // round+act: [m, n]
  float* col_part;                // act': [ceil(m / 128), n]
  float* serial_sum;              // serial: [kSets, m, n] f32, the running sums
  int* serial_flag;               // serial: [kSets, tiles of M, tiles of N], zero at launch
};

// the tensor maps of a launch: A_z and B_z of each operand set (NN: a[0] alone)
template <int kSets>
struct WgmmaMaps {
  CUtensorMap a[kSets], b[kSets];
};

// &maps[z] by selects on the addresses: an index into the parameter space at run time
template <int kSets>
__device__ __forceinline__ const CUtensorMap* pick_map(const CUtensorMap (&maps)[kSets], int z) {
  if constexpr (kSets == 1)
    return &maps[0];
  else if constexpr (kSets == 3)
    return z == 0 ? &maps[0] : (z == 1 ? &maps[1] : &maps[2]);
  else
    return z == 0 ? &maps[0] : (z == 1 ? &maps[1] : (z == 2 ? &maps[2] : &maps[3]));
}

// the serial store's flags: wait until *flag reaches `value` (acquire: the sums published before
// it are visible), trapping after ~2^24 polls; publish `value` (release)
__device__ __forceinline__ void wait_flag(const int* flag, int value) {
  for (uint32_t tries = 0;; ++tries) {
    int seen;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(seen) : "l"(flag) : "memory");
    if (seen >= value) return;
    if (tries == (1u << 24)) __trap();
    __nanosleep(64);
  }
}
__device__ __forceinline__ void publish_flag(int* flag, int value) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(flag), "r"(value) : "memory");
}

// The serial store of one 128 x kBN tile of set `set`, split z of `splits`: each lane's values
// 4 consecutive columns of its two rows at a time (quad_values), added to the running sum split
// z - 1 left (z > 0), then written back for split z + 1 or, at the last split, rounded to bf16
// into the weight gradient. The running sums are read kSerialGroup 16-column groups at a time
// before any of them is written back: a load after a store to the same array waits for it (the
// compiler cannot tell the addresses apart), so one group at a time would pay an L2 round trip
// for each of the tile's kBN / 16 groups. Rows are all live (M = W, a multiple of 128); columns
// past N are skipped. Every thread of the block takes part (the barriers)
constexpr int kSerialGroup = 4;

template <int kBN>
__device__ __forceinline__ void serial_store(const float (&acc)[kBN / 8][4],
                                             const WgmmaGemmArgs& args, int set, int z,
                                             int flag_at, int n0, int row0, int quad,
                                             bool odd) {
  static_assert(kBN / 16 % kSerialGroup == 0, "whole groups");
  const int m = args.m, n = args.n;
  float* sum = args.serial_sum + static_cast<size_t>(set) * m * n;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(args.c[0]) + static_cast<size_t>(set) * m * n;
  int* flag = args.serial_flag + flag_at;
  const bool last = z + 1 == args.splits;
  if (z > 0) {
    if (threadIdx.x == 0) wait_flag(flag, z);
    __syncthreads();
  }
#pragma unroll
  for (int j0 = 0; j0 < kBN / 16; j0 += kSerialGroup) {
    if (n0 + 16 * j0 >= n) break;  // N is a multiple of 128: a group is live or not as a whole
    float4 prev[kSerialGroup][2] = {};
    if (z > 0) {
#pragma unroll
      for (int jj = 0; jj < kSerialGroup; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          prev[jj][h] = __ldcg(reinterpret_cast<const float4*>(
              sum + static_cast<size_t>(row0 + 8 * h) * n + n0 + 16 * (j0 + jj) + quad));
    }
#pragma unroll
    for (int jj = 0; jj < kSerialGroup; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t at = static_cast<size_t>(row0 + 8 * h) * n + n0 + 16 * (j0 + jj) + quad;
        float v[4];
        quad_values(acc, j0 + jj, h, odd, v);
        const float4 p = prev[jj][h];  // zeros at split 0, never added there
        if (z > 0) {
          v[0] = __fadd_rn(p.x, v[0]), v[1] = __fadd_rn(p.y, v[1]);
          v[2] = __fadd_rn(p.z, v[2]), v[3] = __fadd_rn(p.w, v[3]);
        }
        if (last)
          store4(out + at, v);
        else
          __stcg(reinterpret_cast<float4*>(sum + at), make_float4(v[0], v[1], v[2], v[3]));
      }
  }
  if (!last) {  // every thread's sums in L2 before the flag says so
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) publish_flag(flag, z + 1);
  }
}

template <typename T, typename TOut, int kForm, int kLoad, int kStore, int kBN, int kSets>
__global__ void __launch_bounds__(kWgmmaThreads, WgmmaLayout<kBN>::kBlocksPerSm)
wgmma_gemm_kernel(const __grid_constant__ WgmmaMaps<kSets> maps, const WgmmaGemmArgs args) {
  static_assert(std::is_same_v<T, __nv_bfloat16>, "wgmma_gemm_kernel is the bfloat16 GEMM");
  constexpr bool kNN = kForm == kFormNN, kNT = kForm == kFormNT, kTN = kForm == kFormTN;
  static_assert(kSets == 1 || (kSets == 3 && !kTN) || (kSets == 4 && kTN),
                "one operand set, the block kernels' three (NN, NT) or their weight gradients' four "
                "(TN)");
  static_assert((kSets == 4) == (kStore == kStoreSerial), "the serial store is the four sets'");
  static_assert(kLoad == kLoadPlain || (kForm == kFormNN && kLoad == kLoadLn) ||
                    (kTN && (kLoad == kLoadAct || kLoad == kLoadLnB)),
                "LN loads in the NN form, act and LN-b in the TN form");
  static_assert(kStore == kStoreRound || std::is_same_v<T, TOut>, "a rounded store");
  static_assert(kStore != kStoreActGrad || kBN == 128, "db1's partials come from 128-wide tiles");
  using L = WgmmaLayout<kBN>;
  constexpr int kStages = L::kStages;
  constexpr int kTransA = kTN ? 1 : 0, kTransB = kNT ? 0 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  float* red = reinterpret_cast<float*>(smem + L::kRedOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* freed = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the thread's chunks of its warpgroup's A part: chunk column cj, rows rj + 16i (i < 4)
  const int cj = tid & 7, rj = (tid & 127) >> 3;
  const int m = args.m, n = args.n;
  const int sets = kSets == 1 ? 1 : args.sets;
  const int ksteps = (args.k + kWgmmaBK - 1) / kWgmmaBK;  // NN, NT: a segment's K-steps
  const int tiles_n = (n + kBN - 1) / kBN, tiles_m = (m + kWgmmaBM - 1) / kWgmmaBM;
  const int tiles = tiles_n * tiles_m * (kTN ? args.splits * kSets : (kNN ? sets : 1));
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
                       : 0;
  struct Tile {
    int m0, n0, z, set, k_begin, k_end, steps;
  };
  // this block's i-th tile: N fastest, then M, then the set, then the split (TN); N fastest,
  // then the weight set, then M (NN: the sets' tiles of a row block share its A tiles in L2)
  auto tile_at = [&](int i) {
    const int q = static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
    Tile tl;
    tl.n0 = q % tiles_n * kBN;
    tl.set = 0;
    if constexpr (kTN) {
      tl.m0 = q / tiles_n % tiles_m * kWgmmaBM;
      tl.z = q / (tiles_n * tiles_m);
      if constexpr (kSets > 1) tl.set = tl.z % kSets, tl.z /= kSets;
    } else {
      tl.z = kNN ? q / tiles_n % sets : 0;
      tl.m0 = q / (tiles_n * (kNN ? sets : 1)) * kWgmmaBM;
    }
    tl.k_begin = kTN ? tl.z * args.k_per_split : 0;
    tl.k_end = kTN ? min(args.k, tl.k_begin + args.k_per_split) : args.k;
    tl.steps = kTN ? (tl.k_end - tl.k_begin + kWgmmaBK - 1) / kWgmmaBK
                   : (kNT ? sets : 1) * ksteps;  // NT: the segments' steps in turn
    return tl;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&freed[s], kWgmmaWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The copying thread's cursor: the next step to load, as this block's tile and k-step, and
  // the count of steps loaded so far (which stage, which phase)
  int p_i = 0, p_kt = 0, p_g = 0;
  Tile p_tile = tile_at(0);
  auto produce = [&] {  // the next step's copies into its stage, once the stage is free
    if (p_i >= mine) return;
    const int s = p_g % kStages;
    if (p_g >= kStages) mbar_wait(&freed[s], (p_g / kStages - 1) & 1);
    // NT: the step's segment, and its k0 within it; NN: the tile's weight set; TN: its set
    const int seg = kNT ? p_kt / ksteps : (kTN ? p_tile.set : 0);
    const int k0 = p_tile.k_begin + (kNT ? p_kt - seg * ksteps : p_kt) * kWgmmaBK;
    const CUtensorMap* map_a = pick_map<kSets>(maps.a, seg);
    const CUtensorMap* map_b = pick_map<kSets>(maps.b, kNN ? p_tile.z : seg);
    unsigned char* as = smem + s * L::kStageBytes;
    unsigned char* bs = as + kWgmmaATileBytes;
    mbar_expect_tx(&full[s], L::kStageBytes);
    if constexpr (kTN) {  // [64 token rows][64 columns of M] twice
      tma_load_2d(as, map_a, &full[s], p_tile.m0, k0);
      tma_load_2d(as + kWgmmaPartBytes, map_a, &full[s], p_tile.m0 + 64, k0);
    } else {  // [128 rows of M][64 of K]
      tma_load_2d(as, map_a, &full[s], k0, p_tile.m0);
    }
    if constexpr (kNT) {  // [kBN rows of N][64 of K]
      tma_load_2d(bs, map_b, &full[s], k0, p_tile.n0);
    } else {  // [64 rows of K][64 columns of N], kBN / 64 times
#pragma unroll
      for (int part = 0; part < kBN / 64; ++part)
        tma_load_2d(bs + part * kWgmmaPartBytes, map_b, &full[s], p_tile.n0 + 64 * part, k0);
    }
    ++p_g;
    if (++p_kt == p_tile.steps) {
      p_kt = 0;
      if (++p_i < mine) p_tile = tile_at(p_i);
    }
  };
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) produce();

  const T* gamma = args.ln_gamma;
  const T* beta = args.ln_beta;
  float acc[kBN / 8][4];
  zero_acc(acc);
  // act' and bias-residual: the tile's h or residual, 4 bf16 of each of the lane's two rows a
  // 16-column group, loaded before the tile's last step so that their latency hides behind it
  constexpr bool kSide =
      kStore == kStoreActGrad || kStore == kStoreBiasResidual || kStore == kStoreResidual;
  uint2 side[kSide ? kBN / 16 : 1][2];
  const bool odd = t & 1;
  const int quad = odd ? 2 * t + 6 : 2 * t;
  int step = 0;  // this block's K-steps so far: the stage and its phase
  for (int i = 0; i < mine; ++i) {
    const Tile tl = tile_at(i);
    // c_fc: the statistics of the thread's four rows, rounded to bf16 (rows past M: zeros,
    // never stored); dW1: the gamma and beta of its column chunk
    float2 row_st[4];
    uint4 col_gm = {}, col_bt = {};

    if constexpr (kLoad == kLoadLn) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = tl.m0 + 64 * wg + rj + 16 * r;
        row_st[r] = row < m ? make_float2(round_to<T>(args.ln_mean[row]),
                                          round_to<T>(args.ln_inv[row]))
                            : make_float2(0.f, 0.f);
      }
    }
    if constexpr (kLoad == kLoadLnB) {
      const int col = tl.m0 + 64 * wg + 8 * cj;
      col_gm = *reinterpret_cast<const uint4*>(gamma + col);
      col_bt = *reinterpret_cast<const uint4*>(beta + col);
    }
    for (int kt = 0; kt < tl.steps; ++kt, ++step) {
      const int s = step % kStages;
      const int k0 = tl.k_begin + kt * kWgmmaBK;
      unsigned char* as = smem + s * L::kStageBytes;
      unsigned char* bs = as + kWgmmaATileBytes;
      unsigned char* part = as + wg * kWgmmaPartBytes;  // this warpgroup's rows / columns of A
      // what the transform reads besides the tile, loaded before the wait
      uint4 gm = {}, bt = {};
      float tok_mean[4] = {}, tok_inv[4] = {};
      if constexpr (kLoad == kLoadLn) {
        gm = *reinterpret_cast<const uint4*>(gamma + k0 + 8 * cj);
        bt = *reinterpret_cast<const uint4*>(beta + k0 + 8 * cj);
      }
      if constexpr (kLoad == kLoadLnB) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int tok = k0 + rj + 16 * r;
          if (tok < tl.k_end) tok_mean[r] = args.ln_mean[tok], tok_inv[r] = args.ln_inv[tok];
        }
      }
      if constexpr (kSide) {
        if (kt + 1 == tl.steps) {
          const T* src = kStore == kStoreActGrad ? args.h : args.residual;
#pragma unroll
          for (int jj = 0; jj < kBN / 16; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // rows past M read the last row, never used
              const int row = min(tl.m0 + 64 * wg + 16 * (warp & 3) + g + 8 * h, m - 1);
              side[jj][h] = *reinterpret_cast<const uint2*>(
                  src + static_cast<size_t>(row) * n + tl.n0 + 16 * jj + quad);
            }
        }
      }
      mbar_wait(&full[s], (step / kStages) & 1);
      if constexpr (kLoad != kLoadPlain) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = rj + 16 * r;  // chunk cj of a 128-byte row sits at cj ^ (row % 8)
          uint4* p = reinterpret_cast<uint4*>(part + row * 128 + ((cj ^ (row & 7)) << 4));
          if constexpr (kLoad == kLoadLn) {
            *p = ln_bf16x8(*p, row_st[r], gm, bt);
          } else if constexpr (kLoad == kLoadAct) {
            act_chunk_fast(reinterpret_cast<T*>(p), args.act);
          } else if (k0 + row < tl.k_end) {  // LN-b: token rows past T stay zero
            *p = ln_b_bf16x8(*p, tok_mean[r], tok_inv[r], col_gm, col_bt);
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
      }
      const uint64_t da = kTN ? sw128_desc(part, kWgmmaPartBytes, 1024) : sw128_desc(part);
      const uint64_t db = kNT ? sw128_desc(bs) : sw128_desc(bs, kWgmmaPartBytes, 1024);
      // a k-step of 16: 32 bytes along a K-major row, or 16 rows of 128 bytes of an MN-major
      // operand (descriptor units of 16 bytes)
      constexpr uint64_t kStepA = kTN ? 128 : 2, kStepB = kNT ? 2 : 128;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgmmaBK / 16; ++kk)
        wgmma_tile<kBN, kTransA, kTransB>(acc, da + kk * kStepA, db + kk * kStepB,
                                          (kt > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&freed[s]);  // this warp is done with the stage
      if (tid == 0) produce();
    }

    // the epilogue, 16 columns at a time, each lane 4 consecutive values of its two rows
    // (quad_values), so that a quad of lanes stores a row's 16 values whole; rows past M are not
    // stored (nor summed), nor columns past N (a 256-wide tile at N = 128 mod 256)
    const int row0 = tl.m0 + 64 * wg + 16 * (warp & 3) + g;
    if constexpr (kStore == kStoreSerial) {
      serial_store<kBN>(acc, args, tl.set, tl.z,
                        (tl.set * tiles_m + tl.m0 / kWgmmaBM) * tiles_n + tl.n0 / kBN, tl.n0,
                        row0, quad, odd);
      continue;
    }
    TOut* c = static_cast<TOut*>(kNN ? pick3(args.c, tl.z) : args.c[0]);
    if constexpr (kTN) c += static_cast<size_t>(tl.z) * m * n;
    const T* bias = kNN ? pick3(args.bias, tl.z) : args.bias[0];
#pragma unroll
    for (int jj = 0; jj < kBN / 16; ++jj) {
      const int col = tl.n0 + 16 * jj + quad;
      if (tl.n0 + 16 * jj >= n) break;
      float b[4] = {};
      if (bias != nullptr) load4(bias + col, b);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const bool live = row < m;
        const size_t at = static_cast<size_t>(row) * n + col;
        float v[4], gv[4];
        quad_values(acc, jj, h, odd, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(v[e], b[e]);
        if constexpr (kStore == kStoreActGrad) {  // the unrounded products, kept for db1
          float hv[4];
          load4(reinterpret_cast<const T*>(&side[jj][h]), hv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = live ? __fmul_rn(v[e], act_bwd_fast(hv[e], args.act)) : 0.f;
          acc[2 * jj][2 * h] = v[0], acc[2 * jj][2 * h + 1] = v[1];
          acc[2 * jj + 1][2 * h] = v[2], acc[2 * jj + 1][2 * h + 1] = v[3];
        } else if constexpr (kStore == kStoreBiasResidual) {
          float rv[4];
          load4(reinterpret_cast<const T*>(&side[jj][h]), rv);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(v[e], rv[e]);
        } else if constexpr (kStore == kStoreResidual) {  // round, + x, round again (store4)
          float rv[4];
          load4(reinterpret_cast<const T*>(&side[jj][h]), rv);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(round_to<T>(v[e]), rv[e]);
        } else if constexpr (kStore == kStoreRoundAct) {
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[e] = act_round_fast(round_to<T>(v[e]), args.act);
        }
        if (live) {
          store4(c + at, v);
          if constexpr (kStore == kStoreRoundAct) store4(args.g_out + at, gv);
        }
      }
    }
    if constexpr (kStore == kStoreActGrad) {
      // db1: the lane's two rows in order, the eight lanes of a column (a butterfly: every lane
      // ends with the same sum), then the eight warps in row order through shared memory
#pragma unroll
      for (int jj = 0; jj < kBN / 16; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = acc[2 * jj + e / 2][e % 2] + acc[2 * jj + e / 2][2 + e % 2];
#pragma unroll
          for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (g == 0) red[warp * kBN + 16 * jj + quad + e] = v;
        }
      __syncthreads();
      if (tid < kBN) {
        float v = red[tid];
#pragma unroll
        for (int w = 1; w < kWgmmaWarps; ++w) v += red[w * kBN + tid];
        args.col_part[static_cast<size_t>(tl.m0 / kWgmmaBM) * n + tl.n0 + tid] = v;
      }
      __syncthreads();  // red is free for the next tile
    }
  }
}

// a [rows, cols] row-major bf16 matrix, boxes of 64 columns (128 bytes) x box_rows rows in the
// 128-byte swizzle; elements past either extent land as zeros
bool encode_bf16_2d(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int cols,
                    int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch over encoded maps: a persistent grid of at most kBlocksPerSm blocks an SM over the
// tiles (TN: args.splits x M/128 x N/kBN; NN: args.sets x M/128 x N/kBN; NT: M/128 x N/kBN)
template <typename TOut, int kForm, int kLoad, int kStore, int kBN, int kSets>
cudaError_t launch_wgmma_maps(const WgmmaMaps<kSets>& maps, const WgmmaGemmArgs& args,
                              cudaStream_t stream) {
  using L = WgmmaLayout<kBN>;
  auto* kernel = wgmma_gemm_kernel<__nv_bfloat16, TOut, kForm, kLoad, kStore, kBN, kSets>;
  cudaError_t err = allow_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int z = kForm == kFormTN ? args.splits * kSets
                                 : (kForm == kFormNN && kSets > 1 ? args.sets : 1);
  const long long tiles = static_cast<long long>((args.n + kBN - 1) / kBN) *
                          ((args.m + kWgmmaBM - 1) / kWgmmaBM) * z;
  const long long blocks = static_cast<long long>(L::kBlocksPerSm) * sms;
  if (tiles < 1 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles < blocks ? tiles : blocks));
  kernel<<<grid, kWgmmaThreads, L::kBytes, stream>>>(maps, args);
  return cudaGetLastError();
}

// the MLP's launches, one operand set: A [a_rows, a_cols] and B [b_rows, b_cols] as they lie in
// memory (NN: A [M, K], B [K, N]; NT: A [M, K], B [N, K]; TN: A [K, M], B [K, N])
template <typename TOut, int kForm, int kLoad, int kStore, int kBN>
cudaError_t launch_wgmma_gemm(const void* a, int a_rows, int a_cols, const void* b, int b_rows,
                              int b_cols, const WgmmaGemmArgs& args, cudaStream_t stream) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  // a K-major operand comes in [rows][64 of K] boxes, an MN-major one in [64 rows of K][64]
  const int a_box = kForm == kFormTN ? 64 : kWgmmaBM, b_box = kForm == kFormNT ? kBN : 64;
  WgmmaMaps<1> maps = {};
  if (!encode_bf16_2d(encode, &maps.a[0], a, a_rows, a_cols, a_box) ||
      !encode_bf16_2d(encode, &maps.b[0], b, b_rows, b_cols, b_box))
    return cudaErrorInvalidValue;
  return launch_wgmma_maps<TOut, kForm, kLoad, kStore, kBN, 1>(maps, args, stream);
}

// The block-attention kernels' launches (kSets = 3, 128-wide tiles), m = M rows, every operand
// [*, w] or [w, w] with K = w a segment: NN, C_z = A @ B_z + bias_z for z < sets, A [M, w] (a[0])
// and B_z [w, w]; NT, C = sum_z A_z @ B_z^T over z < sets, A_z [M, w] and B_z [w, w] ([in, out]
// weights read as their transpose). args.m, n, k and sets are set here.
template <typename TOut, int kForm, int kLoad, int kStore>
cudaError_t launch_block_gemm(const void* const* a, const void* const* b, int sets, int m, int w,
                              WgmmaGemmArgs args, cudaStream_t stream) {
  static_assert(kForm == kFormNN || kForm == kFormNT, "the block kernels' forms");
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (sets < 1 || sets > 3) return cudaErrorInvalidValue;
  constexpr int kBBox = kForm == kFormNT ? 128 : 64;
  WgmmaMaps<3> maps = {};
  for (int z = 0; z < sets; ++z) {
    if ((kForm == kFormNT || z == 0) &&
        !encode_bf16_2d(encode, &maps.a[z], a[z], m, w, kWgmmaBM))
      return cudaErrorInvalidValue;
    if (!encode_bf16_2d(encode, &maps.b[z], b[z], w, w, kBBox)) return cudaErrorInvalidValue;
  }
  args.m = m, args.n = w, args.k = w, args.splits = 1, args.sets = sets;
  return launch_wgmma_maps<TOut, kForm, kLoad, kStore, 128, 3>(maps, args, stream);
}

// The block backward's weight gradients (kSets = 4, the TN form, kBN-wide tiles (256 in the one
// use; a template, so that only the source that launches it instantiates its kernel), the serial
// store): out[s] = a_s^T b_s over t token rows for s < 4, a_s and b_s [t, w] bf16 as they lie
// (MN-major), out [4, w, w] bf16, each a sum over `splits` runs of k_per_split token rows (a
// multiple of the K-step; every split holds rows) in split order, rounded once. sum [4, w, w]
// f32 and flags [4 * (w / 128) * ceil(w / kBN)] int are scratch; the flags are zeroed here.
template <int kBN>
cudaError_t launch_block_wgrad(const void* const* a, const void* const* b, int t, int w,
                               int splits, int k_per_split, float* sum, int* flags, void* out,
                               cudaStream_t stream) {
  constexpr int kSets = 4;
  if (t < 1 || w < 128 || w % 128 != 0 || splits < 1 || k_per_split < kWgmmaBK ||
      k_per_split % kWgmmaBK != 0 || static_cast<long long>(splits - 1) * k_per_split >= t ||
      static_cast<long long>(splits) * k_per_split < t)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  WgmmaMaps<kSets> maps = {};
  for (int s = 0; s < kSets; ++s)
    if (!encode_bf16_2d(encode, &maps.a[s], a[s], t, w, 64) ||
        !encode_bf16_2d(encode, &maps.b[s], b[s], t, w, 64))
      return cudaErrorInvalidValue;
  const int flags_n = kSets * (w / kWgmmaBM) * ((w + kBN - 1) / kBN);
  cudaError_t err = cudaMemsetAsync(flags, 0, flags_n * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  WgmmaGemmArgs args = {};
  args.m = w, args.n = w, args.k = t, args.splits = splits, args.sets = kSets;
  args.k_per_split = k_per_split;
  args.c[0] = out;
  args.serial_sum = sum;
  args.serial_flag = flags;
  return launch_wgmma_maps<__nv_bfloat16, kFormTN, kLoadPlain, kStoreSerial, kBN, kSets>(
      maps, args, stream);
}

}  // namespace
