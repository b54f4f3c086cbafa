// The projection GEMM of the block-attention backward (block_attention_bwd.cu) on the tensor
// cores, in two forms:
//
//   NN: C_z = A @ B_z + bias_z for z = blockIdx.z < 3, one A [M, K] shared by up to three
//       weight sets B_z [K, N] row-major (the q, k, v recompute: x @ Wq|Wk|Wv + b);
//   NT: C = sum over z < nseg of A_z @ W_z^T, A_z [M, kseg] and W_z [N, kseg] row-major (a
//       [W_in, W_out] weight read as its transpose), up to three segments summed in one f32
//       accumulator (do = dy Wo^T; dx or g = [dq | dk | dv] @ [Wq; Wk; Wv]^T over K = 3W).
//
// Epilogue: the bias (NN, when given) added in f32, then one rounding to TOut; TOut = float keeps
// the product unrounded (the LN form's g). M is ragged: rows at or past M load as zeros (cp.async
// with a source size of 0) and are not stored. N % 128 == 0 and K (kseg) % 64 == 0 (W % 128 == 0 in
// the caller).
//
// What bounds it: 2 M N K FLOPs over (M + N) K + M N elements, several hundred FLOPs a byte at
// M = B*S in the thousands, so operations: the tensor cores, by mma.sync. One block of eight
// warps owns a 128 x 128 tile of C, each warp a 64 x 32 tile (4 x 4 fragments of 16 x 8), and
// walks K in steps of 64 through a ring of three shared-memory stages filled by 16-byte
// cp.async, so two steps are in flight while one multiplies; one __syncthreads a step. Steps
// of 64 were measured 14% faster than steps of 32 in bfloat16 and 6% in float32, and warp
// tiles of 64 x 64 (256-row blocks, one an SM) slower in bfloat16 (PERF.md).
//   * bfloat16: m16n8k16 on bf16 operands with f32 accumulation, as the SIMT kernel it
//     replaces summed exact products in f32: the same function up to the order of the sums.
//     Tiles are stored with rows padded by 8 elements (an odd multiple of 16 bytes, so the
//     eight rows of an ldmatrix fall in eight bank groups). A fragments and the NT form's B
//     (whose rows are output columns) load with ldmatrix; the NN form's B, whose rows are
//     the contraction index, with ldmatrix.trans.
//   * float32: 3xTF32 on m16n8k8 (tf32_tiles.cuh): every operand split once into a TF32 big
//     part and the rest, three products summed in f32, the small terms first, in three rounds
//     over the warp's sixteen independent accumulators; about 2^-20 relative a product, so the
//     1e-4 x max|plain| limit holds at K = 2304 where one TF32 product breaks it (the CPU
//     emulation in tests/test_torch_block_attention_bwd.py). A tiles and the NT form's B
//     (rows padded to 68 floats) load with ldmatrix on 32-bit pairs; the NN form's B cannot
//     (.trans moves 16-bit elements) and is read as 32-bit scalars from rows of 136 floats,
//     8 mod 32 banks, so (k = t, column g) falls in bank 8t + g: no conflict.
// Launch bounds: two blocks an SM in bfloat16 (108 KB of shared memory each), one in float32
// (204 KB, and the split fragments beside 64 accumulators need more than 128 registers).

#pragma once

#include <type_traits>

#include "tf32_tiles.cuh"

namespace {

// the warp grid of a block and the 16 x 8 fragments of C a warp owns
constexpr int kGemmWarpsM = 2, kGemmWarpsN = 4, kGemmMT = 4, kGemmNT = 4;
constexpr int kGemmBM = 16 * kGemmMT * kGemmWarpsM, kGemmBN = 8 * kGemmNT * kGemmWarpsN;
constexpr int kGemmBK = 64, kGemmStages = 3;  // K-step and shared-memory ring
constexpr int kMmaGemmThreads = 32 * kGemmWarpsM * kGemmWarpsN;
// blocks an SM the launch bounds ask for (a register budget): bfloat16, float32
constexpr int kGemmMinBlocksBf16 = 2, kGemmMinBlocksF32 = 1;

struct MmaGemmArgs {
  const void* a[3];     // NN: a[0] is A; NT: A_z
  const void* b[3];     // NN: B_z [K, N]; NT: W_z [N, kseg]
  const void* bias[3];  // NN: bias_z [N] or null; NT: unused
  void* c[3];           // NN: C_z; NT: c[0]
  int m, n, kseg, nseg;
};

// Row strides in elements of the stage buffers, A [kGemmBM][kLdA] and B as NT [kGemmBN][kLdA]
// or as NN [kGemmBK][kLdB], and the elements of a stage
template <typename T, bool kNN>
struct GemmLayout {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kLdA = kGemmBK + (kF32 ? 4 : 8);
  static constexpr int kLdB = kGemmBN + 8;
  static constexpr int kAElems = kGemmBM * kLdA;
  static constexpr int kStage = kAElems + (kNN ? kGemmBK * kLdB : kGemmBN * kLdA);
};

template <typename T, bool kNN>
constexpr size_t mma_gemm_smem() {
  return sizeof(T) * (size_t)kGemmStages * GemmLayout<T, kNN>::kStage;
}

// arr[z] for z < 3 by selects: indexing the kernel's parameter arrays at run time would copy
// them to local memory
template <typename P>
__device__ __forceinline__ P pick3(P const (&arr)[3], int z) {
  return z == 0 ? arr[0] : (z == 1 ? arr[1] : arr[2]);
}

// `nrows` rows of `ncols` elements (a multiple of 16 bytes) from src (row stride `stride`) into
// dst (row stride `ld`) by 16-byte cp.async; rows at or past `live_rows` are zero-filled
template <typename T>
__device__ __forceinline__ void gemm_load_tile(T* dst, int ld, const T* src, size_t stride,
                                               int nrows, int ncols, int live_rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = ncols / kVec;
  for (int e = threadIdx.x; e < nrows * chunks; e += kMmaGemmThreads) {
    const int r = e / chunks, c = (e % chunks) * kVec;
    const bool live = r < live_rows;
    cp_async16(dst + r * ld + c, live ? src + (size_t)r * stride + c : src, live);
  }
}

template <typename T, typename TOut, bool kNN>
__global__ void __launch_bounds__(kMmaGemmThreads,
                                  std::is_same_v<T, float> ? kGemmMinBlocksF32
                                                           : kGemmMinBlocksBf16)
mma_gemm_kernel(MmaGemmArgs args) {
  using L = GemmLayout<T, kNN>;
  constexpr int kLdA = L::kLdA, kLdB = L::kLdB, kStage = L::kStage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the warp's 16 kGemmMT x 8 kGemmNT tile of C
  const int wm = (warp / kGemmWarpsN) * 16 * kGemmMT, wn = (warp % kGemmWarpsN) * 8 * kGemmNT;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int m = args.m, n = args.n, kseg = args.kseg;
  const int z0 = kNN ? blockIdx.z : 0, nseg = kNN ? 1 : args.nseg;
  const int ksteps = kseg / kGemmBK, steps = nseg * ksteps;

  // step i: segment z0 + i / ksteps, columns (i % ksteps) kGemmBK of A_z and of W_z (NT) or
  // rows of B_z (NN)
  auto load = [&](int i) {
    const int z = z0 + i / ksteps, k0 = (i % ksteps) * kGemmBK;
    T* as = smem + (i % kGemmStages) * kStage;
    T* bs = as + L::kAElems;
    const T* a = static_cast<const T*>(kNN ? args.a[0] : pick3(args.a, z));
    const T* b = static_cast<const T*>(pick3(args.b, z));
    gemm_load_tile(as, kLdA, a + (size_t)m0 * kseg + k0, kseg, kGemmBM, kGemmBK, m - m0);
    if constexpr (kNN)
      gemm_load_tile(bs, kLdB, b + (size_t)k0 * n + n0, n, kGemmBK, kGemmBN, kGemmBK);
    else
      gemm_load_tile(bs, kLdA, b + (size_t)n0 * kseg + k0, kseg, kGemmBN, kGemmBK, kGemmBN);
  };

  float acc[kGemmMT][kGemmNT][4];
#pragma unroll
  for (int i = 0; i < kGemmMT; ++i) zero_acc(acc[i]);

#pragma unroll
  for (int i = 0; i < kGemmStages - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();  // an empty group where there is no step: the counts stay aligned
  }
  const int j = lane >> 3, r = lane & 7;  // the ldmatrix row this lane addresses
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kGemmStages - 2>();  // step i has landed (for this thread)
    __syncthreads();  // for every thread, and every warp is done with step i - 1's stage
    if (i + kGemmStages - 1 < steps) load(i + kGemmStages - 1);  // into step i - 1's stage
    cp_async_commit();
    const T* as = smem + (i % kGemmStages) * kStage;
    const T* bs = as + L::kAElems;
    if constexpr (!L::kF32) {
#pragma unroll
      for (int kk = 0; kk < kGemmBK; kk += 16) {
        uint32_t a[kGemmMT][4], b[kGemmNT][2];
#pragma unroll
        for (int mt = 0; mt < kGemmMT; ++mt) load_a(a[mt], as, kLdA, wm + 16 * mt, kk, lane);
#pragma unroll
        for (int nt = 0; nt < kGemmNT; nt += 2) {
          uint32_t x[4];
          if constexpr (kNN)  // rows k, columns n: transposed
            ldsm_x4_trans(x, bs + (kk + (j & 1) * 8 + r) * kLdB + wn + 8 * nt + (j >> 1) * 8);
          else  // rows n, columns k
            ldsm_x4(x, bs + (wn + 8 * nt + (j >> 1) * 8 + r) * kLdA + kk + (j & 1) * 8);
          b[nt][0] = x[0], b[nt][1] = x[1], b[nt + 1][0] = x[2], b[nt + 1][1] = x[3];
        }
#pragma unroll
        for (int mt = 0; mt < kGemmMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kGemmNT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kGemmBK; kk += 8) {
        uint32_t a_big[kGemmMT][4], a_small[kGemmMT][4];
        uint32_t b_big[kGemmNT][2], b_small[kGemmNT][2];
#pragma unroll
        for (int mt = 0; mt < kGemmMT; ++mt) {
          uint32_t x[4];
          load_a_f32(x, as, kLdA, wm + 16 * mt, kk, lane);
          split_frag(x, a_big[mt], a_small[mt]);
        }
#pragma unroll
        for (int nt = 0; nt < kGemmNT; ++nt) {
          if constexpr (kNN) {  // b0 (k = t, column g), b1 (k = t + 4, column g)
            const T* p = bs + (kk + t) * kLdB + wn + 8 * nt + g;
            split_tf32(p[0], b_big[nt][0], b_small[nt][0]);
            split_tf32(p[4 * kLdB], b_big[nt][1], b_small[nt][1]);
          } else if (nt % 2 == 0) {  // two n-tiles a 32-bit ldmatrix.x4
            uint32_t x[4], big[4], small[4];
            ldsm_x4(x, bs + (wn + 8 * nt + (j >> 1) * 8 + r) * kLdA + kk + (j & 1) * 4);
            split_frag(x, big, small);
            b_big[nt][0] = big[0], b_big[nt][1] = big[1];
            b_big[nt + 1][0] = big[2], b_big[nt + 1][1] = big[3];
            b_small[nt][0] = small[0], b_small[nt][1] = small[1];
            b_small[nt + 1][0] = small[2], b_small[nt + 1][1] = small[3];
          }
        }
#pragma unroll
        for (int round = 0; round < 3; ++round)
#pragma unroll
          for (int mt = 0; mt < kGemmMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kGemmNT; ++nt)
              mma_round(acc[mt][nt], round, a_big[mt], a_small[mt], b_big[nt][0], b_big[nt][1],
                        b_small[nt][0], b_small[nt][1]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can remain: nothing is left in flight at exit

  // epilogue: + bias in f32, one rounding to TOut, rows at or past m skipped
  const int zc = kNN ? blockIdx.z : 0;
  const T* bias = static_cast<const T*>(pick3(args.bias, zc));
  TOut* c = static_cast<TOut*>(pick3(args.c, zc));
#pragma unroll
  for (int nt = 0; nt < kGemmNT; ++nt) {
    const int col = n0 + wn + 8 * nt + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) b0 = to_float(bias[col]), b1 = to_float(bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < kGemmMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * mt + g + 8 * h;
        if (row >= m) continue;
        const float lo = __fadd_rn(acc[mt][nt][2 * h], b0);
        const float hi = __fadd_rn(acc[mt][nt][2 * h + 1], b1);
        TOut* dst = c + (size_t)row * n + col;
        if constexpr (std::is_same_v<TOut, float>)
          *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
      }
  }
}

// One launch of the GEMM: NN over gridDim.z = nz weight sets, or NT over args.nseg segments
template <typename T, typename TOut, bool kNN>
cudaError_t launch_mma_gemm(const MmaGemmArgs& args, int nz, cudaStream_t stream) {
  constexpr size_t smem = mma_gemm_smem<T, kNN>();
  cudaError_t err = allow_smem(mma_gemm_kernel<T, TOut, kNN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.n / kGemmBN, (args.m + kGemmBM - 1) / kGemmBM, kNN ? nz : 1);
  mma_gemm_kernel<T, TOut, kNN><<<grid, kMmaGemmThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
