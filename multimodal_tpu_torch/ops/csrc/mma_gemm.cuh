// The projection GEMM of the block kernels on the tensor cores: every product of the
// block-attention forward and backward (block_attention_fwd.cu, block_attention_bwd.cu) and of
// the fused MLP branch (block_mlp.cu). Three forms:
//
//   NN: C_z = A' @ B_z + bias_z for z = blockIdx.z < 3, one A [M, K] shared by up to three
//       weight sets B_z [K, N] row-major (q, k, v = x @ Wq|Wk|Wv + b; out = attn @ Wo + bo;
//       the MLP's h = LN(x) @ W1 + b1 and y = g @ W2 + b2 [+ x]);
//   NT: C = sum over z < nseg of A_z @ W_z^T, A_z [M, kseg] and W_z [N, kseg] row-major (a
//       [W_in, W_out] weight read as its transpose), up to three segments summed in one f32
//       accumulator (do = dy Wo^T; dx or g = [dq | dk | dv] @ [Wq; Wk; Wv]^T over K = 3W; the
//       MLP's dy W2^T and dh W1^T);
//   TN: C_z = A'[K_z, M]^T @ B[K_z, N] for the run of token rows K_z = [z kps, (z + 1) kps) of
//       K = T that block z of gridDim.z owns (kps = k_per_split, a multiple of the K-step), one
//       f32 partial [M, N] per split, summed outside in order (the MLP's dW2 = g^T dy and
//       dW1 = ln_b^T dh; the M N / 128^2 output tiles alone do not fill the card).
//
// A' is A after an elementwise load transform (kLoad), by the row and column of A as it lies in
// memory ([M, K] in NN, [K, M] in TN): LN, ln_apply<T> with the row's statistics rounded to T
// and gamma, beta by column (the forward's LayerNorm, folded into q/k/v and into c_fc); act,
// round_T(act(f32(a))) (g from the saved h, dW2's A); LN-b, round_T((x32 - mean) * inv) *
// gamma_T + beta_T rounding after each step, with the statistics of the contraction row (the MLP
// backward's form of LN(x)). Each thread transforms the 16-byte chunks it copied itself, right
// after its cp.async group has landed and before the barrier that precedes the fragment loads:
// its own copies are visible to it, so the transform costs no barrier of its own. Rows past the
// ragged edge stay the zeros cp.async wrote (LN-b of a zero row would be beta, and its
// statistics lie past the end of their buffer). The transform runs once for every column block
// that reads the tile (N / 128 of them: 18-24 for LN at ViT-B widths, 4-8 for act at W =
// 512-1024), so its cost is its instruction count: the LN form reads the block's row
// statistics, rounded once, from shared memory, and in bfloat16 both LN forms do their
// bf16-operand steps on bf16 pairs (ln_chunk); the act form evaluates act_fwd in f32 an element
// (an expf and a division). Measured on the H100 (PERF.md): per-element scalar code with the
// statistics read from device memory every step ran the LN-folded q/k/v forward at 2.18 ms
// against 1.25 without the fold; the act form as the MLP forward c_proj's NN load ran c_proj at
// 79-106 TFLOP/s in bfloat16, where g written once by c_fc's store lets it run 229-278.
//
// The store (kStore): round, the bias (when given) added in f32 and one rounding to TOut
// (TOut = float keeps the sum unrounded: the LN backward's g, dln, the TN partials); residual,
// the bias added, rounded to T, then the residual (when given) added and rounded again (the
// block forward's both GEMMs: with the LN form's residual that is two roundings, as the
// reference has them); bias-residual, the bias and then the residual added to the f32 sum and
// one rounding to T (the MLP's c_proj, (acc + b2) + x, as the reference sums it); round+act,
// round's h and beside it g = round_T(act(f32(h))) to g_out, the value dW2's act load forms
// from h by the same act_round (the MLP's c_fc, so c_proj loads g plainly); act', the
// sum times act'(f32(h)) stored rounded to T (dh) with the column sums of the unrounded
// products over the block's 128 rows in a fixed order (each lane's rows in order, a butterfly
// over the eight lanes of a column, then the two row-warps through shared memory) as row
// blockIdx.y of col_part (db1's partial sums). M is ragged: rows at or past M load as zeros
// (cp.async with a source size of 0), are not stored and not summed.
// N % 128 == 0, K (kseg) % 64 == 0 in NN and NT, M % 128 == 0 in TN (W, H % 128 == 0).
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
//     (whose rows are output columns) load with ldmatrix; the TN form's A and the NN and TN
//     forms' B, whose tile rows are the contraction index, with ldmatrix.trans.
//   * float32: 3xTF32 on m16n8k8 (tf32_tiles.cuh): every operand split once into a TF32 big
//     part and the rest, three products summed in f32, the small terms first, in three rounds
//     over the warp's sixteen independent accumulators; about 2^-20 relative a product, so the
//     1e-4 x max|plain| limit holds at K = 2304 where one TF32 product breaks it (the CPU
//     emulation in tests/test_torch_block_attention_bwd.py). A tiles and the NT form's B
//     (rows padded to 68 floats) load with ldmatrix on 32-bit pairs; a tile whose rows are the
//     contraction index cannot (.trans moves 16-bit elements) and is read as 32-bit scalars
//     from rows of 136 floats, 8 mod 32 banks, so (k = t, column g) falls in bank 8t + g: no
//     conflict.
// Launch bounds: two blocks an SM in bfloat16 (102-106 KB of shared memory each), one in
// float32 (204-205 KB, and the split fragments beside 64 accumulators need more than 128
// registers). The f32 accumulation of the tensor cores loses a little with every add, so the
// error of one sum grows with K: the TN form's callers bound the rows of a float32 split.

#pragma once

#include <type_traits>

#include "tf32_tiles.cuh"

namespace {

// ----------------------------------------------------------------------------- activations
constexpr int kActQuickGelu = 0, kActGelu = 1;
constexpr float kSqrt2OverPi = 0.7978845608028654f, kGeluC = 0.044715f;

__device__ __forceinline__ float sigmoid_f(float z) { return 1.f / (1.f + expf(-z)); }

// act(h) in f32: quick_gelu or tanh-gelu
__device__ __forceinline__ float act_fwd(float h, int act) {
  if (act == kActQuickGelu) return h * sigmoid_f(1.702f * h);
  const float u = kSqrt2OverPi * (h + kGeluC * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

// d act / d h in f32
__device__ __forceinline__ float act_bwd(float h, int act) {
  if (act == kActQuickGelu) {
    const float s = sigmoid_f(1.702f * h);
    return s + h * 1.702f * s * (1.f - s);
  }
  const float u = kSqrt2OverPi * (h + kGeluC * h * h * h);
  const float t = tanhf(u);
  const float du = kSqrt2OverPi * (1.f + 3.f * kGeluC * h * h);
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
}

// ----------------------------------------------------------------------------- the GEMM
// forms, load transforms and stores (template arguments, so each use is its own kernel)
constexpr int kFormNN = 0, kFormNT = 1, kFormTN = 2;
constexpr int kLoadPlain = 0, kLoadLn = 1, kLoadAct = 2, kLoadLnB = 3;
constexpr int kStoreRound = 0, kStoreResidual = 1, kStoreActGrad = 2, kStoreBiasResidual = 3,
              kStoreRoundAct = 4;

// the warp grid of a block and the 16 x 8 fragments of C a warp owns
constexpr int kGemmWarpsM = 2, kGemmWarpsN = 4, kGemmMT = 4, kGemmNT = 4;
constexpr int kGemmBM = 16 * kGemmMT * kGemmWarpsM, kGemmBN = 8 * kGemmNT * kGemmWarpsN;
constexpr int kGemmBK = 64, kGemmStages = 3;  // K-step and shared-memory ring
constexpr int kMmaGemmThreads = 32 * kGemmWarpsM * kGemmWarpsN;
// blocks an SM the launch bounds ask for (a register budget): bfloat16, float32
constexpr int kGemmMinBlocksBf16 = 2, kGemmMinBlocksF32 = 1;

struct MmaGemmArgs {
  const void* a[3];     // NN, TN: a[0] is A; NT: A_z
  const void* b[3];     // NN: B_z [K, N]; NT: W_z [N, kseg]; TN: b[0] is B [K, N]
  const void* bias[3];  // NN: bias_z [N] or null; otherwise null
  void* c[3];           // NN: C_z; NT: c[0]; TN: c[0], [gridDim.z, M, N] partials
  int m, n, kseg, nseg;
  int k_per_split;        // TN: token rows a split owns, a multiple of kGemmBK
  const float* ln_mean;   // kLoadLn, kLoadLnB: f32 statistics by row of A in memory
  const float* ln_inv;
  const void* ln_gamma;   // kLoadLn, kLoadLnB: [columns of A in memory] of T
  const void* ln_beta;
  int act;                // kLoadAct, kStoreRoundAct, kStoreActGrad: kActQuickGelu or kActGelu
  const void* residual;   // kStoreResidual: [M, N] of T, or null; kStoreBiasResidual: [M, N]
  const void* h;          // kStoreActGrad: [M, N] of T, the pre-activation
  float* col_part;        // kStoreActGrad: [gridDim.y, N] column sums
  void* g_out;            // kStoreRoundAct: [M, N] of T
};

// Row strides in elements of the stage buffers and the elements of a stage: A is [kGemmBM][kLdA]
// (NN, NT) or [kGemmBK][kLdB] (TN); B is [kGemmBN][kLdA] (NT) or [kGemmBK][kLdB] (NN, TN)
template <typename T, int kForm>
struct GemmLayout {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int kLdA = kGemmBK + (kF32 ? 4 : 8);
  static constexpr int kLdB = kGemmBN + 8;
  static constexpr int kAElems = kForm == kFormTN ? kGemmBK * kLdB : kGemmBM * kLdA;
  static constexpr int kStage = kAElems + (kForm == kFormNT ? kGemmBN * kLdA : kGemmBK * kLdB);
};

// the stages, and with the LN load transform the block's row statistics after them
template <typename T, int kForm, int kLoad>
constexpr size_t mma_gemm_smem() {
  return sizeof(T) * (size_t)kGemmStages * GemmLayout<T, kForm>::kStage +
         (kLoad == kLoadLn ? sizeof(float2) * kGemmBM : 0);
}

// arr[z] for z < 3 by selects: indexing the kernel's parameter arrays at run time would copy
// them to local memory
template <typename P>
__device__ __forceinline__ P pick3(P const (&arr)[3], int z) {
  return z == 0 ? arr[0] : (z == 1 ? arr[1] : arr[2]);
}

// f(row, col) for each 16-byte chunk of an nrows x ncols tile that this thread copies
template <typename T, typename F>
__device__ __forceinline__ void for_own_chunks(int nrows, int ncols, F f) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = ncols / kVec;
  for (int e = threadIdx.x; e < nrows * chunks; e += kMmaGemmThreads)
    f(e / chunks, (e % chunks) * kVec);
}

// `nrows` rows of `ncols` elements (a multiple of 16 bytes) from src (row stride `stride`) into
// dst (row stride `ld`) by 16-byte cp.async; rows at or past `live_rows` are zero-filled
template <typename T>
__device__ __forceinline__ void gemm_load_tile(T* dst, int ld, const T* src, size_t stride,
                                               int nrows, int ncols, int live_rows) {
  for_own_chunks<T>(nrows, ncols, [&](int r, int c) {
    const bool live = r < live_rows;
    cp_async16(dst + r * ld + c, live ? src + (size_t)r * stride + c : src, live);
  });
}

// 16 bytes of T (shared or device memory, 16-byte aligned) as floats, and floats stored as T
template <typename T>
__device__ __forceinline__ void vec16_load(const T* p, float (&v)[16 / sizeof(T)]) {
  alignas(16) T e[16 / sizeof(T)];
  *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = to_float(e[i]);
}
template <typename T>
__device__ __forceinline__ void vec16_store(T* p, const float (&v)[16 / sizeof(T)]) {
  alignas(16) T e[16 / sizeof(T)];
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) e[i] = from_float<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
}

// two consecutive elements of T as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// bf16 pairs (two bf16 in a b32 register) - and * and +, each rounded once to nearest. The
// explicit .rn forbids ptxas to fuse a product with the sum after it into one fma, which would
// round once where the reference rounds twice.
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The load transforms of one landed 16-byte chunk p of A in shared memory, whose elements are
// A[row][col..] as A lies in memory; gamma and beta point at the chunk's columns. In bfloat16
// the steps that take two bf16 operands run on bf16 pairs, which for normal values gives the
// bits of the f32 operation rounded to bf16: a product of two bf16 values is exact in f32, and
// a sum or difference is exact in f32 unless the exponents differ by more than 16, when both
// round to the larger operand.
//
// LN: ((x - mean_t) * inv_t) * gamma + beta, rounding after every operation (ln_apply);
// mean_t, inv_t are the row's statistics rounded to T
__device__ __forceinline__ void ln_chunk(float* p, float2 st, const float* gamma,
                                         const float* beta) {
  float v[4], gm[4], bt[4];
  vec16_load(p, v);
  vec16_load(gamma, gm);
  vec16_load(beta, bt);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ln_apply<float>(v[i], st.x, st.y, gm[i], bt[i]);
  vec16_store(p, v);
}
__device__ __forceinline__ void ln_chunk(__nv_bfloat16* p, float2 st, const __nv_bfloat16* gamma,
                                         const __nv_bfloat16* beta) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint4 gm = *reinterpret_cast<const uint4*>(gamma);
  const uint4 bt = *reinterpret_cast<const uint4*>(beta);
  const uint32_t mean2 = pack_bf16(st.x, st.x), inv2 = pack_bf16(st.y, st.y);
  auto ln2 = [&](uint32_t x, uint32_t g, uint32_t b) {
    return bf2_add(bf2_mul(bf2_mul(bf2_sub(x, mean2), inv2), g), b);
  };
  v.x = ln2(v.x, gm.x, bt.x), v.y = ln2(v.y, gm.y, bt.y);
  v.z = ln2(v.z, gm.z, bt.z), v.w = ln2(v.w, gm.w, bt.w);
  *reinterpret_cast<uint4*>(p) = v;
}

// LN-b: round_T((x32 - mean) * inv) * gamma_T + beta_T with f32 statistics, rounding after each
// step
__device__ __forceinline__ void ln_b_chunk(float* p, float mean, float inv, const float* gamma,
                                           const float* beta) {
  float v[4], gm[4], bt[4];
  vec16_load(p, v);
  vec16_load(gamma, gm);
  vec16_load(beta, bt);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), inv), gm[i]), bt[i]);
  vec16_store(p, v);
}
__device__ __forceinline__ void ln_b_chunk(__nv_bfloat16* p, float mean, float inv,
                                           const __nv_bfloat16* gamma,
                                           const __nv_bfloat16* beta) {
  float v[8];
  vec16_load(p, v);
  const uint4 gm = *reinterpret_cast<const uint4*>(gamma);
  const uint4 bt = *reinterpret_cast<const uint4*>(beta);
  auto ln2 = [&](int i, uint32_t g, uint32_t b) {
    const uint32_t xhat = pack_bf16(__fmul_rn(__fsub_rn(v[2 * i], mean), inv),
                                    __fmul_rn(__fsub_rn(v[2 * i + 1], mean), inv));
    return bf2_add(bf2_mul(xhat, g), b);
  };
  const uint4 out = make_uint4(ln2(0, gm.x, bt.x), ln2(1, gm.y, bt.y), ln2(2, gm.z, bt.z),
                               ln2(3, gm.w, bt.w));
  *reinterpret_cast<uint4*>(p) = out;
}

// g = round_T(act(f32(h))) from a pre-activation h of T: one function for the forward's c_fc
// store, which writes g, and the backward's dW2 load, which forms it again, so the two are the
// same bits
template <typename T>
__device__ __forceinline__ float act_round(float h, int act) {
  return round_to<T>(act_fwd(h, act));
}

// act: round_T(act(f32(a)))
template <typename T>
__device__ __forceinline__ void act_chunk(T* p, int act) {
  float v[16 / sizeof(T)];
  vec16_load(p, v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = act_round<T>(v[i], act);
  vec16_store(p, v);
}

// two floats stored as two consecutive elements of T
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <typename T, typename TOut, int kForm, int kLoad, int kStore>
__global__ void __launch_bounds__(kMmaGemmThreads,
                                  std::is_same_v<T, float> ? kGemmMinBlocksF32
                                                           : kGemmMinBlocksBf16)
mma_gemm_kernel(MmaGemmArgs args) {
  constexpr bool kNN = kForm == kFormNN, kNT = kForm == kFormNT, kTN = kForm == kFormTN;
  static_assert(kLoad == kLoadPlain || (kNN && kLoad == kLoadLn) ||
                    (kTN && (kLoad == kLoadAct || kLoad == kLoadLnB)),
                "LN loads in the NN form, act and LN-b in the TN form");
  static_assert(kStore == kStoreRound || std::is_same_v<T, TOut>, "a rounded store");
  using L = GemmLayout<T, kForm>;
  constexpr int kLdA = L::kLdA, kLdB = L::kLdB, kStage = L::kStage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the warp's 16 kGemmMT x 8 kGemmNT tile of C
  const int wm = (warp / kGemmWarpsN) * 16 * kGemmMT, wn = (warp % kGemmWarpsN) * 8 * kGemmNT;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int m = args.m, n = args.n, kseg = args.kseg;
  // the contraction: NN one run over kseg, NT nseg runs of kseg, TN this split's token rows
  const int k_begin = kTN ? blockIdx.z * args.k_per_split : 0;
  const int k_end = kTN ? min(kseg, k_begin + args.k_per_split) : kseg;
  const int z0 = kNN ? blockIdx.z : 0, nseg = kNT ? args.nseg : 1;
  const int ksteps = kTN ? max(0, (k_end - k_begin + kGemmBK - 1) / kGemmBK) : kseg / kGemmBK;
  const int steps = nseg * ksteps;

  // step i: segment z0 + i / ksteps, K columns (NN, NT) or rows (TN) k0.. of A, and the
  // matching rows of B (NN, TN) or columns of W_z (NT)
  auto step_k0 = [&](int i) { return k_begin + (i % ksteps) * kGemmBK; };
  auto load = [&](int i) {
    const int z = z0 + i / ksteps, k0 = step_k0(i);
    T* as = smem + (i % kGemmStages) * kStage;
    T* bs = as + L::kAElems;
    const T* a = static_cast<const T*>(kNT ? pick3(args.a, z) : args.a[0]);
    const T* b = static_cast<const T*>(pick3(args.b, z));
    if constexpr (kTN) {
      gemm_load_tile(as, kLdB, a + (size_t)k0 * m + m0, m, kGemmBK, kGemmBM, k_end - k0);
      gemm_load_tile(bs, kLdB, b + (size_t)k0 * n + n0, n, kGemmBK, kGemmBN, k_end - k0);
    } else {
      gemm_load_tile(as, kLdA, a + (size_t)m0 * kseg + k0, kseg, kGemmBM, kGemmBK, m - m0);
      if constexpr (kNN)
        gemm_load_tile(bs, kLdB, b + (size_t)k0 * n + n0, n, kGemmBK, kGemmBN, kGemmBK);
      else
        gemm_load_tile(bs, kLdA, b + (size_t)n0 * kseg + k0, kseg, kGemmBN, kGemmBK, kGemmBN);
    }
  };
  // kLoadLn: the statistics of the block's rows rounded to T, (mean_t, inv_t), once
  float2* row_stats = reinterpret_cast<float2*>(smem + kGemmStages * kStage);
  if constexpr (kLoad == kLoadLn) {
    for (int r = threadIdx.x; r < kGemmBM && m0 + r < m; r += kMmaGemmThreads)
      row_stats[r] = make_float2(round_to<T>(args.ln_mean[m0 + r]),
                                 round_to<T>(args.ln_inv[m0 + r]));
    __syncthreads();
  }
  const T* gamma = static_cast<const T*>(args.ln_gamma);
  const T* beta = static_cast<const T*>(args.ln_beta);
  // the load transform of step i's A chunks this thread copied, live rows only
  auto transform = [&](int i) {
    const int k0 = step_k0(i);
    T* as = smem + (i % kGemmStages) * kStage;
    if constexpr (kTN)
      for_own_chunks<T>(kGemmBK, kGemmBM, [&](int r, int c) {
        if (r >= k_end - k0) return;
        T* p = as + r * kLdB + c;
        if constexpr (kLoad == kLoadAct)
          act_chunk(p, args.act);
        else
          ln_b_chunk(p, args.ln_mean[k0 + r], args.ln_inv[k0 + r], gamma + m0 + c, beta + m0 + c);
      });
    else
      for_own_chunks<T>(kGemmBM, kGemmBK, [&](int r, int c) {
        if (r < m - m0) ln_chunk(as + r * kLdA + c, row_stats[r], gamma + k0 + c, beta + k0 + c);
      });
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
    if constexpr (kLoad != kLoadPlain) transform(i);  // on this thread's own chunks
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
        for (int mt = 0; mt < kGemmMT; ++mt) {
          if constexpr (kTN)  // rows k, columns m: transposed
            ldsm_x4_trans(a[mt], as + (kk + (j >> 1) * 8 + r) * kLdB + wm + 16 * mt + (j & 1) * 8);
          else
            load_a(a[mt], as, kLdA, wm + 16 * mt, kk, lane);
        }
#pragma unroll
        for (int nt = 0; nt < kGemmNT; nt += 2) {
          uint32_t x[4];
          if constexpr (!kNT)  // rows k, columns n: transposed
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
          if constexpr (kTN) {  // a0 (m g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
            const T* p = as + (kk + t) * kLdB + wm + 16 * mt + g;
            split_tf32(p[0], a_big[mt][0], a_small[mt][0]);
            split_tf32(p[8], a_big[mt][1], a_small[mt][1]);
            split_tf32(p[4 * kLdB], a_big[mt][2], a_small[mt][2]);
            split_tf32(p[4 * kLdB + 8], a_big[mt][3], a_small[mt][3]);
          } else {
            uint32_t x[4];
            load_a_f32(x, as, kLdA, wm + 16 * mt, kk, lane);
            split_frag(x, a_big[mt], a_small[mt]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kGemmNT; ++nt) {
          if constexpr (!kNT) {  // b0 (k = t, column g), b1 (k = t + 4, column g)
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

  // the store: + bias in f32, then by kStore; rows at or past m skipped
  const int zc = kNN ? blockIdx.z : 0;
  const T* bias = static_cast<const T*>(pick3(args.bias, zc));
  TOut* c = static_cast<TOut*>(pick3(args.c, zc));
  if constexpr (kTN) c += (size_t)blockIdx.z * m * n;
  const T* res = static_cast<const T*>(args.residual);
  const T* hp = static_cast<const T*>(args.h);
  float colsum[kGemmNT][2] = {};  // kStoreActGrad: this lane's rows, in order
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
        const size_t at = (size_t)row * n + col;
        float lo = __fadd_rn(acc[mt][nt][2 * h], b0);
        float hi = __fadd_rn(acc[mt][nt][2 * h + 1], b1);
        if constexpr (kStore == kStoreResidual) {
          if (res != nullptr) {
            const float2 rv = load2(res + at);
            lo = __fadd_rn(round_to<T>(lo), rv.x);
            hi = __fadd_rn(round_to<T>(hi), rv.y);
          }
        } else if constexpr (kStore == kStoreBiasResidual) {
          const float2 rv = load2(res + at);
          lo = __fadd_rn(lo, rv.x);
          hi = __fadd_rn(hi, rv.y);
        } else if constexpr (kStore == kStoreRoundAct) {
          store2(static_cast<T*>(args.g_out) + at, act_round<T>(round_to<T>(lo), args.act),
                 act_round<T>(round_to<T>(hi), args.act));
        } else if constexpr (kStore == kStoreActGrad) {
          const float2 hv = load2(hp + at);
          lo = __fmul_rn(lo, act_bwd(hv.x, args.act));
          hi = __fmul_rn(hi, act_bwd(hv.y, args.act));
          colsum[nt][0] += lo;
          colsum[nt][1] += hi;
        }
        store2(c + at, lo, hi);
      }
  }
  if constexpr (kStore == kStoreActGrad) {
    // over the eight lanes of a column (a butterfly: every lane ends with the same sum), then
    // the two row-warps of the block through shared memory, in that order
#pragma unroll
    for (int nt = 0; nt < kGemmNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          colsum[nt][e] += __shfl_xor_sync(0xffffffffu, colsum[nt][e], off);
    __syncthreads();  // every warp is done with the stages: their memory is free
    float* red = reinterpret_cast<float*>(smem_raw);  // [kGemmWarpsM][kGemmBN]
    if (g == 0)
#pragma unroll
      for (int nt = 0; nt < kGemmNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(warp / kGemmWarpsN) * kGemmBN + wn + 8 * nt + 2 * t + e] = colsum[nt][e];
    __syncthreads();
    if (threadIdx.x < kGemmBN)
      args.col_part[(size_t)blockIdx.y * n + n0 + threadIdx.x] =
          red[threadIdx.x] + red[kGemmBN + threadIdx.x];
  }
}

// One launch of the GEMM: NN over gridDim.z = nz weight sets, NT over args.nseg segments, TN
// over nz splits of the token rows
template <typename T, typename TOut, int kForm, int kLoad = kLoadPlain, int kStore = kStoreRound>
cudaError_t launch_mma_gemm(const MmaGemmArgs& args, int nz, cudaStream_t stream) {
  constexpr size_t smem = mma_gemm_smem<T, kForm, kLoad>();
  auto* kernel = mma_gemm_kernel<T, TOut, kForm, kLoad, kStore>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(args.n / kGemmBN, (args.m + kGemmBM - 1) / kGemmBM, kForm == kFormNT ? 1 : nz);
  kernel<<<grid, kMmaGemmThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
