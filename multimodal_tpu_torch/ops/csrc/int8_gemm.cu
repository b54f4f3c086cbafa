// The W8A8 int8 product with its rescale in the epilogue, hand-written for Hopper (sm_90a):
//
//   y[M, N] = store(int32 acc = a[M, K] . b[N, K]^T, sx[M], sw[N] [, bias[N]])
//
// Replaces the int8 dot_generals and their float32 rescales of multimodal_tpu/ops/quant.py:
// _int8_product (:41, the rescale :49), _int8_dense_bwd (:69, the dx rescale :78) and
// int8_matmul (:91-103). Those are XLA code on the TPU, not Pallas kernels.
//
// Store forms (every operation written with its _rn intrinsic, never contracted or
// approximated, so each result is the plain PyTorch version's bit for bit):
//   0  y = round_T((float(acc) * sx) * sw)
//   1  y = round_T(fma(float(acc) * sx, sw, bias))   the float32 train path and W8A8 serving
//                                                   (XLA contracts acc * sx * sw + bias)
//   2  y = round_bf16(float(round_bf16((float(acc) * sx) * sw)) + float(round_bf16(bias)))
//                                                   the bfloat16 train path: the model's bias
//                                                   added to the rounded product
//
// Design. Both operands are K-major (a row of codes is contiguous), the only layout wgmma
// takes for 8-bit operands and the one the row quantize writes. A block owns 128 x 128 tiles
// of y and walks K in steps of 128 bytes: TMA copies the A and B tiles into a ring of three
// shared-memory stages with the 128-byte swizzle, completion reported to an mbarrier per
// stage; two warpgroups each run wgmma.m64n128k32.s32.s8.s8 over 64 rows of the tile (four
// per K step), the int32 sums exact in registers (|acc| <= K * 127^2 < 2^31 for K < 133,000).
// One thread starts the copies; a stage is refilled as soon as both warpgroups are past the
// products that read it, while the next stage's products run. The blocks are persistent, two
// an SM, each walking its tiles as one stream of K steps, so the next tile's first copies are
// in flight while the epilogue of this one runs. The epilogue rescales in the registers
// (each thread holds two rows x pairs of adjacent columns, with the row's sx and the columns'
// sw and bias) and stores straight to y, 4 consecutive values a lane after one swap of pairs
// between neighbouring lanes, so that y is written in whole 32-byte sectors. M and N tails:
// TMA fills rows past the end with zeros and the stores are predicated.
//
// What bounds it, and why this tile: at ViT-B/32's shapes (M = 12800 or 19712, K and N of
// 512-3072) the int8 operations (2MNK at 1,979 TOP/s) and the output bytes (2 or 4 MN at
// 3.35 TB/s) take about as long, so the epilogue's stores must overlap other tiles' products.
// A 128 x 128 tile with three 32 KB stages uses 97 KB of shared memory and under 128
// registers a thread, so two blocks share an SM and one's epilogue runs beside the other's
// main loop; at K = 512-768 a tile has only 4-6 K steps, so the copies of the next tile start
// before this one's epilogue.
//
// K a multiple of 16: the TMA path. K = 8 mod 16 (a row pitch TMA cannot describe): the same
// tile, its codes loaded by the threads in 8-byte pieces into the same swizzled layout, one
// stage, then the same products and epilogue. The tensor maps are encoded per call through the
// driver's cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint (no -lcuda).

#include "hopper.cuh"  // mbarriers, TMA, the wgmma fence / commit / wait and descriptor

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;  // tile rows of a and b, K bytes a step
constexpr int kStages = 3;
constexpr int kThreads = 256;  // two warpgroups, 64 rows of the tile each
constexpr int kTileBytes = kBM * kBK;  // one operand's stage: 16 KB (kBN == kBM)
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + kStages * 8;  // + alignment, barriers

// stage s <- K step kt of both operands' tiles (one thread)
__device__ __forceinline__ void load_stage(unsigned char* smem, uint64_t* full, int s, int kt,
                                            const CUtensorMap* map_a, const CUtensorMap* map_b,
                                            int m0, int n0) {
  mbar_expect_tx(&full[s], kStageBytes);
  tma_load_2d(smem + s * kStageBytes, map_a, &full[s], kt * kBK, m0);
  tma_load_2d(smem + s * kStageBytes + kTileBytes, map_b, &full[s], kt * kBK, n0);
}

// d[64 x 128] (+)= a[64 x 32] . b[128 x 32]^T, int8 -> int32, both from shared memory
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// one K step of 128 bytes: four k32 products, the descriptors advanced 32 bytes each
__device__ __forceinline__ void mma_step(int (&acc)[64], const unsigned char* ta,
                                         const unsigned char* tb, bool first) {
  const uint64_t da = sw128_desc(ta), db = sw128_desc(tb);
#pragma unroll
  for (int kk = 0; kk < kBK / 32; ++kk)
    wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk, (first && kk == 0) ? 0 : 1);
}

// the K = 8 mod 16 path: rows [row0, row0 + 128) x K bytes [k0, k0 + 128) of a [rows, k]
// int8 matrix into the swizzled tile (16-byte chunk c of row r at chunk c ^ (r % 8)), zeros
// past either end
__device__ __forceinline__ void load_tile_plain(unsigned char* tile, const signed char* src,
                                                int row0, int rows, int k, int k0) {
  for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kThreads) {
    const int r = i / (kBK / 8), c8 = i % (kBK / 8);
    const int row = row0 + r, col = k0 + 8 * c8;
    uint2 v = make_uint2(0u, 0u);
    if (row < rows && col < k)
      v = *reinterpret_cast<const uint2*>(src + static_cast<size_t>(row) * k + col);
    *reinterpret_cast<uint2*>(tile + r * kBK + (((c8 >> 1) ^ (r & 7)) << 4) + (c8 & 1) * 8) = v;
  }
}

template <int kStore>
__device__ __forceinline__ float rescaled(int acc, float sx, float sw, float bias) {
  const float p = __fmul_rn(__int2float_rn(acc), sx);
  if (kStore == 0) return __fmul_rn(p, sw);
  if (kStore == 1) return __fmaf_rn(p, sw, bias);
  return __fadd_rn(__bfloat162float(__float2bfloat16_rn(__fmul_rn(p, sw))),
                   __bfloat162float(__float2bfloat16_rn(bias)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One warp's 16 rows x 128 columns of a tile, rescaled in the registers and stored straight
// to y (rows from row0, columns from n0). Accumulator layout of m64nNk32: the warp holds rows
// row0 + lane/4 and row0 + lane/4 + 8; register 4j + {0, 1} columns 8j + 2(lane % 4) + {0, 1}
// of the first row, 4j + {2, 3} the same columns of the second. Over two column groups
// (16 columns) neighbouring lanes swap a pair (one shuffle a row), so that an even lane q
// holds columns 2q..2q+3 of the first group and an odd one 2q-2..2q+1 of the second: each
// lane stores 4 consecutive values (8 bytes in bfloat16, 16 in float32) and a quad writes
// whole 32-byte sectors of a row (pairs as they lie would leave bfloat16 half-sectors).
template <typename TOut, int kStore>
__device__ __forceinline__ void store_tile(const int (&acc)[64], TOut* __restrict__ y,
                                           const float* __restrict__ sx,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ bias, int m, int n,
                                           int row0, int n0, int lane) {
  const int q = lane & 3;
  const bool odd = q & 1;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8;
  const float sx0 = r0 < m ? sx[r0] : 0.f, sx1 = r1 < m ? sx[r1] : 0.f;
  auto scales = [&](int col, float2& w, float2& bb) {
    w = bb = make_float2(0.f, 0.f);
    if (col < n) {
      w = *reinterpret_cast<const float2*>(sw + col);
      if (kStore != 0) bb = *reinterpret_cast<const float2*>(bias + col);
    }
  };
#pragma unroll
  for (int jj = 0; jj < kBN / 16; ++jj) {
    const int j = 2 * jj, c0 = n0 + 8 * j + 2 * q;
    float2 w0, b0, w1, b1;
    scales(c0, w0, b0);
    scales(c0 + 8, w1, b1);
    // [row][group][pair element]
    const float v[2][2][2] = {
        {{rescaled<kStore>(acc[4 * j], sx0, w0.x, b0.x),
          rescaled<kStore>(acc[4 * j + 1], sx0, w0.y, b0.y)},
         {rescaled<kStore>(acc[4 * j + 4], sx0, w1.x, b1.x),
          rescaled<kStore>(acc[4 * j + 5], sx0, w1.y, b1.y)}},
        {{rescaled<kStore>(acc[4 * j + 2], sx1, w0.x, b0.x),
          rescaled<kStore>(acc[4 * j + 3], sx1, w0.y, b0.y)},
         {rescaled<kStore>(acc[4 * j + 6], sx1, w1.x, b1.x),
          rescaled<kStore>(acc[4 * j + 7], sx1, w1.y, b1.y)}}};
    const int col = n0 + 16 * jj + (odd ? 2 * q + 6 : 2 * q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? r0 : r1;
      // an even lane keeps its first-group pair and takes its odd neighbour's; an odd lane
      // keeps its second-group pair and takes its even neighbour's (selects, not a runtime
      // index, which would put v in local memory)
      const float keep0 = odd ? v[r][1][0] : v[r][0][0], keep1 = odd ? v[r][1][1] : v[r][0][1];
      const float give0 = odd ? v[r][0][0] : v[r][1][0], give1 = odd ? v[r][0][1] : v[r][1][1];
      if constexpr (sizeof(TOut) == 4) {
        const float g0 = __shfl_xor_sync(0xffffffffu, give0, 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, give1, 1);
        if (col < n && row < m)
          *reinterpret_cast<float4*>(y + static_cast<size_t>(row) * n + col) =
              odd ? make_float4(g0, g1, keep0, keep1) : make_float4(keep0, keep1, g0, g1);
      } else {
        const uint32_t mine = pack_bf16x2(keep0, keep1);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, pack_bf16x2(give0, give1), 1);
        if (col < n && row < m)
          *reinterpret_cast<uint2*>(y + static_cast<size_t>(row) * n + col) =
              odd ? make_uint2(got, mine) : make_uint2(mine, got);
      }
    }
  }
}

// A persistent block: it takes tiles blockIdx.x, blockIdx.x + gridDim.x, ... (N fastest, so
// that the blocks running together share A's rows in L2), and with TMA their K steps form one
// stream through the stages, so the next tile's first copies land while this tile's epilogue
// runs.
template <typename TOut, int kStore, bool kTma>
__global__ void __launch_bounds__(kThreads, 2)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, const signed char* __restrict__ a,
                     const signed char* __restrict__ b, const float* __restrict__ sx,
                     const float* __restrict__ sw, const float* __restrict__ bias,
                     TOut* __restrict__ y, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int warp_row = wg * 64 + ((tid >> 5) & 3) * 16;  // this warp's first row of a tile
  const int ktiles = (k + kBK - 1) / kBK, tiles_n = (n + kBN - 1) / kBN;
  const int tiles = tiles_n * ((m + kBM - 1) / kBM);
  const int mine = tiles > static_cast<int>(blockIdx.x)
                       ? (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
                       : 0;
  auto tile = [&](int i) { return static_cast<int>(blockIdx.x + i * gridDim.x); };
  auto tile_m0 = [&](int i) { return tile(i) / tiles_n * kBM; };
  auto tile_n0 = [&](int i) { return tile(i) % tiles_n * kBN; };
  auto stage_a = [&](int s) { return smem + s * kStageBytes + wg * 64 * kBK; };
  auto stage_b = [&](int s) { return smem + s * kStageBytes + kTileBytes; };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  if (kTma) {
    const int total = mine * ktiles;  // K steps of all this block's tiles
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int g = 0; g < kStages && g < total; ++g)
        load_stage(smem, full, g, g % ktiles, &map_a, &map_b, tile_m0(g / ktiles),
                    tile_n0(g / ktiles));
    for (int g = 0; g < total; ++g) {
      const int s = g % kStages, kt = g % ktiles;
      mbar_wait(&full[s], (g / kStages) & 1);
      fence_acc(acc);
      wgmma_fence();
      mma_step(acc, stage_a(s), stage_b(s), kt == 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: its stage is free
      fence_acc(acc);
      __syncthreads();  // in both warpgroups
      const int next = g - 1 + kStages;
      if (tid == 0 && g >= 1 && next < total)
        load_stage(smem, full, (g - 1) % kStages, next % ktiles, &map_a, &map_b,
                    tile_m0(next / ktiles), tile_n0(next / ktiles));
      if (kt == ktiles - 1) {
        wgmma_wait<0>();
        fence_acc(acc);
        const int i = g / ktiles;
        store_tile<TOut, kStore>(acc, y, sx, sw, bias, m, n, tile_m0(i) + warp_row, tile_n0(i),
                                 lane);
      }
    }
  } else {
    for (int i = 0; i < mine; ++i) {
      const int m0 = tile_m0(i), n0 = tile_n0(i);
      for (int kt = 0; kt < ktiles; ++kt) {
        load_tile_plain(smem, a, m0, m, k, kt * kBK);
        load_tile_plain(smem + kTileBytes, b, n0, n, k, kt * kBK);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        __syncthreads();
        fence_acc(acc);
        wgmma_fence();
        mma_step(acc, stage_a(0), stage_b(0), kt == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        __syncthreads();
      }
      store_tile<TOut, kStore>(acc, y, sx, sw, bias, m, n, m0 + warp_row, n0, lane);
    }
  }
}

// [rows, k] int8, K-major, boxes of 128 rows x 128 bytes in the 128-byte swizzle
bool encode_operand(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int k) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TOut, int kStore>
cudaError_t launch_gemm(const void* a, const void* b, const void* sx, const void* sw,
                        const void* bias, void* y, int m, int n, int k, cudaStream_t stream) {
  const bool tma = k % 16 == 0;
  CUtensorMap map_a = {}, map_b = {};
  if (tma) {
    const EncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    if (!encode_operand(encode, &map_a, a, m, k) || !encode_operand(encode, &map_b, b, n, k))
      return cudaErrorInvalidValue;
  }
  auto kernel =
      tma ? int8_gemm_kernel<TOut, kStore, true> : int8_gemm_kernel<TOut, kStore, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // persistent: two blocks an SM (97 KB of shared memory and 128 registers a thread each)
  int device = 0, sms = 0;
  cudaError_t got = cudaGetDevice(&device);
  if (got == cudaSuccess)
    got = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (got != cudaSuccess) return got;
  const long long tiles =
      static_cast<long long>((n + kBN - 1) / kBN) * static_cast<long long>((m + kBM - 1) / kBM);
  const dim3 grid(static_cast<unsigned>(tiles < 2LL * sms ? tiles : 2LL * sms));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, static_cast<const signed char*>(a), static_cast<const signed char*>(b),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<TOut*>(y), m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16; store: 0, 1 or 2 (the header's forms; 2 with
// bfloat16 only). a [m, k] and b [n, k] int8, contiguous and 16-byte aligned; sx [m], sw [n]
// and bias [n] (or null for store 0) float32, 8-byte aligned; y [m, n] of out_dtype. k and n
// multiples of 8, m >= 1. Launches on `stream` without synchronising. Returns a cudaError_t.
int mmt_int8_gemm(int out_dtype, int store, const void* a, const void* b, const void* sx,
                  const void* sw, const void* bias, void* y, int m, int n, int k, void* stream) {
  if (m < 1 || n < 8 || k < 8 || n % 8 || k % 8 ||
      static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN) > 0x7fffffffLL ||
      store < 0 || store > 2 || (store != 0 && bias == nullptr) || (store == 2 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    if (store == 0) return (int)launch_gemm<float, 0>(a, b, sx, sw, bias, y, m, n, k, st);
    return (int)launch_gemm<float, 1>(a, b, sx, sw, bias, y, m, n, k, st);
  }
  if (out_dtype == 1) {
    if (store == 0) return (int)launch_gemm<__nv_bfloat16, 0>(a, b, sx, sw, bias, y, m, n, k, st);
    if (store == 1) return (int)launch_gemm<__nv_bfloat16, 1>(a, b, sx, sw, bias, y, m, n, k, st);
    return (int)launch_gemm<__nv_bfloat16, 2>(a, b, sx, sw, bias, y, m, n, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
