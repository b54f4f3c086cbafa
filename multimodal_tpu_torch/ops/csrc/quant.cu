// The int8 quantize of the W8A8 products, hand-written for Hopper: the row quantize and its
// column form. The product and its rescale are int8_gemm.cu.
//
// Replaces the XLA code of multimodal_tpu/ops/quant.py: quantize_rows (:31) and
// quantize_weight (:22).
//
//   quantize_rows_kernel     x [R,C] float32 or bfloat16 -> q [R,C] int8, scale [R] float32:
//                              amax = max |x| over the row, in float32
//                              s    = max(amax, 1e-12) * float32(1/127)   form 0 (jitted)
//                                   = max(amax, 1e-12) / 127              form 1 (eager)
//                              q    = clamp(rint(x / s), -127, 127)       IEEE division,
//                                                                         ties to even
//   quantize_columns_kernel  w [R,C] -> q [C,R], scale [C]: the same per column of w, the
//                            codes written transposed (quantize_weight: w [in, out] -> the
//                            [out, in] operand of the int8 GEMM). A mode of the same launch.
//
// Both are bound by bytes: x read once and a byte written per element. The row form keeps its
// row in registers between the amax and the codes, so the input is read once: a group of G
// threads takes a row (G = 32, one warp, up to 1,024 columns; 64-1,024 threads above, the amax
// by shuffles and one shared-memory step), each thread holding up to four 8-element units
// loaded with 16-byte loads (two for float32) and storing their codes 8 bytes at a time;
// eight rows a block at G = 32, so every SM keeps tens of KB of loads in flight. The column
// form reads w by rows (coalesced) and also keeps what it read in registers: a cluster of 8
// blocks takes a strip of 8 columns (32 for weights of up to 1,024 rows), each block a run of
// rows, the column amaxes meet in distributed shared memory, and the codes go out through
// shared memory in 16-byte stores along the rows of q: no transposed copy of w, w read once.
// A code costs one multiply by the row's rounded reciprocal; the IEEE division (__fdiv_rn)
// runs only where that product lies within 2^-14 of a half-integer, the one place the two can
// round apart (int8_code). Every operation is written with its _rn intrinsic, which nvcc
// never contracts, so the codes and scales are the plain PyTorch version's bit for bit.

#include <cooperative_groups.h>

#include "block_attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kQuantThreads = 256;
constexpr int kMaxUnits = 4;  // 8-element units a thread of the row form holds
constexpr int kMaxGroup = 1024;  // threads a row at most: rows of up to 32,768 elements
constexpr int kMaxPasses = 8;  // passes a block of the column form holds in registers
constexpr int kClusterRows = 8;  // blocks of its clusters, each a run of rows
constexpr int kShortWeight = 1024;  // rows up to which its strips are 32 columns, not 8
constexpr int kMaxWeightRows = kClusterRows * kMaxPasses * (kQuantThreads / 2);  // 8,192
constexpr float kInv127 = 1.0f / 127.0f;

// clamp(rint(v / s), -127, 127) with v / s the IEEE quotient, from t = v * r (r = 1/s rounded
// once): |v| <= amax, so |v / s| <= 128 and t lies within 2.3e-5 of the rounded quotient. The
// two round alike unless t is within 2^-14 of a half-integer, where the division decides.
__device__ __forceinline__ signed char int8_code(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  const float q = fabsf(t - floorf(t) - 0.5f) > 6.103515625e-5f ? rintf(t)
                                                                : rintf(__fdiv_rn(v, s));
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f)));
}

__device__ __forceinline__ float scale_of(float amax, int form) {
  const float m = fmaxf(amax, 1e-12f);
  return form == 0 ? __fmul_rn(m, kInv127) : __fdiv_rn(m, 127.0f);
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  load4(p, v);
  load4(p + 4, v + 4);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack4(signed char a, signed char b, signed char c,
                                          signed char d) {
  return static_cast<uint32_t>(static_cast<unsigned char>(a)) |
         (static_cast<uint32_t>(static_cast<unsigned char>(b)) << 8) |
         (static_cast<uint32_t>(static_cast<unsigned char>(c)) << 16) |
         (static_cast<uint32_t>(static_cast<unsigned char>(d)) << 24);
}

// G threads a row, (block / G) rows a block. kVec: C a multiple of 8, x 16-byte aligned; unit
// u of thread t is elements [8 (uG + t), 8 (uG + t) + 8). Otherwise element i of unit u is
// (8u + i) G + t, loaded one by one.
template <typename T, int G, bool kVec>
__global__ void __launch_bounds__(G > kQuantThreads ? G : kQuantThreads)
    quantize_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                         float* __restrict__ scale, int rows, int cols, int form) {
  constexpr int kBlock = G > kQuantThreads ? G : kQuantThreads;
  constexpr int kWarpsPerRow = G / 32;
  __shared__ float partial[kBlock / 32];
  const int t = threadIdx.x % G;
  const int row = blockIdx.x * (kBlock / G) + threadIdx.x / G;
  const bool live = row < rows;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * cols;

  float v[kMaxUnits * 8];
  float amax = 0.0f;
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    if (kVec) {
      const int c = 8 * (u * G + t);
      if (live && c < cols) {
        load8(xr + c, v + 8 * u);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[8 * u + i] = 0.0f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = (8 * u + i) * G + t;
        v[8 * u + i] = live && c < cols ? to_float(xr[c]) : 0.0f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxUnits * 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (kWarpsPerRow > 1) {
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = amax;
    __syncthreads();
    const int first = (threadIdx.x / G) * kWarpsPerRow;
    amax = partial[first];
    for (int w = 1; w < kWarpsPerRow; ++w) amax = fmaxf(amax, partial[first + w]);
  }
  if (!live) return;
  const float s = scale_of(amax, form), r = __frcp_rn(s);
  if (t == 0) scale[row] = s;

  signed char* qr = q + static_cast<size_t>(row) * cols;
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    if (kVec) {
      const int c = 8 * (u * G + t);
      if (c < cols) {
        const float* e = v + 8 * u;
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(
            pack4(int8_code(e[0], s, r), int8_code(e[1], s, r), int8_code(e[2], s, r),
                  int8_code(e[3], s, r)),
            pack4(int8_code(e[4], s, r), int8_code(e[5], s, r), int8_code(e[6], s, r),
                  int8_code(e[7], s, r)));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = (8 * u + i) * G + t;
        if (c < cols) qr[c] = int8_code(v[8 * u + i], s, r);
      }
    }
  }
}

// four columns [c, c + 4) of row r of w [rows, cols]; zeros past the last column. kVec: cols a
// multiple of 4 and w 16-byte aligned
template <typename T, bool kVec>
__device__ __forceinline__ void load_quad(const T* w, int r, int c, int cols, float v[4]) {
  const T* p = w + static_cast<size_t>(r) * cols + c;
  if (kVec) {
    if (c < cols) {
      load4(p, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.0f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < cols ? to_float(p[j]) : 0.0f;
  }
}

// A cluster of kClusterRows blocks takes a strip of kStrip columns of w; block y of the
// cluster holds rows [y rpb, (y + 1) rpb) in registers (kStrip / 4 threads a row, each four
// columns; 256 / (kStrip / 4) rows a pass, up to kMaxPasses passes), the blocks' column amaxes
// meet in distributed shared memory, and each block codes the rows it holds: w is read once.
// Strips of 8 columns (32 bytes of a float32 row) for tall weights, 32 for short ones, so that
// every block holds enough rows.
template <typename T, bool kVec, int kStrip>
__global__ void __cluster_dims__(1, kClusterRows, 1) __launch_bounds__(kQuantThreads)
    quantize_columns_kernel(const T* __restrict__ w, signed char* __restrict__ q,
                            float* __restrict__ scale, int rows, int cols, int rpb, int form) {
  constexpr int kQuads = kStrip / 4, kPassRows = kQuantThreads / kQuads;
  __shared__ float partial[kQuantThreads / 32][kStrip];
  __shared__ float strip_amax[kStrip];
  __shared__ float strip_scale[kStrip];
  __shared__ __align__(16) signed char tile[kStrip][kMaxPasses * kPassRows + 16];
  cg::cluster_group cluster = cg::this_cluster();
  const int c0 = blockIdx.x * kStrip;
  const int base = blockIdx.y * rpb, end = min(rows, base + rpb);
  const int quad = threadIdx.x % kQuads, rr = threadIdx.x / kQuads, lane = threadIdx.x & 31;
  const int c = c0 + 4 * quad;

  float v[kMaxPasses * 4];
  float amax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int r = base + p * kPassRows + rr;
    if (r < end) {
      load_quad<T, kVec>(w, r, c, cols, v + 4 * p);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * p + j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) amax[j] = fmaxf(amax[j], fabsf(v[4 * p + j]));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    for (int o = kQuads; o < 32; o <<= 1)
      amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], o));
  if (lane < kQuads)
    for (int j = 0; j < 4; ++j) partial[threadIdx.x >> 5][4 * lane + j] = amax[j];
  __syncthreads();
  if (threadIdx.x < kStrip) {
    float a = partial[0][threadIdx.x];
    for (int wi = 1; wi < kQuantThreads / 32; ++wi) a = fmaxf(a, partial[wi][threadIdx.x]);
    strip_amax[threadIdx.x] = a;
  }
  cluster.sync();  // every block's strip_amax written
  if (threadIdx.x < kStrip) {
    float a = 0.0f;
    for (int b = 0; b < kClusterRows; ++b)
      a = fmaxf(a, cluster.map_shared_rank(strip_amax, b)[threadIdx.x]);
    const float sc = scale_of(a, form);
    strip_scale[threadIdx.x] = sc;
    if (blockIdx.y == 0 && c0 + threadIdx.x < cols) scale[c0 + threadIdx.x] = sc;
  }
  cluster.sync();  // every block done reading the others' strip_amax; strip_scale written
  float s[4], r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = strip_scale[4 * quad + j];
    r[j] = __frcp_rn(s[j]);
  }
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tile[4 * quad + j][p * kPassRows + rr] = int8_code(v[4 * p + j], s[j], r[j]);
  __syncthreads();
  const int held = end - base;
  if (held <= 0) return;
  if (rows % 16 == 0) {  // base and held multiples of 16: 16-byte pieces of q's rows
    const int pieces = held / 16;
    for (int i = threadIdx.x; i < kStrip * pieces; i += kQuantThreads) {
      const int cc = i / pieces, piece = i % pieces;
      if (c0 + cc < cols)
        *reinterpret_cast<uint4*>(q + static_cast<size_t>(c0 + cc) * rows + base + 16 * piece) =
            *reinterpret_cast<const uint4*>(&tile[cc][16 * piece]);
    }
  } else {
    for (int i = threadIdx.x; i < kStrip * held; i += kQuantThreads) {
      const int cc = i / held, rl = i % held;
      if (c0 + cc < cols) q[static_cast<size_t>(c0 + cc) * rows + base + rl] = tile[cc][rl];
    }
  }
}

template <typename T, int kStrip>
cudaError_t launch_columns(const T* w, signed char* q, float* scale, int rows, int cols, int form,
                           bool vec, cudaStream_t stream) {
  // rows per block: the rows split over the cluster, in multiples of 16
  const int rpb = ((rows + kClusterRows - 1) / kClusterRows + 15) / 16 * 16;
  const dim3 grid((cols + kStrip - 1) / kStrip, kClusterRows), block(kQuantThreads);
  if (vec)
    quantize_columns_kernel<T, true, kStrip><<<grid, block, 0, stream>>>(w, q, scale, rows, cols,
                                                                         rpb, form);
  else
    quantize_columns_kernel<T, false, kStrip><<<grid, block, 0, stream>>>(w, q, scale, rows,
                                                                          cols, rpb, form);
  return cudaGetLastError();
}

// the smallest group whose threads hold a row in kMaxUnits units each; 0 if none does
int row_group(int cols) {
  const int units = (cols + 7) / 8;
  for (int g = 32; g <= kMaxGroup; g *= 2)
    if (units <= kMaxUnits * g) return g;
  return 0;
}

template <typename T, int G>
cudaError_t launch_rows(const T* x, signed char* q, float* scale, int rows, int cols, int form,
                        bool vec, cudaStream_t stream) {
  constexpr int kBlock = G > kQuantThreads ? G : kQuantThreads;
  const dim3 grid((rows + kBlock / G - 1) / (kBlock / G)), block(kBlock);
  if (vec)
    quantize_rows_kernel<T, G, true><<<grid, block, 0, stream>>>(x, q, scale, rows, cols, form);
  else
    quantize_rows_kernel<T, G, false><<<grid, block, 0, stream>>>(x, q, scale, rows, cols, form);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* scale, int rows, int cols, int form,
                            int columns, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  signed char* qp = static_cast<signed char*>(q);
  float* sp = static_cast<float*>(scale);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (columns) {
    const bool vec = aligned && cols % 4 == 0;
    if (rows <= kShortWeight)
      return launch_columns<T, 32>(xp, qp, sp, rows, cols, form, vec, stream);
    return launch_columns<T, 8>(xp, qp, sp, rows, cols, form, vec, stream);
  }
  const bool vec = aligned && cols % 8 == 0;
  switch (row_group(cols)) {
    case 32: return launch_rows<T, 32>(xp, qp, sp, rows, cols, form, vec, stream);
    case 64: return launch_rows<T, 64>(xp, qp, sp, rows, cols, form, vec, stream);
    case 128: return launch_rows<T, 128>(xp, qp, sp, rows, cols, form, vec, stream);
    case 256: return launch_rows<T, 256>(xp, qp, sp, rows, cols, form, vec, stream);
    case 512: return launch_rows<T, 512>(xp, qp, sp, rows, cols, form, vec, stream);
    case 1024: return launch_rows<T, 1024>(xp, qp, sp, rows, cols, form, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 input; form: 0 = max(amax, 1e-12) * float32(1/127), 1 =
// max(amax, 1e-12) / 127. x [rows, cols] contiguous. columns = 0: q [rows, cols] int8 and
// scale [rows] float32 written, cols at most 32,768; columns = 1: the scale of each column,
// q [cols, rows] and scale [cols], rows at most 8,192. Launches on `stream` without
// synchronising. Returns a cudaError_t.
int mmt_quantize_rows(int dtype, const void* x, void* q, void* scale, int rows, int cols,
                      int form, int columns, void* stream) {
  if (rows < 1 || cols < 1 || (form != 0 && form != 1) || (columns != 0 && columns != 1) ||
      (!columns && row_group(cols) == 0) || (columns && rows > kMaxWeightRows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_quantize<float>(x, q, scale, rows, cols, form, columns, st);
  if (dtype == 1)
    return (int)launch_quantize<__nv_bfloat16>(x, q, scale, rows, cols, form, columns, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
