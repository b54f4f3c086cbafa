// The elementwise halves of the W8A8 int8 products, hand-written for Hopper: the row quantize
// and the rescale of the int32 accumulator.
//
// Replaces the XLA code of multimodal_tpu/ops/quant.py: quantize_rows (:31) and
// quantize_weight (:22), and the rescales of _int8_product (:49), _int8_dense_bwd (:78) and
// int8_matmul (:100-103). The int8 x int8 -> int32 product between them stays a library call
// (torch._int_mm, cuBLASLt), as it is a plain dot_general there.
//
//   quantize_rows_kernel   x [R,C] float32 or bfloat16 -> q [R,C] int8, scale [R] float32:
//                            amax = max |x| over the row, in float32
//                            s    = max(amax, 1e-12) * float32(1/127)   form 0 (jitted)
//                                 = max(amax, 1e-12) / 127              form 1 (eager)
//                            q    = clamp(rint(x / s), -127, 127)       IEEE division,
//                                                                       ties to even
//   int8_rescale_kernel    acc [M,N] int32, sx [M], sw [N] [, bias [N]] float32 ->
//                            y = round_T((float(acc) * sx) * sw)
//                            y = round_T(fma(float(acc) * sx, sw, bias))   with a bias
//                          (XLA contracts the reference's acc * sx * sw + bias into one
//                          fused multiply-add; the plain version emulates it exactly)
//
// Both are bound by bytes: a quantize reads x once and writes a byte per element, a rescale
// reads 4 bytes and writes 2 or 4 per element, with one or two multiplies each. What the
// design does: one warp per row in the quantize (the amax is a warp reduction, no shared
// memory, and the second pass re-reads the row from L1/L2), 4-wide vector loads and stores in
// both, a grid-stride loop in the rescale. Every operation is written with its _rn intrinsic
// (__fdiv_rn, __fmul_rn, __fmaf_rn), which nvcc never contracts or replaces with an
// approximate division, so each result is the plain PyTorch version's bit for bit. Fusing
// the rescale into a tensor-core int8 GEMM's store (and the quantize of x into its load) would
// remove the accumulator's round trip through device memory; that is later work.

#include "block_attention_common.cuh"

namespace {

constexpr int kQuantWarps = 8;  // rows per block of the quantize
constexpr float kInv127 = 1.0f / 127.0f;
constexpr int kRescaleThreads = 256;

__device__ __forceinline__ signed char int8_code(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

// kVec: 4-wide loads and stores (C a multiple of 4 and the rows 16-byte aligned)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kQuantWarps * 32)
    quantize_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                         float* __restrict__ scale, int rows, int cols, int form) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  signed char* qr = q + static_cast<size_t>(row) * cols;

  float amax = 0.0f;
  if (kVec) {
    for (int c = 4 * lane; c < cols; c += 128) {
      float v[4];
      load4(xr + c, v);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
    }
  } else {
    for (int c = lane; c < cols; c += 32) amax = fmaxf(amax, fabsf(to_float(xr[c])));
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float m = fmaxf(amax, 1e-12f);
  const float s = form == 0 ? __fmul_rn(m, kInv127) : __fdiv_rn(m, 127.0f);
  if (lane == 0) scale[row] = s;

  if (kVec) {
    for (int c = 4 * lane; c < cols; c += 128) {
      float v[4];
      load4(xr + c, v);
      char4 out;
      out.x = int8_code(v[0], s);
      out.y = int8_code(v[1], s);
      out.z = int8_code(v[2], s);
      out.w = int8_code(v[3], s);
      *reinterpret_cast<char4*>(qr + c) = out;
    }
  } else {
    for (int c = lane; c < cols; c += 32) qr[c] = int8_code(to_float(xr[c]), s);
  }
}

// four consecutive columns a thread per loop step; N a multiple of 4
template <typename TOut, bool kBias>
__global__ void __launch_bounds__(kRescaleThreads)
    int8_rescale_kernel(const int* __restrict__ acc, const float* __restrict__ sx,
                        const float* __restrict__ sw, const float* __restrict__ bias,
                        TOut* __restrict__ y, int m, int n) {
  const int quads = n / 4;
  const size_t total = static_cast<size_t>(m) * quads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / quads);
    const int c = static_cast<int>(i - static_cast<size_t>(row) * quads) * 4;
    const size_t at = static_cast<size_t>(row) * n + c;
    const int4 a = *reinterpret_cast<const int4*>(acc + at);
    const float4 w = *reinterpret_cast<const float4*>(sw + c);
    const float s = sx[row];
    const float p[4] = {__fmul_rn(__int2float_rn(a.x), s), __fmul_rn(__int2float_rn(a.y), s),
                        __fmul_rn(__int2float_rn(a.z), s), __fmul_rn(__int2float_rn(a.w), s)};
    float v[4];
    if (kBias) {
      const float4 b = *reinterpret_cast<const float4*>(bias + c);
      v[0] = __fmaf_rn(p[0], w.x, b.x);
      v[1] = __fmaf_rn(p[1], w.y, b.y);
      v[2] = __fmaf_rn(p[2], w.z, b.z);
      v[3] = __fmaf_rn(p[3], w.w, b.w);
    } else {
      v[0] = __fmul_rn(p[0], w.x);
      v[1] = __fmul_rn(p[1], w.y);
      v[2] = __fmul_rn(p[2], w.z);
      v[3] = __fmul_rn(p[3], w.w);
    }
    store4(y + at, v);
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* scale, int rows, int cols, int form,
                            cudaStream_t stream) {
  const dim3 grid((rows + kQuantWarps - 1) / kQuantWarps), block(kQuantWarps * 32);
  const T* xp = static_cast<const T*>(x);
  signed char* qp = static_cast<signed char*>(q);
  float* sp = static_cast<float*>(scale);
  if (cols % 4 == 0)
    quantize_rows_kernel<T, true><<<grid, block, 0, stream>>>(xp, qp, sp, rows, cols, form);
  else
    quantize_rows_kernel<T, false><<<grid, block, 0, stream>>>(xp, qp, sp, rows, cols, form);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_rescale(const void* acc, const void* sx, const void* sw, const void* bias,
                           void* y, int m, int n, cudaStream_t stream) {
  const size_t quads = static_cast<size_t>(m) * (n / 4);
  const size_t want = (quads + kRescaleThreads - 1) / kRescaleThreads;
  const dim3 grid(static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16)), block(kRescaleThreads);
  const int* ap = static_cast<const int*>(acc);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* bp = static_cast<const float*>(bias);
  TOut* yp = static_cast<TOut*>(y);
  if (bp != nullptr)
    int8_rescale_kernel<TOut, true><<<grid, block, 0, stream>>>(ap, sxp, swp, bp, yp, m, n);
  else
    int8_rescale_kernel<TOut, false><<<grid, block, 0, stream>>>(ap, sxp, swp, bp, yp, m, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 input; form: 0 = max(amax, 1e-12) * float32(1/127), 1 =
// max(amax, 1e-12) / 127. x [rows, cols] contiguous and 16-byte aligned; q [rows, cols] int8
// and scale [rows] float32 written. Launches on `stream` without synchronising. Returns a
// cudaError_t.
int mmt_quantize_rows(int dtype, const void* x, void* q, void* scale, int rows, int cols,
                      int form, void* stream) {
  if (rows < 1 || cols < 1 || (form != 0 && form != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_quantize<float>(x, q, scale, rows, cols, form, st);
  if (dtype == 1) return (int)launch_quantize<__nv_bfloat16>(x, q, scale, rows, cols, form, st);
  return (int)cudaErrorInvalidValue;
}

// out_dtype: 0 = float32, 1 = bfloat16. acc [m, n] int32, sx [m], sw [n] and bias [n] (or
// null) float32, y [m, n] of out_dtype; all contiguous and 16-byte aligned, n a multiple of 4.
int mmt_int8_rescale(int out_dtype, const void* acc, const void* sx, const void* sw,
                     const void* bias, void* y, int m, int n, void* stream) {
  if (m < 1 || n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return (int)launch_rescale<float>(acc, sx, sw, bias, y, m, n, st);
  if (out_dtype == 1) return (int)launch_rescale<__nv_bfloat16>(acc, sx, sw, bias, y, m, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
