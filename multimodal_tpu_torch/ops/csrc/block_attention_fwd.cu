// Whole-block attention forward for short sequences (S <= 320), hand-written for Hopper.
//
// Replaces the Pallas TPU kernel multimodal_tpu/ops/block_attention.py:_fwd_kernel in its
// non-LN form (reached through _block_attention). For x [B,S,W] and the four [W,W] weights in
// the JAX [in,out] layout it computes
//
//   q,k,v = x @ Wq|Wk|Wv + b          f32 accumulation, bias added in f32, rounded to T
//   p     = softmax(q_h k_h^T / sqrt(D)) per head, f32, finite -1e30 causal mask (col <= row),
//           row max subtracted, then rounded to T
//   attn  = p @ v_h                     f32 accumulation, rounded to T
//   y     = attn @ Wo + bo              as the projections
//
// in three launches: one tiled GEMM for q, k and v (gridDim.z = 3), one attention kernel
// per (query tile, head, image), one tiled GEMM for the output projection. Every product is
// a float FMA on the CUDA cores (for bf16 the operands are widened to float in shared
// memory), so float32 is true float32 with no TF32 anywhere.
//
// What bounds it on the card: the four [B*S,W]x[W,W] projections carry ~97% of the FLOPs at
// ViT-B/32 shapes (S=50, W=768), so the kernel is compute-bound on the GEMMs. The design
// keeps them on a 128x128 output tile per block with an 8x8 register micro-tile per thread
// (16 FMAs per shared-memory load), which is the standard way to reach a useful share of
// the float32 FMA rate without tensor cores. The attention core keeps the [S,S] logits of a
// 16-row query tile in shared memory and streams keys and values through it in 32-row
// chunks, so no [B,H,S,S] tensor ever reaches device memory and shared memory stays under
// 48 KB at S=320, D=128. The TPU kernel's image grouping (_images_per_program) is VMEM
// plumbing and has no counterpart here. wgmma, TMA and a single fused launch are later work.

#include "block_attention_common.cuh"

namespace {

// ----------------------------------------------------------------------------- attention
// One block per (16-row query tile, head, image). Keys and values stream through one
// shared chunk buffer; rows padded to D+1 floats so the per-key dot products are
// bank-conflict free.

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ kmat, const T* __restrict__ v,
                 T* __restrict__ out, int s, int w, int d, int s_pad, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                  // [kBQ][ld]
  float* kv = qs + kBQ * ld;         // [kChunk][ld]
  float* ps = kv + kChunk * ld;      // [kBQ][s_pad] logits, then probabilities

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBQ, head = blockIdx.y, img = blockIdx.z;
  const int rows = min(kBQ, s - r0);
  const size_t base = (size_t)img * s * w + (size_t)head * d;  // element (img, 0, head*d)
  // causal: no row of this tile attends past its last row
  const int kmax = causal ? min(s, r0 + rows) : s;

  for (int e = tid; e < kBQ * d; e += kAttnThreads) {
    const int r = e / d, col = e % d;
    qs[r * ld + col] = r < rows ? to_float(q[base + (size_t)(r0 + r) * w + col]) : 0.f;
  }

  // logits = q k^T * scale, masked
  for (int c0 = 0; c0 < kmax; c0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kChunk * d; e += kAttnThreads) {
      const int r = e / d, col = e % d;
      kv[r * ld + col] = c0 + r < s ? to_float(kmat[base + (size_t)(c0 + r) * w + col]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kBQ * kChunk; e += kAttnThreads) {
      const int r = e / kChunk, c = e % kChunk, key = c0 + c;
      if (key >= kmax) continue;
      float dot = 0.f;
      for (int col = 0; col < d; ++col) dot = fmaf(qs[r * ld + col], kv[c * ld + col], dot);
      const float logit = dot * scale;
      ps[r * s_pad + key] = (causal && key > r0 + r) ? kNegInf : logit;
    }
  }
  __syncthreads();

  // softmax per row, one warp per row: max, exp, sum, divide, round to T
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += kAttnThreads / 32) {
    float* row = ps + r * s_pad;
    float mx = kNegInf;
    for (int j = lane; j < kmax; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kmax; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < kmax; j += 32) row[j] = to_float(from_float<T>(row[j] / sum));
  }

  // attn = p @ v: each thread owns outputs tid, tid + 128, ... of the [kBQ, d] tile
  constexpr int kMaxOut = kBQ * kMaxHeadDim / kAttnThreads;
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < kmax; c0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kChunk * d; e += kAttnThreads) {
      const int r = e / d, col = e % d;
      kv[r * ld + col] = c0 + r < s ? to_float(v[base + (size_t)(c0 + r) * w + col]) : 0.f;
    }
    __syncthreads();
    const int cn = min(kChunk, kmax - c0);
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kAttnThreads;
      if (o >= kBQ * d) break;
      const int r = o / d, col = o % d;
      if (r >= rows) continue;
      const float* prow = ps + r * s_pad + c0;
      float a = acc[i];
      for (int c = 0; c < cn; ++c) a = fmaf(prow[c], kv[c * ld + col], a);
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kAttnThreads;
    if (o >= kBQ * d) break;
    const int r = o / d, col = o % d;
    if (r < rows) out[base + (size_t)(r0 + r) * w + col] = from_float<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* const* wts, const void* const* biases,
                   void* qkv, void* attn, void* y, int b, int s, int w, int heads, int causal,
                   cudaStream_t stream) {
  const int m = b * s, d = w / heads;
  const size_t plane = (size_t)m * w;
  const dim3 gemm_grid(w / kBN, (m + kBM - 1) / kBM, 3);

  GemmOperands qkv_ops;
  for (int z = 0; z < 3; ++z) {
    qkv_ops.b[z] = wts[z];
    qkv_ops.bias[z] = biases[z];
    qkv_ops.c[z] = static_cast<T*>(qkv) + z * plane;
  }
  gemm_bias_kernel<T><<<gemm_grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), qkv_ops, m, w, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int s_pad = (s + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kChunk) * (d + 1) + (size_t)kBQ * s_pad);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = (float)std::pow((double)d, -0.5);  // as the reference's d ** -0.5
  const T* qp = static_cast<const T*>(qkv);
  attention_kernel<T><<<dim3((s + kBQ - 1) / kBQ, heads, b), kAttnThreads, smem, stream>>>(
      qp, qp + plane, qp + 2 * plane, static_cast<T*>(attn), s, w, d, s_pad, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmOperands out_ops;
  out_ops.b[0] = wts[3];
  out_ops.bias[0] = biases[3];
  out_ops.c[0] = y;
  gemm_bias_kernel<T><<<dim3(w / kBN, (m + kBM - 1) / kBM, 1), kGemmThreads, 0, stream>>>(
      static_cast<const T*>(attn), out_ops, m, w, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. wts = {Wq, Wk, Wv, Wo} [W,W] ([in,out]); biases [W].
// qkv: scratch [3, B*S, W]; attn: scratch [B*S, W]; y: output [B, S, W]. All contiguous on
// one device; launches on `stream` without synchronising. Returns a cudaError_t.
int mmt_block_attention_fwd(int dtype, const void* x, const void* wq, const void* bq,
                            const void* wk, const void* bk, const void* wv, const void* bv,
                            const void* wo, const void* bo, void* qkv, void* attn, void* y,
                            int b, int s, int w, int heads, int causal, void* stream) {
  if (b < 1 || s < 1 || s > kMaxSeq || heads < 1 || w % 128 != 0 || w % heads != 0)
    return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  if (d > kMaxHeadDim || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const void* wts[4] = {wq, wk, wv, wo};
  const void* biases[4] = {bq, bk, bv, bo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, wts, biases, qkv, attn, y, b, s, w, heads, causal, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, wts, biases, qkv, attn, y, b, s, w, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}

const char* mmt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
