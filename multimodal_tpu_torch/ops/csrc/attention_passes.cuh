// The attention passes shared by the block-attention kernels (block_attention_fwd.cu,
// block_attention_bwd.cu) and the fused whole-sequence attention pair (fused_attention.cu):
// the forward core softmax(q k^T * scale) v, and the backward's dQ pass and dK/dV pass. All
// three read q, k and v through separate pointers with a row stride of `w` elements and the
// head's columns at head * d, so they serve both a [3, B*S, W] projection scratch and three
// packed [B, S, H*D] tensors. Like the common header this one lives in an anonymous
// namespace: each source that includes it gets its own copy.
//
// The backward passes are templated on kExactProbs, the one numeric difference between the
// two TPU backward kernels they port: the block backward (block_attention.py:_bwd_kernel)
// forms rowsum(dp * p) and ds from the probabilities *rounded* to the compute dtype and
// widened again, and emits attnpre = p v; the fused backward (fused_attention.py:_bwd_kernel)
// forms them from the exact float32 probabilities, uses the rounded ones for dv only, and
// has no attnpre. In float32 the two agree; in bfloat16 they do not.

#pragma once

#include "block_attention_common.cuh"

namespace {

// attention tiles: 16 query rows per block, keys and values streamed in 32-row chunks
constexpr int kBQ = 16, kChunk = 32, kAttnThreads = 128;

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ----------------------------------------------------------------------------- forward core
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
    for (int j = lane; j < kmax; j += 32) row[j] = round_to<T>(row[j] / sum);
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

// out = softmax(q k^T * scale) v per (image, head); q, k, v, out [B, S, w] with d columns
// per head.
template <typename T>
cudaError_t launch_attention_core(const T* q, const T* k, const T* v, T* out, int b, int s,
                                  int w, int heads, int d, float scale, int causal,
                                  cudaStream_t stream) {
  const int s_pad = (s + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kChunk) * (d + 1) + (size_t)kBQ * s_pad);
  cudaError_t err = allow_smem(attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  attention_kernel<T><<<dim3((s + kBQ - 1) / kBQ, heads, b), kAttnThreads, smem, stream>>>(
      q, k, v, out, s, w, d, s_pad, scale, causal);
  return cudaGetLastError();
}

// ----------------------------------------------------------------------------- dQ pass
// One block per (16-row query tile, head, image). stats is [3][B*H*S]: the row max, the row
// sum of exp and rowsum(dp * p) of every query row, read back by the dK/dV pass. With
// kExactProbs the shared rows keep the float32 probabilities and attnpre is not formed.
template <typename T, bool kExactProbs>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ kmat,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   T* __restrict__ attnpre, T* __restrict__ dq, float* __restrict__ stats,
                   int s, int w, int d, int s_pad, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                // [kBQ][ld]
  float* dos = qs + kBQ * ld;      // [kBQ][ld]
  float* kv = dos + kBQ * ld;      // [kChunk][ld] key or value chunk
  float* ps = kv + kChunk * ld;    // [kBQ][s_pad] logits, then p
  float* dps = ps + kBQ * s_pad;   // [kBQ][s_pad] dp, then ds

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kBQ, head = blockIdx.y, img = blockIdx.z;
  const int rows = min(kBQ, s - r0);
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const size_t plane = (size_t)gridDim.z * gridDim.y * s;
  float* st = stats + ((size_t)img * gridDim.y + head) * s + r0;
  const int kmax = causal ? min(s, r0 + rows) : s;

  for (int e = tid; e < kBQ * d; e += kAttnThreads) {
    const int r = e / d, col = e % d;
    const size_t at = base + (size_t)(r0 + r) * w + col;
    qs[r * ld + col] = r < rows ? to_float(q[at]) : 0.f;
    dos[r * ld + col] = r < rows ? to_float(dout[at]) : 0.f;
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
      ps[r * s_pad + key] = (causal && key > r0 + r) ? kNegInf : __fmul_rn(dot, scale);
    }
  }
  __syncthreads();

  // softmax per row, one warp per row; the max and the sum are kept for the dK/dV pass
  for (int r = warp; r < rows; r += kAttnThreads / 32) {
    float* row = ps + r * s_pad;
    float mx = kNegInf;
    for (int j = lane; j < kmax; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kmax; j += 32) {
      const float e = expf(__fsub_rn(row[j], mx));
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < kmax; j += 32) {
      const float p32 = __fdiv_rn(row[j], sum);
      row[j] = kExactProbs ? p32 : round_to<T>(p32);
    }
    if (lane == 0) {
      st[r] = mx;
      st[plane + r] = sum;
    }
  }

  // one pass over the values: dp = do v^T and, in the block form, attnpre = p @ v
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
    for (int e = tid; e < kBQ * kChunk; e += kAttnThreads) {
      const int r = e / kChunk, c = e % kChunk, key = c0 + c;
      if (key >= kmax) continue;
      float dot = 0.f;
      for (int col = 0; col < d; ++col) dot = fmaf(dos[r * ld + col], kv[c * ld + col], dot);
      dps[r * s_pad + key] = dot;
    }
    if constexpr (!kExactProbs) {
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
  }
  if constexpr (!kExactProbs) {
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kAttnThreads;
      if (o >= kBQ * d) break;
      const int r = o / d, col = o % d;
      if (r < rows) attnpre[base + (size_t)(r0 + r) * w + col] = from_float<T>(acc[i]);
    }
  }
  __syncthreads();

  // ds = p * (dp - rowsum(dp * p)), rounded to T; rowsum kept for the dK/dV pass
  for (int r = warp; r < rows; r += kAttnThreads / 32) {
    const float* prow = ps + r * s_pad;
    float* drow = dps + r * s_pad;
    float dl = 0.f;
    for (int j = lane; j < kmax; j += 32) dl = fmaf(drow[j], prow[j], dl);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dl += __shfl_xor_sync(0xffffffffu, dl, off);
    for (int j = lane; j < kmax; j += 32)
      drow[j] = round_to<T>(__fmul_rn(prow[j], __fsub_rn(drow[j], dl)));
    if (lane == 0) st[2 * plane + r] = dl;
  }

  // dq = (ds @ k) * scale
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < kmax; c0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kChunk * d; e += kAttnThreads) {
      const int r = e / d, col = e % d;
      kv[r * ld + col] = c0 + r < s ? to_float(kmat[base + (size_t)(c0 + r) * w + col]) : 0.f;
    }
    __syncthreads();
    const int cn = min(kChunk, kmax - c0);
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kAttnThreads;
      if (o >= kBQ * d) break;
      const int r = o / d, col = o % d;
      if (r >= rows) continue;
      const float* drow = dps + r * s_pad + c0;
      float a = acc[i];
      for (int c = 0; c < cn; ++c) a = fmaf(drow[c], kv[c * ld + col], a);
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kAttnThreads;
    if (o >= kBQ * d) break;
    const int r = o / d, col = o % d;
    if (r < rows) dq[base + (size_t)(r0 + r) * w + col] = from_float<T>(__fmul_rn(acc[i], scale));
  }
}

// ----------------------------------------------------------------------------- dK/dV pass
// One block per (16-key tile, head, image); query rows stream through in 32-row chunks.
// Under the causal mask a row before the tile's first key sees none of its keys (p = ds = 0
// exactly), so the stream starts at that key.
constexpr int kKeyTile = 16, kRowChunk = 32;

template <typename T, bool kExactProbs>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ kmat,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                    int s, int w, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;                      // [kKeyTile][ld]
  float* vs = ks + kKeyTile * ld;        // [kKeyTile][ld]
  float* qs = vs + kKeyTile * ld;        // [kRowChunk][ld]
  float* dos = qs + kRowChunk * ld;      // [kRowChunk][ld]
  float* pt = dos + kRowChunk * ld;      // [kRowChunk][kKeyTile] p
  float* dst = pt + kRowChunk * kKeyTile;  // [kRowChunk][kKeyTile] ds
  float* rst = dst + kRowChunk * kKeyTile;  // [3][kRowChunk] max, sum, rowsum(dp * p)

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kKeyTile, head = blockIdx.y, img = blockIdx.z;
  const int keys = min(kKeyTile, s - j0);
  const size_t base = (size_t)img * s * w + (size_t)head * d;
  const size_t plane = (size_t)gridDim.z * gridDim.y * s;
  const float* st = stats + ((size_t)img * gridDim.y + head) * s;

  for (int e = tid; e < kKeyTile * d; e += kAttnThreads) {
    const int j = e / d, col = e % d;
    const size_t at = base + (size_t)(j0 + j) * w + col;
    ks[j * ld + col] = j < keys ? to_float(kmat[at]) : 0.f;
    vs[j * ld + col] = j < keys ? to_float(v[at]) : 0.f;
  }

  constexpr int kMaxOut = kKeyTile * kMaxHeadDim / kAttnThreads;
  float acc_k[kMaxOut], acc_v[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int q0 = causal ? j0 : 0; q0 < s; q0 += kRowChunk) {
    const int nr = min(kRowChunk, s - q0);
    __syncthreads();
    for (int e = tid; e < kRowChunk * d; e += kAttnThreads) {
      const int r = e / d, col = e % d;
      const size_t at = base + (size_t)(q0 + r) * w + col;
      qs[r * ld + col] = r < nr ? to_float(q[at]) : 0.f;
      dos[r * ld + col] = r < nr ? to_float(dout[at]) : 0.f;
    }
    for (int r = tid; r < kRowChunk; r += kAttnThreads) {
      rst[r] = r < nr ? st[q0 + r] : 0.f;
      rst[kRowChunk + r] = r < nr ? st[plane + q0 + r] : 1.f;
      rst[2 * kRowChunk + r] = r < nr ? st[2 * plane + q0 + r] : 0.f;
    }
    __syncthreads();
    // p and ds of every (row, key) pair, with the dQ pass's exact operation order
    for (int e = tid; e < kRowChunk * kKeyTile; e += kAttnThreads) {
      const int r = e / kKeyTile, j = e % kKeyTile;
      float p = 0.f, ds = 0.f;
      if (r < nr && j < keys) {
        float dot = 0.f;
        for (int col = 0; col < d; ++col) dot = fmaf(qs[r * ld + col], ks[j * ld + col], dot);
        const float logit = (causal && j0 + j > q0 + r) ? kNegInf : __fmul_rn(dot, scale);
        const float p32 = __fdiv_rn(expf(__fsub_rn(logit, rst[r])), rst[kRowChunk + r]);
        p = round_to<T>(p32);
        float dp = 0.f;
        for (int col = 0; col < d; ++col) dp = fmaf(dos[r * ld + col], vs[j * ld + col], dp);
        ds = round_to<T>(
            __fmul_rn(kExactProbs ? p32 : p, __fsub_rn(dp, rst[2 * kRowChunk + r])));
      }
      pt[r * kKeyTile + j] = p;
      dst[r * kKeyTile + j] = ds;
    }
    __syncthreads();
    // dv += p^T do, dk += ds^T q over this chunk's rows
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kAttnThreads;
      if (o >= kKeyTile * d) break;
      const int j = o / d, col = o % d;
      float ak = acc_k[i], av = acc_v[i];
      for (int r = 0; r < nr; ++r) {
        av = fmaf(pt[r * kKeyTile + j], dos[r * ld + col], av);
        ak = fmaf(dst[r * kKeyTile + j], qs[r * ld + col], ak);
      }
      acc_k[i] = ak;
      acc_v[i] = av;
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kAttnThreads;
    if (o >= kKeyTile * d) break;
    const int j = o / d, col = o % d;
    if (j >= keys) continue;
    const size_t at = base + (size_t)(j0 + j) * w + col;
    dk[at] = from_float<T>(__fmul_rn(acc_k[i], scale));
    dv[at] = from_float<T>(acc_v[i]);
  }
}

// The two backward passes in order: dq (and attnpre unless kExactProbs, where it may be
// null), then dk and dv. stats is a float32 scratch of [3, B*H*S].
template <typename T, bool kExactProbs>
cudaError_t launch_attention_bwd_passes(const T* q, const T* k, const T* v, const T* dout,
                                        float* stats, T* attnpre, T* dq, T* dk, T* dv, int b,
                                        int s, int w, int heads, int d, float scale, int causal,
                                        cudaStream_t stream) {
  const int s_pad = (s + kChunk - 1) / kChunk * kChunk;
  const size_t smem_dq =
      sizeof(float) * ((size_t)(2 * kBQ + kChunk) * (d + 1) + (size_t)2 * kBQ * s_pad);
  cudaError_t err = allow_smem(attn_bwd_dq_kernel<T, kExactProbs>, smem_dq);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T, kExactProbs>
      <<<dim3((s + kBQ - 1) / kBQ, heads, b), kAttnThreads, smem_dq, stream>>>(
          q, k, v, dout, attnpre, dq, stats, s, w, d, s_pad, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv =
      sizeof(float) * ((size_t)(2 * kKeyTile + 2 * kRowChunk) * (d + 1) +
                       (size_t)2 * kRowChunk * kKeyTile + 3 * kRowChunk);
  err = allow_smem(attn_bwd_dkv_kernel<T, kExactProbs>, smem_dkv);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T, kExactProbs>
      <<<dim3((s + kKeyTile - 1) / kKeyTile, heads, b), kAttnThreads, smem_dkv, stream>>>(
          q, k, v, dout, stats, dk, dv, s, w, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace
