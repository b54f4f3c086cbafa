// Whole-block attention backward for short sequences (S <= 320), hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/block_attention.py:_bwd_kernel and
// _bwd_kernel_large in their non-LN form (both launched by _block_attention_bwd). The two
// compute the same outputs and differ only in how they budget the TPU's VMEM (S <= 128 and
// 128 < S <= 320); this one design covers every S <= 320 with D <= 128. For x and dy
// [B,S,W] and the four [W,W] weights in the JAX [in,out] layout it computes
//
//   q,k,v   = x @ Wq|Wk|Wv + b               as the forward (f32 accumulation, bias in f32,
//                                             one rounding to T)
//   do      = dy @ Wo^T                       f32 accumulation, rounded to T
//   p       = softmax(q_h k_h^T / sqrt(D))    as the forward, rounded to T
//   attnpre = p @ v_h                         rounded to T
//   dv      = p^T @ do_h                      rounded to T
//   dp      = do_h @ v_h^T                    f32
//   ds      = p * (dp - rowsum(dp * p))       rounded to T
//   dq      = (ds @ k_h) * scale, dk = (ds^T @ q_h) * scale    scaled in f32, rounded to T
//   dx      = [dq | dk | dv] @ [Wq; Wk; Wv]^T one f32 accumulator over K = 3W, rounded once
//
// in five launches: the forward's projection GEMM for q, k and v (gridDim.z = 3); a GEMM
// with transposed weights for do; a dQ pass, one block per (16-row query tile, head, image),
// that streams keys and values in 32-row chunks, writes attnpre and dq and saves three f32
// numbers per query row (the row max, the row sum of exp and rowsum(dp * p)); a dK/dV pass,
// one block per (16-key tile, head, image), that streams the query rows in 32-row chunks and
// rebuilds p and ds from the saved row numbers; and the transposed-weight GEMM for dx. No
// [B,H,S,S] tensor reaches device memory.
//
// What bounds it on the card: the five [B*S,W]x[W,W]-sized GEMM equivalents (q, k, v, do
// and the K = 3W dx product) carry ~90% of the FLOPs at ViT-B/32 shapes, so like the
// forward it is compute-bound on CUDA-core float FMAs; the attention passes are bound by
// shared-memory loads (two per FMA, no register tiling yet). The design choices that matter:
//   * dK and dV sum over every query row of an (image, head). Blocks run in parallel and
//     carry nothing between them, and two f32 [S, D] accumulators at S=320, D=128 (320 KB)
//     exceed a block's shared memory. So the sums run in a second pass, FlashAttention-2
//     style, where each block owns a key tile and keeps its dK/dV rows in registers.
//   * p must be bit-identical in both passes, so that dq and dv see the same rounded
//     probabilities: both passes compute each logit as one in-order fmaf chain over D, then
//     __fmul_rn by the scale (never contracted into the exp's subtraction), then
//     expf(logit - max) / sum with the same saved max and sum. dp is rebuilt the same way,
//     so ds agrees too.
//   * The TPU kernel's image groups (_images_per_program) and its stacked [H*S, S] buffers
//     exist for VMEM and have no counterpart here.
// Every product is a float FMA on the CUDA cores (bf16 operands are widened in shared
// memory), so float32 is true float32. wgmma, TMA and fewer launches are later work.

#include "block_attention_common.cuh"

namespace {

// ----------------------------------------------------------------------------- GEMM, W^T
// C[M,N] = sum_{z < nseg} A_z[M,kseg] @ W_z[N,kseg]^T with one f32 accumulator and one
// rounding, no bias. A_z row-major; W_z row-major [N, kseg], i.e. a [W_in, W_out] weight
// read as its transpose. Requires N % 128 == 0 and kseg % 16 == 0; M is ragged and masked.
struct NtOperands {
  const void* a[3];
  const void* w[3];
};

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(NtOperands ops, T* __restrict__ c, int m, int n, int kseg, int nseg) {
  __shared__ float as[kBK][kBM];  // A tile, transposed: as[kk][row]
  __shared__ float bs[kBK][kBN];  // W tile, transposed: bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int z = 0; z < nseg; ++z) {
    const T* __restrict__ a = static_cast<const T*>(ops.a[z]);
    const T* __restrict__ wt = static_cast<const T*>(ops.w[z]);
    for (int k0 = 0; k0 < kseg; k0 += kBK) {
      // A: 128 rows x 16 cols, W: 128 rows (output columns) x 16 cols; two groups of 4 each
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = tid + h * kGemmThreads;  // 0..511
        const int row = e / 4, col = (e % 4) * 4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m0 + row < m) load4(a + (size_t)(m0 + row) * kseg + k0 + col, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) as[col + i][row] = v[i];
        float u[4];
        load4(wt + (size_t)(n0 + row) * kseg + k0 + col, u);
#pragma unroll
        for (int i = 0; i < 4; ++i) bs[col + i][row] = u[i];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m) continue;
    store4(c + (size_t)row * n + n0 + tx * 4, acc[i]);
    store4(c + (size_t)row * n + n0 + 64 + tx * 4, acc[i] + 4);
  }
}

// ----------------------------------------------------------------------------- dQ pass
// One block per (16-row query tile, head, image). stats is [3][B*H*S]: the row max, the row
// sum of exp and rowsum(dp * p) of every query row, read back by the dK/dV pass.
template <typename T>
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
    for (int j = lane; j < kmax; j += 32) row[j] = to_float(from_float<T>(__fdiv_rn(row[j], sum)));
    if (lane == 0) {
      st[r] = mx;
      st[plane + r] = sum;
    }
  }

  // one pass over the values: attnpre = p @ v and dp = do v^T
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
    if (r < rows) attnpre[base + (size_t)(r0 + r) * w + col] = from_float<T>(acc[i]);
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
      drow[j] = to_float(from_float<T>(__fmul_rn(prow[j], __fsub_rn(drow[j], dl))));
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

template <typename T>
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
        p = to_float(from_float<T>(
            __fdiv_rn(expf(__fsub_rn(logit, rst[r])), rst[kRowChunk + r])));
        float dp = 0.f;
        for (int col = 0; col < d; ++col) dp = fmaf(dos[r * ld + col], vs[j * ld + col], dp);
        ds = to_float(from_float<T>(__fmul_rn(p, __fsub_rn(dp, rst[2 * kRowChunk + r]))));
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

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* const* wts,
                       const void* const* biases, void* qkv, void* dout, float* stats,
                       void* dx, void* dq, void* dk, void* dv, void* attnpre, int b, int s,
                       int w, int heads, int causal, cudaStream_t stream) {
  const int m = b * s, d = w / heads;
  const size_t plane = (size_t)m * w;
  const dim3 gemm_grid(w / kBN, (m + kBM - 1) / kBM, 1);

  // q, k, v recomputed exactly as the forward computed them
  GemmOperands qkv_ops;
  for (int z = 0; z < 3; ++z) {
    qkv_ops.b[z] = wts[z];
    qkv_ops.bias[z] = biases[z];
    qkv_ops.c[z] = static_cast<T*>(qkv) + z * plane;
  }
  gemm_bias_kernel<T><<<dim3(gemm_grid.x, gemm_grid.y, 3), kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), qkv_ops, m, w, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // do = dy @ Wo^T
  NtOperands do_ops = {};
  do_ops.a[0] = dy;
  do_ops.w[0] = wts[3];
  gemm_nt_kernel<T><<<gemm_grid, kGemmThreads, 0, stream>>>(do_ops, static_cast<T*>(dout), m,
                                                             w, w, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = (float)std::pow((double)d, -0.5);  // as the forward's
  const T* qp = static_cast<const T*>(qkv);
  const T* dop = static_cast<const T*>(dout);

  const int s_pad = (s + kChunk - 1) / kChunk * kChunk;
  const size_t smem_dq =
      sizeof(float) * ((size_t)(2 * kBQ + kChunk) * (d + 1) + (size_t)2 * kBQ * s_pad);
  err = allow_smem(attn_bwd_dq_kernel<T>, smem_dq);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<T><<<dim3((s + kBQ - 1) / kBQ, heads, b), kAttnThreads, smem_dq, stream>>>(
      qp, qp + plane, qp + 2 * plane, dop, static_cast<T*>(attnpre), static_cast<T*>(dq), stats,
      s, w, d, s_pad, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv =
      sizeof(float) * ((size_t)(2 * kKeyTile + 2 * kRowChunk) * (d + 1) +
                       (size_t)2 * kRowChunk * kKeyTile + 3 * kRowChunk);
  err = allow_smem(attn_bwd_dkv_kernel<T>, smem_dkv);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_kernel<T>
      <<<dim3((s + kKeyTile - 1) / kKeyTile, heads, b), kAttnThreads, smem_dkv, stream>>>(
          qp, qp + plane, qp + 2 * plane, dop, stats, static_cast<T*>(dk), static_cast<T*>(dv),
          s, w, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dx = [dq | dk | dv] @ [Wq; Wk; Wv]^T, one accumulator over K = 3W
  NtOperands dx_ops;
  const void* grads[3] = {dq, dk, dv};
  for (int z = 0; z < 3; ++z) {
    dx_ops.a[z] = grads[z];
    dx_ops.w[z] = wts[z];
  }
  gemm_nt_kernel<T><<<gemm_grid, kGemmThreads, 0, stream>>>(dx_ops, static_cast<T*>(dx), m, w,
                                                             w, 3);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, dy [B,S,W]; wts = {Wq, Wk, Wv, Wo} [W,W] ([in,out]);
// biases [W]. Scratch: qkv [3, B*S, W], dout [B*S, W] (T), stats [3, B*H*S] float32.
// Outputs dx, dq, dk, dv, attnpre [B,S,W]. All contiguous on one device; launches on
// `stream` without synchronising. Returns a cudaError_t.
int mmt_block_attention_bwd(int dtype, const void* x, const void* dy, const void* wq,
                            const void* bq, const void* wk, const void* bk, const void* wv,
                            const void* bv, const void* wo, const void* bo, void* qkv,
                            void* dout, void* stats, void* dx, void* dq, void* dk, void* dv,
                            void* attnpre, int b, int s, int w, int heads, int causal,
                            void* stream) {
  if (b < 1 || s < 1 || s > kMaxSeq || heads < 1 || w % 128 != 0 || w % heads != 0)
    return (int)cudaErrorInvalidValue;
  const int d = w / heads;
  if (d > kMaxHeadDim || d % 8 != 0) return (int)cudaErrorInvalidValue;
  const void* wts[4] = {wq, wk, wv, wo};
  const void* biases[4] = {bq, bk, bv, bo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, dy, wts, biases, qkv, dout, sp, dx, dq, dk, dv, attnpre,
                                  b, s, w, heads, causal, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, dy, wts, biases, qkv, dout, sp, dx, dq, dk, dv,
                                          attnpre, b, s, w, heads, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
