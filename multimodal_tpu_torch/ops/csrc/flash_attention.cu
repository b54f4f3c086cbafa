// Blocked online-softmax (flash) attention, forward and backward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/flash_attention.py:_fwd_kernel,
// _dq_kernel and _dkv_kernel: attention over separate q [B, Sq, H, D] and k, v [B, Sk, H, D]
// at any length, with no [B, H, Sq, Sk] tensor in device memory in either direction. Forward:
//
//   s    = (q_h k_h^T) * sm_scale          native operands, f32 sums; masked entries (key >=
//                                          Sk, or under `causal` key > query: top-left aligned)
//                                          take the finite -1e30
//   per key tile, in rising order: m_new = max(m, rowmax(s)); p = exp(s - m_new);
//          l = l * exp(m - m_new) + rowsum(p)            the *unrounded* p
//          acc = acc * exp(m - m_new) + round_T(p) @ v_h
//   out  = acc / l  (l == 0 guarded), lse = m + log(l)   lse [B, H, Sq] float32
//
// m starts at the finite -1e30, so the first tile's rescale factor is exp(-1e30 - m_new) = 0
// and a row whose entries in a live tile are all masked keeps m and adds 0; with -inf the same
// lines give NaN. Backward, from (q, k, v, do, lse, delta) with delta = rowsum(do * out)
// computed outside, as the TPU kernels take it:
//
//   p  = exp(s - lse)  f32;  dp = do_h v_h^T;  ds = round_T(p * (dp - delta))
//   dq = sum over key tiles of sm_scale * (ds @ k_h)                        (dQ kernel)
//   dv = sum over query tiles of round_T(p)^T @ do_h
//   dk = sum over query tiles of sm_scale * (ds^T @ q_h)                    (dK/dV kernel)
//
// each tile's product scaled in f32 before it is added, one rounding to T at the end.
//
// Designed for the card, not carried over block by block. The TPU wrapper transposes to
// [B, H, S, D] and pads Sq to 128 and Sk to 256 rows, and broadcasts lse and delta over 128
// lanes: all Mosaic tiling. Here the kernels read [B, S, H, D] in place (row stride H*D, head
// offset h*D) and mask the ragged tails in their loads; the TPU's sequential innermost grid
// axis (key tiles, or query tiles in the dK/dV kernel) is a loop inside the block. Forward and
// dQ: one block per (64-row query tile, head, batch) that streams 64-row key and value tiles
// through shared memory up to the tile's causal bound, the latest (longest) query tiles
// scheduled first. dK/dV: one block per (64-row key tile, head, batch) that streams the query
// tiles from the first live one. Every sum has one owner thread and a fixed order: no atomics,
// two runs give the same bits.
//
// What bounds it: 4 / 6 / 8 x pairs x D FLOPs (forward / dQ / dK-dV; both backward kernels
// rebuild s and dp, a one-pass backward would need 10) over q, k, v, out-sized traffic: at
// S=2048 that is hundreds of FLOPs per byte, bound by operations in both dtypes. The products
// run as CUDA-core FMAs on the register tiles of register_tiles.cuh (shared with the float32
// attention passes): each of the 256 threads owns a 4x4 tile of the logits and a 4 x D/16 tile
// of the accumulator (four neighbouring columns per 64) and reads its operands as float4, so
// one load feeds 4 to 16 FMAs. Tensor cores and TMA are later work.

#include "register_tiles.cuh"

namespace {

// element (batch, row 0, head, 0) of a [B, S, H, D] tensor
__device__ __forceinline__ size_t head_base(int batch, int s, int heads, int head, int d) {
  return ((size_t)batch * s * heads + head) * d;
}

// ----------------------------------------------------------------------------- forward
template <typename T, int kDC>
__global__ void __launch_bounds__(kTileThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int d,
                 float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* qs = smem;              // [kTile][ld]
  float* ks = qs + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  float* ps = vs + kTile * ld;   // [kTile][kPLd] probabilities rounded to T

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // the longest causal tiles first
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d);
  const size_t kbase = head_base(batch, sk, heads, head, d);
  const int rows = min(kTile, sq - r0);
  // top-left causal mask: no row of this tile sees a key past its last row
  const int kmax = causal ? min(sk, r0 + rows) : sk;

  load_tile(qs, q + qbase + (size_t)r0 * stride, stride, rows, d, ld);

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < kmax; c0 += kTile) {
    __syncthreads();  // the last tile's reads of ks, vs and ps are done
    load_tile(ks, k + kbase + (size_t)c0 * stride, stride, sk - c0, d, ld);
    load_tile(vs, v + kbase + (size_t)c0 * stride, stride, sk - c0, d, ld);
    __syncthreads();
    float s[4][4];
    tile_dot(qs, ks, d, ld, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool live = col < sk && (!causal || col <= row);
        s[i][j] = live ? __fmul_rn(s[i][j], scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(__fsub_rn(m[i], m_new));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new));
        sum += p;
        ps[(ty * 4 + i) * kPLd + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = fmaf(l[i], alpha, row_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_accumulate<kDC>(ps, vs, d, ld, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = acc[i][j] / safe_l;
    if (tx == 0 && row < sq) lse[((size_t)batch * heads + head) * sq + row] = m[i] + logf(safe_l);
  }
  store_rows<T, kDC>(out + qbase + (size_t)r0 * stride, stride, rows, d, ty, tx, acc);
}

// ----------------------------------------------------------------------------- dQ
template <typename T, int kDC>
__global__ void __launch_bounds__(kTileThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int d,
                float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* qs = smem;               // [kTile][ld]
  float* dos = qs + kTile * ld;   // [kTile][ld]
  float* ks = dos + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;    // [kTile][ld]
  float* dss = vs + kTile * ld;   // [kTile][kPLd] ds rounded to T

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d);
  const size_t kbase = head_base(batch, sk, heads, head, d);
  const int rows = min(kTile, sq - r0);
  const int kmax = causal ? min(sk, r0 + rows) : sk;

  load_tile(qs, q + qbase + (size_t)r0 * stride, stride, rows, d, ld);
  load_tile(dos, dout + qbase + (size_t)r0 * stride, stride, rows, d, ld);

  float row_lse[4], row_delta[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const size_t at = ((size_t)batch * heads + head) * sq + row;
    row_lse[i] = row < sq ? lse[at] : 0.f;
    row_delta[i] = row < sq ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < kmax; c0 += kTile) {
    __syncthreads();
    load_tile(ks, k + kbase + (size_t)c0 * stride, stride, sk - c0, d, ld);
    load_tile(vs, v + kbase + (size_t)c0 * stride, stride, sk - c0, d, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(qs, ks, d, ld, ty, tx, s);
    tile_dot(dos, vs, d, ld, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool live = col < sk && (!causal || col <= row);
        const float p = expf(__fsub_rn(live ? __fmul_rn(s[i][j], scale) : kNegInf, row_lse[i]));
        dss[(ty * 4 + i) * kPLd + tx + 16 * j] =
            round_to<T>(__fmul_rn(p, __fsub_rn(dp[i][j], row_delta[i])));
      }
    }
    __syncthreads();
    float part[4][kDC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDC; ++j) part[i][j] = 0.f;
    tile_accumulate<kDC>(dss, ks, d, ld, ty, tx, part);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDC; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(scale, part[i][j]));
  }

  store_rows<T, kDC>(dq + qbase + (size_t)r0 * stride, stride, rows, d, ty, tx, acc);
}

// ----------------------------------------------------------------------------- dK/dV
// Thread (ty, tx) forms the (query row ty*4+i, key tx+16*j) entries of p and ds, which pass
// through shared memory, and owns the (key ty*4+i, columns own_col(tx, g)..+3) entries of dk
// and dv.
template <typename T, int kDC>
__global__ void __launch_bounds__(kTileThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 int sq, int sk, int d, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d + 4;
  float* ks = smem;                 // [kTile][ld]
  float* vs = ks + kTile * ld;      // [kTile][ld]
  float* qs = vs + kTile * ld;      // [kTile][ld]
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ps = dos + kTile * ld;     // [kTile][kPLd] p rounded to T, [query][key]
  float* dss = ps + kTile * kPLd;   // [kTile][kPLd] ds rounded to T
  float* rst = dss + kTile * kPLd;  // [2][kTile] lse and delta of the query tile's rows

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c0 = blockIdx.x * kTile;  // under the causal mask the earliest tiles are longest
  const int head = blockIdx.y, batch = blockIdx.z, heads = gridDim.y;
  const size_t stride = (size_t)heads * d;
  const size_t qbase = head_base(batch, sq, heads, head, d);
  const size_t kbase = head_base(batch, sk, heads, head, d);
  const float* lse_h = lse + ((size_t)batch * heads + head) * sq;
  const float* delta_h = delta + ((size_t)batch * heads + head) * sq;

  load_tile(ks, k + kbase + (size_t)c0 * stride, stride, sk - c0, d, ld);
  load_tile(vs, v + kbase + (size_t)c0 * stride, stride, sk - c0, d, ld);

  float acc_k[4][kDC], acc_v[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // a query row before the tile's first key sees none of its keys (p = ds = 0 exactly)
  for (int q0 = causal ? c0 : 0; q0 < sq; q0 += kTile) {
    __syncthreads();
    load_tile(qs, q + qbase + (size_t)q0 * stride, stride, sq - q0, d, ld);
    load_tile(dos, dout + qbase + (size_t)q0 * stride, stride, sq - q0, d, ld);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      rst[threadIdx.x] = row < sq ? lse_h[row] : 0.f;
      rst[kTile + threadIdx.x] = row < sq ? delta_h[row] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(qs, ks, d, ld, ty, tx, s);
    tile_dot(dos, vs, d, ld, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool live = row < sq && col < sk && (!causal || col <= row);
        const float p = expf(__fsub_rn(live ? __fmul_rn(s[i][j], scale) : kNegInf, rst[r]));
        ps[r * kPLd + tx + 16 * j] = round_to<T>(p);
        dss[r * kPLd + tx + 16 * j] =
            round_to<T>(__fmul_rn(p, __fsub_rn(dp[i][j], rst[kTile + r])));
      }
    }
    __syncthreads();
    // dv += p^T do, dk += scale * (ds^T q) over this tile's query rows
    float part[4][kDC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDC; ++j) part[i][j] = 0.f;
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kPLd + ty * 4);
      const float4 d4 = *reinterpret_cast<const float4*>(dss + r * kPLd + ty * 4);
#pragma unroll
      for (int g = 0; g < kDC / 4; ++g) {
        const int col = own_col(tx, g);
        if (col < d) {
          const float4 dov = *reinterpret_cast<const float4*>(dos + r * ld + col);
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * ld + col);
          fma4(acc_v[0] + 4 * g, p4.x, dov);
          fma4(acc_v[1] + 4 * g, p4.y, dov);
          fma4(acc_v[2] + 4 * g, p4.z, dov);
          fma4(acc_v[3] + 4 * g, p4.w, dov);
          fma4(part[0] + 4 * g, d4.x, qv);
          fma4(part[1] + 4 * g, d4.y, qv);
          fma4(part[2] + 4 * g, d4.z, qv);
          fma4(part[3] + 4 * g, d4.w, qv);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kDC; ++j)
        acc_k[i][j] = __fadd_rn(acc_k[i][j], __fmul_rn(scale, part[i][j]));
  }

  store_rows<T, kDC>(dk + kbase + (size_t)c0 * stride, stride, sk - c0, d, ty, tx, acc_k);
  store_rows<T, kDC>(dv + kbase + (size_t)c0 * stride, stride, sk - c0, d, ty, tx, acc_v);
}

// ----------------------------------------------------------------------------- launches
bool flash_shape_ok(int b, int sq, int sk, int heads, int d) {
  return b >= 1 && b <= 65535 && sq >= 1 && sk >= 1 && heads >= 1 && heads <= 65535 && d >= 8 &&
         d <= kMaxHeadDim && d % 8 == 0;
}

dim3 tiles(int s, int heads, int b) { return dim3((s + kTile - 1) / kTile, heads, b); }

template <typename T, int kDC>
cudaError_t flash_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int b,
                      int sq, int sk, int heads, int d, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)3 * kTile * (d + 4) + kTile * kPLd);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, kDC>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, kDC><<<tiles(sq, heads, b), kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int kDC>
cudaError_t flash_dq(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, int b, int sq, int sk,
                     int heads, int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)4 * kTile * (d + 4) + kTile * kPLd);
  cudaError_t err = allow_smem(flash_dq_kernel<T, kDC>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, kDC><<<tiles(sq, heads, b), kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int kDC>
cudaError_t flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int b, int sq,
                      int sk, int heads, int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)4 * kTile * (d + 4) + 2 * kTile * kPLd + 2 * kTile);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, kDC>, smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, kDC><<<tiles(sk, heads, b), kTileThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      d, scale, causal);
  return cudaGetLastError();
}

// the instantiation for (dtype, d): 4 accumulator columns a thread up to D=64, 8 up to D=128
#define MMT_FLASH_DISPATCH(fn, ...)                                          \
  do {                                                                       \
    if (dtype == 0 && d <= 64) return (int)fn<float, 4>(__VA_ARGS__);        \
    if (dtype == 0) return (int)fn<float, 8>(__VA_ARGS__);                   \
    if (dtype == 1 && d <= 64) return (int)fn<__nv_bfloat16, 4>(__VA_ARGS__); \
    if (dtype == 1) return (int)fn<__nv_bfloat16, 8>(__VA_ARGS__);           \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, dout, out, dq: [B, Sq, heads, d]; k, v, dk, dv:
// [B, Sk, heads, d]; lse, delta: float32 [B, heads, Sq]. All contiguous on one device, d a
// multiple of 8 up to 128. Each entry is one launch on `stream`, does not synchronise and
// returns a cudaError_t.
int mmt_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            void* lse, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_fwd, q, k, v, out, static_cast<float*>(lse), b, sq, sk, heads, d,
                     causal, sm_scale, static_cast<cudaStream_t>(stream));
}

int mmt_flash_attention_dq(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta, void* dq, int b,
                           int sq, int sk, int heads, int d, int causal, float sm_scale,
                           void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_dq, q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dq, b, sq, sk, heads, d, causal, sm_scale,
                     static_cast<cudaStream_t>(stream));
}

int mmt_flash_attention_dkv(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dk,
                            void* dv, int b, int sq, int sk, int heads, int d, int causal,
                            float sm_scale, void* stream) {
  if (!flash_shape_ok(b, sq, sk, heads, d)) return (int)cudaErrorInvalidValue;
  MMT_FLASH_DISPATCH(flash_dkv, q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dk, dv, b, sq, sk, heads, d, causal,
                     sm_scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
