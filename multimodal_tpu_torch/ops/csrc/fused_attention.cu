// Fused whole-sequence attention, forward and backward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/fused_attention.py:_fwd_kernel and
// _bwd_kernel: the attention core alone (no projections) over separate q, k and v packed as
// [B, S, H*D], for self-attention at 128 <= S <= 512 with D in {32, 64, 128}. Forward:
//
//   p   = softmax(q_h k_h^T * sm_scale) per head, f32, finite -1e30 causal mask (col <= row),
//         row max subtracted, rounded to T
//   out = p @ v_h                       f32 accumulation, rounded to T
//
// Backward, from (q, k, v, do) with the probabilities recomputed:
//
//   p32   = softmax(...)                exact f32 probabilities, p = p32 rounded to T
//   dv    = p^T @ do_h                  the *rounded* p, as the forward's product used
//   dp    = do_h @ v_h^T                f32
//   delta = rowsum(dp * p32)            the *exact* p32
//   ds    = p32 * (dp - delta)          rounded to T
//   dq    = (ds @ k_h) * sm_scale, dk = (ds^T @ q_h) * sm_scale    scaled in f32, rounded to T
//
// This is where the fused backward differs from the block-attention backward, which forms
// delta and ds from the rounded p: the passes in attention_passes.cuh are templated on that
// choice (kExactProbs) and this file instantiates the exact form.
//
// One launch forward (a block per 16-row query tile, head and image, keys and values
// streamed through shared memory in 32-row chunks, the tile's [16, S] logits kept in shared
// memory: 57 KB at S=512, D=128, above the 48 KB default and allowed by attribute). Two
// launches backward (a dQ pass per query tile that saves three f32 numbers per row, then a
// dK/dV pass per 16-key tile that rebuilds p and ds from them), so dK and dV need no atomics
// and no [B,H,S,S] tensor reaches device memory. The TPU kernel's 16-row sequence pad and its
// 128-lane head groups are Mosaic tiling and have no counterpart: the ragged last tile is
// masked.
//
// What bounds it on the card: 4 B H S^2 D FLOPs forward and 10 B H S^2 D backward over 4 and
// 7 [B,S,H*D] tensors of traffic: at S=197, D=64 that is ~49 FLOP per byte in float32, above
// the CUDA-core float32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so float32 is bound by
// operations; in bfloat16 (~98 FLOP per byte against a tensor-core ridge of 295) it would be
// bound by bytes. These passes run scalar FMAs out of shared memory (two loads per FMA), far
// from either bound; register tiling and mma are later work.

#include "attention_passes.cuh"

namespace {

constexpr int kMaxFusedSeq = 512;

bool fused_shape_ok(int b, int s, int heads, int d) {
  return b >= 1 && s >= 1 && s <= kMaxFusedSeq && heads >= 1 && d >= 1 && d <= kMaxHeadDim;
}

template <typename T>
cudaError_t fused_fwd(const void* q, const void* k, const void* v, void* out, int b, int s,
                      int heads, int d, int causal, float sm_scale, cudaStream_t stream) {
  return launch_attention_core<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                                  static_cast<const T*>(v), static_cast<T*>(out), b, s,
                                  heads * d, heads, d, sm_scale, causal, stream);
}

template <typename T>
cudaError_t fused_bwd(const void* q, const void* k, const void* v, const void* dout,
                      float* stats, void* dq, void* dk, void* dv, int b, int s, int heads, int d,
                      int causal, float sm_scale, cudaStream_t stream) {
  return launch_attention_bwd_passes<T, true>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), stats, static_cast<T*>(nullptr), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), b, s, heads * d, heads, d, sm_scale, causal,
      stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: [B, S, heads*d], contiguous on one device.
// Launches on `stream` without synchronising. Returns a cudaError_t.
int mmt_fused_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                            int b, int s, int heads, int d, int causal, float sm_scale,
                            void* stream) {
  if (!fused_shape_ok(b, s, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)fused_fwd<float>(q, k, v, out, b, s, heads, d, causal, sm_scale, st);
  if (dtype == 1)
    return (int)fused_fwd<__nv_bfloat16>(q, k, v, out, b, s, heads, d, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// dout: the cotangent of out. stats: float32 scratch [3, B*heads*S]. Outputs dq, dk, dv as q.
int mmt_fused_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, void* stats, void* dq, void* dk, void* dv, int b,
                            int s, int heads, int d, int causal, float sm_scale, void* stream) {
  if (!fused_shape_ok(b, s, heads, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)fused_bwd<float>(q, k, v, dout, sp, dq, dk, dv, b, s, heads, d, causal, sm_scale,
                                 st);
  if (dtype == 1)
    return (int)fused_bwd<__nv_bfloat16>(q, k, v, dout, sp, dq, dk, dv, b, s, heads, d, causal,
                                         sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
