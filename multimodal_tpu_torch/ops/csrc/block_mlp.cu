// The MLP half of a pre-LN residual block, y = x + act(LN(x) @ W1 + b1) @ W2 + b2, forward
// and backward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels multimodal_tpu/ops/block_mlp.py:_fwd_kernel and
// _bwd_kernel. For x and dy [T,W] (T = B*S tokens, ragged), W1 [W,H], W2 [H,W] in the JAX
// [in,out] layout, gamma and beta [W], and act one of quick_gelu and tanh-gelu, the forward
// computes
//
//   ln = LN(x)                      f32 statistics, compute-dtype arithmetic rounding after
//                                   every operation; never written to device memory
//   h  = ln @ W1 + b1               f32 accumulation, bias added in f32, rounded to T; written
//                                   (the backward reads it instead of repeating the product)
//   g  = act(f32(h))                evaluated in f32 from the rounded h, rounded to T; written
//                                   to a [T,H] scratch that c_proj reads, freed after it
//   y  = g @ W2 + b2 [+ x]          one f32 sum, rounded to T once
//
// and the backward, from x, dy and the saved h,
//
//   dg   = dy @ W2^T                f32
//   dh32 = dg * act'(f32(h))        f32;  db1 = colsum(dh32), the unrounded values
//   dh   = round_T(dh32)            written to a [T,H] scratch for the two products below
//   dln  = dh @ W1^T                f32 [T,W] scratch
//   dW2  = g^T @ dy                 g recomputed from h as the forward formed it
//   dW1  = ln_b^T @ dh              ln_b = round_T((x32 - mean) * inv) * gamma_T + beta_T: the
//                                   backward's form of LN(x), which in bf16 is not bit for bit
//                                   the forward's (x - mean_T) * inv_T * gamma_T + beta_T
//   db2  = colsum(dy32); dgamma = colsum(dln * xhat32); dbeta = colsum(dln)
//   dx   = inv * (dln gamma32 - mean(dln gamma32) - xhat32 mean(dln gamma32 xhat32)) [+ dy32]
//                                   all in f32 with the f32 gamma, rounded once
//
// What bounds it on the card: the two (forward) and four (backward) [T,W]x[W,H]-sized
// products are all of the FLOPs, so both kernels are bound by operations. What the design
// does. The TPU kernel is one program per tile of tokens that holds both weight matrices and
// an f32 [M,H] hidden tile in VMEM and carries the f32 weight-gradient sums across a
// sequential grid; an SM has 227 KB and blocks run in parallel, so here every product is a
// tiled GEMM of its own and the elementwise work rides the GEMMs' loads and stores. Every
// product runs the tensor-core GEMM of mma_gemm.cuh (bf16 mma.sync in bfloat16, 3xTF32 in
// float32), each with its own load transform and store:
//   forward, 3 launches: row statistics; c_fc, the NN form with the LN load transform and the
//     round+act store, which writes h and beside it g = round_T(act(f32(h))) by the act_round
//     that dW2's load runs too, so the backward's g is the forward's bit for bit; c_proj, the
//     NN form on g with the bias-residual store, round_T((acc + b2) + x) with one rounding
//     (the round store, round_T(acc + b2), without the residual). g costs 2 T H elements of
//     traffic; as c_proj's load transform instead, act ran once for each of the W / 128 column
//     blocks that read a tile, and c_proj ran 79-106 TFLOP/s in bfloat16 on the H100 against
//     229-278 on g (PERF.md).
//   backward, 6 launches: row statistics; dy @ W2^T, the NT form with the act' store, which
//     writes dh and one partial db1 row per 128-token tile; dh @ W1^T, the NT form into f32;
//     the LN vjp row kernel (dx and partial dgamma, dbeta, db2 rows per 32 tokens); dW2 and
//     dW1, the TN form over K = T with the act and LN-b load transforms (g from h, ln_b from
//     x), split over the token rows into f32 partial sums (the output tiles alone, 144 at
//     W=768 and H=3072, do not fill 132 SMs evenly), summed in order and cast outside.
// Writing dh [T,H] to device memory is what the TPU kernel avoids; on this card that
// traffic (2 T H elements) is small beside the products. Rows past a ragged T are masked in
// every load, every transform and every column sum. The column sums go to partial rows in a
// fixed order and are summed outside: no float atomics, so a result never differs from run to
// run. float32 products run 3xTF32, about 2^-20 relative a product. Fewer launches are later
// work.

#include "mma_gemm.cuh"

namespace {

// ----------------------------------------------------------------------------- launches
template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, const void* w1,
                       const void* b1, const void* w2, const void* b2, float* ln_stats, void* g,
                       void* h, void* y, int t, int w, int hid, int act, int residual, float eps,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  cudaError_t err = launch_ln_stats<T>(xp, ln_stats, ln_stats + t, t, w, eps, stream);
  if (err != cudaSuccess) return err;

  // h = round_T(LN(x) @ W1 + b1), g = round_T(act(f32(h)))
  MmaGemmArgs fc = {};
  fc.a[0] = x;
  fc.b[0] = w1;
  fc.bias[0] = b1;
  fc.c[0] = h;
  fc.m = t, fc.n = hid, fc.kseg = w, fc.nseg = 1;
  fc.ln_mean = ln_stats;
  fc.ln_inv = ln_stats + t;
  fc.ln_gamma = gamma;
  fc.ln_beta = beta;
  fc.act = act;
  fc.g_out = g;
  err = launch_mma_gemm<T, T, kFormNN, kLoadLn, kStoreRoundAct>(fc, 1, stream);
  if (err != cudaSuccess) return err;

  // y = round_T(g @ W2 + b2 [+ x]), one rounding
  MmaGemmArgs proj = {};
  proj.a[0] = g;
  proj.b[0] = w2;
  proj.bias[0] = b2;
  proj.c[0] = y;
  proj.m = t, proj.n = w, proj.kseg = hid, proj.nseg = 1;
  if (!residual) return launch_mma_gemm<T, T, kFormNN>(proj, 1, stream);
  proj.residual = x;
  return launch_mma_gemm<T, T, kFormNN, kLoadPlain, kStoreBiasResidual>(proj, 1, stream);
}

struct MlpBwdBuffers {
  float* ln_stats;  // scratch [2, T] f32: mean, inv
  void* dh;         // scratch [T, H] T
  float* dln;       // scratch [T, W] f32
  void* dx;         // output [T, W] of T
  float *dw1_part, *dw2_part;  // outputs [splits, W, H] and [splits, H, W] f32
  float* db1_part;  // output [ceil(T / 128), H] f32
  float* col_part;  // output [3, ceil(T / kLnBwdRows), W] f32: dgamma, dbeta, db2
};

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* h, const void* gamma,
                       const void* beta, const float* gamma32, const void* w1, const void* w2,
                       const MlpBwdBuffers& buf, int t, int w, int hid, int act, int residual,
                       int splits, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  float* mean = buf.ln_stats;
  float* inv = buf.ln_stats + t;
  cudaError_t err = launch_ln_stats<T>(xp, mean, inv, t, w, eps, stream);
  if (err != cudaSuccess) return err;

  // dh = round_T((dy @ W2^T) * act'(h)), db1 partials
  MmaGemmArgs dh = {};
  dh.a[0] = dy;
  dh.b[0] = w2;
  dh.c[0] = buf.dh;
  dh.m = t, dh.n = hid, dh.kseg = w, dh.nseg = 1;
  dh.act = act;
  dh.h = h;
  dh.col_part = buf.db1_part;
  err = launch_mma_gemm<T, T, kFormNT, kLoadPlain, kStoreActGrad>(dh, 1, stream);
  if (err != cudaSuccess) return err;

  // dln = dh @ W1^T, f32
  MmaGemmArgs dln = {};
  dln.a[0] = buf.dh;
  dln.b[0] = w1;
  dln.c[0] = buf.dln;
  dln.m = t, dln.n = w, dln.kseg = hid, dln.nseg = 1;
  err = launch_mma_gemm<T, float, kFormNT>(dln, 1, stream);
  if (err != cudaSuccess) return err;

  // dx, and the dgamma, dbeta and db2 partials
  const int part_rows = (t + kLnBwdRows - 1) / kLnBwdRows;
  const size_t plane = (size_t)part_rows * w;
  ln_bwd_kernel<T, float><<<part_rows, kLnThreads, 0, stream>>>(
      xp, static_cast<const T*>(dy), buf.dln, mean, inv, gamma32, static_cast<T*>(buf.dx),
      buf.col_part, buf.col_part + plane, buf.col_part + 2 * plane, residual, t, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dW2 = g^T dy and dW1 = ln_b^T dh over K = T, `splits` partial sums each
  const int k_per_split = ((t + splits - 1) / splits + kGemmBK - 1) / kGemmBK * kGemmBK;
  MmaGemmArgs dw2 = {};
  dw2.a[0] = h;
  dw2.b[0] = dy;
  dw2.c[0] = buf.dw2_part;
  dw2.m = hid, dw2.n = w, dw2.kseg = t, dw2.k_per_split = k_per_split;
  dw2.act = act;
  err = launch_mma_gemm<T, float, kFormTN, kLoadAct>(dw2, splits, stream);
  if (err != cudaSuccess) return err;
  MmaGemmArgs dw1 = {};
  dw1.a[0] = x;
  dw1.b[0] = buf.dh;
  dw1.c[0] = buf.dw1_part;
  dw1.m = w, dw1.n = hid, dw1.kseg = t, dw1.k_per_split = k_per_split;
  dw1.ln_mean = mean;
  dw1.ln_inv = inv;
  dw1.ln_gamma = gamma;
  dw1.ln_beta = beta;
  return launch_mma_gemm<T, float, kFormTN, kLoadLnB>(dw1, splits, stream);
}

bool mlp_shape_ok(int t, int w, int hid, int act) {
  return t >= 1 && w >= 128 && hid >= 128 && w % 128 == 0 && hid % 128 == 0 &&
         (act == kActQuickGelu || act == kActGelu);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; act: 0 = quick_gelu, 1 = tanh-gelu. x [T,W]; gamma, beta
// [W] of the compute dtype; w1 [W,H], b1 [H], w2 [H,W], b2 [W]. Scratch: ln_stats [2,T]
// float32 and g [T,H] of the compute dtype (the activation). Outputs: h [T,H] (the
// pre-activation) and y [T,W], y including x when residual != 0. All contiguous on one device;
// launches on `stream` without synchronising. Returns a cudaError_t.
int mmt_block_mlp_fwd(int dtype, const void* x, const void* gamma, const void* beta,
                      const void* w1, const void* b1, const void* w2, const void* b2,
                      void* ln_stats, void* g, void* h, void* y, int t, int w, int hid, int act,
                      int residual, float eps, void* stream) {
  if (!mlp_shape_ok(t, w, hid, act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(ln_stats);
  if (dtype == 0)
    return (int)launch_fwd<float>(x, gamma, beta, w1, b1, w2, b2, stats, g, h, y, t, w, hid,
                                  act, residual, eps, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(x, gamma, beta, w1, b1, w2, b2, stats, g, h, y, t,
                                          w, hid, act, residual, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: x, dy [T,W] and the saved h [T,H]; gamma, beta [W] of the compute dtype and
// gamma32 [W] float32. Scratch: ln_stats [2,T] and dln [T,W] float32, dh [T,H] of the
// compute dtype. Outputs: dx [T,W] of the compute dtype, and float32 partial sums to be
// summed over their first dimension: dw1_part [splits,W,H] and dw2_part [splits,H,W] (one
// per split of the token rows, 1 <= splits <= 65535; a split past the last row holds zeros), db1_part
// [mmt_block_mlp_db1_partial_rows(T), H] and col_part [3, mmt_ln_bwd_partial_rows(T), W]
// (dgamma, dbeta, db2).
int mmt_block_mlp_bwd(int dtype, const void* x, const void* dy, const void* h,
                      const void* gamma, const void* beta, const void* gamma32, const void* w1,
                      const void* w2, void* ln_stats, void* dh, void* dln, void* dx,
                      void* dw1_part, void* dw2_part, void* db1_part, void* col_part, int t,
                      int w, int hid, int act, int residual, int splits, float eps,
                      void* stream) {
  if (!mlp_shape_ok(t, w, hid, act) || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpBwdBuffers buf = {};
  buf.ln_stats = static_cast<float*>(ln_stats);
  buf.dh = dh;
  buf.dln = static_cast<float*>(dln);
  buf.dx = dx;
  buf.dw1_part = static_cast<float*>(dw1_part);
  buf.dw2_part = static_cast<float*>(dw2_part);
  buf.db1_part = static_cast<float*>(db1_part);
  buf.col_part = static_cast<float*>(col_part);
  const float* g32 = static_cast<const float*>(gamma32);
  if (dtype == 0)
    return (int)launch_bwd<float>(x, dy, h, gamma, beta, g32, w1, w2, buf, t, w, hid, act,
                                  residual, splits, eps, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(x, dy, h, gamma, beta, g32, w1, w2, buf, t, w, hid,
                                          act, residual, splits, eps, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of the db1 partial-sum output for t token rows.
int mmt_block_mlp_db1_partial_rows(int t) { return (t + kGemmBM - 1) / kGemmBM; }

}  // extern "C"
