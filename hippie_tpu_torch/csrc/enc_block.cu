// The encoder's BasicBlock in training, forward and backward, for sm_90a.
//
// Replaces hippie_tpu/ops/pallas_blocks.py:_enc_block_prim, the Pallas TPU
// kernels _enc_fwd_body (-> _enc_fwd_math) and _enc_bwd_body
// (-> _enc_bwd_math). Forward:
//   c1 = conv3(x, w1, stride)           st1 = masked (mean, var, inv) of c1
//   r1 = bf16(lrelu(bn1(c1)))           c2 = conv3(r1, w2, 1), st2
//   shortcut: cs = conv1x1_s2(x, ws), sts, bn_s(cs); or x itself (sts = 0)
//   out = bf16(lrelu(bn2(c2) + shortcut))
// Backward: recomputes c1, c2, cs from x and the saved statistics, then
// BatchNorm's backward (sums over every entry; only the m/n term is masked),
// the weight gradients and the transposed convolutions, with bf16 roundings
// at the JAX math's points (xh1, a1, r1, xh2, xhs, g0, dc2, da1, dc1, dcs, dx).
//
// What bounds it on an H100: operations. The full-width encoder's 8 blocks
// do 20.6 GFLOP forward and about 62 GFLOP backward (recompute, input and
// weight gradients), 21 us and 63 us at 989 TFLOP/s bf16 dense; no
// activation is over 1.6 MB, so bytes bound nothing. At these sizes the
// kernels are short, and the sequence of launches is what the time is made
// of: 17 launches per forward and 25 per backward with a shortcut, 12 and 18
// without.
//
// Design: the TPU kernel held the whole block in VMEM as one program (and
// its backward did not fit at B=512). A Hopper block cannot hold the batch,
// so each step is its own launch from block_common.cuh: implicit-GEMM convs
// with tensor-core tiles, BatchNorm statistics as fixed-order per-channel
// partial sums and a final pass (no float atomics: repeated runs give the
// same bits), elementwise passes that normalise, activate and round, and
// split-K weight gradients summed in a fixed order. Intermediates round-trip
// through device memory (all of them fit in L2). Each entry point is one
// ctypes call that issues its whole sequence on the caller's stream; scratch
// comes from the caller.

#include "block_common.cuh"

using namespace blocks;

namespace {

inline int out_len(int L, int stride) { return stride == 1 ? L : (L - 1) / 2 + 1; }

struct FwdScratch {
  float* c1;
  bf16* r1;
  float* c2;
  float* cs;
  float* part;
};

FwdScratch plan_fwd(Arena& a, int L, int B, int Co, int stride, int has_short) {
  const int Lo = out_len(L, stride);
  const size_t tot = (size_t)Lo * B * Co;
  FwdScratch s;
  s.c1 = a.take<float>(tot);
  s.r1 = a.take<bf16>(tot);
  s.c2 = a.take<float>(tot);
  s.cs = has_short ? a.take<float>(tot) : nullptr;
  s.part = a.take<float>((size_t)col_chunks(Lo * B, Co) * Co);
  return s;
}

struct BwdScratch {
  float *c1, *c2, *cs, *t, *dxm, *dxs, *wpart, *n;
  bf16 *xh1, *r1, *xh2, *xhs, *g0, *dc2, *dcs, *da1, *dc1;
  float2* part;
};

BwdScratch plan_bwd(Arena& a, int L, int B, int Ci, int Co, int stride, int has_short) {
  const int Lo = out_len(L, stride);
  const int M = Lo * B;
  const size_t tot = (size_t)M * Co;
  const size_t tot_in = (size_t)L * B * Ci;
  BwdScratch s;
  s.c1 = a.take<float>(tot);
  s.c2 = a.take<float>(tot);
  s.cs = has_short ? a.take<float>(tot) : nullptr;
  s.t = a.take<float>(tot);
  s.dxm = a.take<float>(tot_in);
  s.dxs = has_short ? a.take<float>(tot_in) : nullptr;
  size_t wp = std::max(wgrad_partial_floats(M, Co, Co, 3), wgrad_partial_floats(M, Ci, Co, 3));
  if (has_short) wp = std::max(wp, wgrad_partial_floats(M, Ci, Co, 1));
  s.wpart = a.take<float>(wp);
  s.n = a.take<float>(1);
  s.xh1 = a.take<bf16>(tot);
  s.r1 = a.take<bf16>(tot);
  s.xh2 = a.take<bf16>(tot);
  s.xhs = has_short ? a.take<bf16>(tot) : nullptr;
  s.g0 = a.take<bf16>(tot);
  s.dc2 = a.take<bf16>(tot);
  s.dcs = has_short ? a.take<bf16>(tot) : nullptr;
  s.da1 = a.take<bf16>(tot);
  s.dc1 = a.take<bf16>(tot);
  s.part = a.take<float2>((size_t)col_chunks(M, Co) * Co);
  return s;
}

inline int ew_grid(size_t total) { return (int)((total + kEwThreads - 1) / kEwThreads); }

}  // namespace

#define RET_IF(call)          \
  do {                        \
    const int e_ = (call);    \
    if (e_ != 0) return e_;   \
  } while (0)

extern "C" {

// Bytes of scratch the forward / backward need for one block.
long long enc_block_fwd_scratch(int L, int B, int Ci, int Co, int stride, int has_short) {
  (void)Ci;
  Arena a{nullptr};
  plan_fwd(a, L, B, Co, stride, has_short);
  return (long long)a.used;
}

long long enc_block_bwd_scratch(int L, int B, int Ci, int Co, int stride, int has_short) {
  Arena a{nullptr};
  plan_bwd(a, L, B, Ci, Co, stride, has_short);
  return (long long)a.used;
}

// x bf16 [L, B, Ci]; w1 bf16 [3, Ci, Co], w2 [3, Co, Co], ws [1, Ci, Co];
// g*, b* float32 [Co]; mask float32 [B]. ws, gs, bs are null without a
// shortcut (stride 1). Writes out bf16 [Lo, B, Co] and st1, st2, sts float32
// [3, Co] = (mean, var, inv); sts = 0 without a shortcut.
int enc_block_fwd(const void* x_, const void* w1_, const float* g1, const float* b1,
                  const void* w2_, const float* g2, const float* b2, const void* ws_,
                  const float* gs, const float* bs, const float* mask, int L, int B, int Ci,
                  int Co, int stride, int has_short, void* out_, float* st1, float* st2,
                  float* sts, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* w1 = static_cast<const bf16*>(w1_);
  const bf16* w2 = static_cast<const bf16*>(w2_);
  const bf16* ws = static_cast<const bf16*>(ws_);
  bf16* out = static_cast<bf16*>(out_);
  const int Lo = out_len(L, stride);
  const size_t tot = (size_t)Lo * B * Co;
  Arena a{static_cast<char*>(scratch)};
  const FwdScratch S = plan_fwd(a, L, B, Co, stride, has_short);

  RET_IF(launch_conv<false>(x, w1, S.c1, ConvGeom{L, Lo, B, Ci, Co, 3, stride, 1}, s));
  RET_IF(launch_col_stats(S.c1, mask, Lo, B, Co, S.part, st1, s));
  bn_lrelu_kernel<<<ew_grid(tot), kEwThreads, 0, s>>>(S.c1, st1, g1, b1, Co, (int)tot, S.r1);
  BLOCKS_CHECK();
  RET_IF(launch_conv<false>(S.r1, w2, S.c2, ConvGeom{Lo, Lo, B, Co, Co, 3, 1, 1}, s));
  RET_IF(launch_col_stats(S.c2, mask, Lo, B, Co, S.part, st2, s));
  if (has_short) {
    RET_IF(launch_conv<false>(x, ws, S.cs, ConvGeom{L, Lo, B, Ci, Co, 1, 2, 0}, s));
    RET_IF(launch_col_stats(S.cs, mask, Lo, B, Co, S.part, sts, s));
  } else {
    cudaMemsetAsync(sts, 0, sizeof(float) * 3 * Co, s);
    BLOCKS_CHECK();
  }
  bn_add_lrelu_kernel<<<ew_grid(tot), kEwThreads, 0, s>>>(S.c2, st2, g2, b2, S.cs, sts, gs, bs, x,
                                                          Co, (int)tot, out);
  BLOCKS_CHECK();
  return 0;
}

// As the forward, plus st1, st2, sts from it and g bf16 [Lo, B, Co], the
// output's cotangent. Writes dx bf16 [L, B, Ci] and float32 dw1 [3, Ci, Co],
// dg1, db1, dw2 [3, Co, Co], dg2, db2, and with a shortcut dws [1, Ci, Co],
// dgs, dbs (null without one).
int enc_block_bwd(const void* x_, const void* w1_, const float* g1, const float* b1,
                  const void* w2_, const float* g2, const float* b2, const void* ws_,
                  const float* gs, const float* bs, const float* mask, const float* st1,
                  const float* st2, const float* sts, const void* g_, int L, int B, int Ci,
                  int Co, int stride, int has_short, void* dx_, float* dw1, float* dg1,
                  float* db1, float* dw2, float* dg2, float* db2, float* dws, float* dgs,
                  float* dbs, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* w1 = static_cast<const bf16*>(w1_);
  const bf16* w2 = static_cast<const bf16*>(w2_);
  const bf16* ws = static_cast<const bf16*>(ws_);
  const bf16* g = static_cast<const bf16*>(g_);
  bf16* dx = static_cast<bf16*>(dx_);
  const int Lo = out_len(L, stride);
  const int tot = Lo * B * Co;
  const int tot_in = L * B * Ci;
  Arena a{static_cast<char*>(scratch)};
  const BwdScratch S = plan_bwd(a, L, B, Ci, Co, stride, has_short);
  const ConvGeom c1g{L, Lo, B, Ci, Co, 3, stride, 1};    // conv1: x -> c1
  const ConvGeom c2g{Lo, Lo, B, Co, Co, 3, 1, 1};        // conv2: r1 -> c2
  const ConvGeom csg{L, Lo, B, Ci, Co, 1, 2, 0};         // shortcut: x -> cs
  const ConvGeom c2t{Lo, Lo, B, Co, Co, 3, 1, 1};        // conv2^T: dc2 -> da1
  const ConvGeom c1t{Lo, L, B, Co, Ci, 3, stride, 1};    // conv1^T: dc1 -> dx
  const ConvGeom cst{Lo, L, B, Co, Ci, 1, 2, 0};         // shortcut^T: dcs -> dx

  // recompute the forward from x and the saved statistics
  RET_IF(launch_conv<false>(x, w1, S.c1, c1g, s));
  bn_recompute_kernel<<<ew_grid(tot), kEwThreads, 0, s>>>(S.c1, st1, g1, b1, Co, tot, S.xh1, S.r1);
  BLOCKS_CHECK();
  RET_IF(launch_conv<false>(S.r1, w2, S.c2, c2g, s));
  if (has_short) RET_IF(launch_conv<false>(x, ws, S.cs, csg, s));
  out_grad_kernel<<<ew_grid(tot), kEwThreads, 0, s>>>(S.c2, st2, g2, b2, S.cs, sts, gs, bs, x, g,
                                                      Co, tot, S.xh2, S.xhs, S.g0);
  BLOCKS_CHECK();

  // bn2 and the shortcut's BatchNorm
  RET_IF(launch_col_dsum(S.g0, S.xh2, mask, Lo, B, Co, S.part, dg2, db2, S.n, s));
  RET_IF(launch_bn_dx(S.g0, S.xh2, g2, st2, dg2, db2, mask, S.n, Lo, B, Co, S.dc2, s));
  if (has_short) {
    RET_IF(launch_col_dsum(S.g0, S.xhs, mask, Lo, B, Co, S.part, dgs, dbs, S.n, s));
    RET_IF(launch_bn_dx(S.g0, S.xhs, gs, sts, dgs, dbs, mask, S.n, Lo, B, Co, S.dcs, s));
  }

  // conv2, then bn1 through the recomputed activation
  RET_IF(launch_wgrad(S.r1, S.dc2, S.wpart, dw2, c2g, s));
  RET_IF(launch_conv<true>(S.dc2, w2, S.t, c2t, s));
  act_grad_kernel<<<ew_grid(tot), kEwThreads, 0, s>>>(S.t, S.xh1, g1, b1, Co, tot, S.da1);
  BLOCKS_CHECK();
  RET_IF(launch_col_dsum(S.da1, S.xh1, mask, Lo, B, Co, S.part, dg1, db1, S.n, s));
  RET_IF(launch_bn_dx(S.da1, S.xh1, g1, st1, dg1, db1, mask, S.n, Lo, B, Co, S.dc1, s));

  // conv1 and the shortcut's conv
  RET_IF(launch_wgrad(x, S.dc1, S.wpart, dw1, c1g, s));
  RET_IF(launch_conv<true>(S.dc1, w1, S.dxm, c1t, s));
  if (has_short) {
    RET_IF(launch_wgrad(x, S.dcs, S.wpart, dws, csg, s));
    RET_IF(launch_conv<true>(S.dcs, ws, S.dxs, cst, s));
  }
  add_round_kernel<<<ew_grid(tot_in), kEwThreads, 0, s>>>(S.dxm, S.dxs, has_short ? nullptr : S.g0,
                                                          tot_in, dx);
  BLOCKS_CHECK();
  return 0;
}

}  // extern "C"
