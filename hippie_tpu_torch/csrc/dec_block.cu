// The decoder's BasicBlock in training, forward and backward, for sm_90a.
//
// Replaces hippie_tpu/ops/pallas_blocks.py:_dec_block_prim, the Pallas TPU
// kernels _dec_fwd_body (-> _dec_fwd_math) and _dec_bwd_body
// (-> _dec_bwd_math). With Lo = stride * Lin, forward:
//   c2 = conv3(x, w2)                   st2 = masked (mean, var, inv) of c2,
//                                       counted at the input length: n2 = sum(m) * Lin
//   r  = bf16(lrelu(bn2(c2)))
//   stride 2: c1 = conv3(up2(r), w1) + c1b;  stride 1: c1 = conv3(r, w1)
//                                       st1 counted at the output length: n1 = sum(m) * Lo
//   shortcut: cs = conv3(up2(x), ws) + csb, sts (n1), bn_s(cs); or x itself (sts = 0)
//   out = bf16(lrelu(bn1(c1) + shortcut))
// up2 is the nearest x2 upsample of ResizeConv1d; the conv loader reads it in
// place (row (l + t - 1) >> 1 of the source), so no upsampled copy exists.
// Backward: recomputes c2, c1, cs from x and the saved statistics, then
// BatchNorm's backward (sums over every entry; only the m/n term is masked),
// the weight gradients (dw1 and dws read up2(r) and up2(x) through the same
// loader), the conv biases' gradients as fixed-order column sums of dc1 and
// dcs, and the transposed convolutions at Lo, whose rows 2l and 2l + 1 are
// summed in float32 (the upsample's backward) inside the pass that consumes
// them, before any bf16 rounding. bf16 roundings are at the JAX math's
// points (r, xh2, a2, xh1, xhs, g0, dc1, dcs, da2, dc2, dx).
//
// What bounds it on an H100: operations. The full-width decoder's 8 blocks
// do 29.8 GFLOP forward (conv2 at Lin, conv1 and the shortcut at Lo) and
// about 3x that backward, 30 us and 90 us at 989 TFLOP/s bf16 dense; the
// largest activation is 4 MB in float32, so bytes bound nothing. As in the
// encoder, the sequence of short launches is what the time is made of: 17
// launches per forward and 29 per backward with a shortcut, 13 and 18
// without.
//
// Design: each step is its own launch from block_common.cuh (implicit-GEMM
// convs on tensor-core tiles, fixed-order column sums without float atomics,
// elementwise passes that normalise, activate and round). Repeated runs give
// the same bits. Each entry point is one ctypes call that issues its whole
// sequence on the caller's stream; scratch comes from the caller.

#include "block_common.cuh"

using namespace blocks;

namespace {

// Rows of the column-sum partials for both lengths of the block.
inline size_t col_parts(int Lin, int Lo, int B, int Ci, int Co) {
  return std::max((size_t)col_chunks(Lin * B, Ci) * Ci, (size_t)col_chunks(Lo * B, Co) * Co);
}

struct FwdScratch {
  float *c2, *c1, *cs, *part;
  bf16* r;
};

FwdScratch plan_fwd(Arena& a, int Lin, int B, int Ci, int Co, int stride) {
  const int Lo = Lin * stride;
  FwdScratch s;
  s.c2 = a.take<float>((size_t)Lin * B * Ci);
  s.r = a.take<bf16>((size_t)Lin * B * Ci);
  s.c1 = a.take<float>((size_t)Lo * B * Co);
  s.cs = stride != 1 ? a.take<float>((size_t)Lo * B * Co) : nullptr;
  s.part = a.take<float>(col_parts(Lin, Lo, B, Ci, Co));
  return s;
}

struct BwdScratch {
  float *c2, *c1, *cs, *t, *dxm, *wpart, *bpart, *n;
  bf16 *xh2, *r, *da2, *dc2, *xh1, *g0, *dc1, *xhs, *dcs;
  float2* part;
};

BwdScratch plan_bwd(Arena& a, int Lin, int B, int Ci, int Co, int stride) {
  const int Lo = Lin * stride;
  const bool short_ = stride != 1;
  const size_t tin = (size_t)Lin * B * Ci, tout = (size_t)Lo * B * Co;
  BwdScratch s;
  s.c2 = a.take<float>(tin);
  s.c1 = a.take<float>(tout);
  s.cs = short_ ? a.take<float>(tout) : nullptr;
  s.t = a.take<float>((size_t)Lo * B * Ci);  // the transposed convs at Lo
  s.dxm = a.take<float>(tin);
  s.wpart = a.take<float>(std::max(wgrad_partial_floats(Lo * B, Ci, Co, 3),
                                   wgrad_partial_floats(Lin * B, Ci, Ci, 3)));
  s.bpart = short_ ? a.take<float>((size_t)col_chunks(Lo * B, Co) * Co) : nullptr;
  s.n = a.take<float>(1);
  s.xh2 = a.take<bf16>(tin);
  s.r = a.take<bf16>(tin);
  s.da2 = a.take<bf16>(tin);
  s.dc2 = a.take<bf16>(tin);
  s.xh1 = a.take<bf16>(tout);
  s.g0 = a.take<bf16>(tout);
  s.dc1 = a.take<bf16>(tout);
  s.xhs = short_ ? a.take<bf16>(tout) : nullptr;
  s.dcs = short_ ? a.take<bf16>(tout) : nullptr;
  s.part = a.take<float2>(col_parts(Lin, Lo, B, Ci, Co));
  return s;
}

inline int ew_grid(size_t total) { return (int)((total + kEwThreads - 1) / kEwThreads); }

// conv1 or the shortcut's conv: at stride 2 a ResizeConv1d (upsample, bias).
inline int resize_conv(const bf16* src, const bf16* w, const float* bias, float* out,
                       const ConvGeom& g, int stride, cudaStream_t s) {
  return stride != 1 ? launch_conv<false, true>(src, w, out, g, s, bias)
                     : launch_conv<false>(src, w, out, g, s);
}

}  // namespace

#define RET_IF(call)          \
  do {                        \
    const int e_ = (call);    \
    if (e_ != 0) return e_;   \
  } while (0)

extern "C" {

// Bytes of scratch the forward / backward need for one block.
long long dec_block_fwd_scratch(int Lin, int B, int Ci, int Co, int stride) {
  Arena a{nullptr};
  plan_fwd(a, Lin, B, Ci, Co, stride);
  return (long long)a.used;
}

long long dec_block_bwd_scratch(int Lin, int B, int Ci, int Co, int stride) {
  Arena a{nullptr};
  plan_bwd(a, Lin, B, Ci, Co, stride);
  return (long long)a.used;
}

// x bf16 [Lin, B, Ci]; w2 bf16 [3, Ci, Ci], w1 and ws [3, Ci, Co]; c1b, csb,
// g*, b* float32 [C]; mask float32 [B]. c1b, ws, csb, gs, bs are null at
// stride 1 (no conv bias, identity shortcut, Ci == Co). Writes out bf16
// [Lo, B, Co], st2 float32 [3, Ci] and st1, sts [3, Co] = (mean, var, inv);
// sts = 0 at stride 1.
int dec_block_fwd(const void* x_, const void* w2_, const float* g2, const float* b2,
                  const void* w1_, const float* c1b, const float* g1, const float* b1,
                  const void* ws_, const float* csb, const float* gs, const float* bs,
                  const float* mask, int Lin, int B, int Ci, int Co, int stride, void* out_,
                  float* st2, float* st1, float* sts, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* w2 = static_cast<const bf16*>(w2_);
  const bf16* w1 = static_cast<const bf16*>(w1_);
  const bf16* ws = static_cast<const bf16*>(ws_);
  bf16* out = static_cast<bf16*>(out_);
  const bool short_ = stride != 1;
  const int Lo = Lin * stride;
  const int tin = Lin * B * Ci, tout = Lo * B * Co;
  Arena a{static_cast<char*>(scratch)};
  const FwdScratch S = plan_fwd(a, Lin, B, Ci, Co, stride);
  const ConvGeom c2g{Lin, Lin, B, Ci, Ci, 3, 1, 1};  // conv2: x -> c2
  const ConvGeom c1g{Lin, Lo, B, Ci, Co, 3, 1, 1};   // conv1: r -> c1, shortcut: x -> cs

  RET_IF(launch_conv<false>(x, w2, S.c2, c2g, s));
  RET_IF(launch_col_stats(S.c2, mask, Lin, B, Ci, S.part, st2, s));
  bn_lrelu_kernel<<<ew_grid(tin), kEwThreads, 0, s>>>(S.c2, st2, g2, b2, Ci, tin, S.r);
  BLOCKS_CHECK();
  RET_IF(resize_conv(S.r, w1, c1b, S.c1, c1g, stride, s));
  RET_IF(launch_col_stats(S.c1, mask, Lo, B, Co, S.part, st1, s));
  if (short_) {
    RET_IF(resize_conv(x, ws, csb, S.cs, c1g, stride, s));
    RET_IF(launch_col_stats(S.cs, mask, Lo, B, Co, S.part, sts, s));
  } else {
    cudaMemsetAsync(sts, 0, sizeof(float) * 3 * Co, s);
    BLOCKS_CHECK();
  }
  bn_add_lrelu_kernel<<<ew_grid(tout), kEwThreads, 0, s>>>(S.c1, st1, g1, b1, S.cs, sts, gs, bs,
                                                           x, Co, tout, out);
  BLOCKS_CHECK();
  return 0;
}

// As the forward, plus st2, st1, sts from it and g bf16 [Lo, B, Co], the
// output's cotangent. Writes dx bf16 [Lin, B, Ci] and float32 dw2 [3, Ci, Ci],
// dg2, db2 [Ci], dw1 [3, Ci, Co], dg1, db1 [Co], and at stride 2 dc1b, dws
// [3, Ci, Co], dcsb, dgs, dbs (null at stride 1).
int dec_block_bwd(const void* x_, const void* w2_, const float* g2, const float* b2,
                  const void* w1_, const float* c1b, const float* g1, const float* b1,
                  const void* ws_, const float* csb, const float* gs, const float* bs,
                  const float* mask, const float* st2, const float* st1, const float* sts,
                  const void* g_, int Lin, int B, int Ci, int Co, int stride, void* dx_,
                  float* dw2, float* dg2, float* db2, float* dw1, float* dc1b, float* dg1,
                  float* db1, float* dws, float* dcsb, float* dgs, float* dbs, void* scratch,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* w2 = static_cast<const bf16*>(w2_);
  const bf16* w1 = static_cast<const bf16*>(w1_);
  const bf16* ws = static_cast<const bf16*>(ws_);
  const bf16* g = static_cast<const bf16*>(g_);
  bf16* dx = static_cast<bf16*>(dx_);
  const bool short_ = stride != 1;
  const int Lo = Lin * stride;
  const int tin = Lin * B * Ci, tout = Lo * B * Co;
  Arena a{static_cast<char*>(scratch)};
  const BwdScratch S = plan_bwd(a, Lin, B, Ci, Co, stride);
  const ConvGeom c2g{Lin, Lin, B, Ci, Ci, 3, 1, 1};  // conv2 and its transpose
  const ConvGeom c1g{Lin, Lo, B, Ci, Co, 3, 1, 1};   // conv1 and the shortcut's conv
  const ConvGeom c1t{Lo, Lo, B, Co, Ci, 3, 1, 1};    // their transposes, dc -> [Lo, B, Ci]

  // recompute the forward from x and the saved statistics
  RET_IF(launch_conv<false>(x, w2, S.c2, c2g, s));
  bn_recompute_kernel<<<ew_grid(tin), kEwThreads, 0, s>>>(S.c2, st2, g2, b2, Ci, tin, S.xh2, S.r);
  BLOCKS_CHECK();
  RET_IF(resize_conv(S.r, w1, c1b, S.c1, c1g, stride, s));
  if (short_) RET_IF(resize_conv(x, ws, csb, S.cs, c1g, stride, s));
  out_grad_kernel<<<ew_grid(tout), kEwThreads, 0, s>>>(S.c1, st1, g1, b1, S.cs, sts, gs, bs, x, g,
                                                       Co, tout, S.xh1, S.xhs, S.g0);
  BLOCKS_CHECK();

  // bn1, conv1 and, through the upsample, bn2's input gradient
  RET_IF(launch_col_dsum(S.g0, S.xh1, mask, Lo, B, Co, S.part, dg1, db1, S.n, s));
  RET_IF(launch_bn_dx(S.g0, S.xh1, g1, st1, dg1, db1, mask, S.n, Lo, B, Co, S.dc1, s));
  if (short_) {
    RET_IF(launch_wgrad<true>(S.r, S.dc1, S.wpart, dw1, c1g, s));
    RET_IF(launch_col_sum(S.dc1, Lo * B, Co, S.bpart, dc1b, s));
  } else {
    RET_IF(launch_wgrad(S.r, S.dc1, S.wpart, dw1, c1g, s));
  }
  RET_IF(launch_conv<true>(S.dc1, w1, S.t, c1t, s));
  if (short_) {
    pair_act_grad_kernel<<<ew_grid(tin), kEwThreads, 0, s>>>(S.t, S.xh2, g2, b2, B * Ci, Ci, tin,
                                                             S.da2);
  } else {
    act_grad_kernel<<<ew_grid(tin), kEwThreads, 0, s>>>(S.t, S.xh2, g2, b2, Ci, tin, S.da2);
  }
  BLOCKS_CHECK();

  // bn2 (counted at Lin) and conv2
  RET_IF(launch_col_dsum(S.da2, S.xh2, mask, Lin, B, Ci, S.part, dg2, db2, S.n, s));
  RET_IF(launch_bn_dx(S.da2, S.xh2, g2, st2, dg2, db2, mask, S.n, Lin, B, Ci, S.dc2, s));
  RET_IF(launch_wgrad(x, S.dc2, S.wpart, dw2, c2g, s));
  RET_IF(launch_conv<true>(S.dc2, w2, S.dxm, c2g, s));

  // the shortcut: its BatchNorm (counted at Lo) and conv, through the upsample
  if (short_) {
    RET_IF(launch_col_dsum(S.g0, S.xhs, mask, Lo, B, Co, S.part, dgs, dbs, S.n, s));
    RET_IF(launch_bn_dx(S.g0, S.xhs, gs, sts, dgs, dbs, mask, S.n, Lo, B, Co, S.dcs, s));
    RET_IF(launch_wgrad<true>(x, S.dcs, S.wpart, dws, c1g, s));
    RET_IF(launch_col_sum(S.dcs, Lo * B, Co, S.bpart, dcsb, s));
    RET_IF(launch_conv<true>(S.dcs, ws, S.t, c1t, s));
    add_pair_round_kernel<<<ew_grid(tin), kEwThreads, 0, s>>>(S.dxm, S.t, B * Ci, tin, dx);
  } else {
    add_round_kernel<<<ew_grid(tin), kEwThreads, 0, s>>>(S.dxm, nullptr, S.g0, tin, dx);
  }
  BLOCKS_CHECK();
  return 0;
}

}  // extern "C"
