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
// kernels are short, and the number of launches and passes over device
// memory is what the time is made of.
//
// Forward design (sm90_gemm.cuh): 5 launches with a shortcut or without,
//   0 the tickets of the cross-block sums to zero (a memset)
//   1 conv1 as a wgmma GEMM; its epilogue writes c1 (fp32) and each tile's
//     masked moments per channel (count, sum, and the squares about the
//     tile's own mean); the blocks that finish last merge the tiles' moments
//     in a fixed order (Chan's formula) into st1 = (mean, var, inv)
//   2 r1 = bf16(lrelu(bn1(c1))), elementwise (8 entries per thread)
//   3 conv2 and the shortcut's conv into a second accumulator of the same
//     tile; the epilogue writes c2, cs and their moments, merged into st2 and
//     sts as in 1
//   4 out = bf16(lrelu(bn2(c2) + shortcut)), elementwise
// A tile whose rows are all padding has count 0 and merges as nothing, so
// the padded rows reach no statistic. The variance is the merged sum of
// squares about each tile's mean, the plain version's two passes per tile.
//
// Backward design (sm90_gemm.cuh): 7 launches with a shortcut or without,
// each GEMM a wgmma tile fed by a 4-stage cp.async ring, and each
// elementwise step done in the epilogue of the GEMM that produces its input:
//   1 conv1 recompute; epilogue xh1, r1 (bf16 from the accumulator)
//   2 conv2 recompute and the shortcut's conv into a second accumulator of
//     the same tile; epilogue xh2, xhs, g0 and per-(m-tile, channel) sums of
//     g0*xh2, g0, g0*xhs taken from the rounded values; the blocks that
//     finish last sum those in a fixed order into dg2, db2, dgs, dbs
//   3 dc2, dcs (BatchNorm's backward, elementwise)
//   4 the transposed conv2 (epilogue da1 and the sums of da1*xh1, da1 into
//     dg1, db1 as in 2), with the split-K tiles of dw2 and dws in the same grid
//   5 dc1
//   6 dx = the transposed conv1 (+ the shortcut's) into one accumulator,
//     plus g0 without a shortcut, rounded once; with dw1's split-K tiles
//   7 the fixed-order sums of the weight gradients' split-K partials
// The cross-block sums and merges take integer tickets (the last block of a
// group reduces the group's partials in index order); there are no float
// atomics, so repeated runs give the same bits. Each entry point is one
// ctypes call that issues its whole sequence on the caller's stream; scratch
// comes from the caller.

#include "block_common.cuh"
#include "sm90_gemm.cuh"

using namespace blocks;
using sm90::BnDx;
using sm90::bn_dx8_kernel;
using sm90::ConvLoader;
using sm90::ConvOut;
using sm90::ConvSeg;
using sm90::ep_col;
using sm90::ep_row0;
using sm90::fwd_act8_kernel;
using sm90::gemm_launch;
using sm90::kLdS;
using sm90::make_seg;
using sm90::MomentGrid;
using sm90::Split;
using sm90::wgrad_job;
using sm90::wgrad_split;
using sm90::WgradSum;

namespace {

inline int out_len(int L, int stride) { return stride == 1 ? L : (L - 1) / 2 + 1; }

struct Plan {
  int L, B, Ci, Co, Lo, M;
  int mtiles, ntiles, groups;  // tiles of the [M, Co] GEMMs; groups of m-tiles
  int xtiles;                  // m-tiles of dx [L*B, Ci]
  Split s1, s2, ss;            // dw1, dw2, dws
  ConvGeom c1g, c2g, csg, c2t, c1t, cst;
};

Plan plan(int L, int B, int Ci, int Co, int stride) {
  Plan p;
  p.L = L, p.B = B, p.Ci = Ci, p.Co = Co;
  p.Lo = out_len(L, stride);
  p.M = p.Lo * B;
  p.mtiles = cdiv(p.M, sm90::kBM);
  p.ntiles = Co / sm90::kBN;
  p.groups = cdiv(p.mtiles, sm90::kGroup);
  p.xtiles = cdiv(L * B, sm90::kBM);
  p.s1 = wgrad_split(p.M, Ci, Co, 3);
  p.s2 = wgrad_split(p.M, Co, Co, 3);
  p.ss = wgrad_split(p.M, Ci, Co, 1);
  p.c1g = ConvGeom{L, p.Lo, B, Ci, Co, 3, stride, 1};      // conv1: x -> c1
  p.c2g = ConvGeom{p.Lo, p.Lo, B, Co, Co, 3, 1, 1};        // conv2: r1 -> c2
  p.csg = ConvGeom{L, p.Lo, B, Ci, Co, 1, 2, 0};           // shortcut: x -> cs
  p.c2t = ConvGeom{p.Lo, p.Lo, B, Co, Co, 3, 1, 1};        // conv2^T: dc2 -> da1
  p.c1t = ConvGeom{p.Lo, L, B, Co, Ci, 3, stride, 1};      // conv1^T: dc1 -> dx
  p.cst = ConvGeom{p.Lo, L, B, Co, Ci, 1, 2, 0};           // shortcut^T: dcs -> dx
  return p;
}

// --- forward ---------------------------------------------------------------------

struct FwdScratch {
  float *c1, *c2, *cs, *part, *gpart;
  bf16* r1;
  unsigned* tk;
};

FwdScratch plan_fwd(Arena& a, const Plan& p, int has_short) {
  const size_t tot = (size_t)p.M * p.Co;
  FwdScratch s;
  s.c1 = a.take<float>(tot);
  s.r1 = a.take<bf16>(tot);
  s.c2 = a.take<float>(tot);
  s.cs = has_short ? a.take<float>(tot) : nullptr;
  s.part = a.take<float>((size_t)p.mtiles * 6 * p.Co);
  s.gpart = a.take<float>((size_t)p.groups * 6 * p.Co);
  s.tk = a.take<unsigned>((size_t)(p.groups + 1) * p.ntiles);
  return s;
}

struct FwdArgs {
  const bf16 *x, *w1, *w2, *ws;
  const float* mask;
  float *st1, *st2, *sts;
  FwdScratch S;
  Plan P;
};

// 1 and 3: conv1, or conv2 (+ the shortcut's conv into acc1); the epilogue
// writes the fp32 outputs and each tile's moments, and the finishing blocks
// merge those into st1, or st2 (and sts).
template <bool SECOND, bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) fwd_conv_kernel(FwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvSeg s0 = SECOND ? make_seg<false>(A.S.r1, A.w2, P.c2g, m0) : make_seg<false>(A.x, A.w1, P.c1g, m0);
  const ConvSeg s1 = SHORT ? make_seg<false>(A.x, A.ws, P.csg, m0) : ConvSeg{};
  const ConvLoader<false> ld(s0, s1, m0, n0);
  float acc0[32], acc1[32];
  sm90::mainloop<0, 1, SHORT>(ld, ld.steps(), s0.nsteps, ring, acc0, acc1);
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc0, st);
  if (SHORT) sm90::stage_acc(acc1, st + sm90::kBM * kLdS);
  const ConvOut out[2] = {{SECOND ? A.S.c2 : A.S.c1, nullptr, SECOND ? A.st2 : A.st1}, {A.S.cs, nullptr, A.sts}};
  const MomentGrid grid{A.mask, P.B, P.M, P.Co, P.mtiles, P.ntiles, A.S.part, A.S.gpart, A.S.tk};
  if (sm90::conv_stats_epilogue<SHORT ? 2 : 1>(st, out, grid, mt, nt) && SECOND && !SHORT) {
    const int n = n0 + ep_col();
    A.sts[n] = A.sts[P.Co + n] = A.sts[2 * P.Co + n] = 0.f;
  }
}

// --- backward --------------------------------------------------------------------

struct BwdScratch {
  bf16 *xh1, *r1, *xh2, *xhs, *g0, *dc2, *dcs, *da1, *dc1;
  float *part, *gpart, *n, *wp1, *wp2, *wps;
  unsigned* tk;
};

BwdScratch plan_bwd(Arena& a, const Plan& p, int has_short) {
  const size_t tot = (size_t)p.M * p.Co;
  const size_t w1 = (size_t)3 * p.Ci * p.Co, w2 = (size_t)3 * p.Co * p.Co, ws = (size_t)p.Ci * p.Co;
  BwdScratch s;
  s.xh1 = a.take<bf16>(tot);
  s.r1 = a.take<bf16>(tot);
  s.xh2 = a.take<bf16>(tot);
  s.xhs = has_short ? a.take<bf16>(tot) : nullptr;
  s.g0 = a.take<bf16>(tot);
  s.dc2 = a.take<bf16>(tot);
  s.dcs = has_short ? a.take<bf16>(tot) : nullptr;
  s.da1 = a.take<bf16>(tot);
  s.dc1 = a.take<bf16>(tot);
  s.part = a.take<float>((size_t)p.mtiles * 3 * p.Co);
  s.gpart = a.take<float>((size_t)p.groups * 3 * p.Co);
  s.n = a.take<float>(1);
  s.wp1 = a.take<float>(p.s1.splits * w1);
  s.wp2 = a.take<float>(p.s2.splits * w2);
  s.wps = has_short ? a.take<float>(p.ss.splits * ws) : nullptr;
  s.tk = a.take<unsigned>((size_t)(p.groups + 1) * p.ntiles);
  return s;
}

struct BwdArgs {
  const bf16 *x, *w1, *w2, *ws, *g;
  const float *g1, *b1, *g2, *b2, *gs, *bs, *mask, *st1, *st2, *sts;
  bf16* dx;
  float *dw1, *dg1, *db1, *dw2, *dg2, *db2, *dws, *dgs, *dbs;
  BwdScratch S;
  Plan P;
};

// 1: conv1 recompute -> xh1, r1. Block (0, 0) also writes the count
// n = sum(mask) * Lo and zeroes the tickets of launches 2 and 4.
__global__ void __launch_bounds__(sm90::kThreads) bwd_conv1_kernel(BwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  if (mt == 0 && nt == 0) {
    const float cnt = block_mask_count(A.mask, P.B);
    if (threadIdx.x == 0) *A.S.n = cnt * (float)P.Lo;
    for (int i = threadIdx.x; i < (P.groups + 1) * P.ntiles; i += sm90::kThreads) A.S.tk[i] = 0u;
  }
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvLoader<false> ld(make_seg<false>(A.x, A.w1, P.c1g, m0), ConvSeg{}, m0, n0);
  float acc[32], unused[32];
  sm90::mainloop<0, 1, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  __syncthreads();
  const int c = ep_col(), n = n0 + c;
  const float mu = A.st1[n], inv = A.st1[2 * P.Co + n], gm = A.g1[n], bt = A.b1[n];
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M; ++r) {
    const size_t i = (size_t)(m0 + r) * P.Co + n;
    const bf16 h = to_bf(__fmul_rn(__fsub_rn(st[r * kLdS + c], mu), inv));
    const bf16 a = to_bf(__fadd_rn(__fmul_rn(gm, bf(h)), bt));
    A.S.xh1[i] = h;
    A.S.r1[i] = to_bf(lrelu(bf(a)));
  }
}

// 2: conv2 recompute (+ the shortcut's conv) -> xh2, xhs, g0, and dg2, db2,
// dgs, dbs by the finishing blocks.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) bwd_conv2_kernel(BwdArgs A) {
  constexpr int NQ = SHORT ? 3 : 2;
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvSeg s0 = make_seg<false>(A.S.r1, A.w2, P.c2g, m0);
  const ConvSeg s1 = SHORT ? make_seg<false>(A.x, A.ws, P.csg, m0) : ConvSeg{};
  const ConvLoader<false> ld(s0, s1, m0, n0);
  sm90::load_ep_tile(sm90::ep_tile(ring, 0), A.g, m0, n0, P.M, P.Co);
  if (!SHORT) sm90::load_ep_tile(sm90::ep_tile(ring, 1), A.x, m0, n0, P.M, P.Co);
  float acc0[32], acc1[32];
  sm90::mainloop<0, 1, SHORT>(ld, ld.steps(), s0.nsteps, ring, acc0, acc1);
  const bf16* gt = sm90::ring_ptr<bf16>(dyn, sm90::ep_tile(ring, 0));
  const bf16* xt = sm90::ring_ptr<bf16>(dyn, sm90::ep_tile(ring, 1));
  float* st0 = sm90::ring_ptr<float>(dyn, ring);
  float* st1 = st0 + sm90::kBM * kLdS;
  sm90::stage_acc(acc0, st0);
  if (SHORT) sm90::stage_acc(acc1, st1);
  __syncthreads();

  const int c = ep_col(), n = n0 + c, C = P.Co;
  const float mu2 = A.st2[n], inv2 = A.st2[2 * C + n], gm2 = A.g2[n], bt2 = A.b2[n];
  const float mus = SHORT ? A.sts[n] : 0.f, invs = SHORT ? A.sts[2 * C + n] : 0.f;
  const float gms = SHORT ? A.gs[n] : 0.f, bts = SHORT ? A.bs[n] : 0.f;
  float s[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q] = 0.f;
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M; ++r) {
    const size_t i = (size_t)(m0 + r) * C + n;
    const bf16 h2 = to_bf(__fmul_rn(__fsub_rn(st0[r * kLdS + c], mu2), inv2));
    const float a2 = __fadd_rn(__fmul_rn(gm2, bf(h2)), bt2);
    float sh;
    bf16 hs = to_bf(0.f);
    if (SHORT) {
      hs = to_bf(__fmul_rn(__fsub_rn(st1[r * kLdS + c], mus), invs));
      sh = __fadd_rn(__fmul_rn(gms, bf(hs)), bts);
      A.S.xhs[i] = hs;
    } else {
      sh = bf(xt[r * sm90::kBN + c]);  // stride 1 and C_in == C_out: x's row m is the output's
    }
    const bf16 g0 = to_bf(__fmul_rn(bf(gt[r * sm90::kBN + c]), dlrelu(__fadd_rn(a2, sh))));
    A.S.xh2[i] = h2;
    A.S.g0[i] = g0;
    const float gv = bf(g0);
    s[0] = __fadd_rn(s[0], __fmul_rn(gv, bf(h2)));
    s[1] = __fadd_rn(s[1], gv);
    if (SHORT) s[NQ - 1] = __fadd_rn(s[NQ - 1], __fmul_rn(gv, bf(hs)));
  }
  sm90::write_tile_sums<NQ>(s, A.S.part, mt, C, n);
  float tot[NQ];
  if (sm90::finish_col_sums<NQ>(A.S.part, A.S.gpart, A.S.tk, mt, P.mtiles, nt, P.ntiles, C, n0, tot) &&
      threadIdx.x < 64) {
    A.dg2[n] = tot[0];
    A.db2[n] = tot[1];
    if (SHORT) {
      A.dgs[n] = tot[NQ - 1];
      A.dbs[n] = tot[1];  // the shortcut's dbeta is the same sum of g0
    }
  }
}

// 4: dw2's and dws's split-K tiles, then the transposed conv2 -> da1 and
// dg1, db1 by the finishing blocks.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) bwd_mid_kernel(BwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  int j = blockIdx.x;
  if (j < P.s2.jobs) return wgrad_job(dyn, A.S.r1, A.S.dc2, P.c2g, P.s2, j, A.S.wp2);
  j -= P.s2.jobs;
  if (SHORT) {
    if (j < P.ss.jobs) return wgrad_job(dyn, A.x, A.S.dcs, P.csg, P.ss, j, A.S.wps);
    j -= P.ss.jobs;
  }
  const int mt = j % P.mtiles, nt = j / P.mtiles, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvLoader<true> ld(make_seg<true>(A.S.dc2, A.w2, P.c2t, m0), ConvSeg{}, m0, n0);
  sm90::load_ep_tile(sm90::ep_tile(ring, 0), A.S.xh1, m0, n0, P.M, P.Co);
  float acc[32], unused[32];
  sm90::mainloop<0, 0, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  const bf16* ht = sm90::ring_ptr<bf16>(dyn, sm90::ep_tile(ring, 0));
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  __syncthreads();
  const int c = ep_col(), n = n0 + c, C = P.Co;
  const float gm = A.g1[n], bt = A.b1[n];
  float s[2] = {0.f, 0.f};
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M; ++r) {
    const size_t i = (size_t)(m0 + r) * C + n;
    const float h = bf(ht[r * sm90::kBN + c]);
    const float a = bf(to_bf(__fadd_rn(__fmul_rn(gm, h), bt)));
    const bf16 da = to_bf(__fmul_rn(st[r * kLdS + c], dlrelu(a)));
    A.S.da1[i] = da;
    s[0] = __fadd_rn(s[0], __fmul_rn(bf(da), h));
    s[1] = __fadd_rn(s[1], bf(da));
  }
  sm90::write_tile_sums<2>(s, A.S.part, mt, C, n);
  float tot[2];
  if (sm90::finish_col_sums<2>(A.S.part, A.S.gpart, A.S.tk, mt, P.mtiles, nt, P.ntiles, C, n0, tot) &&
      threadIdx.x < 64) {
    A.dg1[n] = tot[0];
    A.db1[n] = tot[1];
  }
}

// 6: dw1's split-K tiles, then dx = conv1^T(dc1) (+ shortcut^T(dcs)) into one
// accumulator, plus g0 without a shortcut, rounded to bf16 once.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) bwd_dx_kernel(BwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  int j = blockIdx.x;
  if (j < P.s1.jobs) return wgrad_job(dyn, A.x, A.S.dc1, P.c1g, P.s1, j, A.S.wp1);
  j -= P.s1.jobs;
  const int mt = j % P.xtiles, nt = j / P.xtiles, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvSeg s1 = SHORT ? make_seg<true>(A.S.dcs, A.ws, P.cst, m0) : ConvSeg{};
  const ConvLoader<true> ld(make_seg<true>(A.S.dc1, A.w1, P.c1t, m0), s1, m0, n0);
  const int Min = P.L * P.B;
  if (!SHORT) sm90::load_ep_tile(sm90::ep_tile(ring, 0), A.S.g0, m0, n0, Min, P.Ci);
  float acc[32], unused[32];
  sm90::mainloop<0, 0, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  const bf16* gt = sm90::ring_ptr<bf16>(dyn, sm90::ep_tile(ring, 0));
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  __syncthreads();
  const int c = ep_col(), n = n0 + c;
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < Min; ++r) {
    const size_t i = (size_t)(m0 + r) * P.Ci + n;
    float v = st[r * kLdS + c];
    if (!SHORT) v = __fadd_rn(v, bf(gt[r * sm90::kBN + c]));  // stride 1: g0 [Lo, B, Co] is [L, B, Ci]
    A.dx[i] = to_bf(v);
  }
}

}  // namespace

#define RET_IF(call)          \
  do {                        \
    const int e_ = (call);    \
    if (e_ != 0) return e_;   \
  } while (0)

extern "C" {

// Bytes of scratch the forward / backward need for one block.
long long enc_block_fwd_scratch(int L, int B, int Ci, int Co, int stride, int has_short) {
  Arena a{nullptr};
  plan_fwd(a, plan(L, B, Ci, Co, stride), has_short);
  return (long long)a.used;
}

long long enc_block_bwd_scratch(int L, int B, int Ci, int Co, int stride, int has_short) {
  Arena a{nullptr};
  plan_bwd(a, plan(L, B, Ci, Co, stride), has_short);
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
  FwdArgs A;
  A.x = static_cast<const bf16*>(x_);
  A.w1 = static_cast<const bf16*>(w1_);
  A.w2 = static_cast<const bf16*>(w2_);
  A.ws = static_cast<const bf16*>(ws_);
  A.mask = mask, A.st1 = st1, A.st2 = st2, A.sts = sts;
  A.P = plan(L, B, Ci, Co, stride);
  Arena a{static_cast<char*>(scratch)};
  A.S = plan_fwd(a, A.P, has_short);
  const Plan& P = A.P;
  const FwdScratch& S = A.S;
  const size_t tot = (size_t)P.M * Co;
  const dim3 tiles(P.mtiles, P.ntiles);

  RET_IF(static_cast<int>(cudaMemsetAsync(S.tk, 0, sizeof(unsigned) * (P.groups + 1) * P.ntiles, s)));
  RET_IF(gemm_launch(fwd_conv_kernel<false, false>, tiles, 0, A, s));
  fwd_act8_kernel<false><<<ew_grid(tot / 8), kEwThreads, 0, s>>>(S.c1, st1, g1, b1, nullptr, nullptr, nullptr,
                                                                 nullptr, nullptr, Co, (int)tot, S.r1);
  BLOCKS_CHECK();
  RET_IF(gemm_launch(has_short ? fwd_conv_kernel<true, true> : fwd_conv_kernel<true, false>, tiles, 0, A, s));
  fwd_act8_kernel<true><<<ew_grid(tot / 8), kEwThreads, 0, s>>>(S.c2, st2, g2, b2, S.cs, sts, gs, bs, A.x, Co,
                                                                (int)tot, static_cast<bf16*>(out_));
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
  BwdArgs A;
  A.x = static_cast<const bf16*>(x_);
  A.w1 = static_cast<const bf16*>(w1_);
  A.w2 = static_cast<const bf16*>(w2_);
  A.ws = static_cast<const bf16*>(ws_);
  A.g = static_cast<const bf16*>(g_);
  A.g1 = g1, A.b1 = b1, A.g2 = g2, A.b2 = b2, A.gs = gs, A.bs = bs;
  A.mask = mask, A.st1 = st1, A.st2 = st2, A.sts = sts;
  A.dx = static_cast<bf16*>(dx_);
  A.dw1 = dw1, A.dg1 = dg1, A.db1 = db1, A.dw2 = dw2, A.dg2 = dg2, A.db2 = db2;
  A.dws = dws, A.dgs = dgs, A.dbs = dbs;
  A.P = plan(L, B, Ci, Co, stride);
  Arena a{static_cast<char*>(scratch)};
  A.S = plan_bwd(a, A.P, has_short);
  const Plan& P = A.P;
  const BwdScratch& S = A.S;
  const size_t tot = (size_t)P.M * Co;
  const dim3 tiles(P.mtiles, P.ntiles);
  const int ew8 = ew_grid(tot / 8);
  const BnDx bn2{S.xh2, g2, st2, dg2, db2, S.dc2}, bns{S.xhs, gs, sts, dgs, dbs, S.dcs};
  const BnDx bn1{S.xh1, g1, st1, dg1, db1, S.dc1};
  const int mid = P.s2.jobs + (has_short ? P.ss.jobs : 0) + P.mtiles * P.ntiles;
  const int last = P.s1.jobs + P.xtiles * (Ci / sm90::kBN);

  RET_IF(gemm_launch(bwd_conv1_kernel, tiles, 0, A, s));
  if (has_short) {
    RET_IF(gemm_launch(bwd_conv2_kernel<true>, tiles, 1, A, s));
    bn_dx8_kernel<true><<<ew8, kEwThreads, 0, s>>>(S.g0, bn2, bns, mask, S.n, B, Co, (int)tot);
    BLOCKS_CHECK();
    RET_IF(gemm_launch(bwd_mid_kernel<true>, dim3(mid), 1, A, s));
  } else {
    RET_IF(gemm_launch(bwd_conv2_kernel<false>, tiles, 2, A, s));
    bn_dx8_kernel<false><<<ew8, kEwThreads, 0, s>>>(S.g0, bn2, bn2, mask, S.n, B, Co, (int)tot);
    BLOCKS_CHECK();
    RET_IF(gemm_launch(bwd_mid_kernel<false>, dim3(mid), 1, A, s));
  }
  bn_dx8_kernel<false><<<ew8, kEwThreads, 0, s>>>(S.da1, bn1, bn1, mask, S.n, B, Co, (int)tot);
  BLOCKS_CHECK();
  RET_IF(gemm_launch(has_short ? bwd_dx_kernel<true> : bwd_dx_kernel<false>, dim3(last), has_short ? 0 : 1, A, s));
  const WgradSum w1s{S.wp1, P.s1.splits, 3 * Ci * Co, dw1}, w2s{S.wp2, P.s2.splits, 3 * Co * Co, dw2};
  const WgradSum wss{S.wps, P.ss.splits, has_short ? Ci * Co : 0, dws};
  sm90::wgrad_sum3_kernel<<<ew_grid((size_t)w1s.n + w2s.n + wss.n), kEwThreads, 0, s>>>(w1s, w2s, wss);
  BLOCKS_CHECK();
  return 0;
}

}  // extern "C"
