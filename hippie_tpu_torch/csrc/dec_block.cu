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
// dcs, and the transposed convolutions through the upsample, whose pairs of
// rows (the upsample's backward) are summed in float32 before any bf16
// rounding. bf16 roundings are at the JAX math's points (r, xh2, a2, xh1,
// xhs, g0, dc1, dcs, da2, dc2, dx).
//
// What bounds it on an H100: operations. The full-width decoder's 8 blocks
// do 29.8 GFLOP forward (conv2 at Lin, conv1 and the shortcut at Lo) and
// about 3x that backward, 30 us and 90 us at 989 TFLOP/s bf16 dense; the
// largest activation is 4 MB in float32, so bytes bound nothing. At these
// sizes the number of launches and of passes over device memory is what the
// time is made of.
//
// Forward design (sm90_gemm.cuh, as the encoder's forward): 5 launches at
// either stride,
//   0 the tickets of the cross-block merges to zero (a memset)
//   1 conv2 at Lin as a wgmma GEMM over M2 = Lin*B rows; its epilogue writes
//     c2 (fp32) and each tile's masked moments per channel (count, sum, and
//     the squares about the tile's own mean); the blocks that finish last
//     merge the tiles' moments in a fixed order (Chan's formula) into st2,
//     whose count is the masked rows of M2, sum(m) * Lin
//   2 r = bf16(lrelu(bn2(c2))), elementwise (8 entries per thread)
//   3 conv1 on up2(r) (+ c1b) and, at stride 2, the shortcut's conv on up2(x)
//     (+ csb) into two accumulators of one tile at Lo (M1 = Lo*B rows; the
//     loader reads the upsample in place); the epilogue adds the conv biases,
//     writes c1, cs and their moments, merged into st1 and sts as in 1; at
//     stride 1 the finisher writes sts = 0
//   4 out = bf16(lrelu(bn1(c1) + (stride 2 ? bn_s(cs) : x))), elementwise
// The two GEMM launches group their tiles by their own M, in one ticket
// array sized for both: launch 1's finishers leave every ticket at zero, so
// the one memset serves launch 3 as well.
//
// Backward design (sm90_gemm.cuh, as the encoder's backward): 7 launches at
// either stride, each GEMM a wgmma tile fed by a 4-stage cp.async ring, each
// elementwise step in the epilogue of the GEMM that produces its input:
//   1 conv2 recompute at Lin; epilogue xh2, r (bf16)
//   2 conv1 on up2(r) (+ c1b) and the shortcut's conv on up2(x) (+ csb) into
//     two accumulators of one tile at Lo (the loader reads the upsample in
//     place); epilogue xh1, xhs, g0 and the per-(m-tile, channel) sums of
//     g0*xh1, g0, g0*xhs that the finishing blocks sum into dg1, db1, dgs, dbs
//   3 dc1, dcs (BatchNorm's backward); at stride 2 over 64 x 64 tiles, so
//     that the conv biases' gradients dc1b, dcsb are fixed-order column sums
//     of the rounded dc1, dcs
//   4 dr, the transposed conv1 through the upsample: output row l at Lin
//     takes its k-steps from dc1 rows 2l + 1 - t and 2l + 2 - t against the
//     unsummed w1[t], so the pair sum is in the fp32 accumulator, before any
//     rounding; epilogue da2 and the sums of da2*xh2, da2 into dg2, db2
//     (counted at Lin); with the split-K tiles of dw1 and dws in the same grid
//   5 dc2
//   6 dx = the transposed conv2 and the shortcut's transposed conv through
//     the upsample into one accumulator (plus g0 at stride 1), rounded once;
//     with dw2's split-K tiles
//   7 the fixed-order sums of the weight gradients' split-K partials
// The cross-block sums take integer tickets (the last block of a group sums
// the group's partials in index order); there are no float atomics, so
// repeated runs give the same bits. Each entry point is one ctypes call that
// issues its whole sequence on the caller's stream; scratch comes from the
// caller.

#include "block_common.cuh"
#include "sm90_gemm.cuh"

using namespace blocks;
using sm90::BnDx;
using sm90::bn_dx1;
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

struct Plan {
  int Lin, B, Ci, Co, Lo, M2, M1;
  int mt2, nt2, g2;  // tiles and groups of m-tiles of the [M2 = Lin*B, Ci] GEMMs
  int mt1, nt1, g1;  // and of the [M1 = Lo*B, Co] ones
  Split s1, s2, ss;  // dw1, dw2, dws
  ConvGeom c2g;      // conv2 x -> c2 at Lin, dw2, and (the same numbers) its transpose
  ConvGeom c1g;      // conv1 r -> c1 and the shortcut x -> cs at Lo (through the upsample at stride 2), dw1, dws
  ConvGeom c1t;      // their transposes dc -> [Lin, B, Ci] (summed over the upsample's pairs at stride 2)
};

Plan plan(int Lin, int B, int Ci, int Co, int stride) {
  Plan p;
  p.Lin = Lin, p.B = B, p.Ci = Ci, p.Co = Co;
  p.Lo = Lin * stride;
  p.M2 = Lin * B, p.M1 = p.Lo * B;
  p.mt2 = cdiv(p.M2, sm90::kBM), p.nt2 = Ci / sm90::kBN, p.g2 = cdiv(p.mt2, sm90::kGroup);
  p.mt1 = cdiv(p.M1, sm90::kBM), p.nt1 = Co / sm90::kBN, p.g1 = cdiv(p.mt1, sm90::kGroup);
  p.s1 = wgrad_split(p.M1, Ci, Co, 3);
  p.s2 = wgrad_split(p.M2, Ci, Ci, 3);
  p.ss = wgrad_split(p.M1, Ci, Co, 3);
  p.c2g = ConvGeom{Lin, Lin, B, Ci, Ci, 3, 1, 1};
  p.c1g = ConvGeom{Lin, p.Lo, B, Ci, Co, 3, 1, 1};
  p.c1t = ConvGeom{p.Lo, Lin, B, Co, Ci, 3, 1, 1};
  return p;
}

// Ticket counters of the cross-block sums, for both lengths' grids.
__host__ __device__ inline int tickets(const Plan& p) {
  const int t1 = (p.g1 + 1) * p.nt1, t2 = (p.g2 + 1) * p.nt2;
  return t1 > t2 ? t1 : t2;
}

// --- forward ---------------------------------------------------------------------

struct FwdScratch {
  float *c2, *c1, *cs, *part, *gpart;
  bf16* r;
  unsigned* tk;
};

// part, gpart and tk serve both GEMM launches: conv2's [M2, Ci] grid (one
// statistic) and conv1's [M1, Co] grid (two with the shortcut).
FwdScratch plan_fwd(Arena& a, const Plan& p, int stride) {
  const int ns = stride != 1 ? 2 : 1;
  FwdScratch s;
  s.c2 = a.take<float>((size_t)p.M2 * p.Ci);
  s.r = a.take<bf16>((size_t)p.M2 * p.Ci);
  s.c1 = a.take<float>((size_t)p.M1 * p.Co);
  s.cs = stride != 1 ? a.take<float>((size_t)p.M1 * p.Co) : nullptr;
  s.part = a.take<float>(std::max((size_t)p.mt2 * 3 * p.Ci, (size_t)p.mt1 * 3 * ns * p.Co));
  s.gpart = a.take<float>(std::max((size_t)p.g2 * 3 * p.Ci, (size_t)p.g1 * 3 * ns * p.Co));
  s.tk = a.take<unsigned>(tickets(p));
  return s;
}

struct FwdArgs {
  const bf16 *x, *w2, *w1, *ws;
  const float *c1b, *csb, *mask;
  float *st2, *st1, *sts;
  float* mom;  // segmented: this rank's moments [3 NS, C] in place of st2 / st1, sts
  FwdScratch S;
  Plan P;
};

// 1: conv2 at Lin -> c2, and st2 by the finishing blocks.
__global__ void __launch_bounds__(sm90::kThreads) dec_fwd_conv2_kernel(FwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvLoader<false> ld(make_seg<false>(A.x, A.w2, P.c2g, m0), ConvSeg{}, m0, n0);
  float acc[32], unused[32];
  sm90::mainloop<0, 1, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  const ConvOut out[1] = {{A.S.c2, nullptr, A.st2, A.mom}};
  sm90::conv_stats_epilogue<1>(st, out, MomentGrid{A.mask, P.B, P.M2, P.Ci, P.mt2, P.nt2, A.S.part, A.S.gpart,
                                                   A.S.tk}, mt, nt);
}

// 3: conv1 on up2(r) + c1b and the shortcut's conv on up2(x) + csb at Lo
// (stride 1: conv1 on r alone) -> c1, cs, and st1, sts by the finishing blocks.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) dec_fwd_conv1_kernel(FwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvSeg s0 = make_seg<false>(A.S.r, A.w1, P.c1g, m0, SHORT);
  const ConvSeg s1 = SHORT ? make_seg<false>(A.x, A.ws, P.c1g, m0, true) : ConvSeg{};
  const ConvLoader<false> ld(s0, s1, m0, n0);
  float acc0[32], acc1[32];
  sm90::mainloop<0, 1, SHORT>(ld, ld.steps(), s0.nsteps, ring, acc0, acc1);
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc0, st);
  if (SHORT) sm90::stage_acc(acc1, st + sm90::kBM * kLdS);
  const ConvOut out[2] = {{A.S.c1, A.c1b, A.st1, A.mom}, {A.S.cs, A.csb, A.sts, A.mom ? A.mom + 3 * P.Co : nullptr}};
  const MomentGrid grid{A.mask, P.B, P.M1, P.Co, P.mt1, P.nt1, A.S.part, A.S.gpart, A.S.tk};
  if (sm90::conv_stats_epilogue<SHORT ? 2 : 1>(st, out, grid, mt, nt) && !SHORT) {
    const int n = n0 + ep_col();
    A.sts[n] = A.sts[P.Co + n] = A.sts[2 * P.Co + n] = 0.f;
  }
}

// --- backward --------------------------------------------------------------------

struct BwdScratch {
  bf16 *xh2, *r, *da2, *dc2, *xh1, *g0, *dc1, *xhs, *dcs;
  float *part, *gpart, *n, *wp1, *wp2, *wps;
  unsigned* tk;
};

BwdScratch plan_bwd(Arena& a, const Plan& p, int stride) {
  const bool short_ = stride != 1;
  const size_t tin = (size_t)p.M2 * p.Ci, tout = (size_t)p.M1 * p.Co;
  const size_t w1 = (size_t)3 * p.Ci * p.Co, w2 = (size_t)3 * p.Ci * p.Ci;
  BwdScratch s;
  s.xh2 = a.take<bf16>(tin);
  s.r = a.take<bf16>(tin);
  s.da2 = a.take<bf16>(tin);
  s.dc2 = a.take<bf16>(tin);
  s.xh1 = a.take<bf16>(tout);
  s.g0 = a.take<bf16>(tout);
  s.dc1 = a.take<bf16>(tout);
  s.xhs = short_ ? a.take<bf16>(tout) : nullptr;
  s.dcs = short_ ? a.take<bf16>(tout) : nullptr;
  s.part = a.take<float>(std::max((size_t)p.mt1 * 3 * p.Co, (size_t)p.mt2 * 2 * p.Ci));
  s.gpart = a.take<float>(std::max((size_t)p.g1 * 3 * p.Co, (size_t)p.g2 * 2 * p.Ci));
  s.n = a.take<float>(2);
  s.wp1 = a.take<float>(p.s1.splits * w1);
  s.wp2 = a.take<float>(p.s2.splits * w2);
  s.wps = short_ ? a.take<float>(p.ss.splits * w1) : nullptr;
  s.tk = a.take<unsigned>(tickets(p));
  return s;
}

struct BwdArgs {
  const bf16 *x, *w2, *w1, *ws, *g;
  const float *g2, *b2, *c1b, *g1, *b1, *csb, *gs, *bs, *mask, *st2, *st1, *sts;
  const float* nc;  // the counts (n1, n2) BatchNorm's backward divides by: S.n, or the global ones
  bf16* dx;
  float *dw2, *dg2, *db2, *dw1, *dc1b, *dg1, *db1, *dws, *dcsb, *dgs, *dbs;
  BwdScratch S;
  Plan P;
};

// 1: conv2 recompute at Lin -> xh2, r. Block (0, 0) also writes the counts
// n1 = sum(mask) * Lo, n2 = sum(mask) * Lin and zeroes the tickets.
__global__ void __launch_bounds__(sm90::kThreads) bwd_conv2_kernel(BwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  if (mt == 0 && nt == 0) {
    const float cnt = block_mask_count(A.mask, P.B);
    if (threadIdx.x == 0) A.S.n[0] = cnt * (float)P.Lo, A.S.n[1] = cnt * (float)P.Lin;
    for (int i = threadIdx.x; i < tickets(P); i += sm90::kThreads) A.S.tk[i] = 0u;
  }
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvLoader<false> ld(make_seg<false>(A.x, A.w2, P.c2g, m0), ConvSeg{}, m0, n0);
  float acc[32], unused[32];
  sm90::mainloop<0, 1, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  __syncthreads();
  const int c = ep_col(), n = n0 + c;
  const float mu = A.st2[n], inv = A.st2[2 * P.Ci + n], gm = A.g2[n], bt = A.b2[n];
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M2; ++r) {
    const size_t i = (size_t)(m0 + r) * P.Ci + n;
    const bf16 h = to_bf(__fmul_rn(__fsub_rn(st[r * kLdS + c], mu), inv));
    const bf16 a = to_bf(__fadd_rn(__fmul_rn(gm, bf(h)), bt));
    A.S.xh2[i] = h;
    A.S.r[i] = to_bf(lrelu(bf(a)));
  }
}

// 2: conv1 (+ the shortcut's conv) at Lo -> xh1, xhs, g0, and dg1, db1, dgs,
// dbs by the finishing blocks.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) bwd_conv1_kernel(BwdArgs A) {
  constexpr int NQ = SHORT ? 3 : 2;
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvSeg s0 = make_seg<false>(A.S.r, A.w1, P.c1g, m0, SHORT);
  const ConvSeg s1 = SHORT ? make_seg<false>(A.x, A.ws, P.c1g, m0, true) : ConvSeg{};
  const ConvLoader<false> ld(s0, s1, m0, n0);
  sm90::load_ep_tile(sm90::ep_tile(ring, 0), A.g, m0, n0, P.M1, P.Co);
  if (!SHORT) sm90::load_ep_tile(sm90::ep_tile(ring, 1), A.x, m0, n0, P.M1, P.Co);
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
  const float mu1 = A.st1[n], inv1 = A.st1[2 * C + n], gm1 = A.g1[n], bt1 = A.b1[n];
  const float cb1 = SHORT ? A.c1b[n] : 0.f, cbs = SHORT ? A.csb[n] : 0.f;
  const float mus = SHORT ? A.sts[n] : 0.f, invs = SHORT ? A.sts[2 * C + n] : 0.f;
  const float gms = SHORT ? A.gs[n] : 0.f, bts = SHORT ? A.bs[n] : 0.f;
  float s[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q] = 0.f;
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M1; ++r) {
    const size_t i = (size_t)(m0 + r) * C + n;
    const float c1 = SHORT ? __fadd_rn(st0[r * kLdS + c], cb1) : st0[r * kLdS + c];
    const bf16 h1 = to_bf(__fmul_rn(__fsub_rn(c1, mu1), inv1));
    const float a1 = __fadd_rn(__fmul_rn(gm1, bf(h1)), bt1);
    float sh;
    bf16 hs = to_bf(0.f);
    if (SHORT) {
      hs = to_bf(__fmul_rn(__fsub_rn(__fadd_rn(st1[r * kLdS + c], cbs), mus), invs));
      sh = __fadd_rn(__fmul_rn(gms, bf(hs)), bts);
      A.S.xhs[i] = hs;
    } else {
      sh = bf(xt[r * sm90::kBN + c]);  // stride 1 and C_in == C_out: x's row m is the output's
    }
    const bf16 g0 = to_bf(__fmul_rn(bf(gt[r * sm90::kBN + c]), dlrelu(__fadd_rn(a1, sh))));
    A.S.xh1[i] = h1;
    A.S.g0[i] = g0;
    const float gv = bf(g0);
    s[0] = __fadd_rn(s[0], __fmul_rn(gv, bf(h1)));
    s[1] = __fadd_rn(s[1], gv);
    if (SHORT) s[NQ - 1] = __fadd_rn(s[NQ - 1], __fmul_rn(gv, bf(hs)));
  }
  sm90::write_tile_sums<NQ>(s, A.S.part, mt, C, n);
  float tot[NQ];
  if (sm90::finish_col_sums<NQ>(A.S.part, A.S.gpart, A.S.tk, mt, P.mt1, nt, P.nt1, C, n0, tot) &&
      threadIdx.x < 64) {
    A.dg1[n] = tot[0];
    A.db1[n] = tot[1];
    if (SHORT) {
      A.dgs[n] = tot[NQ - 1];
      A.dbs[n] = tot[1];  // the shortcut's dbeta is the same sum of g0
    }
  }
}

// 3 at stride 2: dc1, dcs over a 64 x 64 tile, 8 columns and 4 rows per
// thread (16-byte loads and stores), and the conv biases' gradients dc1b,
// dcsb as fixed-order column sums of the rounded values: rows in order
// within each of 16 row lanes, then the lanes in order, then the tiles.
__global__ void __launch_bounds__(sm90::kThreads) bwd_dc_bias_kernel(BwdArgs A) {
  __shared__ float red[2][16][sm90::kBN];
  const Plan& P = A.P;
  const int mt = blockIdx.x, nt = blockIdx.y, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const int cg = threadIdx.x & 7, lane = threadIdx.x >> 3, n = n0 + 8 * cg, C = P.Co;
  float gi1[8], gis[8], dg1[8], db1[8], dgs[8], dbs[8], inv[8];
  sm90::load8(A.g1 + n, gi1);
  sm90::load8(A.st1 + 2 * C + n, inv);
#pragma unroll
  for (int e = 0; e < 8; ++e) gi1[e] = __fmul_rn(gi1[e], inv[e]);
  sm90::load8(A.gs + n, gis);
  sm90::load8(A.sts + 2 * C + n, inv);
#pragma unroll
  for (int e = 0; e < 8; ++e) gis[e] = __fmul_rn(gis[e], inv[e]);
  sm90::load8(A.dg1 + n, dg1);
  sm90::load8(A.db1 + n, db1);
  sm90::load8(A.dgs + n, dgs);
  sm90::load8(A.dbs + n, dbs);
  const float n1 = A.nc[0];
  uint4 dy[4], h1[4], hs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // every row's loads ahead of the stores
    const int m = m0 + lane + 16 * j;
    const size_t i = (size_t)min(m, P.M1 - 1) * C + n;
    dy[j] = *reinterpret_cast<const uint4*>(A.S.g0 + i);
    h1[j] = *reinterpret_cast<const uint4*>(A.S.xh1 + i);
    hs[j] = *reinterpret_cast<const uint4*>(A.S.xhs + i);
  }
  float s1[8] = {}, ss[8] = {};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + lane + 16 * j;
    if (m >= P.M1) break;
    const float mn = A.mask[m % P.B] / n1;
    const bf16* d = reinterpret_cast<const bf16*>(&dy[j]);
    const bf16* x1 = reinterpret_cast<const bf16*>(&h1[j]);
    const bf16* xs = reinterpret_cast<const bf16*>(&hs[j]);
    uint4 o1, os;
    bf16* p1 = reinterpret_cast<bf16*>(&o1);
    bf16* ps = reinterpret_cast<bf16*>(&os);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p1[e] = bn_dx1(bf(d[e]), bf(x1[e]), gi1[e], mn, db1[e], dg1[e]);
      ps[e] = bn_dx1(bf(d[e]), bf(xs[e]), gis[e], mn, dbs[e], dgs[e]);
      s1[e] = __fadd_rn(s1[e], bf(p1[e]));
      ss[e] = __fadd_rn(ss[e], bf(ps[e]));
    }
    const size_t i = (size_t)m * C + n;
    *reinterpret_cast<uint4*>(A.S.dc1 + i) = o1;
    *reinterpret_cast<uint4*>(A.S.dcs + i) = os;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[0][lane][8 * cg + e] = s1[e], red[1][lane][8 * cg + e] = ss[e];
  __syncthreads();
  if (threadIdx.x < sm90::kBN) {
    float t[2] = {0.f, 0.f};
    for (int l = 0; l < 16; ++l) t[0] = __fadd_rn(t[0], red[0][l][threadIdx.x]), t[1] = __fadd_rn(t[1], red[1][l][threadIdx.x]);
    A.S.part[((size_t)mt * 2) * C + n0 + threadIdx.x] = t[0];
    A.S.part[((size_t)mt * 2 + 1) * C + n0 + threadIdx.x] = t[1];
  }
  float tot[2];
  if (sm90::finish_col_sums<2>(A.S.part, A.S.gpart, A.S.tk, mt, P.mt1, nt, P.nt1, C, n0, tot) &&
      threadIdx.x < 64) {
    A.dc1b[n0 + threadIdx.x] = tot[0];
    A.dcsb[n0 + threadIdx.x] = tot[1];
  }
}

// 4: dw1's and dws's split-K tiles, then dr = the transposed conv1 (through
// the upsample at stride 2) at Lin -> da2, and dg2, db2 by the finishing blocks.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) bwd_mid_kernel(BwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  int j = blockIdx.x;
  if (j < P.s1.jobs) return wgrad_job(dyn, A.S.r, A.S.dc1, P.c1g, P.s1, j, A.S.wp1, SHORT);
  j -= P.s1.jobs;
  if (SHORT) {
    if (j < P.ss.jobs) return wgrad_job(dyn, A.x, A.S.dcs, P.c1g, P.ss, j, A.S.wps, true);
    j -= P.ss.jobs;
  }
  const int mt = j % P.mt2, nt = j / P.mt2, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvLoader<true> ld(make_seg<true>(A.S.dc1, A.w1, P.c1t, m0, SHORT), ConvSeg{}, m0, n0);
  sm90::load_ep_tile(sm90::ep_tile(ring, 0), A.S.xh2, m0, n0, P.M2, P.Ci);
  float acc[32], unused[32];
  sm90::mainloop<0, 0, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  const bf16* ht = sm90::ring_ptr<bf16>(dyn, sm90::ep_tile(ring, 0));
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  __syncthreads();
  const int c = ep_col(), n = n0 + c, C = P.Ci;
  const float gm = A.g2[n], bt = A.b2[n];
  float s[2] = {0.f, 0.f};
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M2; ++r) {
    const size_t i = (size_t)(m0 + r) * C + n;
    const float h = bf(ht[r * sm90::kBN + c]);
    const float a = bf(to_bf(__fadd_rn(__fmul_rn(gm, h), bt)));
    const bf16 da = to_bf(__fmul_rn(st[r * kLdS + c], dlrelu(a)));
    A.S.da2[i] = da;
    s[0] = __fadd_rn(s[0], __fmul_rn(bf(da), h));
    s[1] = __fadd_rn(s[1], bf(da));
  }
  sm90::write_tile_sums<2>(s, A.S.part, mt, C, n);
  float tot[2];
  if (sm90::finish_col_sums<2>(A.S.part, A.S.gpart, A.S.tk, mt, P.mt2, nt, P.nt2, C, n0, tot) &&
      threadIdx.x < 64) {
    A.dg2[n] = tot[0];
    A.db2[n] = tot[1];
  }
}

// 6: dw2's split-K tiles, then dx = conv2^T(dc2) (+ the shortcut's transposed
// conv of dcs through the upsample) into one accumulator, plus g0 at stride
// 1, rounded to bf16 once.
template <bool SHORT>
__global__ void __launch_bounds__(sm90::kThreads) bwd_dx_kernel(BwdArgs A) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  const Plan& P = A.P;
  int j = blockIdx.x;
  if (j < P.s2.jobs) return wgrad_job(dyn, A.x, A.S.dc2, P.c2g, P.s2, j, A.S.wp2);
  j -= P.s2.jobs;
  const int mt = j % P.mt2, nt = j / P.mt2, m0 = mt * sm90::kBM, n0 = nt * sm90::kBN;
  const uint32_t ring = sm90::ring_base(dyn);
  const ConvSeg s1 = SHORT ? make_seg<true>(A.S.dcs, A.ws, P.c1t, m0, true) : ConvSeg{};
  const ConvLoader<true> ld(make_seg<true>(A.S.dc2, A.w2, P.c2g, m0), s1, m0, n0);
  if (!SHORT) sm90::load_ep_tile(sm90::ep_tile(ring, 0), A.S.g0, m0, n0, P.M2, P.Ci);
  float acc[32], unused[32];
  sm90::mainloop<0, 0, false>(ld, ld.steps(), ld.steps(), ring, acc, unused);
  const bf16* gt = sm90::ring_ptr<bf16>(dyn, sm90::ep_tile(ring, 0));
  float* st = sm90::ring_ptr<float>(dyn, ring);
  sm90::stage_acc(acc, st);
  __syncthreads();
  const int c = ep_col(), n = n0 + c;
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < P.M2; ++r) {
    float v = st[r * kLdS + c];
    if (!SHORT) v = __fadd_rn(v, bf(gt[r * sm90::kBN + c]));  // stride 1: g0 [Lo, B, Co] is [Lin, B, Ci]
    A.dx[(size_t)(m0 + r) * P.Ci + n] = to_bf(v);
  }
}

}  // namespace

#define RET_IF(call)          \
  do {                        \
    const int e_ = (call);    \
    if (e_ != 0) return e_;   \
  } while (0)

namespace {

// Segments first..last of the forward (1: memset and conv2, 2: r and conv1,
// 3: the output); mom null: the statistics straight into st2, st1, sts.
int fwd_run(const void* x_, const void* w2_, const float* g2, const float* b2, const void* w1_, const float* c1b,
            const float* g1, const float* b1, const void* ws_, const float* csb, const float* gs, const float* bs,
            const float* mask, int Lin, int B, int Ci, int Co, int stride, void* out_, float* st2, float* st1,
            float* sts, void* scratch, void* stream, float* mom, int first, int last) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FwdArgs A;
  A.x = static_cast<const bf16*>(x_);
  A.w2 = static_cast<const bf16*>(w2_);
  A.w1 = static_cast<const bf16*>(w1_);
  A.ws = static_cast<const bf16*>(ws_);
  A.c1b = c1b, A.csb = csb, A.mask = mask, A.st2 = st2, A.st1 = st1, A.sts = sts, A.mom = mom;
  A.P = plan(Lin, B, Ci, Co, stride);
  Arena a{static_cast<char*>(scratch)};
  A.S = plan_fwd(a, A.P, stride);
  const Plan& P = A.P;
  const FwdScratch& S = A.S;
  const size_t tin = (size_t)P.M2 * Ci, tout = (size_t)P.M1 * Co;

  if (first <= 1 && 1 <= last) {
    RET_IF(static_cast<int>(cudaMemsetAsync(S.tk, 0, sizeof(unsigned) * tickets(P), s)));
    RET_IF(gemm_launch(dec_fwd_conv2_kernel, dim3(P.mt2, P.nt2), 0, A, s));
  }
  if (first <= 2 && 2 <= last) {
    fwd_act8_kernel<false><<<ew_grid(tin / 8), kEwThreads, 0, s>>>(S.c2, st2, g2, b2, nullptr, nullptr, nullptr,
                                                                   nullptr, nullptr, Ci, (int)tin, S.r);
    BLOCKS_CHECK();
    RET_IF(gemm_launch(stride != 1 ? dec_fwd_conv1_kernel<true> : dec_fwd_conv1_kernel<false>, dim3(P.mt1, P.nt1),
                       0, A, s));
  }
  if (first <= 3 && 3 <= last) {
    fwd_act8_kernel<true><<<ew_grid(tout / 8), kEwThreads, 0, s>>>(S.c1, st1, g1, b1, S.cs, sts, gs, bs, A.x, Co,
                                                                   (int)tout, static_cast<bf16*>(out_));
    BLOCKS_CHECK();
  }
  return 0;
}

// Segments first..last of the backward (1: the recomputes, dg1, db1, dgs,
// dbs; 2: dc1, dcs and dr, dg2 and db2; 3: dc2, dx and the weight
// gradients); n null: the counts the first launch writes into scratch.
int bwd_run(const void* x_, const void* w2_, const float* g2, const float* b2, const void* w1_, const float* c1b,
            const float* g1, const float* b1, const void* ws_, const float* csb, const float* gs, const float* bs,
            const float* mask, const float* st2, const float* st1, const float* sts, const void* g_, int Lin, int B,
            int Ci, int Co, int stride, void* dx_, float* dw2, float* dg2, float* db2, float* dw1, float* dc1b,
            float* dg1, float* db1, float* dws, float* dcsb, float* dgs, float* dbs, void* scratch, void* stream,
            const float* n, int first, int last) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool short_ = stride != 1;
  BwdArgs A;
  A.x = static_cast<const bf16*>(x_);
  A.w2 = static_cast<const bf16*>(w2_);
  A.w1 = static_cast<const bf16*>(w1_);
  A.ws = static_cast<const bf16*>(ws_);
  A.g = static_cast<const bf16*>(g_);
  A.g2 = g2, A.b2 = b2, A.c1b = c1b, A.g1 = g1, A.b1 = b1, A.csb = csb, A.gs = gs, A.bs = bs;
  A.mask = mask, A.st2 = st2, A.st1 = st1, A.sts = sts;
  A.dx = static_cast<bf16*>(dx_);
  A.dw2 = dw2, A.dg2 = dg2, A.db2 = db2, A.dw1 = dw1, A.dc1b = dc1b, A.dg1 = dg1, A.db1 = db1;
  A.dws = dws, A.dcsb = dcsb, A.dgs = dgs, A.dbs = dbs;
  A.P = plan(Lin, B, Ci, Co, stride);
  Arena a{static_cast<char*>(scratch)};
  A.S = plan_bwd(a, A.P, stride);
  A.nc = n ? n : A.S.n;
  const Plan& P = A.P;
  const BwdScratch& S = A.S;
  const size_t tin = (size_t)P.M2 * Ci, tout = (size_t)P.M1 * Co;
  const BnDx bn1{S.xh1, g1, st1, dg1, db1, S.dc1}, bn2{S.xh2, g2, st2, dg2, db2, S.dc2};
  const int mid = P.s1.jobs + (short_ ? P.ss.jobs : 0) + P.mt2 * P.nt2;
  const int last_grid = P.s2.jobs + P.mt2 * P.nt2;

  if (first <= 1 && 1 <= last) {
    RET_IF(gemm_launch(bwd_conv2_kernel, dim3(P.mt2, P.nt2), 0, A, s));
    RET_IF(gemm_launch(short_ ? bwd_conv1_kernel<true> : bwd_conv1_kernel<false>, dim3(P.mt1, P.nt1),
                       short_ ? 1 : 2, A, s));
  }
  if (first <= 2 && 2 <= last) {
    if (short_) {
      bwd_dc_bias_kernel<<<dim3(P.mt1, P.nt1), sm90::kThreads, 0, s>>>(A);
    } else {
      bn_dx8_kernel<false><<<ew_grid(tout / 8), kEwThreads, 0, s>>>(S.g0, bn1, bn1, mask, A.nc, B, Co, (int)tout);
    }
    BLOCKS_CHECK();
    RET_IF(gemm_launch(short_ ? bwd_mid_kernel<true> : bwd_mid_kernel<false>, dim3(mid), 1, A, s));
  }
  if (first <= 3 && 3 <= last) {
    bn_dx8_kernel<false><<<ew_grid(tin / 8), kEwThreads, 0, s>>>(S.da2, bn2, bn2, mask, A.nc + 1, B, Ci, (int)tin);
    BLOCKS_CHECK();
    RET_IF(gemm_launch(short_ ? bwd_dx_kernel<true> : bwd_dx_kernel<false>, dim3(last_grid), short_ ? 0 : 1, A, s));
    const WgradSum w1s{S.wp1, P.s1.splits, 3 * Ci * Co, dw1}, w2s{S.wp2, P.s2.splits, 3 * Ci * Ci, dw2};
    const WgradSum wss{S.wps, P.ss.splits, short_ ? 3 * Ci * Co : 0, dws};
    sm90::wgrad_sum3_kernel<<<ew_grid((size_t)w1s.n + w2s.n + wss.n), kEwThreads, 0, s>>>(w1s, w2s, wss);
    BLOCKS_CHECK();
  }
  return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch the forward / backward need for one block.
long long dec_block_fwd_scratch(int Lin, int B, int Ci, int Co, int stride) {
  Arena a{nullptr};
  plan_fwd(a, plan(Lin, B, Ci, Co, stride), stride);
  return (long long)a.used;
}

long long dec_block_bwd_scratch(int Lin, int B, int Ci, int Co, int stride) {
  Arena a{nullptr};
  plan_bwd(a, plan(Lin, B, Ci, Co, stride), stride);
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
  return fwd_run(x_, w2_, g2, b2, w1_, c1b, g1, b1, ws_, csb, gs, bs, mask, Lin, B, Ci, Co, stride, out_, st2, st1,
                 sts, scratch, stream, nullptr, 1, 3);
}

// The forward in three segments for data parallelism, each stopping at a
// statistic (the same arguments, the same scratch in every segment):
//   seg 1: the tickets' memset and conv2; its moments go to mom [3, Ci]
//   seg 2: r from st2, then conv1 (+ the shortcut's conv); their moments go
//          to mom [3 NS, Co] (c1's rows 0-2, cs's 3-5)
//   seg 3: the output from st1, sts
// Between segments the caller merges every rank's mom into st2, or st1 and
// sts (bn_stats_merge of enc_block.cu). sts = 0 at stride 1.
int dec_block_fwd_seg(const void* x_, const void* w2_, const float* g2, const float* b2,
                      const void* w1_, const float* c1b, const float* g1, const float* b1,
                      const void* ws_, const float* csb, const float* gs, const float* bs,
                      const float* mask, int Lin, int B, int Ci, int Co, int stride, void* out_,
                      float* st2, float* st1, float* sts, void* scratch, void* stream, float* mom, int seg) {
  if (seg < 1 || seg > 3) return 1;  // cudaErrorInvalidValue
  return fwd_run(x_, w2_, g2, b2, w1_, c1b, g1, b1, ws_, csb, gs, bs, mask, Lin, B, Ci, Co, stride, out_, st2, st1,
                 sts, scratch, stream, mom, seg, seg);
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
  return bwd_run(x_, w2_, g2, b2, w1_, c1b, g1, b1, ws_, csb, gs, bs, mask, st2, st1, sts, g_, Lin, B, Ci, Co,
                 stride, dx_, dw2, dg2, db2, dw1, dc1b, dg1, db1, dws, dcsb, dgs, dbs, scratch, stream, nullptr, 1,
                 3);
}

// The backward in three segments for data parallelism, each stopping where
// a BatchNorm's dgamma, dbeta are finished (the same arguments, the same
// scratch in every segment):
//   seg 1: conv2 and conv1 (+ the shortcut's conv) recomputed; writes dg1,
//          db1 (and dgs, dbs)
//   seg 2: dc1 (dcs, and the conv biases' gradients), then dr; writes dg2, db2
//   seg 3: dc2, dx and the weight gradients
// Between segments the caller sums the dgamma, dbeta just written over the
// ranks in place; n is float32 [2] on the device, the global counts
// (sum(mask) * Lo, sum(mask) * Lin) over every rank, which BatchNorm's
// backward divides by. The weight and conv-bias gradients stay this rank's.
int dec_block_bwd_seg(const void* x_, const void* w2_, const float* g2, const float* b2,
                      const void* w1_, const float* c1b, const float* g1, const float* b1,
                      const void* ws_, const float* csb, const float* gs, const float* bs,
                      const float* mask, const float* st2, const float* st1, const float* sts,
                      const void* g_, int Lin, int B, int Ci, int Co, int stride, void* dx_,
                      float* dw2, float* dg2, float* db2, float* dw1, float* dc1b, float* dg1,
                      float* db1, float* dws, float* dcsb, float* dgs, float* dbs, void* scratch,
                      void* stream, const float* n, int seg) {
  if (seg < 1 || seg > 3 || n == nullptr) return 1;  // cudaErrorInvalidValue
  return bwd_run(x_, w2_, g2, b2, w1_, c1b, g1, b1, ws_, csb, gs, bs, mask, st2, st1, sts, g_, Lin, B, Ci, Co,
                 stride, dx_, dw2, dg2, db2, dw1, dc1b, dg1, db1, dws, dcsb, dgs, dbs, scratch, stream, n, seg, seg);
}

}  // extern "C"
