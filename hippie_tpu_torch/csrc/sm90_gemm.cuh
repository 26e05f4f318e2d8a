// A Hopper GEMM core for sm_90a: wgmma on an asynchronous shared-memory ring.
//
// Used by the block kernels (enc_block.cu, dec_block.cu). One block is one
// warpgroup (128 threads) and owns a 64 x 64 output tile. Each k-step moves a
// 64-deep slice of both operands into one slot of a kStages-deep ring in
// dynamic shared memory with 16-byte cp.async copies (zero-filled where a row
// falls outside the operand: a conv tap off the edge, a row past M), while
// the warpgroup runs wgmma.mma_async (m64n64k16, bf16 operands, fp32
// accumulators) on the slot that has arrived. The copies for step k + 2 are
// in flight while step k multiplies, and step k's products run on while the
// block waits for step k + 1's operands (one wgmma group in flight).
//
// Shared layout: every operand tile is 64 rows of 128 bytes (64 bf16), with
// the 16-byte chunk j of row r stored at chunk j ^ (r % 8): the 128-byte
// swizzle the wgmma descriptors name (layout type 1), on 1024-byte aligned
// tiles. A row is either an M (or N) index holding 64 k-values ("K-major",
// the gathered activations, and a transposed conv's weights) or a k index
// holding 64 M (or N) values ("MN-major", a forward conv's weights and both
// operands of a weight gradient, read with wgmma's transpose bit). Rows come
// from device memory as whole 128-byte runs, so the copies are coalesced and
// the swizzle keeps the shared stores free of bank conflicts.
//
// Descriptors: K-major, k16 step s starts 32 * s bytes into the tile, with
// the 8-row stride (1024 bytes) as the stride offset; MN-major, step s starts
// 16 rows (2048 bytes) in, and an instruction's 64-wide M or N extent is one
// swizzle atom, so only the 8-row stride (1024 bytes) is ever read; it goes
// in both offset fields.

#pragma once

#include <cstdint>

#include "block_common.cuh"

namespace sm90 {

using blocks::bf;
using blocks::bf16;
using blocks::cdiv;
using blocks::ConvGeom;
using blocks::kEwThreads;
using blocks::src_pos;
using blocks::to_bf;

constexpr int kThreads = 128;          // one warpgroup
constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kStages = 4;
constexpr int kTileBytes = 64 * 128;   // one operand tile: 64 rows of 128 bytes
constexpr int kSlotBytes = 2 * kTileBytes;
constexpr int kRingBytes = kStages * kSlotBytes;
constexpr int kSmemBytes = kRingBytes + 1024;  // + the slack to align the ring to 1024
// A kernel whose epilogue reads `tiles` 64 x 64 bf16 tiles of its inputs
// keeps them after the ring (ep_tile).
constexpr int smem_bytes(int tiles) { return kSmemBytes + tiles * kTileBytes; }
constexpr int kLdS = kBN + 8;          // row stride (floats) of an fp32 staging tile
static_assert(2 * kBM * kLdS * 4 <= kRingBytes, "two staging tiles fit in the ring");

// --- PTX wrappers ------------------------------------------------------------
// (A host build for checking indexing, tests/test_torch_sm90_cpu.py, defines
// SM90_HOST_EMULATION and brings its own versions of these.)

#ifndef SM90_HOST_EMULATION

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src unread).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed shared writes visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the accumulators' uses after the wgmma that writes them.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#endif  // SM90_HOST_EMULATION

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
template <int MN>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int s) {
  return MN ? make_desc(tile + 2048 * s, 1024, 1024) : make_desc(tile + 32 * s, 16, 1024);
}

#ifndef SM90_HOST_EMULATION
// d[64 x 64] += A[64 x 16] B[16 x 64]; TA / TB: the operand is MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

#endif  // SM90_HOST_EMULATION

// --- the ring ------------------------------------------------------------------

// The ring's 1024-aligned shared address in the block's dynamic shared memory.
__device__ __forceinline__ uint32_t ring_base(unsigned char* dyn) {
  return (smem_u32(dyn) + 1023u) & ~1023u;
}
// A generic pointer to shared address `addr` of `dyn`'s window.
template <class T>
__device__ __forceinline__ T* ring_ptr(unsigned char* dyn, uint32_t addr) {
  return reinterpret_cast<T*>(dyn + (addr - smem_u32(dyn)));
}
// Shared address of 16-byte chunk j of row r of a tile.
__device__ __forceinline__ uint32_t swz(uint32_t tile, int r, int j) {
  return tile + r * 128 + ((j ^ (r & 7)) << 4);
}

// Shared address of the epilogue's input tile i.
__device__ __forceinline__ uint32_t ep_tile(uint32_t ring, int i) { return ring + kRingBytes + i * kTileBytes; }

// Copies the bf16 tile src[m0 + r][n0 + c] (r, c < 64; rows of C elements;
// rows at or past M zero) into shared tile `tile`, row r at byte 128 r,
// asynchronously: issued before mainloop(), it has landed when that returns.
__device__ __forceinline__ void load_ep_tile(uint32_t tile, const bf16* src, int m0, int n0, int M, int C) {
  const int j = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (threadIdx.x >> 3) + 16 * i;
    const bool ok = m0 + r < M;
    cp16(tile + r * 128 + j * 16, ok ? src + (size_t)(m0 + r) * C + n0 + 8 * j : src, ok);
  }
}

// Runs the k-steps of `ld` (ld.load(ks, a_tile, b_tile) issues step ks's
// copies, each thread 4 chunks of each tile: row (tid >> 3) + 16 i, chunk
// tid & 7). With DUAL, steps [0, nfirst) go into acc0 and the rest into acc1;
// otherwise all into acc0. Ends with the ring drained and the block synced, so
// the caller may reuse it.
template <int TA, int TB, bool DUAL, class Ld>
__device__ __forceinline__ void mainloop(const Ld& ld, int nk, int nfirst, uint32_t ring,
                                         float (&acc0)[32], float (&acc1)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc0[i] = 0.f;
    if (DUAL) acc1[i] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < nk) ld.load(s, ring + s * kSlotBytes, ring + s * kSlotBytes + kTileBytes);
    cp_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_wait<kStages - 3>();  // step ks has landed (this thread's copies)
    fence_async_smem();
    __syncthreads();         // ... everyone's; and step ks - 2's wgmma is done, its slot free
    const int nx = ks + kStages - 2;
    if (nx < nk) {
      const uint32_t slot = ring + (nx % kStages) * kSlotBytes;
      ld.load(nx, slot, slot + kTileBytes);
    }
    cp_commit();
    const uint32_t a = ring + (ks % kStages) * kSlotBytes, b = a + kTileBytes;
    fence_acc(acc0);
    if (DUAL) fence_acc(acc1);
    wg_fence();
    if (!DUAL || ks < nfirst) {
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s)
        wgmma_m64n64k16<TA, TB>(acc0, tile_desc<TA>(a, s), tile_desc<TB>(b, s));
    } else {
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s)
        wgmma_m64n64k16<TA, TB>(acc1, tile_desc<TA>(a, s), tile_desc<TB>(b, s));
    }
    wg_commit();
    wg_wait<1>();  // step ks - 1's products are done; step ks's may run on
    fence_acc(acc0);
    if (DUAL) fence_acc(acc1);
  }
  wg_wait<0>();
  fence_acc(acc0);
  if (DUAL) fence_acc(acc1);
  cp_wait<0>();
  __syncthreads();
}

// Row and column of accumulator element d[4 j + 2 i + c]: row 16 w + lane / 4
// + 8 i, column 8 j + 2 (lane % 4) + c (w the warp, lane its lane).
__device__ __forceinline__ int acc_row() { return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2); }
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x & 3); }

// The accumulator into an fp32 staging tile st[64][kLdS].
__device__ __forceinline__ void stage_acc(const float (&d)[32], float* st) {
  const int r = acc_row(), c = acc_col();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(st + r * kLdS + 8 * j + c) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(st + (r + 8) * kLdS + 8 * j + c) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// --- loaders -----------------------------------------------------------------

// One convolution's k-steps into a 64-row tile: 64 channels of one tap per
// step, over the taps that reach some row of the tile (a tap off the edge for
// every row, or a stride-2 transposed conv's tap that does not divide, is
// skipped). taps: up to six tap indices, 3 bits each. up: the source is read
// through the nearest x2 upsample (src_pos<TRANS, true>); a transposed one
// then has two steps per weight tap, t = 2 * tap + half.
struct ConvSeg {
  const bf16* src;
  const bf16* w;
  ConvGeom g;
  int taps;
  int nsteps;
  bool up;
  int kshift;  // log2 of the k-steps per tap (Csrc / 64), or -1 if not a power of 2
};

template <bool TRANS>
__device__ __forceinline__ int seg_pos(const ConvSeg& s, int l, int t) {
  return s.up ? src_pos<TRANS, true>(l, t, s.g) : src_pos<TRANS, false>(l, t, s.g);
}

template <bool TRANS>
__device__ __forceinline__ ConvSeg make_seg(const bf16* src, const bf16* w, const ConvGeom& g, int m0,
                                            bool up = false) {
  const int kpt = g.Csrc / kBK;
  ConvSeg s{src, w, g, 0, 0, up, (kpt & (kpt - 1)) ? -1 : __ffs(kpt) - 1};
  const int M = g.Lout * g.B;
  const int lo = m0 / g.B, hi = min(m0 + kBM - 1, M - 1) / g.B;
  int n = 0;
  for (int t = 0; t < (TRANS && up ? 2 * g.taps : g.taps); ++t) {
    bool any = false;
    for (int l = lo; l <= hi && !any; ++l) any = seg_pos<TRANS>(s, l, t) >= 0;
    if (any) s.taps |= t << (3 * n++);
  }
  s.nsteps = n * (g.Csrc / kBK);
  return s;
}

// Implicit-GEMM convolution, one or two of them (the second, s1, has
// s1.nsteps == 0 when absent), into output rows [m0, m0 + 64) and columns
// [n0, n0 + 64). A (K-major): the gathered source rows. B: w[t][c][n]
// (MN-major) or, TRANS, w[t][n][c] (K-major). Both convolutions have the
// same Lout, B and N.
template <bool TRANS>
struct ConvLoader {
  ConvSeg s0, s1;
  int n0;
  int row_l[4], row_b[4];  // this thread's A rows: position and batch index; l = -1 past M

  __device__ __forceinline__ ConvLoader(const ConvSeg& a, const ConvSeg& b, int m0, int n0_) : s0(a), s1(b), n0(n0_) {
    const int M = a.g.Lout * a.g.B;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + (threadIdx.x >> 3) + 16 * i;
      row_l[i] = m < M ? m / a.g.B : -1;
      row_b[i] = m < M ? m - row_l[i] * a.g.B : 0;
    }
  }
  __device__ __forceinline__ int steps() const { return s0.nsteps + s1.nsteps; }

  __device__ __forceinline__ void load(int ks, uint32_t a, uint32_t b) const {
    const bool second = ks >= s0.nsteps;
    const ConvSeg s = second ? s1 : s0;  // a copy: a reference puts the loader in local memory
    const int k = second ? ks - s0.nsteps : ks;
    const int kpt = s.g.Csrc / kBK;
    const int ti = s.kshift >= 0 ? k >> s.kshift : k / kpt;  // no division per step
    const int t = (s.taps >> (3 * ti)) & 7;
    const int wt = TRANS && s.up ? t >> 1 : t;  // the weight tap
    const int c0 = (k - ti * kpt) * kBK;
    const int j = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 16 * i;
      const int p = row_l[i] >= 0 ? seg_pos<TRANS>(s, row_l[i], t) : -1;
      const bf16* pa = p >= 0 ? s.src + ((size_t)(p * s.g.B + row_b[i]) * s.g.Csrc + c0 + 8 * j) : s.src;
      cp16(swz(a, r, j), pa, p >= 0);
      const bf16* pb = TRANS ? s.w + ((size_t)(wt * s.g.N + n0 + r) * s.g.Csrc + c0 + 8 * j)
                             : s.w + ((size_t)(wt * s.g.Csrc + c0 + r) * s.g.N + n0 + 8 * j);
      cp16(swz(b, r, j), pb, true);
    }
  }
};

// n / d for n < 2^31 by a multiply and a shift (d fixed per launch): the
// loaders' per-step row arithmetic without a division.
struct FastDiv {
  unsigned d, magic, shift;
  __host__ __device__ explicit FastDiv(unsigned d_ = 1) : d(d_), shift(0) {
    while ((1u << shift) < d) ++shift;
    magic = (unsigned)((((1ull << 32) * ((1ull << shift) - d)) / d) + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, magic) + (unsigned)n) >> shift);
  }
};

// Weight gradient tile: dW[t][i0 + i][n0 + n] over rows [r0, r1) of
// dc [Lout*B, N], against the tap-t gather of x [Lsrc, B, Csrc] (up: of its
// x2 upsample). Both operands MN-major: a k-step is 64 rows m, each 64
// channels of x and dc.
struct WgradLoader {
  const bf16* x;
  const bf16* dc;
  ConvGeom g;
  int t, i0, n0, r0, r1;
  bool up;
  FastDiv divB;  // by g.B

  __device__ __forceinline__ int steps() const { return (r1 - r0 + kBK - 1) / kBK; }

  __device__ __forceinline__ void load(int ks, uint32_t a, uint32_t b) const {
    const int j = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 16 * i;
      const int m = r0 + ks * kBK + r;
      const bool ok = m < r1;
      const int l = divB.div(m), bi = m - l * g.B;
      const int p = !ok ? -1 : up ? src_pos<false, true>(l, t, g) : src_pos<false>(l, t, g);
      cp16(swz(a, r, j), p >= 0 ? x + ((size_t)(p * g.B + bi) * g.Csrc + i0 + 8 * j) : x, p >= 0);
      cp16(swz(b, r, j), ok ? dc + ((size_t)m * g.N + n0 + 8 * j) : dc, ok);
    }
  }
};

// --- fixed-order column sums across a grid --------------------------------------

constexpr int kGroup = 16;  // m-tiles per first-level group

// In-order sum over rows [beg, end) of p[row * stride], NQ quantities q at
// p + q * C; loads issued 8 rows ahead of the adds.
template <int NQ>
__device__ __forceinline__ void sum_rows(const float* p, int beg, int end, int stride, int C,
                                         float (&acc)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
  for (int i = beg; i < end; i += 8) {
    float v[8][NQ];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        v[k][q] = i + k < end ? __ldcg(p + (size_t)(i + k) * stride + q * C) : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (i + k < end) acc[q] += v[k][q];
  }
}

// Masked moments of a set of rows, (count, sum, M2 about its own mean), 3
// floats per statistic. Chan's merge of b into a; a set with count 0 merges as
// nothing.
__device__ __forceinline__ void merge_moments(float* a, const float* b) {
  if (b[0] == 0.f) return;
  if (a[0] == 0.f) {
    a[0] = b[0], a[1] = b[1], a[2] = b[2];
    return;
  }
  const float n = a[0] + b[0];
  const float d = b[1] / b[0] - a[1] / a[0];
  a[2] = a[2] + b[2] + d * d * (a[0] * b[0] / n);
  a[1] += b[1];
  a[0] = n;
}

// The reductions finish_cols takes: each reduces rows [beg, end) of a
// [rows][NQ][C] array at column n0 + (tid & 63), two threads per column
// (halves in order), into `out` of threads tid < 64.
// Sum: in-order sums of NQ quantities.
template <int NQ_>
struct SumRows {
  static constexpr int NQ = NQ_;
  __device__ static void reduce(const float* p, int beg, int end, int C, int n0, float (&out)[NQ],
                                float (*red)[64]) {
    const int c = threadIdx.x & 63, h = threadIdx.x >> 6;
    const int mid = beg + (end - beg + 1) / 2;
    float acc[NQ];
    sum_rows<NQ>(p + n0 + c, h ? mid : beg, h ? end : mid, NQ * C, C, acc);
    if (h) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) red[q][c] = acc[q];
    }
    __syncthreads();
    if (!h) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) out[q] = acc[q] + red[q][c];
    }
    __syncthreads();
  }
};
// Moments: NS statistics' (count, sum, M2), merged in order.
template <int NS>
struct MomentRows {
  static constexpr int NQ = 3 * NS;
  __device__ static void reduce(const float* p, int beg, int end, int C, int n0, float (&out)[NQ],
                                float (*red)[64]) {
    const int c = threadIdx.x & 63, h = threadIdx.x >> 6;
    const int mid = beg + (end - beg + 1) / 2;
    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
    const float* col = p + n0 + c;
    for (int i = h ? mid : beg, e = h ? end : mid; i < e; i += 8) {  // loads 8 rows ahead of the merges
      float v[8][NQ];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int q = 0; q < NQ; ++q) v[k][q] = i + k < e ? __ldcg(col + (size_t)(i + k) * NQ * C + q * C) : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int st = 0; st < NS; ++st) merge_moments(acc + 3 * st, v[k] + 3 * st);  // a row past e has count 0
    }
    if (h) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) red[q][c] = acc[q];
    }
    __syncthreads();
    if (!h) {
      float other[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) other[q] = red[q][c];
#pragma unroll
      for (int st = 0; st < NS; ++st) merge_moments(acc + 3 * st, other + 3 * st);
#pragma unroll
      for (int q = 0; q < NQ; ++q) out[q] = acc[q];
    }
    __syncthreads();
  }
};

// Column reductions over a grid's m-tiles, in a fixed order, by the blocks
// that finish last. Each block has written row mt of part [mtiles][NQ][C]
// (its tile's partials, columns n0 + [0, 64) of n-tile nt) before the call.
// The last block of each group of kGroup m-tiles reduces the group in order
// into gpart [groups][NQ][C]; the last group's finisher reduces the groups in
// order and returns true, with out[q] the result of column n0 + tid in
// threads tid < 64. Tickets tk [(groups + 1) * ntiles] are integers: zero on
// entry, and the finishers set them back to zero.
template <class Red>
__device__ bool finish_cols(float* part, float* gpart, unsigned* tk, int mt, int mtiles, int nt, int ntiles,
                            int C, int n0, float (&out)[Red::NQ]) {
  constexpr int NQ = Red::NQ;
  __shared__ float red[NQ][kBN];
  __shared__ unsigned last;
  const int groups = (mtiles + kGroup - 1) / kGroup;
  const int g = mt / kGroup;
  const int gbeg = g * kGroup, gend = min(mtiles, gbeg + kGroup);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tk[g * ntiles + nt], 1u) == (unsigned)(gend - gbeg - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  if (threadIdx.x == 0) tk[g * ntiles + nt] = 0u;
  float s[NQ];
  Red::reduce(part, gbeg, gend, C, n0, s, red);
  if (threadIdx.x < kBN) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) gpart[((size_t)g * NQ + q) * C + n0 + threadIdx.x] = s[q];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tk[groups * ntiles + nt], 1u) == (unsigned)(groups - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  if (threadIdx.x == 0) tk[groups * ntiles + nt] = 0u;
  Red::reduce(gpart, 0, groups, C, n0, out, red);
  return true;
}

template <int NQ>
__device__ bool finish_col_sums(float* part, float* gpart, unsigned* tk, int mt, int mtiles, int nt,
                                int ntiles, int C, int n0, float (&out)[NQ]) {
  return finish_cols<SumRows<NQ>>(part, gpart, tk, mt, mtiles, nt, ntiles, C, n0, out);
}

// --- epilogues -------------------------------------------------------------------

// The epilogues run one column per thread pair: column c = tid & 63 of the
// tile, rows [32 h, 32 h + 32) for h = tid >> 6; row sums combine the halves
// in order.
__device__ __forceinline__ int ep_col() { return threadIdx.x & 63; }
__device__ __forceinline__ int ep_row0() { return (threadIdx.x >> 6) * 32; }

// Writes row mt of part [mtiles][NQ][C] from the thread pairs' sums s.
template <int NQ>
__device__ __forceinline__ void write_tile_sums(const float (&s)[NQ], float* part, int mt, int C, int n) {
  __shared__ float red[NQ][kBN];
  const int c = ep_col();
  if (threadIdx.x >= 64) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) red[q][c] = s[q];
  }
  __syncthreads();
  if (threadIdx.x < 64) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) part[((size_t)mt * NQ + q) * C + n] = s[q] + red[q][c];
  }
}

// The mask of a tile's rows m0 + r (mask[row % B], 0 past M) into msk[64];
// the caller syncs before reading it.
__device__ __forceinline__ void tile_mask(const float* mask, int m0, int M, int B, float* msk) {
  if (threadIdx.x < kBM) msk[threadIdx.x] = m0 + threadIdx.x < M ? mask[(m0 + threadIdx.x) % B] : 0.f;
}

// The tile's masked moments of fp32 staging tile st's column ep_col(), rows
// m0 + r < M with mask msk[r] (tile_mask): (count, sum, M2 about the tile's
// own mean), in every thread's out[0..2]. The mean is taken first, then the
// squares about it, as the plain version's two passes.
__device__ __forceinline__ void tile_moments(const float* st, const float* msk, int m0, int M, float (&out)[3]) {
  __shared__ float red[2][2][kBN];
  const int c = ep_col(), h = threadIdx.x >> 6, r0 = ep_row0();
  float n = 0.f, s = 0.f;
  for (int r = r0; r < r0 + 32 && m0 + r < M; ++r) {
    n += msk[r];
    s = __fadd_rn(s, __fmul_rn(st[r * kLdS + c], msk[r]));
  }
  red[0][h][c] = n, red[1][h][c] = s;
  __syncthreads();
  n = red[0][0][c] + red[0][1][c];
  s = red[1][0][c] + red[1][1][c];
  const float mean = n > 0.f ? s / n : 0.f;
  float m2 = 0.f;
  for (int r = r0; r < r0 + 32 && m0 + r < M; ++r) {
    const float d = __fsub_rn(st[r * kLdS + c], mean);
    m2 = __fadd_rn(m2, __fmul_rn(__fmul_rn(d, d), msk[r]));
  }
  __syncthreads();
  red[0][h][c] = m2;
  __syncthreads();
  out[0] = n, out[1] = s, out[2] = red[0][0][c] + red[0][1][c];
  __syncthreads();
}

// (mean, var, inv) of the merged moments into st [3, C] at column n.
__device__ __forceinline__ void write_stats(const float* mom, float* st, int C, int n) {
  const float var = mom[2] / mom[0];
  st[n] = mom[1] / mom[0];
  st[C + n] = var;
  st[2 * C + n] = 1.f / sqrtf(var + blocks::kEps);
}

// A forward conv's output: fp32 c [M, C], the bias [C] added before the
// statistics (or null), and its BatchNorm statistics st [3, C].
struct ConvOut {
  float* c;
  const float* bias;
  float* st;
};

// The grid of a forward conv's statistics over [M, C]: row m's mask is
// mask[m % B]; part [mtiles][3 NS][C], gpart [groups][3 NS][C] and the
// tickets tk as finish_cols takes them.
struct MomentGrid {
  const float* mask;
  int B, M, C, mtiles, ntiles;
  float *part, *gpart;
  unsigned* tk;
};

// The epilogue of NS forward convs of one tile (NS = 2: the shortcut's in a
// second accumulator), staged in st (conv q at st + q * kBM * kLdS; the
// block syncs here before reading it): adds
// out[q].bias, writes out[q].c and each tile's masked moments (count, sum,
// and the squares about the tile's own mean); the blocks that finish last
// merge every tile's moments in a fixed order (Chan's formula) into
// out[q].st. A tile whose rows are all padding has count 0 and merges as
// nothing, so the padded rows reach no statistic, and the count is the
// masked rows of M by itself. Returns true in the threads tid < 64 of the
// last finisher.
template <int NS>
__device__ bool conv_stats_epilogue(float* st, const ConvOut* out, const MomentGrid& g, int mt, int nt) {
  __shared__ float msk[kBM];
  const int m0 = mt * kBM, n0 = nt * kBN, c = ep_col(), n = n0 + c;
  tile_mask(g.mask, m0, g.M, g.B, msk);
  float bias[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) bias[q] = out[q].bias ? out[q].bias[n] : 0.f;
  __syncthreads();  // the staging tiles and msk
  for (int r = ep_row0(); r < ep_row0() + 32 && m0 + r < g.M; ++r) {
#pragma unroll
    for (int q = 0; q < NS; ++q) {  // this thread's own entries, which tile_moments reads back
      float* v = st + q * kBM * kLdS + r * kLdS + c;
      if (out[q].bias) *v = __fadd_rn(*v, bias[q]);
      out[q].c[(size_t)(m0 + r) * g.C + n] = *v;
    }
  }
  float mom[3 * NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    float m3[3];
    tile_moments(st + q * kBM * kLdS, msk, m0, g.M, m3);
    mom[3 * q] = m3[0], mom[3 * q + 1] = m3[1], mom[3 * q + 2] = m3[2];
  }
  if (threadIdx.x < 64) {
#pragma unroll
    for (int q = 0; q < 3 * NS; ++q) g.part[((size_t)mt * 3 * NS + q) * g.C + n] = mom[q];
  }
  float tot[3 * NS];
  if (!finish_cols<MomentRows<NS>>(g.part, g.gpart, g.tk, mt, g.mtiles, nt, g.ntiles, g.C, n0, tot) ||
      threadIdx.x >= 64)
    return false;
#pragma unroll
  for (int q = 0; q < NS; ++q) write_stats(tot + 3 * q, out[q].st, g.C, n);
  return true;
}

// BatchNorm's backward, dc = bf16((gamma * inv) * (dy - (m / n) * (dbeta + xh * dgamma))).
__device__ __forceinline__ bf16 bn_dx1(float dy, float xh, float gi, float mn, float dbeta, float dgamma) {
  return to_bf(__fmul_rn(gi, __fsub_rn(dy, __fmul_rn(mn, __fadd_rn(dbeta, __fmul_rn(xh, dgamma))))));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The forwards' elementwise passes, 8 entries per thread: out =
// bf16(lrelu(bn(c))), or (OUT) the block's output bf16(lrelu(bn(c) + (cs ?
// bn_s(cs) : x))). st, sts are [3, C] rows (mean, var, inv).
template <bool OUT>
__global__ void __launch_bounds__(kEwThreads)
fwd_act8_kernel(const float* __restrict__ c, const float* __restrict__ st, const float* __restrict__ g,
                const float* __restrict__ b, const float* __restrict__ cs, const float* __restrict__ sts,
                const float* __restrict__ gs, const float* __restrict__ bs, const bf16* __restrict__ x, int C,
                int total, bf16* __restrict__ out) {
  const int base = (blockIdx.x * kEwThreads + threadIdx.x) * 8;
  if (base >= total) return;
  const int k = base % C;
  float v[8], mu[8], inv[8], gm[8], bt[8], a[8];
  load8(c + base, v);
  load8(st + k, mu);
  load8(st + 2 * C + k, inv);
  load8(g + k, gm);
  load8(b + k, bt);
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] = blocks::bn_affine(v[e], mu[e], inv[e], gm[e], bt[e]);
  if (OUT && cs) {
    load8(cs + base, v);
    load8(sts + k, mu);
    load8(sts + 2 * C + k, inv);
    load8(gs + k, gm);
    load8(bs + k, bt);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = __fadd_rn(a[e], blocks::bn_affine(v[e], mu[e], inv[e], gm[e], bt[e]));
  } else if (OUT) {  // stride 1 and C_in == C_out: x's entry i is the output's
    const uint4 xv = *reinterpret_cast<const uint4*>(x + base);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = __fadd_rn(a[e], bf(xe[e]));
  }
  uint4 ov;
  bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = to_bf(blocks::lrelu(a[e]));
  *reinterpret_cast<uint4*>(out + base) = ov;
}

// BatchNorm's backward over [M, C], 8 entries per thread; TWO: a second
// BatchNorm on the same dy (the shortcut's).
struct BnDx {
  const bf16* xh;
  const float *gamma, *st, *dgamma, *dbeta;
  bf16* dc;
};

template <bool TWO>
__global__ void __launch_bounds__(kEwThreads)
bn_dx8_kernel(const bf16* __restrict__ dy, BnDx p, BnDx q, const float* __restrict__ mask,
              const float* __restrict__ n_ptr, int B, int C, int total) {
  const int base = (blockIdx.x * kEwThreads + threadIdx.x) * 8;
  if (base >= total) return;
  const int m = base / C, c = base - m * C;
  const float mn = mask[m % B] / n_ptr[0];
  const uint4 dv = *reinterpret_cast<const uint4*>(dy + base);
  const bf16* d = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
  for (int k = 0; k < (TWO ? 2 : 1); ++k) {
    const BnDx& b = k ? q : p;
    const uint4 hv = *reinterpret_cast<const uint4*>(b.xh + base);
    const bf16* h = reinterpret_cast<const bf16*>(&hv);
    float gm[8], inv[8], dbt[8], dgm[8];
    load8(b.gamma + c, gm);
    load8(b.st + 2 * C + c, inv);
    load8(b.dbeta + c, dbt);
    load8(b.dgamma + c, dgm);
    uint4 ov;
    bf16* o = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = bn_dx1(bf(d[e]), bf(h[e]), __fmul_rn(gm[e], inv[e]), mn, dbt[e], dgm[e]);
    *reinterpret_cast<uint4*>(b.dc + base) = ov;
  }
}

// --- weight gradients ------------------------------------------------------------

// Split-K of a weight gradient over M rows: about 264 jobs, each at least 8
// whole k-steps.
struct Split {
  int rows, splits, jobs;
};
inline Split wgrad_split(int M, int Ci, int Co, int taps) {
  const int tiles = taps * (Ci / kBM) * (Co / kBN);
  const int ktiles = cdiv(M, kBK);
  const int want = std::max(1, std::min(cdiv(ktiles, 8), cdiv(264, tiles)));
  const int rows = cdiv(ktiles, want) * kBK;
  const int splits = cdiv(M, rows);
  return Split{rows, splits, splits * tiles};
}

// A split-K weight-gradient job j of a grid (n-tiles fastest, then input
// channel tiles, taps, splits): its fp32 partial into part [splits][taps][Ci][Co].
// up: x is read through the x2 upsample.
__device__ __forceinline__ void wgrad_job(unsigned char* dyn, const bf16* x, const bf16* dc,
                                          const ConvGeom& g, const Split& sp, int j, float* part,
                                          bool up = false) {
  const int tn = g.N / kBN, ti = g.Csrc / kBM;
  const int n0 = (j % tn) * kBN;
  j /= tn;
  const int i0 = (j % ti) * kBM;
  j /= ti;
  const int t = j % g.taps, s = j / g.taps;
  const int M = g.Lout * g.B;
  const WgradLoader ld{x, dc, g, t, i0, n0, s * sp.rows, min(M, (s + 1) * sp.rows), up, FastDiv(g.B)};
  float acc[32], unused[32];
  mainloop<1, 1, false>(ld, ld.steps(), ld.steps(), ring_base(dyn), acc, unused);
  float* base = part + ((size_t)(s * g.taps + t) * g.Csrc + i0) * g.N + n0;
  const int r = acc_row(), c = acc_col();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    *reinterpret_cast<float2*>(base + (size_t)r * g.N + 8 * k + c) = make_float2(acc[4 * k], acc[4 * k + 1]);
    *reinterpret_cast<float2*>(base + (size_t)(r + 8) * g.N + 8 * k + c) =
        make_float2(acc[4 * k + 2], acc[4 * k + 3]);
  }
}

// dw = sum over splits of the partials, in order, for up to three weights.
struct WgradSum {
  const float* part;
  int splits, n;
  float* dw;
};

__global__ void __launch_bounds__(kEwThreads) wgrad_sum3_kernel(WgradSum a, WgradSum b, WgradSum c) {
  int i = blockIdx.x * kEwThreads + threadIdx.x;
  WgradSum w = a;
  if (i >= a.n) {
    i -= a.n;
    w = b;
    if (i >= b.n) {
      i -= b.n;
      w = c;
      if (i >= c.n) return;
    }
  }
  float s = 0.f;
  int k = 0;
  for (; k + 4 <= w.splits; k += 4) {  // four loads in flight, added in order
    const float a0 = w.part[(size_t)k * w.n + i], a1 = w.part[(size_t)(k + 1) * w.n + i];
    const float a2 = w.part[(size_t)(k + 2) * w.n + i], a3 = w.part[(size_t)(k + 3) * w.n + i];
    s = (((s + a0) + a1) + a2) + a3;
  }
  for (; k < w.splits; ++k) s += w.part[(size_t)k * w.n + i];
  w.dw[i] = s;
}

// --- launches --------------------------------------------------------------------

// A GEMM kernel of kThreads whose epilogue reads `ep_tiles` input tiles kept
// in shared memory; its one argument is the entry point's argument struct.
template <class K, class Args>
int gemm_launch(K kernel, dim3 grid, int ep_tiles, const Args& args, cudaStream_t s) {
  const int smem = smem_bytes(ep_tiles);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, kThreads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
