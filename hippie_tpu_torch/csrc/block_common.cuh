// Primitives of the fused BasicBlock kernels, for sm_90a.
//
// Shared by the encoder block (enc_block.cu) and the decoder block (dec_block.cu).
// Activations are bf16 [L, B, C] (length leading, as hippie_tpu's
// pallas_blocks.py keeps them), so a conv's GEMM view is [L*B, C] row-major
// and a conv tap is a shift of B rows. Weights are bf16 [taps, C_in, C_out].
//
//   conv_gemm    implicit-GEMM conv: M = L_out*B rows, K = taps*C_src,
//                N = C_out, bf16 operands (wmma 16x16x16), fp32 accumulator,
//                fp32 output. The forward gathers row l*stride + t - pad; the
//                transposed conv (input gradient) gathers row (l + pad - t) /
//                stride where that divides, and reads w[t] transposed. Zero
//                padding comes from the loader's bounds; rows past M are
//                masked in the epilogue. With UP (the decoder's ResizeConv1d)
//                the forward reads its source through a nearest x2 upsample,
//                row (l + t - pad) >> 1, and adds a per-channel bias.
//   wgrad_gemm   weight gradient dW[t] = X_t^T dC: the reduction runs over
//                the M = L_out*B rows, cut into fixed split-K ranges; each
//                range writes its own partial and wgrad_final sums the
//                partials in a fixed order. UP gathers X as conv_gemm does.
//   col_*        per-channel sums over the M rows (masked mean, centred
//                variance, and BatchNorm's backward sums): fixed row chunks
//                write partials, a final pass sums them in a fixed order.
//   bn_dx        BatchNorm's backward elementwise pass.
//   col_sum      unmasked per-channel sums of a bf16 [M, C] (a conv bias's
//                gradient), partials then a fixed-order final pass.
//   pair_*       the backward of the x2 upsample: rows 2l and 2l + 1 of a
//                float32 [2L*B, C] summed in float32 inside the pass that
//                consumes them.
//
// No float atomics anywhere: every sum has a fixed shape, so repeated runs
// give the same bits. Every launch is on the caller's stream; the launchers
// return cudaGetLastError() after each launch.
//
// What bounds these at the encoder's shapes (B=512, M from 12,800 down to
// 2,048 rows, C 64..512): the GEMMs are operations-bound on paper (a block's
// forward is 0.8-5.6 GFLOP against activations of at most 1.6 MB), but at
// this size a launch is short and the card is far from full, so the
// sequence of launches and their latency bound it in practice. The tiles are
// small (64x64) so that even the narrowest GEMM (N = 64) has 200 blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstddef>
#include <type_traits>

namespace blocks {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;

constexpr int kBM = 64;   // GEMM tile rows
constexpr int kBN = 64;   // GEMM tile columns
constexpr int kBK = 32;   // GEMM tile depth
constexpr int kGemmThreads = 128;  // 4 warps, 2x2, each 32x32
constexpr int kPadH = 8;  // bf16 row padding of the shared tiles (16 bytes)
constexpr int kPadF = 4;  // float row padding of the output staging tile

constexpr int kColX = 32;  // columns per column-sum block
constexpr int kColY = 8;   // row lanes per column-sum block
constexpr int kEwThreads = 256;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float lrelu(float a) { return a >= 0.f ? a : __fmul_rn(a, kSlope); }
__device__ __forceinline__ float dlrelu(float a) { return a >= 0.f ? 1.f : kSlope; }

// g * ((c - mu) * inv) + b, in the plain version's order and without FMA contraction.
__device__ __forceinline__ float bn_affine(float c, float mu, float inv, float g, float b) {
  return __fadd_rn(__fmul_rn(g, __fmul_rn(__fsub_rn(c, mu), inv)), b);
}

struct ConvGeom {
  int Lsrc;    // length of the gathered operand
  int Lout;    // output rows are Lout * B
  int B;
  int Csrc;    // channels of the gathered operand: K per tap
  int N;       // output channels
  int taps, stride, pad;
};

// Source position that output position l reads through tap t, or -1. UP: the
// source of length Lsrc is read as its nearest x2 upsample, of length 2*Lsrc.
template <bool TRANS, bool UP = false>
__device__ __forceinline__ int src_pos(int l, int t, const ConvGeom& g) {
  if (UP) {
    const int p = l * g.stride + t - g.pad;
    return (p >= 0 && p < 2 * g.Lsrc) ? p >> 1 : -1;
  }
  if (!TRANS) {
    const int p = l * g.stride + t - g.pad;
    return (p >= 0 && p < g.Lsrc) ? p : -1;
  }
  const int num = l + g.pad - t;
  if (num < 0 || num % g.stride) return -1;
  const int p = num / g.stride;
  return p < g.Lsrc ? p : -1;
}

// out[m, n] = sum_{t, c} src[pos(m, t), b(m), c] * W(t, c, n), fp32 [Lout*B, N].
// W(t, c, n) = w[t][c][n] (forward, w [taps, Csrc, N]) or w[t][n][c]
// (TRANS, w [taps, N, Csrc]). Needs Csrc % 32 == 0 and N % 64 == 0. UP (not
// with TRANS): upsampled source, and out[m, n] += bias[n] after the sum.
template <bool TRANS, bool UP = false>
__global__ void __launch_bounds__(kGemmThreads)
conv_gemm_kernel(const bf16* __restrict__ src, const bf16* __restrict__ w,
                 float* __restrict__ out, ConvGeom g, const float* __restrict__ bias) {
  static_assert(!(TRANS && UP), "the upsampled conv has no transposed form here");
  constexpr int kLdA = kBK + kPadH;                    // As[m][k]
  constexpr int kLdB = TRANS ? kBK + kPadH : kBN + kPadH;  // Bs[n][k] or Bs[k][n]
  constexpr int kBRows = TRANS ? kBN : kBK;
  constexpr int kLdC = kBN + kPadF;
  __shared__ __align__(128) bf16 As[kBM * kLdA];
  __shared__ __align__(128) bf16 Bs[kBRows * kLdB];
  __shared__ __align__(128) float Cs[kBM * kLdC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int M = g.Lout * g.B;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int nk = g.taps * g.Csrc / kBK;

  uint4 ra[2], rb[2];  // each thread carries 2 16-byte pieces of A and 2 of B

  auto load = [&](int kt) {
    const int k0 = kt * kBK;
    const int t = k0 / g.Csrc;
    const int c0 = k0 - t * g.Csrc;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      const int row = idx >> 2, part = idx & 3;  // 64 rows x 4 pieces of 8
      const int m = m0 + row;
      ra[j] = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const int l = m / g.B, b = m - l * g.B;
        const int p = src_pos<TRANS, UP>(l, t, g);
        if (p >= 0)
          ra[j] = *reinterpret_cast<const uint4*>(src + ((size_t)p * g.B + b) * g.Csrc + c0 + part * 8);
      }
      if (!TRANS) {  // rows k of w[t][c0 + k][n0 ...]: 32 rows x 8 pieces
        const int kr = idx >> 3, pc = idx & 7;
        rb[j] = *reinterpret_cast<const uint4*>(
            w + ((size_t)t * g.Csrc + c0 + kr) * g.N + n0 + pc * 8);
      } else {       // rows n of w[t][n0 + n][c0 ...]: 64 rows x 4 pieces
        const int nr = idx >> 2, pc = idx & 3;
        rb[j] = *reinterpret_cast<const uint4*>(
            w + ((size_t)t * g.N + n0 + nr) * g.Csrc + c0 + pc * 8);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      *reinterpret_cast<uint4*>(As + (idx >> 2) * kLdA + (idx & 3) * 8) = ra[j];
      if (!TRANS) {
        *reinterpret_cast<uint4*>(Bs + (idx >> 3) * kLdB + (idx & 7) * 8) = rb[j];
      } else {
        *reinterpret_cast<uint4*>(Bs + (idx >> 2) * kLdB + (idx & 3) * 8) = rb[j];
      }
    }
  };

  using BLayout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], TRANS ? Bs + n * kLdB + kk : Bs + kk * kLdB + n, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kBM * (kBN / 4); idx += kGemmThreads) {
    const int row = idx / (kBN / 4), part = idx % (kBN / 4);
    const int m = m0 + row;
    if (m < M) {
      float4 v = *reinterpret_cast<const float4*>(Cs + row * kLdC + part * 4);
      if (UP) {
        const float* bn = bias + n0 + part * 4;
        v = make_float4(__fadd_rn(v.x, bn[0]), __fadd_rn(v.y, bn[1]), __fadd_rn(v.z, bn[2]),
                        __fadd_rn(v.w, bn[3]));
      }
      *reinterpret_cast<float4*>(out + (size_t)m * g.N + n0 + part * 4) = v;
    }
  }
}

// Partial weight gradients: part[s][t][ci][co] = sum over rows m of split s of
// x[pos(m, t), b(m), ci] * dc[m, co]. grid (Ci/64, Co/64, taps * splits).
template <bool UP = false>
__global__ void __launch_bounds__(kGemmThreads)
wgrad_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dc,
                  float* __restrict__ part, ConvGeom g, int rows_per_split) {
  // g: Lsrc = L of x, Lout = rows of dc / B, Csrc = Ci, N = Co
  constexpr int kLd = kBM + kPadH;  // As[k][i] (col-major A^T), Bs[k][n]
  __shared__ __align__(128) bf16 As[kBK * kLd];
  __shared__ __align__(128) bf16 Bs[kBK * kLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int M = g.Lout * g.B;
  const int i0 = blockIdx.x * kBM;  // input channel tile
  const int n0 = blockIdx.y * kBN;  // output channel tile
  const int t = blockIdx.z % g.taps;
  const int s = blockIdx.z / g.taps;
  const int r0 = s * rows_per_split;
  const int r1 = min(M, r0 + rows_per_split);
  const int nk = (r1 - r0 + kBK - 1) / kBK;

  uint4 ra[2], rb[2];
  auto load = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      const int kr = idx >> 3, pc = idx & 7;  // 32 rows x 8 pieces of 8
      const int m = r0 + kt * kBK + kr;
      ra[j] = make_uint4(0, 0, 0, 0);
      rb[j] = make_uint4(0, 0, 0, 0);
      if (m < r1) {
        const int l = m / g.B, b = m - l * g.B;
        const int p = src_pos<false, UP>(l, t, g);
        if (p >= 0)
          ra[j] = *reinterpret_cast<const uint4*>(x + ((size_t)p * g.B + b) * g.Csrc + i0 + pc * 8);
        rb[j] = *reinterpret_cast<const uint4*>(dc + (size_t)m * g.N + n0 + pc * 8);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      *reinterpret_cast<uint4*>(As + (idx >> 3) * kLd + (idx & 7) * 8) = ra[j];
      *reinterpret_cast<uint4*>(Bs + (idx >> 3) * kLd + (idx & 7) * 8) = rb[j];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (nk > 0) load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * kLd + wm * 32 + i * 16, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLd + wn * 32 + j * 16, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* base = part + ((size_t)(s * g.taps + t) * g.Csrc) * g.N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(base + (size_t)(i0 + wm * 32 + i * 16) * g.N + n0 + wn * 32 + j * 16,
                              acc[i][j], g.N, wmma::mem_row_major);
}

// dw[i] = sum_s part[s][i], s in order.
__global__ void __launch_bounds__(kEwThreads)
wgrad_final_kernel(const float* __restrict__ part, int splits, int n, float* __restrict__ dw) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  dw[i] = s;
}

// --- column sums --------------------------------------------------------------

// Sum of the mask over B rows, in a fixed order, valid in every thread.
__device__ float block_mask_count(const float* __restrict__ mask, int B) {
  __shared__ float warp_sums[32];
  float s = 0.f;
  for (int i = threadIdx.x; i < B; i += blockDim.x) s += mask[i];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) total += warp_sums[k];
  return total;
}

// MODE 0: part[r][c] = sum m_b * v. MODE 1: sum m_b * (v - mean_c)^2.
// grid (C/32, chunks), block (32, 8).
template <int MODE>
__global__ void __launch_bounds__(kColX * kColY)
col_partial_kernel(const float* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ mean, int M, int B, int C, int rows_per_chunk,
                   float* __restrict__ part) {
  __shared__ float red[kColY][kColX + 1];
  const int c = blockIdx.x * kColX + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  const float mu = MODE == 1 ? mean[c] : 0.f;
  float acc = 0.f;
  for (int m = r0 + threadIdx.y; m < r1; m += kColY) {
    const float x = v[(size_t)m * C + c];
    const float w = mask[m % B];
    if (MODE == 0) {
      acc = __fadd_rn(acc, __fmul_rn(x, w));
    } else {
      const float d = __fsub_rn(x, mu);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(d, d), w));
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0) {
    float s = red[0][threadIdx.x];
    for (int y = 1; y < kColY; ++y) s += red[y][threadIdx.x];
    part[(size_t)blockIdx.y * C + c] = s;
  }
}

// n = sum(mask) * Lo. MODE 0: st[0][c] = sum / n. MODE 1: st[1][c] = var =
// sum / n, st[2][c] = 1 / sqrt(var + eps). st is [3, C].
template <int MODE>
__global__ void __launch_bounds__(kEwThreads)
col_final_kernel(const float* __restrict__ part, int chunks, int C, const float* __restrict__ mask,
                 int B, int Lo, float* __restrict__ st) {
  const float n = block_mask_count(mask, B) * (float)Lo;
  const int c = blockIdx.x * kEwThreads + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int r = 0; r < chunks; ++r) s += part[(size_t)r * C + c];
  if (MODE == 0) {
    st[c] = s / n;
  } else {
    const float var = s / n;
    st[C + c] = var;
    st[2 * C + c] = 1.f / sqrtf(var + kEps);
  }
}

// BatchNorm backward sums over every entry: part[r][c] = (sum dy*xh, sum dy).
__global__ void __launch_bounds__(kColX * kColY)
col_dsum_partial_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ xh, int M, int C,
                        int rows_per_chunk, float2* __restrict__ part) {
  __shared__ float2 red[kColY][kColX + 1];
  const int c = blockIdx.x * kColX + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float sg = 0.f, sb = 0.f;
  for (int m = r0 + threadIdx.y; m < r1; m += kColY) {
    const float d = bf(dy[(size_t)m * C + c]);
    sg = __fadd_rn(sg, __fmul_rn(d, bf(xh[(size_t)m * C + c])));
    sb = __fadd_rn(sb, d);
  }
  red[threadIdx.y][threadIdx.x] = make_float2(sg, sb);
  __syncthreads();
  if (threadIdx.y == 0) {
    float2 s = red[0][threadIdx.x];
    for (int y = 1; y < kColY; ++y) {
      s.x += red[y][threadIdx.x].x;
      s.y += red[y][threadIdx.x].y;
    }
    part[(size_t)blockIdx.y * C + c] = s;
  }
}

// dgamma[c], dbeta[c] from the partials; n_out[0] = sum(mask) * Lo.
__global__ void __launch_bounds__(kEwThreads)
col_dsum_final_kernel(const float2* __restrict__ part, int chunks, int C,
                      const float* __restrict__ mask, int B, int Lo, float* __restrict__ dgamma,
                      float* __restrict__ dbeta, float* __restrict__ n_out) {
  const float n = block_mask_count(mask, B) * (float)Lo;
  const int c = blockIdx.x * kEwThreads + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) n_out[0] = n;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int r = 0; r < chunks; ++r) {
    sg += part[(size_t)r * C + c].x;
    sb += part[(size_t)r * C + c].y;
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

// Unmasked column sums of a bf16 [M, C]: part[r][c] = sum of v over chunk r.
__global__ void __launch_bounds__(kColX * kColY)
col_sum_partial_kernel(const bf16* __restrict__ v, int M, int C, int rows_per_chunk,
                       float* __restrict__ part) {
  __shared__ float red[kColY][kColX + 1];
  const int c = blockIdx.x * kColX + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float acc = 0.f;
  for (int m = r0 + threadIdx.y; m < r1; m += kColY) acc = __fadd_rn(acc, bf(v[(size_t)m * C + c]));
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0) {
    float s = red[0][threadIdx.x];
    for (int y = 1; y < kColY; ++y) s += red[y][threadIdx.x];
    part[(size_t)blockIdx.y * C + c] = s;
  }
}

// dc = bf16((gamma * inv) * (dy - (m / n) * (dbeta + xh * dgamma))); st is [3, C].
__global__ void __launch_bounds__(kEwThreads)
bn_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ xh,
             const float* __restrict__ gamma, const float* __restrict__ st,
             const float* __restrict__ dgamma, const float* __restrict__ dbeta,
             const float* __restrict__ mask, const float* __restrict__ n_ptr, int B, int C,
             int total, bf16* __restrict__ dc) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int c = i % C;
  const int b = (i / C) % B;
  const float gi = __fmul_rn(gamma[c], st[2 * C + c]);
  const float mn = mask[b] / n_ptr[0];
  const float inner = __fadd_rn(dbeta[c], __fmul_rn(bf(xh[i]), dgamma[c]));
  dc[i] = to_bf(__fmul_rn(gi, __fsub_rn(bf(dy[i]), __fmul_rn(mn, inner))));
}


// --- elementwise passes over [L*B, C] -------------------------------------------
// st, sts are [3, C] rows (mean, var, inv). Each rounds to bf16 where the plain
// version does.

// out = bf16(lrelu(g * ((c - mu) * inv) + b))
__global__ void __launch_bounds__(kEwThreads)
bn_lrelu_kernel(const float* __restrict__ c, const float* __restrict__ st,
                const float* __restrict__ g, const float* __restrict__ b, int C, int total,
                bf16* __restrict__ out) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % C;
  out[i] = to_bf(lrelu(bn_affine(c[i], st[k], st[2 * C + k], g[k], b[k])));
}

// out = bf16(lrelu(bn(c) + (cs ? bn_s(cs) : x))): the block's output
__global__ void __launch_bounds__(kEwThreads)
bn_add_lrelu_kernel(const float* __restrict__ c, const float* __restrict__ st,
                    const float* __restrict__ g, const float* __restrict__ b,
                    const float* __restrict__ cs, const float* __restrict__ sts,
                    const float* __restrict__ gs, const float* __restrict__ bs,
                    const bf16* __restrict__ x, int C, int total, bf16* __restrict__ out) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % C;
  const float a = bn_affine(c[i], st[k], st[2 * C + k], g[k], b[k]);
  const float sh = cs ? bn_affine(cs[i], sts[k], sts[2 * C + k], gs[k], bs[k]) : bf(x[i]);
  out[i] = to_bf(lrelu(__fadd_rn(a, sh)));
}

// Backward recompute of a normalised, activated conv output:
// xh = bf16((c - mu) * inv), a = bf16(g * xh + b), r = bf16(lrelu(a)).
__global__ void __launch_bounds__(kEwThreads)
bn_recompute_kernel(const float* __restrict__ c, const float* __restrict__ st,
                    const float* __restrict__ g, const float* __restrict__ b, int C, int total,
                    bf16* __restrict__ xh, bf16* __restrict__ r) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % C;
  const bf16 h = to_bf(__fmul_rn(__fsub_rn(c[i], st[k]), st[2 * C + k]));
  xh[i] = h;
  const bf16 a = to_bf(__fadd_rn(__fmul_rn(g[k], bf(h)), b[k]));
  r[i] = to_bf(lrelu(bf(a)));
}

// The output's gradient through the last LeakyReLU:
// xh = bf16((c - mu) * inv), a = g * xh + b; with a shortcut
// xhs = bf16((cs - mus) * invs), sh = gs * xhs + bs, else sh = x;
// g0 = bf16(gout * dlrelu(a + sh)).
__global__ void __launch_bounds__(kEwThreads)
out_grad_kernel(const float* __restrict__ c, const float* __restrict__ st,
                const float* __restrict__ g, const float* __restrict__ b,
                const float* __restrict__ cs, const float* __restrict__ sts,
                const float* __restrict__ gs, const float* __restrict__ bs,
                const bf16* __restrict__ x, const bf16* __restrict__ gout, int C, int total,
                bf16* __restrict__ xh, bf16* __restrict__ xhs, bf16* __restrict__ g0) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % C;
  const bf16 h = to_bf(__fmul_rn(__fsub_rn(c[i], st[k]), st[2 * C + k]));
  xh[i] = h;
  const float a = __fadd_rn(__fmul_rn(g[k], bf(h)), b[k]);
  float sh;
  if (cs) {
    const bf16 hs = to_bf(__fmul_rn(__fsub_rn(cs[i], sts[k]), sts[2 * C + k]));
    xhs[i] = hs;
    sh = __fadd_rn(__fmul_rn(gs[k], bf(hs)), bs[k]);
  } else {
    sh = bf(x[i]);
  }
  g0[i] = to_bf(__fmul_rn(bf(gout[i]), dlrelu(__fadd_rn(a, sh))));
}

// The gradient through a recomputed activation: out = bf16(t * dlrelu(bf16(g * xh + b))).
__global__ void __launch_bounds__(kEwThreads)
act_grad_kernel(const float* __restrict__ t, const bf16* __restrict__ xh,
                const float* __restrict__ g, const float* __restrict__ b, int C, int total,
                bf16* __restrict__ out) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % C;
  const float a = bf(to_bf(__fadd_rn(__fmul_rn(g[k], bf(xh[i])), b[k])));
  out[i] = to_bf(__fmul_rn(t[i], dlrelu(a)));
}

// The gradient through the x2 upsample and a recomputed activation: t is
// float32 [2L*B, C], xh bf16 [L*B, C];
// out = bf16((t[2l] + t[2l+1]) * dlrelu(bf16(g * xh + b))).
__global__ void __launch_bounds__(kEwThreads)
pair_act_grad_kernel(const float* __restrict__ t, const bf16* __restrict__ xh,
                     const float* __restrict__ g, const float* __restrict__ b, int BC, int C,
                     int total, bf16* __restrict__ out) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const int k = i % C;
  const size_t j = (size_t)(i / BC) * 2 * BC + i % BC;  // row 2l of t
  const float a = bf(to_bf(__fadd_rn(__fmul_rn(g[k], bf(xh[i])), b[k])));
  out[i] = to_bf(__fmul_rn(__fadd_rn(t[j], t[j + BC]), dlrelu(a)));
}

// out = bf16(a + (t[2l] + t[2l+1])): a float32 [L*B, C], t float32 [2L*B, C].
__global__ void __launch_bounds__(kEwThreads)
add_pair_round_kernel(const float* __restrict__ a, const float* __restrict__ t, int BC, int total,
                      bf16* __restrict__ out) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  const size_t j = (size_t)(i / BC) * 2 * BC + i % BC;
  out[i] = to_bf(__fadd_rn(a[i], __fadd_rn(t[j], t[j + BC])));
}

// out = bf16(a + (b ? b : c)), a and b fp32, c bf16.
__global__ void __launch_bounds__(kEwThreads)
add_round_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const bf16* __restrict__ c, int total, bf16* __restrict__ out) {
  const int i = blockIdx.x * kEwThreads + threadIdx.x;
  if (i >= total) return;
  out[i] = to_bf(__fadd_rn(a[i], b ? b[i] : bf(c[i])));
}

// --- host-side launchers -----------------------------------------------------

// Bump allocator over the caller's scratch; with base == nullptr it only counts.
struct Arena {
  char* base;
  size_t used = 0;
  template <class T>
  T* take(size_t n) {
    const size_t off = (used + 255) & ~size_t(255);
    used = off + n * sizeof(T);
    return base ? reinterpret_cast<T*>(base + off) : nullptr;
  }
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Row chunks of the column sums: about 256 blocks in all, at least 32 rows each.
inline int col_chunks(int M, int C) {
  const int want = cdiv(256, C / kColX);
  return std::max(1, std::min(want, cdiv(M, 32)));
}

// Split-K of the weight gradient: about 264 blocks in all, at least one k-tile each.
inline int wgrad_rows_per_split(int M, int Ci, int Co, int taps) {
  const int tiles = (Ci / kBM) * (Co / kBN) * taps;
  const int ktiles = cdiv(M, kBK);
  const int splits = std::max(1, std::min(ktiles, cdiv(264, tiles)));
  return cdiv(ktiles, splits) * kBK;
}

inline size_t wgrad_partial_floats(int M, int Ci, int Co, int taps) {
  return (size_t)cdiv(M, wgrad_rows_per_split(M, Ci, Co, taps)) * taps * Ci * Co;
}

#define BLOCKS_CHECK()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

// UP: the source read through the x2 upsample, and bias [N] added.
template <bool TRANS, bool UP = false>
int launch_conv(const bf16* src, const bf16* w, float* out, const ConvGeom& g, cudaStream_t s,
                const float* bias = nullptr) {
  dim3 grid(cdiv(g.Lout * g.B, kBM), g.N / kBN);
  conv_gemm_kernel<TRANS, UP><<<grid, kGemmThreads, 0, s>>>(src, w, out, g, bias);
  BLOCKS_CHECK();
  return 0;
}

// dw [taps, Ci, Co] from x [Lsrc, B, Ci] (UP: read as its x2 upsample) and
// dc [Lout, B, Co]; part from the arena.
template <bool UP = false>
inline int launch_wgrad(const bf16* x, const bf16* dc, float* part, float* dw, const ConvGeom& g,
                        cudaStream_t s) {
  const int M = g.Lout * g.B;
  const int rows = wgrad_rows_per_split(M, g.Csrc, g.N, g.taps);
  const int splits = cdiv(M, rows);
  dim3 grid(g.Csrc / kBM, g.N / kBN, g.taps * splits);
  wgrad_gemm_kernel<UP><<<grid, kGemmThreads, 0, s>>>(x, dc, part, g, rows);
  BLOCKS_CHECK();
  const int n = g.taps * g.Csrc * g.N;
  wgrad_final_kernel<<<cdiv(n, kEwThreads), kEwThreads, 0, s>>>(part, splits, n, dw);
  BLOCKS_CHECK();
  return 0;
}

// Masked (mean, var, inv) of v fp32 [Lo*B, C] into st [3, C]; part holds
// col_chunks(M, C) * C floats.
inline int launch_col_stats(const float* v, const float* mask, int Lo, int B, int C, float* part,
                            float* st, cudaStream_t s) {
  const int M = Lo * B;
  const int chunks = col_chunks(M, C);
  const int rows = cdiv(M, chunks);
  dim3 grid(C / kColX, chunks), block(kColX, kColY);
  const int fin = cdiv(C, kEwThreads);
  col_partial_kernel<0><<<grid, block, 0, s>>>(v, mask, nullptr, M, B, C, rows, part);
  BLOCKS_CHECK();
  col_final_kernel<0><<<fin, kEwThreads, 0, s>>>(part, chunks, C, mask, B, Lo, st);
  BLOCKS_CHECK();
  col_partial_kernel<1><<<grid, block, 0, s>>>(v, mask, st, M, B, C, rows, part);
  BLOCKS_CHECK();
  col_final_kernel<1><<<fin, kEwThreads, 0, s>>>(part, chunks, C, mask, B, Lo, st);
  BLOCKS_CHECK();
  return 0;
}

// (dgamma, dbeta) of BatchNorm's backward over dy, xh bf16 [Lo*B, C]; n_out
// gets sum(mask) * Lo; part holds col_chunks(M, C) float2.
inline int launch_col_dsum(const bf16* dy, const bf16* xh, const float* mask, int Lo, int B, int C,
                           float2* part, float* dgamma, float* dbeta, float* n_out,
                           cudaStream_t s) {
  const int M = Lo * B;
  const int chunks = col_chunks(M, C);
  dim3 grid(C / kColX, chunks), block(kColX, kColY);
  col_dsum_partial_kernel<<<grid, block, 0, s>>>(dy, xh, M, C, cdiv(M, chunks), part);
  BLOCKS_CHECK();
  col_dsum_final_kernel<<<cdiv(C, kEwThreads), kEwThreads, 0, s>>>(part, chunks, C, mask, B, Lo,
                                                                   dgamma, dbeta, n_out);
  BLOCKS_CHECK();
  return 0;
}

// out [C] = the column sums of v bf16 [M, C], unmasked; part holds
// col_chunks(M, C) * C floats.
inline int launch_col_sum(const bf16* v, int M, int C, float* part, float* out, cudaStream_t s) {
  const int chunks = col_chunks(M, C);
  dim3 grid(C / kColX, chunks), block(kColX, kColY);
  col_sum_partial_kernel<<<grid, block, 0, s>>>(v, M, C, cdiv(M, chunks), part);
  BLOCKS_CHECK();
  wgrad_final_kernel<<<cdiv(C, kEwThreads), kEwThreads, 0, s>>>(part, chunks, C, out);
  BLOCKS_CHECK();
  return 0;
}

inline int launch_bn_dx(const bf16* dy, const bf16* xh, const float* gamma, const float* st,
                        const float* dgamma, const float* dbeta, const float* mask,
                        const float* n_ptr, int Lo, int B, int C, bf16* dc, cudaStream_t s) {
  const int total = Lo * B * C;
  bn_dx_kernel<<<cdiv(total, kEwThreads), kEwThreads, 0, s>>>(dy, xh, gamma, st, dgamma, dbeta,
                                                              mask, n_ptr, B, C, total, dc);
  BLOCKS_CHECK();
  return 0;
}

}  // namespace blocks
