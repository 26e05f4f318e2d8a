// Primitives of the fused BasicBlock kernels, for sm_90a.
//
// Shared by the encoder block (enc_block.cu) and the decoder block (dec_block.cu).
// Activations are bf16 [L, B, C] (length leading, as hippie_tpu's
// pallas_blocks.py keeps them), so a conv's GEMM view is [L*B, C] row-major
// and a conv tap is a shift of B rows. Weights are bf16 [taps, C_in, C_out].
//
//   src_pos      which source row an output row reads through a tap: the
//                forward conv, the transposed conv (input gradient), and
//                either through the decoder's nearest x2 upsample (UP)
//   conv_gemm    the decoder's forward convs on wmma tiles (bf16 16x16x16,
//                fp32 accumulator and output): M = L_out*B rows, K =
//                taps*C_src, N = C_out; UP (ResizeConv1d) reads its source
//                through the upsample and adds a per-channel bias
//   col_*        the decoder forward's masked per-channel statistics (mean,
//                then the centred variance): fixed row chunks write
//                partials, a final pass sums them in a fixed order
//   bn_*         elementwise passes that normalise, activate and round
//
// The GEMM core of every other kernel is sm90_gemm.cuh (wgmma). No float
// atomics anywhere: every sum has a fixed shape, so repeated runs give the
// same bits. Every launch is on the caller's stream; the launchers return
// cudaGetLastError() after each launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <cstddef>

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
// TRANS and UP: the transposed conv (stride 1) summed over an upsample's
// pairs, output l at the upsample's rows 2l and 2l + 1: t = 2 * tap + half
// reads source row 2l + half + pad - tap.
template <bool TRANS, bool UP = false>
__device__ __forceinline__ int src_pos(int l, int t, const ConvGeom& g) {
  if (TRANS && UP) {
    const int p = 2 * l + (t & 1) + g.pad - (t >> 1);
    return (p >= 0 && p < g.Lsrc) ? p : -1;
  }
  if (UP) {
    const int p = l * g.stride + t - g.pad;
    return (p >= 0 && p < 2 * g.Lsrc) ? p >> 1 : -1;
  }
  if (!TRANS) {
    const int p = l * g.stride + t - g.pad;
    return (p >= 0 && p < g.Lsrc) ? p : -1;
  }
  const int num = l + g.pad - t;  // the blocks' strides are 1 and 2: no division
  if (num < 0 || (g.stride != 1 && (num & 1))) return -1;
  const int p = g.stride != 1 ? num >> 1 : num;
  return p < g.Lsrc ? p : -1;
}

// out[m, n] = sum_{t, c} src[pos(m, t), b(m), c] * w[t][c][n], fp32
// [Lout*B, N], w [taps, Csrc, N]. Needs Csrc % 32 == 0 and N % 64 == 0. UP:
// upsampled source, and out[m, n] += bias[n] after the sum.
template <bool UP = false>
__global__ void __launch_bounds__(kGemmThreads)
conv_gemm_kernel(const bf16* __restrict__ src, const bf16* __restrict__ w,
                 float* __restrict__ out, ConvGeom g, const float* __restrict__ bias) {
  constexpr int kLdA = kBK + kPadH;  // As[m][k]
  constexpr int kLdB = kBN + kPadH;  // Bs[k][n]
  constexpr int kBRows = kBK;
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
        const int p = src_pos<false, UP>(l, t, g);
        if (p >= 0)
          ra[j] = *reinterpret_cast<const uint4*>(src + ((size_t)p * g.B + b) * g.Csrc + c0 + part * 8);
      }
      const int kr = idx >> 3, pc = idx & 7;  // rows k of w[t][c0 + k][n0 ...]: 32 rows x 8 pieces
      rb[j] = *reinterpret_cast<const uint4*>(w + ((size_t)t * g.Csrc + c0 + kr) * g.N + n0 + pc * 8);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + j * kGemmThreads;
      *reinterpret_cast<uint4*>(As + (idx >> 2) * kLdA + (idx & 3) * 8) = ra[j];
      *reinterpret_cast<uint4*>(Bs + (idx >> 3) * kLdB + (idx & 7) * 8) = rb[j];
    }
  };

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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + n, kLdB);
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

#define BLOCKS_CHECK()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

// UP: the source read through the x2 upsample, and bias [N] added.
template <bool UP = false>
int launch_conv(const bf16* src, const bf16* w, float* out, const ConvGeom& g, cudaStream_t s,
                const float* bias = nullptr) {
  dim3 grid(cdiv(g.Lout * g.B, kBM), g.N / kBN);
  conv_gemm_kernel<UP><<<grid, kGemmThreads, 0, s>>>(src, w, out, g, bias);
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

}  // namespace blocks
