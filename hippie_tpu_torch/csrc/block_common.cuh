// Scalar helpers and host-side plumbing of the fused BasicBlock kernels, for sm_90a.
//
// Shared by the encoder block (enc_block.cu) and the decoder block
// (dec_block.cu), whose every GEMM and elementwise pass runs on the wgmma
// core of sm90_gemm.cuh. Activations are bf16 [L, B, C] (length leading, as
// hippie_tpu's pallas_blocks.py keeps them), so a conv's GEMM view is
// [L*B, C] row-major and a conv tap is a shift of B rows. Weights are bf16
// [taps, C_in, C_out].
//
//   src_pos      which source row an output row reads through a tap: the
//                forward conv, the transposed conv (input gradient), and
//                either through the decoder's nearest x2 upsample (UP)
//   bf, lrelu,   the roundings and activations, in the plain version's order
//   bn_affine    and without FMA contraction
//   Arena        the entry points' scratch, carved from one caller buffer
//
// No float atomics anywhere: every sum has a fixed shape, so repeated runs
// give the same bits. Every launch is on the caller's stream; the launchers
// return cudaGetLastError() after each launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace blocks {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr float kSlope = 0.01f;
constexpr int kEwThreads = 256;  // threads of an elementwise block

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

// Blocks of an elementwise pass over `total` threads' work.
inline int ew_grid(size_t total) { return (int)((total + kEwThreads - 1) / kEwThreads); }

#define BLOCKS_CHECK()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

}  // namespace blocks
