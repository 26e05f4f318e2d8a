// Fused masked sums of the cVAE loss, and their gradients, for sm_90a.
//
// Replaces hippie_tpu/ops/pallas_ops.py:fused_vae_sums (the Pallas TPU
// kernels _fwd_kernel and _bwd_kernel) and fused_masked_sse (_sse_kernel, the
// joint model's second modality). fused_vae_sums' forward, in one pass over
// the batch:
//   sse = sum_r m_r * sum_l d_rl^2,        d  = where(m > 0, dec - data, 0)
//   kl  = sum_r m_r * sum_j k_rj,          k  = -0.5 (1 + lv - mu^2 - exp(lv)),
//                                          mu, lv = where(m > 0, ., 0)
// The where() guard comes before the square and the exp: padded rows of a
// tail batch can hold +-1e7 or inf, and inf * 0 would be NaN.
// Backward, one elementwise pass given g = (g_mse, g_kl) in device memory:
//   ddec = 2 g_mse d m,  ddata = -ddec,  dmu = g_kl mu m,
//   dlogvar = -0.5 g_kl (1 - exp(lv)) m
//
// masked_sse is the forward's first sum alone, sse = sum_r m_r * sum_l d_rl^2,
// on the second modality (L=100); its backward (-2 g d m, 2 g d m) is
// elementwise torch ops, as _sse_bwd is plain JAX.
//
// What bounds it on an H100 at the main path's shapes (B=512, L=50, z=10):
// the forward reads (2*B*L + 2*B*z + B) * 4 = 247,808 B, about 0.07 us at
// 3.35 TB/s; the backward reads that and writes 245,760 B. Both are far
// below a launch's latency (a few us), so the kernel is bound by launches:
// 2 per train step (forward, backward). masked_sse at B=512, L=100 reads
// (2*B*L + B) * 4 = 411,648 B, 0.12 us: one more launch per joint step,
// bound the same way.
//
// Design: the TPU kernel ran as one program over the whole batch in VMEM and
// summed in one go. Here blocks run in parallel and in no fixed order, so
// each forward is one launch whose blocks reduce their rows into a partial
// and take an integer ticket; the block that takes the last one sums the
// partials in index order in one warp, writes the result and resets the
// ticket for the next call. The ticket and the partials live in a workspace
// the caller keeps per kernel and stream. At these sizes a launch's time is
// the chain of a load, a block sum, a ticket and a last sum, so the batch is
// spread thin: vae_sums' forward takes 4 rows per block (128 blocks for
// B=512, at most one load per thread per array; with 32 rows per block, 16
// blocks took 5.8 us on an H100 where 4 took 2.9), masked_sse 16 rows per
// block (32 blocks), a warp per row.
// Every reduction has a fixed shape (strided per-thread loops, then warp
// shuffles, then one warp over the warp sums), and there are no float
// atomics, so repeated runs give the same bits. The backward reads
// (g_mse, g_kl) from device memory, so the train step never syncs the host.
// All launchers take PyTorch's current stream and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // threads per block, a multiple of 32
constexpr int kRowsPerBlock = 4;    // batch rows per forward block: B=512 gives 128 blocks

// Sum of (a, b) over the block, in a fixed order; the result is valid in
// thread 0. `smem` holds one float2 per warp.
__device__ float2 block_sum2(float a, float b, float2* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) smem[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float2 v = lane < nwarps ? smem[lane] : make_float2(0.f, 0.f);
    a = v.x;
    b = v.y;
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
  }
  return make_float2(a, b);
}

// Sum of a over the block, in a fixed order: block_sum2 with one value.
__device__ float block_sum1(float a, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
  if (lane == 0) smem[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < (blockDim.x >> 5) ? smem[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
  }
  return a;
}

// atomicAdd(p, 1) with acquire-release order at device scope: the caller's
// earlier writes are visible to whoever reads the value it returns, and the
// caller sees the writes released before it.
// (The host build of tests/test_torch_sm90_cpu.py brings its own.)
#ifndef SM90_HOST_EMULATION
__device__ __forceinline__ unsigned ticket_add(unsigned* p) {
  unsigned t;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(t) : "l"(p) : "memory");
  return t;
}
#endif  // SM90_HOST_EMULATION

// One launch: each block reduces kRowsPerBlock rows into one (sse, kl)
// partial, then takes an integer ticket; the block that takes the last one
// sums the partials in index order in one warp, writes out and resets the
// ticket for the next call. ws holds the ticket, then the partials (float2,
// from ws + 2).
__global__ void __launch_bounds__(kThreads)
vae_sums_fwd_kernel(const float* __restrict__ data, const float* __restrict__ dec,
                    const float* __restrict__ mu, const float* __restrict__ logvar,
                    const float* __restrict__ mask, int B, int L, int Z, float* __restrict__ ws,
                    float* __restrict__ out) {
  __shared__ float2 smem[kThreads / 32];
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  float2* part = reinterpret_cast<float2*>(ws + 2);
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, B - r0);
  float sse = 0.f;
  float kl = 0.f;

  const int nl = rows * L;
  const float* data_b = data + (size_t)r0 * L;
  const float* dec_b = dec + (size_t)r0 * L;
  for (int i = threadIdx.x; i < nl; i += kThreads) {
    const float m = mask[r0 + i / L];
    const float d = m > 0.f ? dec_b[i] - data_b[i] : 0.f;
    sse += d * d * m;
  }

  const int nz = rows * Z;
  const float* mu_b = mu + (size_t)r0 * Z;
  const float* lv_b = logvar + (size_t)r0 * Z;
  for (int i = threadIdx.x; i < nz; i += kThreads) {
    const float m = mask[r0 + i / Z];
    const float u = m > 0.f ? mu_b[i] : 0.f;
    const float lv = m > 0.f ? lv_b[i] : 0.f;
    kl += -0.5f * (1.f + lv - u * u - expf(lv)) * m;
  }

  const float2 s = block_sum2(sse, kl, smem);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    last = ticket_add(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float a = 0.f, b = 0.f;
  for (int i = lane; i < (int)gridDim.x; i += 32) {
    const float2 v = __ldcg(part + i);
    a += v.x;
    b += v.y;
  }
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    out[0] = a;
    out[1] = b;
    *ticket = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
vae_sums_bwd_kernel(const float* __restrict__ data, const float* __restrict__ dec,
                    const float* __restrict__ mu, const float* __restrict__ logvar,
                    const float* __restrict__ mask, const float* __restrict__ g,
                    int B, int L, int Z, float* __restrict__ ddata, float* __restrict__ ddec,
                    float* __restrict__ dmu, float* __restrict__ dlogvar) {
  const int nl = B * L;
  const int n = nl + B * Z;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (i < nl) {
    const float g_mse = g[0];
    const float m = mask[i / L];
    const float d = (m > 0.f ? dec[i] - data[i] : 0.f) * m;
    ddec[i] = 2.f * g_mse * d;
    ddata[i] = -2.f * g_mse * d;
  } else {
    const float g_kl = g[1];
    const int j = i - nl;
    const float m = mask[j / Z];
    const float u = m > 0.f ? mu[j] : 0.f;
    const float lv = m > 0.f ? logvar[j] : 0.f;
    dmu[j] = g_kl * u * m;
    dlogvar[j] = g_kl * -0.5f * (1.f - expf(lv)) * m;
  }
}

constexpr int kSseRows = 16;  // batch rows per masked-SSE block: B=512 gives 32 blocks

// One launch: each block sums kSseRows rows (a warp per row, data and dec as
// float4 when L % 4 == 0 and both are 16-byte aligned, each row's mask read
// once) into its partial, then takes an integer ticket; the block that takes
// the last one sums the partials in index order in one warp, writes the
// result and resets the ticket for the next call. ws holds the ticket, then
// the partials.
__global__ void __launch_bounds__(kThreads)
masked_sse_kernel(const float* __restrict__ data, const float* __restrict__ dec,
                  const float* __restrict__ mask, int B, int L, float* __restrict__ ws,
                  float* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float smem[kWarps];
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  float* part = ws + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec = (L & 3) == 0 && ((reinterpret_cast<size_t>(data) | reinterpret_cast<size_t>(dec)) & 15) == 0;
  float sse = 0.f;
#pragma unroll
  for (int k = 0; k < kSseRows / kWarps; ++k) {
    const int r = blockIdx.x * kSseRows + k * kWarps + warp;
    if (r >= B) break;
    const float m = mask[r];
    const bool keep = m > 0.f;  // where(m > 0, dec - data, 0) before the square
    const size_t row = (size_t)r * L;
    if (vec) {
      const float4* a = reinterpret_cast<const float4*>(data + row);
      const float4* b = reinterpret_cast<const float4*>(dec + row);
      for (int i = lane; i < L / 4; i += 32) {
        const float4 x = a[i], y = b[i];
        const float d0 = keep ? y.x - x.x : 0.f, d1 = keep ? y.y - x.y : 0.f;
        const float d2 = keep ? y.z - x.z : 0.f, d3 = keep ? y.w - x.w : 0.f;
        sse += d0 * d0 * m;
        sse += d1 * d1 * m;
        sse += d2 * d2 * m;
        sse += d3 * d3 * m;
      }
    } else {
      for (int i = lane; i < L; i += 32) {
        const float d = keep ? dec[row + i] - data[row + i] : 0.f;
        sse += d * d * m;
      }
    }
  }
  const float s = block_sum1(sse, smem);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    last = ticket_add(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || warp != 0) return;
  float v = 0.f;
  for (int i = lane; i < (int)gridDim.x; i += 32) v += __ldcg(part + i);
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) {
    out[0] = v;
    *ticket = 0u;
  }
}

}  // namespace

extern "C" {

// Floats of the workspace of each forward for a batch of B rows: the ticket
// (and, for vae_sums' float2 partials, a float of padding), then the partials.
int vae_sums_fwd_workspace(int B) { return 2 + 2 * ((B + kRowsPerBlock - 1) / kRowsPerBlock); }
int masked_sse_fwd_workspace(int B) { return 1 + (B + kSseRows - 1) / kSseRows; }

// out[0] = sse, out[1] = kl. ws: the caller's workspace for this stream,
// vae_sums_fwd_workspace(B) floats whose first (the ticket) is zero before
// the first call (the kernel leaves it zero). All arrays float32,
// contiguous: data/dec [B, L], mu/logvar [B, Z], mask [B].
int vae_sums_fwd(const float* data, const float* dec, const float* mu, const float* logvar,
                 const float* mask, int B, int L, int Z, float* ws, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  vae_sums_fwd_kernel<<<nblocks, kThreads, 0, s>>>(data, dec, mu, logvar, mask, B, L, Z, ws, out);
  return static_cast<int>(cudaGetLastError());
}

// g = (g_mse, g_kl) in device memory; the four gradients have the inputs' shapes.
int vae_sums_bwd(const float* data, const float* dec, const float* mu, const float* logvar,
                 const float* mask, const float* g, int B, int L, int Z, float* ddata,
                 float* ddec, float* dmu, float* dlogvar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * (L + Z);
  const int nblocks = (n + kThreads - 1) / kThreads;
  vae_sums_bwd_kernel<<<nblocks, kThreads, 0, s>>>(data, dec, mu, logvar, mask, g, B, L, Z,
                                                   ddata, ddec, dmu, dlogvar);
  return static_cast<int>(cudaGetLastError());
}

// out[0] = sum(mask * where(mask > 0, dec - data, 0)^2). ws: the caller's
// workspace for this stream, masked_sse_fwd_workspace(B) floats whose first
// (the ticket) is zero before the first call (the kernel leaves it zero).
// data/dec [B, L], mask [B], float32, contiguous.
int masked_sse_fwd(const float* data, const float* dec, const float* mask, int B, int L,
                   float* ws, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  masked_sse_kernel<<<(B + kSseRows - 1) / kSseRows, kThreads, 0, s>>>(data, dec, mask, B, L, ws, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
