// Fused masked sums of the cVAE loss, and their gradients, for sm_90a.
//
// Replaces hippie_tpu/ops/pallas_ops.py:fused_vae_sums (the Pallas TPU
// kernels _fwd_kernel and _bwd_kernel). Forward, in one pass over the batch:
//   sse = sum_r m_r * sum_l d_rl^2,        d  = where(m > 0, dec - data, 0)
//   kl  = sum_r m_r * sum_j k_rj,          k  = -0.5 (1 + lv - mu^2 - exp(lv)),
//                                          mu, lv = where(m > 0, ., 0)
// The where() guard comes before the square and the exp: padded rows of a
// tail batch can hold +-1e7 or inf, and inf * 0 would be NaN.
// Backward, one elementwise pass given g = (g_mse, g_kl) in device memory:
//   ddec = 2 g_mse d m,  ddata = -ddec,  dmu = g_kl mu m,
//   dlogvar = -0.5 g_kl (1 - exp(lv)) m
//
// What bounds it on an H100 at the main path's shapes (B=512, L=50, z=10):
// the forward reads (2*B*L + 2*B*z + B) * 4 = 247,808 B, about 0.07 us at
// 3.35 TB/s; the backward reads that and writes 245,760 B. Both are far
// below a launch's latency (a few us), so the kernel is bound by launches:
// 3 per train step (forward partials, forward final sum, backward).
//
// Design: the TPU kernel ran as one program over the whole batch in VMEM and
// summed in one go. Here blocks run in parallel and in no fixed order, so the
// forward is two launches: blocks of kThreads threads each reduce kRowsPerBlock
// rows into one (sse, kl) partial, and a single block sums the partials. At
// these sizes a launch's time is the latency of its threads' dependent loads,
// so the partial pass spreads the batch thin: 4 rows per block gives 128
// blocks for B=512 and at most one load per thread per array (with 32 rows
// per block, 16 blocks took 5.8 us on an H100; with 4, 2.9 us).
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

__global__ void __launch_bounds__(kThreads)
vae_sums_partial_kernel(const float* __restrict__ data, const float* __restrict__ dec,
                        const float* __restrict__ mu, const float* __restrict__ logvar,
                        const float* __restrict__ mask, int B, int L, int Z,
                        float2* __restrict__ partial) {
  __shared__ float2 smem[kThreads / 32];
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
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
vae_sums_final_kernel(const float2* __restrict__ partial, int n, float* __restrict__ out) {
  __shared__ float2 smem[kThreads / 32];
  float sse = 0.f;
  float kl = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    sse += partial[i].x;
    kl += partial[i].y;
  }
  const float2 s = block_sum2(sse, kl, smem);
  if (threadIdx.x == 0) {
    out[0] = s.x;
    out[1] = s.y;
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

}  // namespace

extern "C" {

// Number of float2 partials the forward needs as scratch for a batch of B rows.
int vae_sums_fwd_partials(int B) { return (B + kRowsPerBlock - 1) / kRowsPerBlock; }

// out[0] = sse, out[1] = kl. `partial` holds vae_sums_fwd_partials(B) float2.
// All arrays float32, contiguous: data/dec [B, L], mu/logvar [B, Z], mask [B].
int vae_sums_fwd(const float* data, const float* dec, const float* mu, const float* logvar,
                 const float* mask, int B, int L, int Z, float* partial, float* out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = vae_sums_fwd_partials(B);
  float2* p = reinterpret_cast<float2*>(partial);
  vae_sums_partial_kernel<<<nblocks, kThreads, 0, s>>>(data, dec, mu, logvar, mask, B, L, Z, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vae_sums_final_kernel<<<1, kThreads, 0, s>>>(p, nblocks, out);
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

}  // extern "C"
