"""A host build of the block kernels (hippie_tpu_torch/csrc/enc_block.cu and
dec_block.cu) and of the loss kernels' forwards (csrc/vae_sums.cu) held
against their plain versions on the CPU.

No compiler here can build the kernels for the card, and the wgmma core of
csrc/sm90_gemm.cuh has no interpret mode. So the sources are compiled with
``g++`` against the shim below, which stands in for CUDA:

- each block's threads run as ``std::thread``s (a pool kept across blocks),
  one block after another, with
  a ``std::barrier`` for ``__syncthreads`` (a thread that returns drops out of
  it, as an exited thread does on the card) and one per warp for the shuffles;
- dynamic shared memory is one 1024-aligned buffer, ``cp.async`` a copy into it
  (zero-filled where the source is invalid), and the ring's fences and waits
  do nothing;
- ``wgmma.mma_async`` m64n64k16 reads its operands through the descriptors:
  the start address, the stride offset per 8 rows of a K-major operand and
  per 8 k-rows of an MN-major one, and the 128-byte swizzle (bits 4-6 of the
  address XOR bits 7-9); each thread adds the products into its own 32
  accumulators in the instruction's layout;
- the loss kernels' acquire-release ticket is an atomic add;
- launches (``kernel<<<...>>>``) and ``cudaMemsetAsync`` are counted.

What it checks: the kernels' indexing, tiling, epilogues, tickets and
fixed-order sums, their launch counts, and their agreement with the plain
versions at small shapes (B <= 20, 64 and 128 channels, both strides, and a
415-row tail of B = 512), with padded rows at +-1e4; the loss kernels at B =
3, 20 and 512 with padded rows at +-1e7 and +-inf, one launch per call, and
a second call's bits equal to the first's (the ticket is reset). What it cannot check: the hardware's own reading of the
descriptors and of the PTX, memory ordering between blocks that run at once,
and speed. chip_smoke.py and tests/test_torch_cuda_kernels.py check those on
the card. Limits as on the card (chip_smoke.py phase 5b): bf16 outputs and
float32 gradients relative Frobenius 1e-2, statistics 1e-4 of their scale,
the decoder's conv-bias gradients by their rounding-noise limit; the loss
sums rtol 4e-6 (chip_smoke.py phase 3).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hippie_tpu_torch.ops import cuda_blocks as cb
from hippie_tpu_torch.ops import cuda_ops

torch.set_num_threads(1)

CSRC = pathlib.Path(cb.__file__).resolve().parents[1] / "csrc"

SHIM = r"""
#pragma once
#define SM90_HOST_EMULATION 1
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct uint3 { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

namespace shim {
constexpr size_t kSmem = 232448;  // what one block may use on the card
alignas(1024) inline unsigned char smem[kSmem];
inline int error = 0;
inline long launches = 0;
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  float shfl[32][32];
};
inline thread_local Block* blk = nullptr;
inline unsigned char* dyn_smem() { return smem; }
inline unsigned tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }

// Worker threads kept across blocks and launches: a block's threads are the
// first nt workers, started and joined by two barriers.
struct Pool {
  std::vector<std::thread> ts;
  std::unique_ptr<std::barrier<>> start, done;
  std::function<void(unsigned)> job;
  unsigned n = 0;
  void run(unsigned nt, std::function<void(unsigned)> f) {
    if (nt != n) resize(nt);
    job = std::move(f);
    start->arrive_and_wait();
    done->arrive_and_wait();
  }
  void resize(unsigned nt) {
    if (n) {
      job = nullptr;
      start->arrive_and_wait();
      for (auto& t : ts) t.join();
      ts.clear();
    }
    n = nt;
    start = std::make_unique<std::barrier<>>(nt + 1);
    done = std::make_unique<std::barrier<>>(nt + 1);
    for (unsigned t = 0; t < nt; ++t)
      ts.emplace_back([this, t] {
        for (;;) {
          start->arrive_and_wait();
          if (!job) return;
          job(t);
          done->arrive_and_wait();
        }
      });
  }
};
inline Pool* pool = new Pool;  // never destroyed: its threads end with the process

template <class... P>
struct Launch {
  void (*f)(P...);
  dim3 g, b;
  size_t shm;
  template <class... A>
  void operator()(const A&... a) const {
    ++launches;
    const unsigned nt = b.x * b.y * b.z;
    if (shm > kSmem || nt > 1024 || nt == 0) {
      error = 9;  // cudaErrorInvalidConfiguration
      return;
    }
    for (unsigned z = 0; z < g.z; ++z)
      for (unsigned y = 0; y < g.y; ++y)
        for (unsigned x = 0; x < g.x; ++x) {
          Block B;
          B.bar = std::make_unique<std::barrier<>>(nt);
          for (unsigned w = 0; w * 32 < nt; ++w)
            B.warps.push_back(std::make_unique<std::barrier<>>(std::min(32u, nt - 32 * w)));
          pool->run(nt, [&](unsigned t) {
            threadIdx = uint3{t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
            blockIdx = uint3{x, y, z};
            blockDim = b;
            gridDim = g;
            blk = &B;
            f(a...);
            B.warps[t / 32]->arrive_and_drop();
            B.bar->arrive_and_drop();
          });
        }
  }
};
template <class... P>
Launch<P...> launcher(void (*f)(P...), dim3 g, dim3 b, size_t shm = 0, cudaStream_t = nullptr) {
  return Launch<P...>{f, g, b, shm};
}
}  // namespace shim

inline void __syncthreads() { shim::blk->bar->arrive_and_wait(); }
inline float __shfl_down_sync(unsigned, float v, int off) {
  const unsigned t = shim::tid(), w = t / 32, lane = t % 32;
  shim::Block& B = *shim::blk;
  B.shfl[w][lane] = v;
  B.warps[w]->arrive_and_wait();
  const float r = lane + off < 32 ? B.shfl[w][lane + off] : v;
  B.warps[w]->arrive_and_wait();
  return r;
}
inline cudaError_t cudaGetLastError() {
  const int e = shim::error;
  shim::error = 0;
  return e;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  if (bytes > (int)shim::kSmem) shim::error = 1;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  ++shim::launches;
  std::memset(p, v, n);
  return 0;
}

extern "C" long shim_launches() { return shim::launches; }

// the PTX wrappers of sm90_gemm.cuh
namespace sm90 {
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const unsigned char*>(p) - shim::smem);
}
inline void cp16(uint32_t dst, const void* src, bool valid) {
  if (dst % 16 || dst + 16 > shim::kSmem) std::abort();
  if (valid) std::memcpy(shim::smem + dst, src, 16);
  else std::memset(shim::smem + dst, 0, 16);
}
inline void cp_commit() {}
template <int N> inline void cp_wait() {}
inline void fence_async_smem() {}
inline void wg_fence() {}
inline void wg_commit() {}
template <int N> inline void wg_wait() {}
inline void fence_acc(float (&)[32]) {}

// Element (row, k) of a 64 x 16 operand: row indexes M (A) or N (B).
inline float operand(uint64_t desc, bool mn_major, int row, int k) {
  if ((desc >> 62) != 1) std::abort();  // 128-byte swizzle only
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  uint32_t a = mn_major ? start + (k >> 3) * sbo + (k & 7) * 128 + (row >> 6) * lbo + 2 * (row & 63)
                        : start + (row >> 3) * sbo + (row & 7) * 128 + 2 * k;
  a ^= ((a >> 7) & 7) << 4;
  if (a + 2 > shim::kSmem) std::abort();
  __nv_bfloat16 v;
  std::memcpy(&v, shim::smem + a, 2);
  return __bfloat162float(v);
}

// d[4 j + 2 i + c] is row 16 w + lane / 4 + 8 i, column 8 j + 2 (lane % 4) + c.
template <int TA, int TB>
inline void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b) {
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  float av[2][16], bv[16][16];
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 16; ++k) av[i][k] = operand(a, TA, 16 * w + lane / 4 + 8 * i, k);
  for (int j = 0; j < 8; ++j)
    for (int c = 0; c < 2; ++c)
      for (int k = 0; k < 16; ++k) bv[2 * j + c][k] = operand(b, TB, 8 * j + 2 * (lane % 4) + c, k);
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 2; ++i)
      for (int c = 0; c < 2; ++c) {
        float s = d[4 * j + 2 * i + c];
        for (int k = 0; k < 16; ++k) s += av[i][k] * bv[2 * j + c][k];
        d[4 * j + 2 * i + c] = s;
      }
}
}  // namespace sm90

// vae_sums.cu's ticket: the blocks run one after another here
inline unsigned ticket_add(unsigned* p) { return atomicAdd(p, 1u); }
"""


def host_source(text: str) -> str:
    """A CUDA source as the shim compiles it: the dynamic shared array is the
    shim's buffer, and kernel<<<grid, block, smem, stream>>>(args) is
    shim::launcher(kernel, grid, block, smem, stream)(args)."""
    text = re.sub(r"extern __shared__[^;]*?\b(\w+)\[\];", r"unsigned char* \1 = shim::dyn_smem();", text)
    return re.sub(r"([\w:]+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>", r"shim::launcher(\1, \2)", text, flags=re.S)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host build of the kernels")
    d = tmp_path_factory.mktemp("sm90_host")
    (d / "include").mkdir()
    (d / "include" / "sm90_host_shim.h").write_text(SHIM)
    for name in ("cuda_runtime.h", "cuda_bf16.h"):
        (d / "include" / name).write_text('#pragma once\n#include "sm90_host_shim.h"\n')
    for src in CSRC.glob("*.cu*"):
        (d / src.name).write_text(host_source(src.read_text()))
    procs = {}
    for kind, src in (("enc", "enc_block"), ("dec", "dec_block"), ("vae_sums", "vae_sums")):
        cmd = [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-fPIC", "-shared", "-pthread",
               "-I", str(d / "include"), "-include", "sm90_host_shim.h", "-x", "c++",
               str(d / f"{src}.cu"), "-o", str(d / f"{src}.so")]
        procs[kind] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src)
    out = {}
    for kind, (proc, src) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"host build of {src}.cu failed:\n{log[-6000:]}"
        lib = ctypes.CDLL(str(d / f"{src}.so"))
        lib.shim_launches.restype = ctypes.c_long
        out[kind] = lib
    for kind in ("enc", "dec"):
        ints, *directions = cb._SIGNATURES[kind]
        for direction, (n_in, n_out) in zip(("fwd", "bwd"), directions):
            scratch = getattr(out[kind], f"{kind}_block_{direction}_scratch")
            scratch.argtypes, scratch.restype = [ctypes.c_int] * ints, ctypes.c_longlong
            fn = getattr(out[kind], f"{kind}_block_{direction}")
            fn.argtypes = [ctypes.c_void_p] * n_in + [ctypes.c_int] * ints + [ctypes.c_void_p] * n_out
            fn.restype = ctypes.c_int
    loss = out["vae_sums"]
    for name, n_in, ints in (("vae_sums_fwd", 5, 3), ("masked_sse_fwd", 3, 2)):
        size = getattr(loss, f"{name}_workspace")
        size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
        fn = getattr(loss, name)
        fn.argtypes, fn.restype = [ctypes.c_void_p] * n_in + [ctypes.c_int] * ints + [ctypes.c_void_p] * 3, ctypes.c_int
    return out


# ---------------------------------------------------------------------------
# The entry points' calls, as ops/cuda_blocks.py makes them, on CPU tensors.
# Scratch is filled with 0x5A bytes and outputs with NaN, so a ticket that is
# not zeroed or an output that is not written shows.
# ---------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(nbytes):
    return torch.full((max(int(nbytes), 1),), 0x5A, dtype=torch.uint8)


def _nan(*shape):
    return torch.full(shape, float("nan"), dtype=torch.float32)


def _call(lib, name, *args):
    before = lib.shim_launches()
    err = getattr(lib, name)(*args)
    assert err == 0, f"{name}: error {err}"
    return lib.shim_launches() - before


def enc_fwd(lib, stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m):
    L, B, ci = x.shape
    co = w2.shape[-1]
    short = int(stride != 1)
    out = torch.full((cb._out_len(L, stride), B, co), float("nan"), dtype=torch.bfloat16)
    st = [_nan(3, co) for _ in range(3)]
    scratch = _scratch(lib.enc_block_fwd_scratch(L, B, ci, co, stride, short))
    n = _call(lib, "enc_block_fwd", *(_ptr(t) for t in (x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m)),
              L, B, ci, co, stride, short, *(_ptr(t) for t in (out, *st, scratch)), None)
    return (out, *st), n


def enc_bwd(lib, stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m, st1, st2, sts, g):
    L, B, ci = x.shape
    co = w2.shape[-1]
    short = stride != 1
    dx = torch.full_like(x, float("nan"))
    dw1, dw2 = _nan(*w1.shape), _nan(*w2.shape)
    dvec = _nan(6, co)
    dws = _nan(*ws.shape) if short else None
    scratch = _scratch(lib.enc_block_bwd_scratch(L, B, ci, co, stride, int(short)))
    n = _call(lib, "enc_block_bwd",
              *(_ptr(t) for t in (x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m, st1, st2, sts, g)),
              L, B, ci, co, stride, int(short),
              *(_ptr(t) for t in (dx, dw1, dvec[0], dvec[1], dw2, dvec[2], dvec[3], dws)),
              _ptr(dvec[4]) if short else None, _ptr(dvec[5]) if short else None, _ptr(scratch), None)
    dgs, dbs = (dvec[4], dvec[5]) if short else (None, None)
    return (dx, dw1, dvec[0], dvec[1], dw2, dvec[2], dvec[3], dws, dgs, dbs), n


def dec_fwd(lib, stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m):
    L, B, ci = x.shape
    co = w1.shape[-1]
    out = torch.full((L * stride, B, co), float("nan"), dtype=torch.bfloat16)
    st2, st1, sts = _nan(3, ci), _nan(3, co), _nan(3, co)
    scratch = _scratch(lib.dec_block_fwd_scratch(L, B, ci, co, stride))
    n = _call(lib, "dec_block_fwd", *(_ptr(t) for t in (x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m)),
              L, B, ci, co, stride, *(_ptr(t) for t in (out, st2, st1, sts, scratch)), None)
    return (out, st2, st1, sts), n


def dec_bwd(lib, stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m, st2, st1, sts, g):
    L, B, ci = x.shape
    co = w1.shape[-1]
    short = stride != 1
    dx = torch.full_like(x, float("nan"))
    dw2, dw1 = _nan(*w2.shape), _nan(*w1.shape)
    dv2, dv1 = _nan(2, ci), _nan(6, co)
    dws = _nan(*ws.shape) if short else None
    d1 = [dv1[i] if short else None for i in range(2, 6)]
    scratch = _scratch(lib.dec_block_bwd_scratch(L, B, ci, co, stride))
    n = _call(lib, "dec_block_bwd",
              *(_ptr(t) for t in (x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m, st2, st1, sts, g)),
              L, B, ci, co, stride,
              *(_ptr(t) for t in (dx, dw2, dv2[0], dv2[1], dw1, d1[0], dv1[0], dv1[1], dws, d1[1], d1[2], d1[3],
                                  scratch)), None)
    return (dx, dw2, dv2[0], dv2[1], dw1, d1[0], dv1[0], dv1[1], dws, d1[1], d1[2], d1[3]), n


# ---------------------------------------------------------------------------
# Inputs and limits
# ---------------------------------------------------------------------------


def _inputs(kind, stride, L, ci, co, batch, n_real, seed=0):
    """The block's operands (kernel layout, seeded with numpy) and the output
    cotangent; rows past n_real are padding at +-1e4."""
    r = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    f = lambda *s: r.normal(size=s)  # noqa: E731
    vec = lambda c: [t(r.uniform(0.5, 1.5, c)), t(0.1 * f(c))]  # noqa: E731
    x = f(L, batch, ci)
    x[:, n_real:] = 1e4 * np.where(r.random((L, batch - n_real, ci)) < 0.5, 1.0, -1.0)
    bf = torch.bfloat16
    if kind == "enc":
        lo = cb._out_len(L, stride)
        args = [t(x, bf), t(f(3, ci, co) / np.sqrt(3 * ci), bf), *vec(co), t(f(3, co, co) / np.sqrt(3 * co), bf),
                *vec(co)]
        args += [t(f(1, ci, co) / np.sqrt(ci), bf), *vec(co)] if stride != 1 else [None] * 3
    else:
        lo = L * stride
        args = [t(x, bf), t(f(3, ci, ci) / np.sqrt(3 * ci), bf), *vec(ci), t(f(3, ci, co) / np.sqrt(3 * ci), bf),
                t(0.1 * f(co)) if stride != 1 else None, *vec(co)]
        args += [t(f(3, ci, co) / np.sqrt(3 * ci), bf), t(0.1 * f(co)), *vec(co)] if stride != 1 else [None] * 4
    args.append(t((np.arange(batch) < n_real).reshape(batch, 1)))
    return args, t(f(lo, batch, co), bf)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _stats_err(a, b):
    scale = torch.stack([b[0].abs() + b[1].clamp_min(0).sqrt(), b[1].abs(), b[2].abs()])
    return float(((a - b).abs() / scale.clamp_min(1e-30)).max())


def _bias_grad_tol(g, gamma, st, dgamma):
    """chip_smoke.py's bias_grad_tol: 1e-2 |g| plus 1e-3 of |gamma inv dgamma|."""
    return float(1e-2 * g.double().norm() + 1e-3 * (gamma * st[2] * dgamma).double().norm())


# (kind, stride, L, C_in, C_out, B, real rows); B and the lengths make tiles
# that span positions and a ragged last tile; the L=64 and L=32 cases have
# over 16 m-tiles (two ticket groups) and weight gradients in several splits;
# the last is the train step's 415-row tail, whose padded rows fill whole tiles
CASES = [("enc", 1, 7, 64, 64, 20, 13), ("enc", 2, 7, 64, 128, 20, 13), ("enc", 2, 5, 128, 128, 3, 2),
         ("enc", 1, 64, 64, 64, 20, 13),
         ("dec", 1, 4, 64, 64, 20, 13), ("dec", 2, 4, 128, 64, 20, 13), ("dec", 2, 3, 128, 128, 3, 2),
         ("dec", 2, 32, 128, 64, 20, 13), ("dec", 2, 2, 64, 64, 512, 415)]
MOST = {"enc_block_fwd": 5, "enc_block_bwd": 8, "dec_block_fwd": 5, "dec_block_bwd": 8}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "{}-s{}-L{}-{}-{}-B{}".format(*c[:6]))
def test_block_kernels_match_plain_on_the_host(libs, case):
    kind, stride, L, ci, co, batch, n_real = case
    lib = libs[kind]
    args, g = _inputs(kind, stride, L, ci, co, batch, n_real, seed=L + ci + co)
    ops = cb.ENC_OPS if kind == "enc" else cb.DEC_OPS
    fwd, bwd = (enc_fwd, enc_bwd) if kind == "enc" else (dec_fwd, dec_bwd)
    got, n_fwd = fwd(lib, stride, *args)
    ref = ops.fwd_plain(stride, *args)
    assert n_fwd <= MOST[f"{kind}_block_fwd"], f"{n_fwd} launches"
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0][:, :n_real], ref[0][:, :n_real]) < 1e-2
    assert _rel(got[0], ref[0]) < 1e-2
    for a, b in zip(got[1:], ref[1:]):
        assert _stats_err(a, b) <= 1e-4
    dgot, n_bwd = bwd(lib, stride, *args, *got[1:], g)
    dref = ops.bwd_plain(stride, *args, *got[1:], g)
    assert n_bwd <= MOST[f"{kind}_block_bwd"], f"{n_bwd} launches"
    names = ("dx", "dw1", "dg1", "db1", "dw2", "dg2", "db2", "dws", "dgs", "dbs") if kind == "enc" else \
        ("dx", "dw2", "dg2", "db2", "dw1", "dc1b", "dg1", "db1", "dws", "dcsb", "dgs", "dbs")
    bias = {"dc1b": (args[6], got[2], dref[6]), "dcsb": (args[10], got[3], dref[10])} if kind == "dec" else {}
    for name, a, b in zip(names, dgot, dref):
        if a is None:
            assert stride == 1 and not b.any(), name
        elif name in bias:
            assert float((a - b).double().norm()) <= _bias_grad_tol(g, *bias[name]), name
        else:
            assert torch.isfinite(a).all(), name
            assert _rel(a, b) < 1e-2, (name, _rel(a, b))
    assert _rel(dgot[0][:, :n_real], dref[0][:, :n_real]) < 1e-2


# ---------------------------------------------------------------------------
# The loss kernels' forwards (csrc/vae_sums.cu), one launch each, on a fresh
# workspace as ops/cuda_ops.py makes it (a zero ticket, then the partials).
# ---------------------------------------------------------------------------

# (B, real rows, pad): padded rows hold +-pad
LOSS_CASES = [(b, n, pad) for b, n in ((3, 2), (20, 13), (512, 415)) for pad in (1e7, np.inf)]


def _loss_inputs(batch, n_real, pad, cols, seed=0):
    """[batch, c] float32 arrays for c in cols, rows past n_real at +-pad, and
    the mask column."""
    r = np.random.default_rng(seed)
    out = []
    for c in cols:
        a = r.normal(size=(batch, c)).astype(np.float32)
        a[n_real:] = pad * np.where(r.random((batch - n_real, c)) < 0.5, 1.0, -1.0)
        out.append(torch.from_numpy(a))
    return out, torch.from_numpy((np.arange(batch) < n_real).astype(np.float32).reshape(batch, 1))


def _twice(lib, name, args, n_out, batch):
    """Two calls of a loss kernel on one workspace: their outputs, each after
    one launch and with the ticket back at zero."""
    ws = torch.zeros(getattr(lib, f"{name}_workspace")(batch), dtype=torch.float32)
    outs = []
    for _ in range(2):
        out = _nan(n_out)
        assert _call(lib, name, *args, _ptr(ws), _ptr(out), None) == 1
        assert ws[:1].view(torch.int32).item() == 0, "ticket not reset"
        outs.append(out)
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])
    return outs[0]


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "B{}-{}-pad{:g}".format(*c))
def test_vae_sums_fwd_matches_plain_on_the_host(libs, case):
    batch, n_real, pad = case
    (data, dec, mu, logvar), mask = _loss_inputs(batch, n_real, pad, (50, 50, 10, 10), seed=batch)
    data = data.clamp(-10, 10)  # the data's padded rows stay finite, as the loader's
    got = _twice(libs["vae_sums"], "vae_sums_fwd", [*(_ptr(t) for t in (data, dec, mu, logvar, mask)), batch, 50, 10],
                 2, batch)
    torch.testing.assert_close(got, cuda_ops.vae_sums_plain(data, dec, mu, logvar, mask), rtol=4e-6, atol=0)


@pytest.mark.parametrize("case", LOSS_CASES, ids=lambda c: "B{}-{}-pad{:g}".format(*c))
def test_masked_sse_fwd_matches_plain_on_the_host(libs, case):
    batch, n_real, pad = case
    (data, dec), mask = _loss_inputs(batch, n_real, pad, (100, 100), seed=batch + 1)
    data = data.clamp(-10, 10)
    got = _twice(libs["vae_sums"], "masked_sse_fwd", [*(_ptr(t) for t in (data, dec, mask)), batch, 100], 1, batch)
    torch.testing.assert_close(got[0], cuda_ops.masked_sse_plain(data, dec, mask), rtol=4e-6, atol=0)
