#!/usr/bin/env python3
"""Per-kernel device split of the block kernels and of the loss kernels on
one NVIDIA GPU, for the port in a given checkout.

    python3 kernel_split.py [CHECKOUT]
    python3 kernel_split.py [CHECKOUT] --variants
    python3 kernel_split.py --aot-start

CHECKOUT (default: this one) is a directory that holds hippie_tpu_torch/, for
instance the parent commit unpacked with ``git archive``, so that two
versions of the kernels are measured in one call on one card. With that
package, it runs chip_smoke.py's phases 5b, 5d and 5f (the encoder and the
decoder block kernels against their plain versions at the waveform encoder's,
the decoder's and the ISI encoder's shapes, then each shape's µs/call, device
µs, and each block kernel's device kernels by time and count per call, and
the per-pass sums), times vae_sums_fwd (at the train step's shapes) and
masked_sse_fwd beside F.mse_loss(dec, data, reduction="sum"), twice, and
times vae_sums_bwd: µs/call, device µs alone, and in a CUDA graph behind the
kernel that writes its g (chip_smoke.bwd_in_graph), with all four gradients
and, where the package's wrapper takes ``want``, with the train step's three.

``--variants`` times this tree's vae_sums_bwd (the train step's gradients)
beside variants made from its source, 6 rounds in turns: launched with
Hopper's programmatic dependent launch, laid out as a warp per row, a kernel
that does nothing over the same grid, and, with CHECKOUT, that checkout's
backward (all four gradients): each one's device µs alone, and in a CUDA
graph behind the kernel that writes its g.

``--aot-start`` copies the package into a fresh directory (so nothing is
built beside it) and runs the unimodal training CLI there twice, each a
fresh process at full width with one batch per stage through the kernels,
with ``--aot-dir`` a fresh cache: the first process builds the libraries
into it, the second loads them. Prints both walls and each library's build
seconds from its manifest.

The helpers are this checkout's chip_smoke.py. Exits non-zero without a
CUDA device.
"""

import ctypes
import importlib.util
import inspect
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def bwd_times(smoke, cuda_ops, want=None) -> dict:
    """vae_sums_bwd at the train step's shapes (a 415-row tail of 512):
    µs/call (CUDA events), device µs alone, and in a graph behind its
    predecessor. ``want`` None: the wrapper's default (all four)."""
    import torch

    x = smoke.loss_inputs(415)
    g = torch.tensor([1.0 / (415 * smoke.L), 1.0 / 415], device="cuda")
    kw = {} if want is None else {"want": want}
    fn = lambda: cuda_ops.vae_sums_bwd_cuda(*x, g, **kw)  # noqa: E731
    dev_us, n, _ = smoke.device_profile(fn, n=50)
    return {"us_per_call": smoke.time_ms(fn) * 1e3, "device_us": dev_us, "launches": n,
            **smoke.bwd_in_graph(lambda g2: cuda_ops.vae_sums_bwd_cuda(*x, g2, **kw), g)}


def split(checkout: pathlib.Path, smoke) -> int:
    import torch
    import torch.nn.functional as F

    from hippie_tpu_torch.ops import _build, cuda_ops

    card = card_name()
    print(f"{card}; package {pathlib.Path(_build.__file__).parents[1]}; built {_build.build()}")
    loss = smoke.loss_inputs(415)
    sse = smoke.sse_inputs(415)
    data_all, dec_all, _ = smoke.sse_inputs(smoke.B)
    fns = {"vae_sums_fwd": lambda: cuda_ops.vae_sums_fwd_cuda(*loss),
           "masked_sse_fwd": lambda: cuda_ops.masked_sse_fwd_cuda(*sse),
           "F.mse_loss(sum)": lambda: F.mse_loss(dec_all, data_all, reduction="sum")}
    one = torch.zeros(1, device="cuda")
    takes_want = "want" in inspect.signature(cuda_ops.vae_sums_bwd_cuda).parameters
    for _ in range(2):
        for name, fn in fns.items():
            ms = smoke.time_ms(fn)
            us, n, parts = smoke.device_profile(fn, n=50)
            print(f"{name}: {ms * 1e3:.2f} us/call, {us:.2f} us device in {n:g} launches per call "
                  f"({smoke.split_line(parts)}) on {card}")
        for tag, want in (("all", None),) + ((("step", smoke.STEP_GRADS),) if takes_want else ()):
            print(f"vae_sums_bwd ({tag}): {json.dumps(bwd_times(smoke, cuda_ops, want))} on {card}")
        floor, _, _ = smoke.device_profile(lambda: one.add_(1.0), n=50)
        print(f"launch floor (one-element add_): {floor:.3f} us device on {card}")
    for bb in (smoke.ENC, smoke.DEC, smoke.isi_backbone()):
        errs, per_shape = smoke.phase_blocks(bb, card)
        smoke.block_records(bb, per_shape, errs, dict.fromkeys(smoke.all_launches(), 0), card)
    return 0


# Variants of this tree's vae_sums_bwd for --variants, made from its source:
# the kernel body of a warp per row (lane k takes the row's k-th vectors, the
# row's mask and g read once per warp, no index divided) and of a kernel that
# does nothing over the same grid; the launch through cudaLaunchKernelEx with
# programmatic stream serialization, the kernel waiting (griddepcontrol.wait)
# before its first read.
ROW_BODY = r"""{
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kBwdThreads / 32) + (threadIdx.x >> 5);
  if (r >= B) return;
  const int nl = (want & (kDData | kDDec)) ? L / VL : 0;
  const int nz = (want & (kDMu | kDLogvar)) ? Z / VZ : 0;
  const size_t rl = (size_t)r * L, rz = (size_t)r * Z;
  const float m = mask[r];
  const float g_mse = g[0], g_kl = g[1];
  for (int base = 0; base < max(nl, nz); base += 32) {
    const int i = (base + lane) * VL, j = (base + lane) * VZ;
    const bool has_l = base + lane < nl;
    const bool has_mu = (want & kDMu) && base + lane < nz;
    const bool has_lv = (want & kDLogvar) && base + lane < nz;
    float x[VL] = {}, y[VL] = {}, u[VZ] = {}, v[VZ] = {};
    if (has_l) {
      ldv(data + rl + i, x);
      ldv(dec + rl + i, y);
    }
    if (has_mu) ldv(mu + rz + j, u);
    if (has_lv) ldv(logvar + rz + j, v);
    const bool keep = m > 0.f;
    if (has_l) {
      float d[VL], o[VL];
      for (int e = 0; e < VL; ++e) d[e] = (keep ? y[e] - x[e] : 0.f) * m;
      if (want & kDDec) { for (int e = 0; e < VL; ++e) o[e] = 2.f * g_mse * d[e]; stv(ddec + rl + i, o); }
      if (want & kDData) { for (int e = 0; e < VL; ++e) o[e] = -2.f * g_mse * d[e]; stv(ddata + rl + i, o); }
    }
    if (has_mu) {
      float o[VZ];
      for (int e = 0; e < VZ; ++e) o[e] = g_kl * (keep ? u[e] : 0.f) * m;
      stv(dmu + rz + j, o);
    }
    if (has_lv) {
      float o[VZ];
      for (int e = 0; e < VZ; ++e) o[e] = g_kl * -0.5f * (1.f - expf(keep ? v[e] : 0.f)) * m;
      stv(dlogvar + rz + j, o);
    }
  }
}

"""
SIGNATURE_END = "float* __restrict__ dmu, float* __restrict__ dlogvar) {\n"
GRID = "const dim3 grid((slots + kBwdThreads - 1) / kBwdThreads);"
LAUNCH = "vae_sums_bwd_kernel<VL, VZ><<<grid, kBwdThreads, 0, s>>>("
PDL_CONFIG = """cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kBwdThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define HIPPIE_BWD_LAUNCH"""


def bwd_variant(src: str, name: str) -> str:
    """This tree's vae_sums.cu with its backward made into ``name``."""
    head, rest = src.split("vae_sums_bwd_kernel(const float* __restrict__ data", 1)
    sig, rest = rest.split(SIGNATURE_END, 1)
    body_end = rest.index("\nconstexpr int kSseRows")
    body, tail = rest[:body_end], rest[body_end:]
    if name == "pdl":
        body = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n' + body
        tail = tail.replace("#define HIPPIE_BWD_LAUNCH", PDL_CONFIG, 1).replace(
            LAUNCH, "cudaLaunchKernelEx(&cfg, vae_sums_bwd_kernel<VL, VZ>, ", 1)
    elif name == "row":
        body = ROW_BODY.removeprefix("{\n")
        tail = tail.replace(GRID, "const dim3 grid((B + kBwdThreads / 32 - 1) / (kBwdThreads / 32));", 1)
    elif name == "empty":
        body = "}\n\n"
    out = head + "vae_sums_bwd_kernel(const float* __restrict__ data" + sig + SIGNATURE_END + body + tail
    if name != "kept" and out == src:
        raise RuntimeError(f"vae_sums.cu no longer has the backward that the {name} variant changes")
    return out


def variants(smoke, parent) -> int:
    """vae_sums_bwd (the train step's gradients) as kept, with a
    programmatic launch, as a warp per row, as a kernel that does nothing,
    and ``parent``'s (all four gradients), 6 rounds in turns: medians."""
    import statistics

    import torch

    from hippie_tpu_torch.ops import _build, cuda_ops

    card = card_name()
    out = HERE / "build" / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "vae_sums.cu").read_text()
    sources = {n: bwd_variant(src, n) for n in ("kept", "pdl", "row", "empty")}
    if parent is not None:
        sources["parent"] = (parent / "hippie_tpu_torch" / "csrc" / "vae_sums.cu").read_text()
    procs = {}
    for n, text in sources.items():
        (out / f"{n}.cu").write_text(text)
        procs[n] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{n}.so"),
                                     str(out / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    x = smoke.loss_inputs(415)
    g0 = torch.tensor([1.0 / (415 * smoke.L), 1.0 / 415], device="cuda")
    outs = [torch.empty_like(t) for t in x[:4]]
    plain = cuda_ops.vae_sums_bwd_plain(*x, g0, want=smoke.STEP_GRADS)
    calls = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"kernel_split: the {n} variant did not build:\n{log[-4000:]}", file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out / f"{n}.so"))
        with_want = "unsigned want" in sources[n]
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vae_sums_bwd.argtypes = [P] * 6 + [I] * 3 + ([ctypes.c_uint] if with_want else []) + [P] * 5
        lib.vae_sums_bwd.restype = I

        def call(g, lib=lib, with_want=with_want):
            flags = (14, None) if with_want else (outs[0].data_ptr(),)  # no ddata where it is asked
            err = lib.vae_sums_bwd(*(t.data_ptr() for t in x), g.data_ptr(), smoke.B, smoke.L, smoke.Z, *flags,
                                   *(t.data_ptr() for t in outs[1:]), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{lib}: cudaError {err}")
            return outs
        calls[n] = call
    one = torch.zeros(1, device="cuda")
    res = {n: {"alone_us": [], "pair_us": [], "predecessor_us": [], "in_graph_device_us": []} for n in calls}
    floors = []
    for rnd in range(6):
        for n in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
            for o in outs:
                o.fill_(float("nan"))
            calls[n](g0)
            torch.cuda.synchronize()
            if n != "empty":
                for got, want in zip(outs[1:], plain[1:]):
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
            alone, _, _ = smoke.device_profile(lambda: calls[n](g0), n=200)
            gr = smoke.bwd_in_graph(calls[n], g0)
            for k, v in (("alone_us", alone), ("pair_us", gr["pair_us"]), ("predecessor_us", gr["predecessor_us"]),
                         ("in_graph_device_us", gr["kernel_device_us"])):
                res[n][k].append(v)
        floors.append(smoke.device_profile(lambda: one.add_(1.0), n=200)[0])
    for n, r in res.items():
        print(f"vae_sums_bwd variant {n}: " + json.dumps({k: round(statistics.median(v), 3) for k, v in r.items()})
              + f" (medians of 6 rounds) on {card}")
    print(f"launch floor (one-element add_): {statistics.median(floors):.3f} us device (median of 6) on {card}")
    return 0


def aot_start() -> int:
    """Two fresh processes of the training CLI on a fresh --aot-dir, from a
    copy of the package that has built nothing."""
    card = card_name()
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="hippie_aot_start_", dir=HERE / "build") as root:
        root = pathlib.Path(root)
        shutil.copytree(HERE / "hippie_tpu_torch", root / "pkg" / "hippie_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cache = root / "cache"
        walls = []
        for run in range(2):
            out = root / f"out{run}"
            cmd = [sys.executable, "-m", "hippie_tpu_torch.scripts.train_model", "--data-root",
                   str(HERE / "datasets"), "--loss-backend", "pallas", "--block-backend", "pallas",
                   "--limit-train-batches", "1", "--limit-val-batches", "1", "--output-dir", str(out),
                   "--checkpoint-dir", str(out / "ck"), "--aot-dir", str(cache)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=root / "pkg", capture_output=True, text=True, timeout=900)
            walls.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n")
                return 1
            libs = sorted((cache / "torch_kernels").glob("*.so"))
            mtimes = {p.name: p.stat().st_mtime for p in libs}
            if run == 0:
                first = mtimes
            built = {p.stem: round(json.loads(p.with_suffix(".json").read_text())["build_seconds"], 2)
                     for p in libs}
            print(f"aot-start run {run}: train_model (unimodal, full width, one batch per stage, the kernels) "
                  f"{walls[-1]:.2f} s wall; {len(libs)} libraries in the cache, build seconds {built}"
                  + ("" if run == 0 else f"; rebuilt none: {mtimes == first}") + f" on {card}", flush=True)
        if not (root / "pkg" / "build").exists():
            print("aot-start: nothing was built beside the package")
    print(f"aot-start: cold {walls[0]:.2f} s, warm {walls[1]:.2f} s on {card}")
    return 0


def main() -> int:
    args = sys.argv[1:]
    checkout = pathlib.Path(args[0] if args and not args[0].startswith("--") else HERE).resolve()
    # --variants runs this tree's package and reads only CHECKOUT's vae_sums.cu
    sys.path.insert(0, str(HERE if "--variants" in args else checkout))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 1
    if "--variants" in args:
        return variants(smoke, None if checkout == HERE else checkout)
    if "--aot-start" in args:
        return aot_start()
    return split(checkout, smoke)


if __name__ == "__main__":
    sys.exit(main())
