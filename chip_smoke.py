#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hippie_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from hippie_tpu_torch/csrc/, holds
each kernel against its plain PyTorch version at the train step's shapes,
trains the full-width waveform cVAE (z=10, ResNet18 encoder and decoder,
8,056,639 parameters) for one epoch on the cellexplorer-celltype pretraining
pool from datasets/ with the fused VAE-loss kernel, checks that the epoch went
through the kernels, checks one step against the same step on the plain
version, embeds the target dataset, and times the slice and the kernels.

Every phase prints one line. The second-to-last line is the ``kernels`` JSON
record, the last the device record. Exits non-zero, printing neither, when no
CUDA device is present, outside the repository, or when any phase fails.
"""

from __future__ import annotations

import copy
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
DATA_ROOT = str(REPO / "datasets")
TARGET = "cellexplorer-celltype"
B, L, Z = 512, 50, 10  # the train step's batch, waveform length, latent width
LR, WD = 1e-3, 0.01  # stage-1 AdamW (the JAX pipeline's defaults)
FULL_PARAMS = 8_056_639
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise PhaseError(what)


# ---------------------------------------------------------------------------
# Kernel inputs, bounds and timing
# ---------------------------------------------------------------------------


def loss_inputs(n_real: int, pad=None, seed: int = 0, device="cuda"):
    """(data, dec, mu, logvar, mask_col) at the train step's shapes; the rows
    past ``n_real`` are padding, driven to +-``pad`` when it is given."""
    import torch

    r = np.random.default_rng(seed)
    data = r.normal(size=(B, L)).astype(np.float32)
    dec = r.normal(size=(B, L)).astype(np.float32)
    mu = r.normal(size=(B, Z)).astype(np.float32)
    logvar = (0.3 * r.normal(size=(B, Z))).astype(np.float32)
    mask = (np.arange(B) < n_real).astype(np.float32).reshape(B, 1)
    if pad is not None:
        sign = np.where(np.arange(B - n_real) % 2 == 0, 1.0, -1.0).astype(np.float32)[:, None]
        dec[n_real:] = 3.0 * pad * sign
        mu[n_real:] = pad * sign
        logvar[n_real:] = pad * sign
    return tuple(torch.from_numpy(x).to(device) for x in (data, dec, mu, logvar, mask))


def vae_sums_bounds(b: int, l: int, z: int):
    """Least time (ms) on the card for the forward and the backward: each input
    read once, each output written once, against the float32 operations."""
    f4 = 4
    in_bytes = f4 * (2 * b * l + 2 * b * z + b)
    fwd_bytes = in_bytes + f4 * 2
    bwd_bytes = in_bytes + f4 * 2 + f4 * (2 * b * l + 2 * b * z)
    fwd_ops = 4 * b * l + 9 * b * z  # sub, square, mask, add; the KL's 8 ops and an exp
    bwd_ops = 4 * b * l + 8 * b * z
    out = {}
    for name, nbytes, ops in (("vae_sums_fwd", fwd_bytes, fwd_ops), ("vae_sums_bwd", bwd_bytes, bwd_ops)):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def time_ms(fn, n: int = 500, warmup: int = 50) -> float:
    """Mean time of ``fn`` on the device's timeline, over ``n`` calls back to back."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build():
    from hippie_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    for name in secs:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[2 build] {len(secs)} source(s) {sorted(secs)} built with nvcc in {wall:.2f} s")


def phase_kernel_vs_plain(device="cuda"):
    """The kernel against its plain version: values rtol 4e-6, gradients
    rtol 1e-5 / atol 1e-7; repeat runs equal bit for bit.

    The values are sums of B*L = 25,600 and B*z = 5,120 nonnegative float32
    terms, summed in a different order by the kernel (per-thread strides, then
    warp and block trees) and by torch. Each order's error is bounded by about
    (log2(25,600) + 1) * 2^-24 = 9.5e-7 of the sum, so the two differ by at
    most 1.9e-6; rtol 4e-6 leaves a factor 2. The gradients are elementwise
    (test_pallas.py's rtol 1e-5).
    """
    import torch

    from hippie_tpu_torch.ops import cuda_ops

    err = {"vae_sums_fwd": 0.0, "vae_sums_bwd": 0.0}
    cases = {"full": (B, None), "tail_415": (415, None), "one_row_pad_1e7": (1, 1e7)}
    for case, (n_real, pad) in cases.items():
        x = loss_inputs(n_real, pad, device=device)
        got = cuda_ops.vae_sums_fwd_cuda(*x)
        ref = cuda_ops.vae_sums_plain(*x)
        exact = cuda_ops.vae_sums_plain(*(t.double() for t in x))
        check(bool(torch.isfinite(got).all()), f"{case}: kernel sums not finite: {got}")
        torch.testing.assert_close(got, ref, rtol=4e-6, atol=0)
        runs = [cuda_ops.vae_sums_fwd_cuda(*x) for _ in range(3)]
        check(all(torch.equal(r, got) for r in runs), f"{case}: repeat runs differ")
        n = float(n_real)
        g = torch.tensor([1.0 / (n * L), 1.0 / n], device=device)
        grads = cuda_ops.vae_sums_bwd_cuda(*x, g)
        ref_grads = cuda_ops.vae_sums_bwd_plain(*x, g)
        for name, a, b in zip(("ddata", "ddec", "dmu", "dlogvar"), grads, ref_grads):
            check(bool(torch.isfinite(a).all()), f"{case}: {name} not finite")
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=lambda m: f"{case} {name}: {m}")
        torch.cuda.synchronize()
        fwd_err = float((got - ref).abs().max())
        bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads, ref_grads))
        err["vae_sums_fwd"] = max(err["vae_sums_fwd"], fwd_err)
        err["vae_sums_bwd"] = max(err["vae_sums_bwd"], bwd_err)
        rel64 = float(((got.double() - exact).abs() / exact.abs()).max())
        print(f"  {case}: sums {got.tolist()} |kernel - plain| {fwd_err:.3g} "
              f"(kernel vs float64 rel {rel64:.3g}), grads |kernel - plain| {bwd_err:.3g}")
    print(f"[3 kernel vs plain] vae_sums_fwd and vae_sums_bwd agree with the plain version on "
          f"{len(cases)} cases at B={B} L={L} z={Z}")
    return err


def full_config():
    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.models import cvae

    return cvae.CVAEConfig(z_dim=Z, output_size=L, class_hidden_dim=5,
                           num_sources=registry.NUM_SOURCES, num_classes=5)


def phase_slice(cfg, batch_size: int = B, device="cuda"):
    """Stage-1 pretraining of the waveform model for one epoch over the
    leave-target-out pool, with the fused VAE-loss kernel; returns what the
    later phases need and the kernels' launch counts of this epoch."""
    import torch

    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.ops import cuda_ops
    from hippie_tpu_torch.train import optim, pipeline, step

    pcfg = pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False, device=device)
    t0 = time.perf_counter()
    pool = pipeline.load_pretrain_pool(pcfg)
    load_s = time.perf_counter() - t0
    check(len(pool) == 2975 and tuple(pool.wave.shape) == (2975, L),
          f"pool has {tuple(pool.wave.shape)} rows, expected (2975, {L})")
    check(pool.wave.device.type == torch.device(device).type, "pool is not on the device")

    model = cvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = cvae.param_count(model)
    if cfg == full_config():
        check(n_params == FULL_PARAMS, f"{n_params} parameters, expected {FULL_PARAMS}")
    ts = step.TrainState(model, optim.make_optimizer(model.parameters(), LR, WD))
    idx, mask = device_data.batch_plan(np.arange(len(pool)), batch_size, shuffle=True,
                                       generator=torch.Generator().manual_seed(1))
    train_epoch, _ = step.make_unimodal_epoch_fns(beta=1.0, loss_backend="pallas")
    gen = torch.Generator(device=device).manual_seed(2)

    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    ts, metrics = train_epoch(ts, pool.wave, pool.source, None, idx, mask, generator=gen)
    losses = metrics.loss.tolist()
    epoch_s = time.perf_counter() - t0
    launches = dict(cuda_ops.launches)

    nb = idx.shape[0]
    check(all(np.isfinite(losses)), f"non-finite loss in the epoch: {losses}")
    check(int(mask[-1].sum()) == len(pool) - (nb - 1) * batch_size, "tail mask is wrong")
    if device != "cpu":
        check(launches == {"vae_sums_fwd": nb, "vae_sums_bwd": nb},
              f"kernel launches {launches}, expected {nb} forward and {nb} backward")
    print(f"[4 slice] pool {len(pool)} rows loaded and preprocessed in {load_s:.2f} s; "
          f"{n_params:,} params; {nb} steps at B={batch_size} (tail {int(mask[-1].sum())} real rows) "
          f"in {epoch_s:.2f} s with the first call's set-up; losses {[round(x, 5) for x in losses]}; "
          f"launches {launches}")
    return ts, pool, idx, mask, launches


def phase_step_parity(model, pool, idx, mask, device="cuda"):
    """One step with loss_backend="pallas" against the same step through the
    kernel's plain version (autograd through vae_sums_plain), from the same
    weights, batch (the masked tail) and injected noise, convolutions in full
    float32 and cuDNN deterministic. Loss rtol 1e-5. Parameters: AdamW's first
    update is about lr * sign(g), so an element whose gradient is at rounding
    level may move either way; where |g| > 1e-4 in both steps the new values
    agree to 1e-6 (lr / 1000), everywhere to 2 * lr."""
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.ops import cuda_ops
    from hippie_tpu_torch.train import optim, step

    i = idx.shape[0] - 1
    bi = torch.as_tensor(idx[i], device=device).long()
    bd, bs = pool.wave[bi], pool.source[bi]
    bmask = torch.as_tensor(mask[i], device=device)
    eps = torch.from_numpy(np.random.default_rng(3).normal(size=(len(bi), model.z_mean.out_features))
                           .astype(np.float32)).to(device)

    def plain_step(ts):
        m, opt = ts
        m.train()
        opt.zero_grad(set_to_none=True)
        _, mu, logvar, dec = m(bd, bs, None, eps=eps, mask=bmask)
        mask_col = bmask.reshape(-1, 1)
        n = mask_col.sum()
        sse, kl = cuda_ops.vae_sums_plain(bd, dec, mu, logvar, mask_col).unbind(0)
        total = sse / (n * bd.shape[1]) + kl / n
        total.backward()
        opt.step()
        return float(total.detach())

    batch_step, _ = step.make_unimodal_steps(beta=1.0, loss_backend="pallas")
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_fp32():
            for name in ("kernel", "plain"):
                m = copy.deepcopy(model)
                ts = step.TrainState(m, optim.make_optimizer(m.parameters(), LR, WD))
                if name == "kernel":
                    _, metrics = batch_step(ts, bd, bs, None, bmask, eps=eps)
                    loss = float(metrics.loss)
                else:
                    loss = plain_step(ts)
                out[name] = (loss, m)
    finally:
        torch.backends.cudnn.deterministic = deterministic

    (lk, mk), (lp, mp) = out["kernel"], out["plain"]
    check(np.isfinite([lk, lp]).all(), f"non-finite loss: {lk} {lp}")
    check(abs(lk - lp) <= 1e-5 * abs(lp), f"loss {lk} vs plain {lp}")
    worst, n_loose, n_total = 0.0, 0, 0
    for (name, pk), pp in zip(mk.named_parameters(), mp.parameters()):
        d = (pk - pp).detach().abs()
        check(float(d.max()) <= 2 * LR * (1 + 1e-3), f"{name}: moved {float(d.max())} apart")
        if pk.grad is not None:
            decisive = (pk.grad.abs() > 1e-4) & (pp.grad.abs() > 1e-4)
            if bool(decisive.any()):
                worst = max(worst, float(d[decisive].max()))
            n_loose += int((d > 1e-6).sum())
        n_total += d.numel()
    check(worst <= 1e-6, f"parameters with decisive gradients differ by {worst}")
    for (name, bk), bp in zip(mk.named_buffers(), mp.buffers()):
        check(torch.allclose(bk.double(), bp.double(), rtol=1e-5, atol=1e-6), f"{name} differs")
    print(f"[5 step parity] loss kernel {lk:.8f} plain {lp:.8f} (rel {abs(lk - lp) / abs(lp):.3g}); "
          f"decisive params max |diff| {worst:.3g}; {n_loose} of {n_total} elements differ by "
          f"more than 1e-6 (all within 2 * lr)")


def phase_embed(model, device="cuda"):
    """Eval-mode embeddings of the target: [392, z], finite, each row z-scored;
    agree with the same model in float64 on the host to atol 1e-4 (the embed
    path runs without TF32), on the first 64 rows."""
    import torch

    from hippie_tpu_torch.evaluate.embeddings import embed_unimodal
    from hippie_tpu_torch.train import pipeline

    pcfg = pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False, device=device)
    target = pipeline.load_dataset(pcfg, TARGET)
    t0 = time.perf_counter()
    emb = embed_unimodal(model, target.wave, target.source)
    emb_host = emb.cpu()
    embed_s = time.perf_counter() - t0
    z = model.z_mean.out_features
    check(tuple(emb.shape) == (392, z), f"embeddings {tuple(emb.shape)}, expected (392, {z})")
    check(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    row_mean = float(emb_host.mean(1).abs().max())
    row_std = float((emb_host.std(1) - 1).abs().max())
    check(row_mean < 1e-5 and row_std < 1e-4, f"rows not z-scored: mean {row_mean}, std-1 {row_std}")
    # eval mode: rows are independent, so 64 of them make the host reference
    ref_model = copy.deepcopy(model).to("cpu", torch.float64)
    ref = embed_unimodal(ref_model, target.wave[:64].cpu().double(), target.source[:64].cpu())
    diff = float((emb_host[:64].double() - ref).abs().max())
    check(diff <= 1e-4, f"embeddings differ from the float64 host model by {diff}")
    print(f"[6 embed] {TARGET}: {tuple(emb.shape)} in {embed_s * 1e3:.1f} ms, "
          f"max |row mean| {row_mean:.2g}, max |row std - 1| {row_std:.2g}, "
          f"max |card - float64 host| {diff:.3g}")


def profile_epoch(run_epoch, steps: int, ms_step: float):
    """Device time of one epoch by kernel (torch.profiler): the busy time per
    step, the idle share of the unprofiled step time, and the largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_epoch()
        torch.cuda.synchronize()
    # device-side kernels and copies only: a host op's row, and a user
    # annotation's device row (Optimizer.step), repeat their kernels' time
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    if not rows:
        print("  profile: the profiler recorded no device time (device busy share not measured)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"  profile: device busy {busy_ms:.3f} ms/step of {ms_step:.3f} ms/step "
          f"(idle share {1 - busy_ms / ms_step:.3f}); {sum(r[1] for r in rows) / steps:.0f} "
          f"device kernels and copies/step")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / 1e3 / steps:8.3f} ms/step {count / steps:6.1f}/step  {key[:90]}")
    for us, count, key in rows:
        if "vae_sums" in key:
            print(f"    kernel {key}: {us / count:.2f} us device time per launch")


def phase_timings(ts, pool, idx, mask, card: str, errs: dict, launches: dict):
    import torch

    from hippie_tpu_torch.ops import cuda_ops
    from hippie_tpu_torch.train import step

    train_epoch, _ = step.make_unimodal_epoch_fns(beta=1.0, loss_backend="pallas")
    gen = torch.Generator(device="cuda").manual_seed(4)
    epochs = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(epochs):
        ts, metrics = train_epoch(ts, pool.wave, pool.source, None, idx, mask, generator=gen)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / (epochs * idx.shape[0])
    check(bool(torch.isfinite(metrics.loss).all()), "non-finite loss while timing")
    print(f"[7 timings] slice: {ms_step:.3f} ms/step over {epochs} epochs of {idx.shape[0]} steps "
          f"(B={B}, cuDNN defaults) on {card}")
    profile_epoch(lambda: train_epoch(ts, pool.wave, pool.source, None, idx, mask, generator=gen),
                  idx.shape[0], ms_step)

    x = loss_inputs(415, device="cuda")
    g = torch.tensor([1.0 / (415 * L), 1.0 / 415], device="cuda")
    fns = {
        "vae_sums_fwd": (lambda: cuda_ops.vae_sums_fwd_cuda(*x), lambda: cuda_ops.vae_sums_plain(*x)),
        "vae_sums_bwd": (lambda: cuda_ops.vae_sums_bwd_cuda(*x, g),
                         lambda: cuda_ops.vae_sums_bwd_plain(*x, g)),
    }
    bounds = vae_sums_bounds(*x[0].shape, x[2].shape[1])
    sources = {"vae_sums_fwd": "hippie_tpu/ops/pallas_ops.py:87",
               "vae_sums_bwd": "hippie_tpu/ops/pallas_ops.py:109"}
    kernels = []
    for name, (kernel, plain) in fns.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bound_ms, bound_by = bounds[name]
        print(f"  {name}: kernel {ms * 1e3:.2f} us/call, plain {plain_ms * 1e3:.2f} us/call, "
              f"bound {bound_ms * 1e3:.4f} us ({bound_by}) on {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": "hippie_tpu_torch/csrc/vae_sums.cu",
            "replaces": sources[name], "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (REPO / "hippie_tpu_torch" / "csrc").is_dir() or not (REPO / "datasets").is_dir():
        print(f"chip_smoke: run from the repository (no hippie_tpu_torch/ or datasets/ in {REPO})",
              file=sys.stderr)
        return 2

    try:
        kind = torch.cuda.get_device_name(0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True
                              ).stdout.strip().splitlines()[0]
        print(f"[1 device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s)")
        print(card)
        phase_build()
        errs = phase_kernel_vs_plain()
        ts, pool, idx, mask, launches = phase_slice(full_config())
        phase_step_parity(ts.model, pool, idx, mask)
        phase_embed(ts.model)
        kernels = phase_timings(ts, pool, idx, mask, card, errs, launches)
        torch.cuda.synchronize()
    except Exception as e:  # any failed phase fails the run, with its traceback
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
