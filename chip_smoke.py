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
version, holds the encoder block kernels against their plain versions at the
full-width encoder's block shapes, runs that trained encoder's training pass
through them (backend="pallas") against the plain blocks and the float32
encoder, embeds the target dataset, and times the slice and the kernels.

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
# the tensor cores, bf16 dense tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# The full-width encoder's 8 BasicBlocks: (stride, L_in, C_in, C_out).
ENC_BLOCKS = ((1, 25, 64, 64), (1, 25, 64, 64), (2, 25, 64, 128), (1, 13, 128, 128),
              (2, 13, 128, 256), (1, 7, 256, 256), (2, 7, 256, 512), (1, 4, 512, 512))
ENC_SOURCE = "hippie_tpu_torch/csrc/enc_block.cu"


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


def enc_block_inputs(stride, L, ci, co, n_real: int = B, pad=None, seed: int = 0, device="cuda"):
    """The fused block's operands at the encoder's shapes, in the kernels'
    layout: (x, w1, g1, b1, w2, g2, b2, ws, gs, bs, mask) and the output
    cotangent g. Rows past ``n_real`` are padding, driven to +-``pad`` in x
    when it is given. ws, gs, bs are None for a stride-1 block."""
    import torch

    r = np.random.default_rng(seed)
    lo = L if stride == 1 else (L - 1) // 2 + 1
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    x = f(L, B, ci)
    if pad is not None:
        x[:, n_real:] = pad * np.where(r.random((L, B - n_real, ci)) < 0.5, 1.0, -1.0)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    bf = torch.bfloat16
    ts = [dev(x, bf), dev(f(3, ci, co) / np.sqrt(3 * ci), bf), dev(r.uniform(0.5, 1.5, co)),
          dev(0.1 * f(co)), dev(f(3, co, co) / np.sqrt(3 * co), bf), dev(r.uniform(0.5, 1.5, co)),
          dev(0.1 * f(co))]
    if stride != 1:
        ts += [dev(f(1, ci, co) / np.sqrt(ci), bf), dev(r.uniform(0.5, 1.5, co)), dev(0.1 * f(co))]
    else:
        ts += [None, None, None]
    ts.append(dev((np.arange(B) < n_real).reshape(B, 1)))
    return ts, dev(f(lo, B, co), bf)


def enc_block_bounds(stride, L, ci, co, b: int = B):
    """Least time (ms) on the card for one block's forward and backward: bf16
    tensor-core operations (the backward recomputes the forward, then the
    input and weight gradients: 3x the forward's products) against each
    input read once and each output written once."""
    lo = L if stride == 1 else (L - 1) // 2 + 1
    short = stride != 1
    wts = 3 * ci * co + 3 * co * co + (ci * co if short else 0)
    nvec = 4 + (2 if short else 0)  # gammas and betas
    fwd_ops = 2 * lo * b * wts
    x_b, y_b = 2 * L * b * ci, 2 * lo * b * co
    common = x_b + 2 * wts + 4 * nvec * co + 4 * b
    fwd_bytes = common + y_b + 4 * 9 * co
    bwd_bytes = common + 4 * 9 * co + y_b + x_b + 4 * wts + 4 * nvec * co
    out = {}
    for name, nbytes, ops in (("enc_block_fwd", fwd_bytes, fwd_ops),
                              ("enc_block_bwd", bwd_bytes, 3 * fwd_ops)):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def device_profile(fn, n: int = 10):
    """(device us, device kernels and copies) per call of ``fn``, from
    torch.profiler over ``n`` calls; (0.0, 0.0) if it records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    return sum(r[0] for r in rows) / n, sum(r[1] for r in rows) / n


def rel_err(a, b) -> float:
    """Relative Frobenius norm of a - b, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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


BLOCK_GRADS = ("dx", "dw1", "dg1", "db1", "dw2", "dg2", "db2", "dws", "dgs", "dbs")


def stats_err(a, b) -> float:
    """Largest error of (mean, var, inv) rows against their scale: |mean| + std, var, inv."""
    import torch

    scale = torch.stack([b[0].abs() + b[1].clamp_min(0).sqrt(), b[1].abs(), b[2].abs()])
    err = (a - b).abs()
    return float(torch.where(scale > 0, err / scale.clamp_min(1e-30), err * 1e30).max())


def phase_enc_blocks():
    """The encoder block kernels against their plain versions at the 7
    full-width block shapes, B=512: a full batch, and a 415-row tail whose
    padded rows of x hold +-1e4. The cotangent is nonzero on every row, so
    BatchNorm's backward sums over all entries are held too; both backwards
    get the kernel forward's statistics.

    Limits. Kernel and plain multiply the same bf16 operands exactly into
    float32 and round to bf16 at the same points; they differ only in the
    order of the float32 sums (tensor-core tiles and fixed split-K against
    cuBLAS). That moves a value by about 1e-7 of its size, and flips its
    bf16 rounding (2^-8 relative) only where it lies that close to a rounding
    boundary. The gradients amplify that: a BatchNorm bias gradient sums
    terms of both signs over up to 12,800 rows, and one value turning at
    LeakyReLU's kink moves it by about 1e-2 of its size. So the bf16 outputs
    (out and dx, over all rows and over the real rows) and the float32
    weight and affine gradients are held at relative Frobenius norm 1e-2
    (measured worst 4.9e-3), and the statistics (mean, var, inv) at 1e-4 of
    their scale (|mean| + std, var, inv); the first BatchNorm's see no bf16
    rounding at all, the others only through r1. Both are tighter than the
    JAX package's 3e-2 for its fused block against float32
    (tests/test_pallas_blocks.py:37). Repeat runs of both kernels are bit-equal.
    Returns the largest |kernel - plain| of out (forward) and dx (backward)
    in the full-batch cases.
    """
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.ops import cuda_blocks as cb

    err = {"enc_block_fwd": 0.0, "enc_block_bwd": 0.0}
    worst = {}
    for stride, L, ci, co in sorted(set(ENC_BLOCKS), key=ENC_BLOCKS.index):
        short = stride != 1
        for case, (n_real, pad) in (("full", (B, None)), ("tail_415", (415, 1e4))):
            tag = f"s{stride} L{L} {ci}->{co} {case}"
            args, g = enc_block_inputs(stride, L, ci, co, n_real, pad, seed=L + co)
            got = cb.enc_block_fwd_cuda(stride, *args)
            dgot = cb.enc_block_bwd_cuda(stride, *args, *got[1:], g)
            with full_fp32():
                ref = cb.enc_block_fwd_plain(stride, short, *args)
                dref = cb.enc_block_bwd_plain(stride, short, *args, *got[1:], g)
            torch.cuda.synchronize()
            real = slice(0, n_real)
            rels = {"out": max(rel_err(got[0], ref[0]), rel_err(got[0][:, real], ref[0][:, real]))}
            for name, a, b in zip(BLOCK_GRADS, dgot, dref):
                if a is None:  # no shortcut: the plain version's zeros
                    check(not b.any(), f"{tag}: plain {name} is not zero")
                    continue
                check(bool(torch.isfinite(a).all()), f"{tag}: kernel {name} not finite")
                rels[name] = rel_err(a, b)
            rels["dx"] = max(rels["dx"], rel_err(dgot[0][:, real], dref[0][:, real]))
            check(bool(torch.isfinite(got[0]).all()), f"{tag}: kernel output not finite")
            for name, v in rels.items():
                check(v <= 1e-2, f"{tag}: {name} relative error {v:.3g} > 1e-2")
                worst[name] = max(worst.get(name, 0.0), v)
            st = max(stats_err(a, b) for a, b in zip(got[1:], ref[1:]))
            check(st <= 1e-4, f"{tag}: statistics differ by {st:.3g} of their scale")
            worst["stats"] = max(worst.get("stats", 0.0), st)
            for _ in range(2):
                again = cb.enc_block_fwd_cuda(stride, *args)
                dagain = cb.enc_block_bwd_cuda(stride, *args, *got[1:], g)
                check(all(torch.equal(a, b) for a, b in zip(again, got)), f"{tag}: forward repeat differs")
                check(all(a is None or torch.equal(a, b) for a, b in zip(dagain, dgot)),
                      f"{tag}: backward repeat differs")
            if pad is None:  # padded rows at +-1e4 make values whose one ulp is several units
                err["enc_block_fwd"] = max(err["enc_block_fwd"], float(
                    (got[0].float() - ref[0].float()).abs().max()))
                err["enc_block_bwd"] = max(err["enc_block_bwd"], float(
                    (dgot[0].float() - dref[0].float()).abs().max()))
            print(f"  {tag}: " + " ".join(f"{k} {v:.2e}" for k, v in rels.items()) + f" stats {st:.2e}")
    print(f"[5b enc blocks] enc_block_fwd and enc_block_bwd agree with the plain version at "
          f"{len(set(ENC_BLOCKS))} shapes x 2 cases, B={B}; worst relative errors "
          + " ".join(f"{k} {v:.2e}" for k, v in worst.items()) + "; repeat runs bit-equal")
    return err


def encoder_through_plain_blocks(enc, x, mask):
    """ResNet18Enc's backend="pallas" training path with every block on the
    plain versions under autograd: the card's reference for the kernels."""
    import torch

    from hippie_tpu_torch.nn.functional import leaky_relu
    from hippie_tpu_torch.ops import cuda_blocks as cb

    out = leaky_relu(enc.bn1(enc.conv1(x), mask)).permute(2, 0, 1).to(torch.bfloat16).contiguous()
    mask_col = cb.mask_column(mask, out.shape[1], out.device)
    for layer in (enc.layer1, enc.layer2, enc.layer3, enc.layer4):
        for block in layer:
            out = cb.enc_block_apply(cb.PlainEncBlockFn, block, out, mask_col)
    return enc.linear(out.float().mean(dim=0))


def phase_encoder(model, pool, idx, mask, card: str, errs: dict):
    """The trained model's full-width encoder in training, forward and
    backward, through backend="pallas" on the epoch's last pool batch (415
    real rows of 512), with a fixed cotangent that is zero on the padded rows
    (as the masked loss gives). Held against the same encoder through the
    plain block versions on the card, and against the float32
    backend="xla" encoder (cuDNN without TF32, eager masked BatchNorm).

    Limits. Output and BN buffers: 1e-2 against the plain blocks, 3e-2
    against float32 (tests/test_pallas_blocks.py:37). Gradients: chained
    blocks pass a one-ulp bf16 flip on as a small move of the next block's
    statistics, and a value at LeakyReLU's kink turns its gradient from 1 to
    0.01; a BatchNorm bias gradient is a sum of terms of both signs, so a few
    such turns move it by a tenth. The plain path itself, given its input
    scaled by 1 + 1e-6, moves its whole gradient by about 4e-2 and single
    parameters' by up to about 0.13 (measured on the card). So the kernel
    path is held to the plain path as closely as the plain path holds to
    itself: the whole gradient within twice that spread (and 1e-2 at
    least), its cosine's distance from 1 within twice the spread's, each
    parameter within twice the worst parameter's spread, all measured in
    this run. Against float32 the whole gradient's cosine is above 0.97 (the
    JAX package's limit for its fused path, tests/test_pallas_blocks.py:245).
    The pass makes 8 forward and 8 backward block launches.

    Then times the encoder's forward and backward with both backends, and
    each block kernel against its plain version at the 8 blocks' shapes;
    returns the two kernels' records.
    """
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.ops import cuda_blocks as cb

    i = idx.shape[0] - 1
    bi = torch.as_tensor(idx[i], device="cuda").long()
    x = pool.wave[bi][:, None, :]
    bmask = torch.as_tensor(mask[i], device="cuda")
    z2 = model.encoder.linear.out_features
    cot = torch.from_numpy(np.random.default_rng(5).normal(size=(B, z2)).astype(np.float32)).cuda()
    cot = cot * bmask[:, None]

    def run(enc, how):
        enc.train()
        enc.zero_grad(set_to_none=True)
        if how == "plain":
            out = encoder_through_plain_blocks(enc, x, bmask)
        else:
            out = enc(x, bmask, backend=how)
        (out * cot).sum().backward()
        return out.detach()

    encs = {how: copy.deepcopy(model.encoder) for how in ("pallas", "plain", "plain_eps", "xla")}
    cb.reset_launches()
    outs = {"pallas": run(encs["pallas"], "pallas")}
    torch.cuda.synchronize()
    launches = dict(cb.launches)
    check(launches == {"enc_block_fwd": 8, "enc_block_bwd": 8},
          f"encoder pass made block launches {launches}, expected 8 forward and 8 backward")
    with full_fp32():
        outs["plain"] = run(encs["plain"], "plain")
        outs["xla"] = run(encs["xla"], "xla")
        x0, x = x, x * (1 + 1e-6)  # the plain path's own spread under a rounding-level change
        outs["plain_eps"] = run(encs["plain_eps"], "plain")
        x = x0
    real = bmask > 0
    check(bool(torch.isfinite(outs["pallas"]).all()), "encoder output not finite")

    def compare(a, b):
        grads = {n: rel_err(pa.grad, pb.grad) for (n, pa), pb in
                 zip(encs[a].named_parameters(), encs[b].parameters())}
        ga = torch.cat([p.grad.double().ravel() for p in encs[a].parameters()])
        gb = torch.cat([p.grad.double().ravel() for p in encs[b].parameters()])
        return {"out": rel_err(outs[a][real], outs[b][real]), "grads": grads,
                "grad": rel_err(ga, gb), "cos": float(ga @ gb / (ga.norm() * gb.norm())),
                "buffers": max(rel_err(ba, bb) for (n, ba), bb in zip(encs[a].named_buffers(),
                                                                      encs[b].buffers()) if "running" in n)}

    cmp = {"plain": compare("pallas", "plain"), "xla": compare("pallas", "xla"),
           "self": compare("plain_eps", "plain")}
    report = []
    for name, c in cmp.items():
        worst = sorted(c["grads"].items(), key=lambda kv: -kv[1])[:3]
        report.append(f"{name}: output {c['out']:.2e}, BN buffers {c['buffers']:.2e}, gradient "
                      f"{c['grad']:.2e} (cosine {c['cos']:.6f}), worst parameters "
                      + ", ".join(f"{k} {v:.2e}" for k, v in worst))
    print(f"[5c encoder] backend=pallas, one training pass at B={B} (tail {int(real.sum())} real rows): "
          f"launches {launches}\n  pallas vs " + "\n  pallas vs ".join(report[:2])
          + f"\n  plain(x * (1 + 1e-6)) vs plain: " + report[2].split(": ", 1)[1])
    for ref, lim in (("plain", 1e-2), ("xla", 3e-2)):
        check(cmp[ref]["out"] <= lim, f"encoder output vs {ref}: {cmp[ref]['out']:.3g} > {lim}")
        check(cmp[ref]["buffers"] <= lim, f"encoder BN buffers vs {ref}: {cmp[ref]['buffers']:.3g} > {lim}")
    own, got = cmp["self"], cmp["plain"]
    check(got["grad"] <= max(1e-2, 2 * own["grad"]),
          f"encoder gradient vs plain {got['grad']:.3g}, over twice the plain path's own {own['grad']:.3g}")
    check(1 - got["cos"] <= max(1e-4, 2 * (1 - own["cos"])),
          f"encoder gradient cosine vs plain {got['cos']:.6f}, own {own['cos']:.6f}")
    lim = max(1e-2, 2 * max(own["grads"].values()))
    for name, e in got["grads"].items():
        check(e <= lim, f"encoder {name} gradient vs plain {e:.3g} > {lim:.3g}")
    check(cmp["xla"]["cos"] > 0.97, f"encoder gradient cosine vs float32 {cmp['xla']['cos']:.6f}")

    # timings: the encoder's forward + backward, alternating the backends
    enc_ms = {"pallas": [], "xla": []}
    for how in ("pallas", "xla", "xla", "pallas"):
        enc_ms[how].append(time_ms(lambda: run(encs[how], how), n=20, warmup=3))
    print(f"  encoder fwd+bwd: pallas {enc_ms['pallas']} ms, xla (cuDNN defaults) {enc_ms['xla']} ms "
          f"on {card}")
    for how in ("pallas", "xla"):
        dev_us, n_dev = device_profile(lambda: run(encs[how], how), n=5)
        ms = min(enc_ms[how])
        print(f"  profile encoder {how}: device busy {dev_us / 1e3:.3f} ms of {ms:.3f} ms "
              f"(idle share {1 - dev_us / 1e3 / ms:.3f}), {n_dev:.0f} device kernels and copies per pass")
    per_shape = {}
    for stride, L, ci, co in sorted(set(ENC_BLOCKS), key=ENC_BLOCKS.index):
        args, g = enc_block_inputs(stride, L, ci, co, 415, seed=L + co)
        st = cb.enc_block_fwd_cuda(stride, *args)[1:]
        short = stride != 1
        fns = {"enc_block_fwd": (lambda: cb.enc_block_fwd_cuda(stride, *args),
                                 lambda: cb.enc_block_fwd_plain(stride, short, *args)),
               "enc_block_bwd": (lambda: cb.enc_block_bwd_cuda(stride, *args, *st, g),
                                 lambda: cb.enc_block_bwd_plain(stride, short, *args, *st, g))}
        bounds = enc_block_bounds(stride, L, ci, co)
        for name, (kernel, plain) in fns.items():
            ms, plain_ms = time_ms(kernel, n=50, warmup=5), time_ms(plain, n=20, warmup=3)
            dev_us, n_dev = device_profile(kernel)
            per_shape[(stride, L, ci, co, name)] = (ms, plain_ms, bounds[name][0], dev_us / 1e3,
                                                    bounds[name][1])
            print(f"  {name} s{stride} L{L} {ci}->{co}: kernel {ms * 1e3:.1f} us/call "
                  f"({dev_us:.1f} us device in {n_dev:.0f} kernels), plain {plain_ms * 1e3:.1f} us/call, "
                  f"bound {bounds[name][0] * 1e3:.2f} us ({bounds[name][1]})")
    kernels = []
    for name, line in (("enc_block_fwd", "568"), ("enc_block_bwd", "600")):
        rows = [per_shape[blk + (name,)] for blk in ENC_BLOCKS]
        tot = [sum(r[k] for r in rows) for k in range(4)]
        by_ops = sum(r[2] for r in rows if r[4] == "operations")
        bound_by = "operations" if by_ops >= tot[2] / 2 else "bytes"
        print(f"  {name} over the encoder's 8 blocks: kernel {tot[0]:.4f} ms ({tot[3]:.4f} ms device), "
              f"plain {tot[1]:.4f} ms, bound {tot[2]:.4f} ms ({by_ops:.4f} ms of it by operations) "
              f"on {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": ENC_SOURCE,
            "replaces": f"hippie_tpu/ops/pallas_blocks.py:{line}", "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot[0], "plain_ms": tot[1], "bound_ms": tot[2],
            "bound_by": bound_by, "library_ms": None,
        })
    return kernels


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
        enc_errs = phase_enc_blocks()
        enc_kernels = phase_encoder(ts.model, pool, idx, mask, card, enc_errs)
        phase_embed(ts.model)
        kernels = phase_timings(ts, pool, idx, mask, card, errs, launches) + enc_kernels
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
