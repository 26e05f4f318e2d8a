#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hippie_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from hippie_tpu_torch/csrc/, holds
the fused VAE-loss and masked-SSE kernels against their plain PyTorch
versions at the train steps' shapes, and trains the full-width waveform cVAE
(z=10, ResNet18 encoder and decoder, 8,056,639 parameters) for one epoch on
the cellexplorer-celltype pretraining pool from datasets/ twice from the same
weights: with the loss kernel and cuDNN blocks (block_backend="xla"), then
with the loss kernel and every BasicBlock of both backbones on the fused
block kernels (block_backend="pallas"), checking that each epoch went
through exactly the kernels it should. It checks one step of each against
the same step on the plain versions, holds the encoder and the decoder block
kernels against their plain versions at the full-width blocks' shapes (and
the encoder's at the ISI encoder's), runs the trained encoder's and
decoder's training passes through them (backend="pallas") against the plain
blocks and float32, and embeds the target dataset. Then the same for the
joint wave + ISI cVAE (16,115,748 parameters, four backbones, both loss
kernels): a stage-1 epoch with each block backend, one step against the
plain versions, the joint embeddings. Then it times the train steps with
both block backends and each kernel (vae_sums_bwd beside the device time of
a one-element torch op, the launch floor). Last it runs the port's unimodal
3-stage pipeline (run_unimodal_pipeline, the user's main path) at full width
on cellexplorer-celltype, one epoch per stage through the loss and block
kernels, and checks its 13 outputs, its checkpoints against the best
snapshots, its 45 balanced accuracies and its kernel launches; then the
joint 3-stage pipeline (run_pipeline(model_type="multimodal"), 16,115,748
parameters in stage 1, the path that runs all seven kernels) the same way:
5 outputs, 2 checkpoints, 15 balanced accuracies, exact launches, which
are the ``launches`` of the kernels line. Both pipelines write their
checkpoints in a background thread (BestTracker.flush_async), and print each
write's split and their peak device memory. Then the
inference CLI embeds the target with the unimodal pipeline's stage-3
checkpoints and the joint one's, each file held to the models called
directly, and k-means and the GMM run on the card against the host. Then
the unimodal pipeline with schedule-free AdamW and the joint one with bf16
Adam moments (12), with one step of each optimizer on the full-width model
against the host and the optimizer's device memory with float32 and bf16
moments, the embedding server on both pipelines'
checkpoints with its load test (13), the deployable artifact (14: the
three stage-3 checkpoints exported, loaded in a fresh process, held to the
models called directly, timed with bench_artifact, served), K-replica
training (15: a K=4 ensemble epoch through the kernels, exactly 4x the
launches, each replica its single-model epoch; the lr_sweep CLI with its
winners through the stage-1 seams) and k-fold (16: kfold_eval embed-once,
refit, and --fold-parallel, which runs the sequential refits, against it). Each block kernel is split by kernel
(device time and launches per call; at most 5 per enc_block_fwd and
dec_block_fwd call and 8 per enc_block_bwd and dec_block_bwd call), and the
block libraries' SASS is checked for wgmma (HGMMA).

Every phase prints one line. The second-to-last line is the ``kernels`` JSON
record, the last the device record. Exits non-zero, printing neither, when no
CUDA device is present, outside the repository, or when any phase fails.

To compare the pipelines of another checkout (a parent commit unpacked with
``git archive``) with this one on the same card:

    python3 chip_smoke.py --compare CHECKOUT [--pairs N]

runs, N times in turns (CHECKOUT then this tree, then this tree then
CHECKOUT, ...), a fresh process per run that builds that tree's kernels and
runs its phase 9 twice (cold: the process's first pipeline, as a CLI run;
then warm) and its phase 10, and prints each run's wall times and
``ckpt_save`` and the medians. ``python3 chip_smoke.py --artifact-replies
DIR [DEVICE]`` is phase 14's fresh process.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
DATA_ROOT = str(REPO / "datasets")
TARGET = "cellexplorer-celltype"
B, L, Z = 512, 50, 10  # the train step's batch, waveform length, latent width
L_ISI = 100  # the ISI histogram's length
LR, WD = 1e-3, 0.01  # stage-1 AdamW (the JAX pipeline's defaults)
CLIP = 1.0  # the joint pipeline always clips the gradients' global norm (quirk Q7)
FULL_PARAMS = 8_056_639
FULL_MM_PARAMS = 16_115_748
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, bf16 dense tensor-core FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# The full-width encoder's 8 BasicBlocks: (stride, L_in, C_in, C_out).
ENC_BLOCKS = ((1, 25, 64, 64), (1, 25, 64, 64), (2, 25, 64, 128), (1, 13, 128, 128),
              (2, 13, 128, 256), (1, 7, 256, 256), (2, 7, 256, 512), (1, 4, 512, 512))
# The full-width decoder's 8 BasicBlocks: (stride, L_in, C_in, C_out).
DEC_BLOCKS = ((1, 4, 512, 512), (2, 4, 512, 256), (1, 8, 256, 256), (2, 8, 256, 128),
              (1, 16, 128, 128), (2, 16, 128, 64), (1, 32, 64, 64), (1, 32, 64, 64))
# CUDA launches per call of the block kernels that run on the wgmma core
BLOCK_LAUNCH_LIMITS = {"enc_block_fwd": 5, "enc_block_bwd": 8, "dec_block_fwd": 5, "dec_block_bwd": 8}
# kernels of each block library that must run wgmma (HGMMA in their SASS)
WGMMA_KERNELS = {"enc_block": ("fwd_conv_kernel", "bwd_conv1_kernel", "bwd_mid_kernel", "bwd_dx_kernel"),
                 "dec_block": ("dec_fwd_conv2_kernel", "dec_fwd_conv1_kernel", "bwd_conv2_kernel",
                               "bwd_conv1_kernel", "bwd_mid_kernel", "bwd_dx_kernel")}


class Backbone(NamedTuple):
    """One backbone's fused block kernels, as chip_smoke.py drives them."""

    kind: str        # "enc" or "dec": the kernels are <kind>_block_fwd / _bwd
    blocks: tuple    # the full-width backbone's blocks, in order
    source: str
    lines: tuple     # pallas_blocks.py lines of the forward's and backward's pallas_call
    grads: tuple     # the backward's outputs
    bias_grads: dict  # conv-bias gradient -> positions of (gamma in the operands,
    #                   its statistics in the forward's outputs, dgamma in the grads)
    label: str       # phase_blocks' line tag


ENC = Backbone("enc", ENC_BLOCKS, "hippie_tpu_torch/csrc/enc_block.cu", ("568", "600"),
               ("dx", "dw1", "dg1", "db1", "dw2", "dg2", "db2", "dws", "dgs", "dbs"), {},
               "5b enc blocks")
DEC = Backbone("dec", DEC_BLOCKS, "hippie_tpu_torch/csrc/dec_block.cu", ("638", "669"),
               ("dx", "dw2", "dg2", "db2", "dw1", "dc1b", "dg1", "db1", "dws", "dcsb", "dgs", "dbs"),
               {"dc1b": (6, 2, 6), "dcsb": (10, 3, 10)}, "5d dec blocks")


def encoder_blocks(encoder, length: int) -> tuple:
    """(stride, L_in, C_in, C_out) of each BasicBlock of a ResNet18Enc on an
    input of ``length``, read from its modules (the stem halves the length)."""
    out, n = [], (length - 1) // 2 + 1
    for block in (b for layer in (encoder.layer1, encoder.layer2, encoder.layer3, encoder.layer4)
                  for b in layer):
        co, ci = block.conv1.weight.shape[:2]
        out.append((block.stride, n, ci, co))
        n = n if block.stride == 1 else (n - 1) // 2 + 1
    return tuple(out)


def decoder_blocks(decoder) -> tuple:
    """(stride, L_in, C_in, C_out) of each BasicBlockDec of a ResNet18Dec, read
    from the blocks' inputs and outputs in an eval forward of two rows on the
    host (weights left unset: only the shapes are read)."""
    import torch

    dec = copy.deepcopy(decoder).to_empty(device="cpu").eval()
    seen = []
    hooks = [b.register_forward_hook(lambda mod, args, out: seen.append(
        (mod.stride, args[0].shape[2], args[0].shape[1], out.shape[1])))
        for layer in (dec.layer4, dec.layer3, dec.layer2, dec.layer1) for b in layer]
    with torch.no_grad():
        dec(torch.zeros(2, dec.linear.in_features))
    for h in hooks:
        h.remove()
    return tuple(seen)


ISI_LABEL = "5f ISI enc blocks"


def isi_backbone() -> Backbone:
    """The encoder's block kernels at the joint model's ISI encoder's blocks
    (input length 100), read from the model. Checks that its waveform encoder
    has ENC_BLOCKS' shapes and both its decoders DEC_BLOCKS', so that phases
    5b and 5d time the joint step's other three backbones."""
    import torch

    from hippie_tpu_torch.models import cvae

    with torch.device("meta"):
        model = cvae.MultiModalCVAE(joint_config())
    wave = encoder_blocks(model.encoder_mod1, L)
    check(wave == ENC_BLOCKS, f"the waveform encoder's blocks {wave}, expected {ENC_BLOCKS}")
    for name in ("decoder_mod1", "decoder_mod2"):
        got = decoder_blocks(getattr(model, name))
        check(got == DEC_BLOCKS, f"the joint model's {name} blocks {got}, expected {DEC_BLOCKS}")
    print("  joint model: waveform encoder at ENC_BLOCKS' shapes, both decoders at DEC_BLOCKS'")
    return ENC._replace(blocks=encoder_blocks(model.encoder_mod2, L_ISI), label=ISI_LABEL)


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


def sse_inputs(n_real: int, pad=None, seed: int = 0, device="cuda"):
    """(data, dec, mask_col) at the joint step's second modality, [B, 100];
    the rows past ``n_real`` are padding, with dec at +-``pad`` there (+-inf
    when ``pad`` is inf)."""
    import torch

    r = np.random.default_rng(seed)
    data = r.normal(size=(B, L_ISI)).astype(np.float32)
    dec = r.normal(size=(B, L_ISI)).astype(np.float32)
    if pad is not None:
        sign = np.where(np.arange(B - n_real) % 2 == 0, 1.0, -1.0).astype(np.float32)[:, None]
        dec[n_real:] = pad * sign
    mask = (np.arange(B) < n_real).astype(np.float32).reshape(B, 1)
    return tuple(torch.from_numpy(x).to(device) for x in (data, dec, mask))


def masked_sse_bound(b: int, l: int):
    """Least time (ms) of the masked-SSE forward: data and dec [b, l] and the
    mask read once, one float written, against its 4 float32 operations per
    element (sub, square, mask, add)."""
    t_bytes = 4 * (2 * b * l + b + 1) / PEAK_BYTES_PER_S * 1e3
    t_ops = 4 * b * l / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def dec_block_inputs(stride, L, ci, co, n_real: int = B, pad=None, seed: int = 0, device="cuda"):
    """The decoder block's operands in the kernels' layout: (x, w2, g2, b2, w1,
    c1b, g1, b1, ws, csb, gs, bs, mask) and the output cotangent g. Rows past
    ``n_real`` are padding, driven to +-``pad`` in x when it is given. c1b and
    the shortcut's four are None for a stride-1 block."""
    import torch

    r = np.random.default_rng(seed)
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    x = f(L, B, ci)
    if pad is not None:
        x[:, n_real:] = pad * np.where(r.random((L, B - n_real, ci)) < 0.5, 1.0, -1.0)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    bf = torch.bfloat16
    vec = lambda c: [dev(r.uniform(0.5, 1.5, c)), dev(0.1 * f(c))]  # noqa: E731
    ts = [dev(x, bf), dev(f(3, ci, ci) / np.sqrt(3 * ci), bf), *vec(ci),
          dev(f(3, ci, co) / np.sqrt(3 * ci), bf), dev(0.1 * f(co)) if stride != 1 else None, *vec(co)]
    if stride != 1:
        ts += [dev(f(3, ci, co) / np.sqrt(3 * ci), bf), dev(0.1 * f(co)), *vec(co)]
    else:
        ts += [None] * 4
    ts.append(dev((np.arange(B) < n_real).reshape(B, 1)))
    return ts, dev(f(L * stride, B, co), bf)


def dec_block_bounds(stride, L, ci, co, b: int = B):
    """As enc_block_bounds for a decoder block, each conv counted at its own
    length: conv2 at L_in, conv1 and the shortcut's conv at L_out = stride *
    L_in (on the upsampled input)."""
    lo = L * stride
    short = stride != 1
    fwd_ops = 2 * b * (L * 3 * ci * ci + lo * 3 * ci * co * (2 if short else 1))
    wts = 3 * ci * ci + 3 * ci * co * (2 if short else 1)
    vecs = 2 * ci + (6 if short else 2) * co  # gammas, betas and conv biases
    x_b, y_b = 2 * L * b * ci, 2 * lo * b * co
    stats = 4 * 3 * (ci + 2 * co)
    common = x_b + 2 * wts + 4 * vecs + 4 * b
    fwd_bytes = common + y_b + stats
    bwd_bytes = common + stats + y_b + x_b + 4 * wts + 4 * vecs
    out = {}
    for name, nbytes, ops in (("dec_block_fwd", fwd_bytes, fwd_ops),
                              ("dec_block_bwd", bwd_bytes, 3 * fwd_ops)):
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_BF16_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def block_inputs(bb: Backbone, *args, **kw):
    return (enc_block_inputs if bb.kind == "enc" else dec_block_inputs)(*args, **kw)


def block_bounds(bb: Backbone, *args):
    return (enc_block_bounds if bb.kind == "enc" else dec_block_bounds)(*args)


def bias_grad_tol(g, gamma, st, dgamma) -> float:
    """Limit of |kernel - plain| for a conv bias's gradient before BatchNorm
    (the decoder's dc1b, dcsb). In exact arithmetic it is -gamma * inv *
    dgamma * sum(m * xh) / n: the bf16 xh's mean over the real rows, zero but
    for rounding, times gamma * inv * dgamma, which padded rows far out
    (with a nonzero cotangent) make large. So 1e-2 * |g| (the JAX package's
    limit, tests/test_pallas_blocks.py:172-181) plus 1e-3 of that factor
    (at most 3.9e-5 of it measured on the CPU, tests/test_torch_dec_blocks.py)."""
    return float(1e-2 * g.double().norm() + 1e-3 * (gamma * st[2] * dgamma).double().norm())


@contextlib.contextmanager
def plain_blocks():
    """Within it, the backbones' backend="pallas" path runs every block on the
    plain versions under autograd (PlainEncBlockFn, PlainDecBlockFn): the
    card's reference for the block kernels along the same path."""
    from hippie_tpu_torch.ops import cuda_blocks as cb

    saved = cb.EncBlockFn, cb.DecBlockFn
    cb.EncBlockFn, cb.DecBlockFn = cb.PlainEncBlockFn, cb.PlainDecBlockFn
    try:
        yield
    finally:
        cb.EncBlockFn, cb.DecBlockFn = saved


def all_launches() -> dict:
    from hippie_tpu_torch.ops import cuda_blocks, cuda_ops

    return {**cuda_ops.launches, **cuda_blocks.launches}


def reset_all_launches():
    from hippie_tpu_torch.ops import cuda_blocks, cuda_ops

    cuda_ops.reset_launches()
    cuda_blocks.reset_launches()


def kernel_name(key: str) -> str:
    """A device kernel's profiler key without its return type, namespace and arguments."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return re.sub(r"^blocks::|^sm90::", "", name.removeprefix("void ").replace(", ", ","))


def device_profile(fn, n: int = 10):
    """(device us, device kernels and copies, split) per call of ``fn``, from
    torch.profiler over ``n`` calls; ``split`` maps each kernel's name
    (kernel_name) to its (device us, launches) per call. (0.0, 0.0, {}) if
    the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # the tracer sometimes drops whole calls' device events: take a full trace
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and e.self_device_time_total > 0]
        if rows and all(r[1] % n == 0 for r in rows):
            break
    split = {}
    for us, count, key in sorted(rows, reverse=True):
        us0, c0 = split.get(kernel_name(key), (0.0, 0.0))
        split[kernel_name(key)] = (us0 + us / n, c0 + count / n)
    return sum(r[0] for r in rows) / n, sum(r[1] for r in rows) / n, split


def split_line(split: dict) -> str:
    """One line of device_profile's split: name us x launches, largest first."""
    return ", ".join(f"{k} {us:.1f} us x{c:g}" for k, (us, c) in split.items())


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
            if any(w in line.lower() for w in ("registers", "spill", "warning")):
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[2 build] {len(secs)} source(s) {sorted(secs)} built with nvcc in {wall:.2f} s")
    # the block kernels on the wgmma core: HGMMA in each GEMM kernel's SASS
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    for lib, names in WGMMA_KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.so_path(lib))], capture_output=True,
                              text=True, timeout=300).stdout
        fns = sass.split("Function : ")[1:]  # each kernel's SASS, its name first
        with_hgmma = {f.split()[0]: f.count("HGMMA") for f in fns if "HGMMA" in f}
        print(f"  {lib} SASS: HGMMA instructions in {len(with_hgmma)} of {len(fns)} kernels: {with_hgmma}")
        for name in names:
            check(any(name in k for k in with_hgmma), f"no HGMMA instruction in {lib}'s {name}")


def phase_kernel_vs_plain(device="cuda"):
    """The loss kernels against their plain versions: values rtol 4e-6,
    gradients rtol 1e-5 / atol 1e-7; repeat runs equal bit for bit; padded
    rows at +-1e4, +-inf and +-1e7; vae_sums_fwd one CUDA launch per call.

    The values are sums of B*L = 25,600 and B*z = 5,120 nonnegative float32
    terms, summed in a different order by the kernel (per-thread strides, then
    warp and block trees) and by torch. Each order's error is bounded by about
    (log2(25,600) + 1) * 2^-24 = 9.5e-7 of the sum, so the two differ by at
    most 1.9e-6; rtol 4e-6 leaves a factor 2 (the masked SSE's 51,200 terms:
    1.0e-6 and 2.0e-6). The gradients are elementwise (test_pallas.py's rtol
    1e-5).
    """
    import torch

    from hippie_tpu_torch.ops import cuda_ops

    err = {"vae_sums_fwd": 0.0, "vae_sums_bwd": 0.0}
    cases = {"full": (B, None), "tail_415": (415, None), "tail_415_pad_1e4": (415, 1e4),
             "tail_415_pad_inf": (415, np.inf), "one_row_pad_1e7": (1, 1e7)}
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
    x = loss_inputs(415, device=device)
    _, n_fwd, split = device_profile(lambda: cuda_ops.vae_sums_fwd_cuda(*x), n=50)
    print(f"  vae_sums_fwd: {n_fwd:g} CUDA launches per call ({split_line(split)})")
    check(n_fwd <= 1, f"vae_sums_fwd makes {n_fwd:g} CUDA launches per call, over 1")
    print(f"[3 kernel vs plain] vae_sums_fwd and vae_sums_bwd agree with the plain version on "
          f"{len(cases)} cases at B={B} L={L} z={Z}")
    err["masked_sse_fwd"] = masked_sse_vs_plain(device)
    return err


def masked_sse_vs_plain(device="cuda") -> float:
    """masked_sse_fwd against masked_sse_plain at [B, 100] (phase 3's limits),
    on the full batch and on a 415-row tail whose padded rows hold +-1e4 or
    inf; repeats bit-equal; the autograd backward (fused_masked_sse) against
    autograd through the plain version. Returns the largest |kernel - plain|."""
    import torch

    from hippie_tpu_torch.ops import cuda_ops

    worst = 0.0
    cases = {"full": (B, None), "tail_415_pad_1e4": (415, 1e4), "tail_415_pad_inf": (415, np.inf)}
    for case, (n_real, pad) in cases.items():
        data, dec, m = sse_inputs(n_real, pad, device=device)
        got = cuda_ops.masked_sse_fwd_cuda(data, dec, m)
        ref = cuda_ops.masked_sse_plain(data, dec, m)
        check(bool(torch.isfinite(got)), f"masked_sse {case}: kernel sum not finite: {got}")
        torch.testing.assert_close(got, ref, rtol=4e-6, atol=0)
        runs = [cuda_ops.masked_sse_fwd_cuda(data, dec, m) for _ in range(3)]
        check(all(torch.equal(r, got) for r in runs), f"masked_sse {case}: repeat runs differ")
        g = 1.0 / (n_real * L_ISI)
        leaves = [t.clone().requires_grad_(True) for t in (data, dec)]
        (g * cuda_ops.fused_masked_sse(*leaves, m)).backward()
        ref_leaves = [t.clone().requires_grad_(True) for t in (data, dec)]
        (g * cuda_ops.masked_sse_plain(*ref_leaves, m)).backward()
        for name, a, b in zip(("ddata", "ddec"), leaves, ref_leaves):
            check(bool(torch.isfinite(a.grad).all()), f"masked_sse {case}: {name} not finite")
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-7,
                                       msg=lambda msg: f"masked_sse {case} {name}: {msg}")
        diff = float((got - ref).abs())
        worst = max(worst, diff)
        print(f"  masked_sse {case}: sum {float(got):.6f} |kernel - plain| {diff:.3g}")
    print(f"[3 kernel vs plain] masked_sse_fwd agrees with the plain version on {len(cases)} cases "
          f"at B={B} L={L_ISI}, repeats bit-equal, autograd gradients as the plain version's")
    return worst


def full_config():
    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.models import cvae

    return cvae.CVAEConfig(z_dim=Z, output_size=L, class_hidden_dim=5,
                           num_sources=registry.NUM_SOURCES, num_classes=5)


def phase_slice(cfg, block_backend: str = "xla", pool=None, batch_size: int = B, device="cuda"):
    """Stage-1 pretraining of the waveform model for one epoch over the
    leave-target-out pool with the fused VAE-loss kernel and the given block
    backend, from the seeded initial weights (the same in every call); returns
    what the later phases need, the kernels' launch counts of this epoch and
    its losses."""
    import torch

    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import optim, pipeline, step

    pcfg = pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False, device=device)
    t0 = time.perf_counter()
    pool = pipeline.load_pretrain_pool(pcfg) if pool is None else pool
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
    train_epoch, _ = step.make_unimodal_epoch_fns(beta=1.0, loss_backend="pallas",
                                                  block_backend=block_backend)
    gen = torch.Generator(device=device).manual_seed(2)

    reset_all_launches()
    t0 = time.perf_counter()
    ts, metrics = train_epoch(ts, pool.wave, pool.source, None, idx, mask, generator=gen)
    losses = metrics.loss.tolist()
    epoch_s = time.perf_counter() - t0
    launches = all_launches()

    nb = idx.shape[0]
    check(all(np.isfinite(losses)), f"non-finite loss in the epoch: {losses}")
    check(int(mask[-1].sum()) == len(pool) - (nb - 1) * batch_size, "tail mask is wrong")
    if device != "cpu":
        per_step = sum(cfg.num_blocks) if block_backend == "pallas" else 0  # blocks per backbone
        want = {k: (nb if k.startswith("vae_sums") else 0 if k == "masked_sse_fwd" else per_step * nb)
                for k in launches}
        check(launches == want, f"kernel launches {launches}, expected {want}")
    tag = "[4 slice]" if block_backend == "xla" else f"[4b slice, block_backend={block_backend}]"
    print(f"{tag} pool {len(pool)} rows loaded and preprocessed in {load_s:.2f} s; "
          f"{n_params:,} params; {nb} steps at B={batch_size} (tail {int(mask[-1].sum())} real rows) "
          f"in {epoch_s:.2f} s with the first call's set-up; losses {[round(x, 5) for x in losses]}; "
          f"launches {launches}")
    return ts, pool, idx, mask, launches, losses


def last_batch(model, pool, idx, mask, device="cuda"):
    """The epoch's last pool batch (the masked tail) and fixed noise for it."""
    import torch

    i = idx.shape[0] - 1
    bi = torch.as_tensor(idx[i], device=device).long()
    eps = torch.from_numpy(np.random.default_rng(3).normal(size=(len(bi), model.z_mean.out_features))
                           .astype(np.float32)).to(device)
    return pool.wave[bi], pool.source[bi], torch.as_tensor(mask[i], device=device), eps


@contextlib.contextmanager
def plain_losses():
    """Within it, loss_backend="pallas" computes its sums with the loss
    kernels' plain versions under autograd: the card's reference for the loss
    kernels along the same path."""
    from hippie_tpu_torch.ops import cuda_ops as co

    saved = co.fused_vae_sums, co.fused_masked_sse
    co.fused_vae_sums = lambda *a: tuple(co.vae_sums_plain(*a).unbind(0))
    co.fused_masked_sse = co.masked_sse_plain
    try:
        yield
    finally:
        co.fused_vae_sums, co.fused_masked_sse = saved


def phase_step_parity(model, pool, idx, mask, device="cuda"):
    """One unimodal step against the same step on the plain versions
    (step_parity), on the epoch's last pool batch (the masked tail)."""
    from hippie_tpu_torch.train import step

    bd, bs, bmask, eps = last_batch(model, pool, idx, mask, device)

    def run(block_backend, ts, scale):
        batch_step, _ = step.make_unimodal_steps(beta=1.0, loss_backend="pallas",
                                                 block_backend=block_backend)
        return batch_step(ts, bd * scale, bs, None, bmask, eps=eps)[1].loss

    step_parity(model, run, "5 step parity", {"vae_sums_fwd": 1, "vae_sums_bwd": 1, "masked_sse_fwd": 0,
                                              "enc_block_fwd": 8, "enc_block_bwd": 8,
                                              "dec_block_fwd": 8, "dec_block_bwd": 8})


def step_parity(model, run, label: str, block_launches: dict, clip_val=None):
    """One step with loss_backend="pallas" against the same step through the
    loss kernels' plain versions (plain_losses), from the same weights, batch
    and injected noise, convolutions in full float32 and cuDNN deterministic.
    Loss rtol 1e-5. Parameters: AdamW's first update is about lr * sign(g),
    so an element whose gradient is at rounding level may move either way;
    where |g| > 1e-4 in both steps the new values agree to 1e-6 (lr / 1000),
    everywhere to 2 * lr.

    Then one step with block_backend="pallas" as well, against the same step
    with every block on the plain versions (plain_blocks). The backbones
    chain bf16 blocks, whose gradients are chaotic (a one-ulp flip moves the
    next block's statistics; a value at LeakyReLU's kink turns its gradient
    from 1 to 0.01), so, as phase 5c, the kernel step is held to the plain
    step as closely as the plain step holds to itself with its input scaled
    by 1 + 1e-6, measured here: the whole gradient within twice that spread
    (and 1e-2 at least), its cosine's distance from 1 within twice the
    spread's (and 1e-4 at least). Loss rtol 1e-2 and BN buffers 1e-2 (the
    CPU test's limits against the JAX fused step), parameters within 2 * lr.

    ``run(block_backend, ts, scale)`` makes one train step of ``ts`` with its
    data scaled by ``scale`` and returns the loss."""
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.train import optim, step

    nullctx = contextlib.nullcontext
    runs = {"kernel": ("xla", nullctx, nullctx, 1.0),
            "plain": ("xla", plain_losses, nullctx, 1.0),
            "blocks_kernel": ("pallas", nullctx, nullctx, 1.0),
            "blocks_plain": ("pallas", nullctx, plain_blocks, 1.0),
            "blocks_plain_eps": ("pallas", nullctx, plain_blocks, 1 + 1e-6)}
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with full_fp32():
            for name, (block_backend, losses_ctx, blocks_ctx, scale) in runs.items():
                m = copy.deepcopy(model)
                ts = step.TrainState(m, optim.make_optimizer(m.parameters(), LR, WD, clip_val=clip_val))
                reset_all_launches()
                with losses_ctx(), blocks_ctx():
                    loss = float(run(block_backend, ts, scale))
                out[name] = (loss, m, all_launches())
    finally:
        torch.backends.cudnn.deterministic = deterministic

    (lk, mk, _), (lp, mp, launched) = out["kernel"], out["plain"]
    check(all(v == 0 for v in launched.values()), f"the plain step launched {launched}")
    check(np.isfinite([lk, lp]).all(), f"non-finite loss: {lk} {lp}")
    check(abs(lk - lp) <= 1e-5 * abs(lp), f"loss {lk} vs plain {lp}")
    worst, n_loose, n_total = 0.0, 0, 0
    for (name, pk), pp in zip(mk.named_parameters(), mp.parameters()):
        d = (pk - pp).detach().abs()
        check(float(d.max()) <= 2 * LR * (1 + 1e-3), f"{name}: moved {float(d.max())} apart")
        decisive = (pk.grad.abs() > 1e-4) & (pp.grad.abs() > 1e-4)
        if bool(decisive.any()):
            worst = max(worst, float(d[decisive].max()))
        n_loose += int((d > 1e-6).sum())
        n_total += d.numel()
    check(worst <= 1e-6, f"parameters with decisive gradients differ by {worst}")
    for (name, bk), bp in zip(mk.named_buffers(), mp.buffers()):
        check(torch.allclose(bk.double(), bp.double(), rtol=1e-5, atol=1e-6), f"{name} differs")
    print(f"[{label}] loss kernel {lk:.8f} plain {lp:.8f} (rel {abs(lk - lp) / abs(lp):.3g}); "
          f"decisive params max |diff| {worst:.3g}; {n_loose} of {n_total} elements differ by "
          f"more than 1e-6 (all within 2 * lr)")

    # block_backend="pallas": the block kernels against the plain blocks
    check(out["blocks_kernel"][2] == block_launches,
          f"the block_backend=pallas step launched {out['blocks_kernel'][2]}, expected {block_launches}")
    check(all(v == 0 for k, v in out["blocks_plain"][2].items() if "block" in k),
          "the plain-blocks step launched a block kernel")

    def grads(m):
        return torch.cat([p.grad.double().ravel() for p in m.parameters()])

    def compare(a, b):
        (la, ma, _), (lb, mb, _) = out[a], out[b]
        ga, gb = grads(ma), grads(mb)
        bufs = max(rel_err(x, y) for (n, x), y in zip(ma.named_buffers(), mb.buffers()) if "running" in n)
        moved = max(float((x - y).detach().abs().max()) for x, y in zip(ma.parameters(), mb.parameters()))
        return {"loss": abs(la - lb) / abs(lb), "grad": rel_err(ga, gb),
                "cos": float(ga @ gb / (ga.norm() * gb.norm())), "buffers": bufs, "moved": moved}

    got, own = compare("blocks_kernel", "blocks_plain"), compare("blocks_plain_eps", "blocks_plain")
    n_fwd = sum(v for k, v in block_launches.items() if k.endswith("block_fwd"))
    print(f"  block_backend=pallas ({n_fwd} block launches each way): loss kernel "
          f"{out['blocks_kernel'][0]:.8f} plain {out['blocks_plain'][0]:.8f}; kernel vs plain: "
          + ", ".join(f"{k} {v:.3g}" for k, v in got.items()) + "; plain(x * (1 + 1e-6)) vs plain: "
          + ", ".join(f"{k} {v:.3g}" for k, v in own.items()))
    check(np.isfinite([out["blocks_kernel"][0], out["blocks_plain"][0]]).all(), "non-finite block loss")
    check(got["loss"] <= 1e-2, f"block step loss vs plain {got['loss']:.3g}")
    check(got["buffers"] <= 1e-2, f"block step BN buffers vs plain {got['buffers']:.3g}")
    check(got["moved"] <= 2 * LR * (1 + 1e-3), f"block step parameters {got['moved']:.3g} apart")
    check(got["grad"] <= max(1e-2, 2 * own["grad"]),
          f"block step gradient vs plain {got['grad']:.3g}, own spread {own['grad']:.3g}")
    check(1 - got["cos"] <= max(1e-4, 2 * (1 - own["cos"])),
          f"block step gradient cosine vs plain {got['cos']:.6f}, own {own['cos']:.6f}")


def stats_err(a, b) -> float:
    """Largest error of (mean, var, inv) rows against their scale: |mean| + std, var, inv."""
    import torch

    scale = torch.stack([b[0].abs() + b[1].clamp_min(0).sqrt(), b[1].abs(), b[2].abs()])
    err = (a - b).abs()
    return float(torch.where(scale > 0, err / scale.clamp_min(1e-30), err * 1e30).max())


def phase_blocks(bb: Backbone, card: str):
    """A backbone's block kernels against their plain versions at the
    full-width backbone's distinct block shapes, B=512: a full batch, and a 415-row tail whose
    padded rows of x hold +-1e4. The cotangent is nonzero on every row, so
    BatchNorm's backward sums over all entries are held too; both backwards
    get the kernel forward's statistics. Then each kernel's time per call
    (CUDA events, and the profiler's device time) beside its plain version's
    and its bound, per shape, and its device kernels by time and count per call.

    Limits. Kernel and plain multiply the same bf16 operands exactly into
    float32 and round to bf16 at the same points; they differ only in the
    order of the float32 sums (tensor-core tiles and fixed split-K against
    cuBLAS). That moves a value by about 1e-7 of its size, and flips its
    bf16 rounding (2^-8 relative) only where it lies that close to a rounding
    boundary. The gradients amplify that: a BatchNorm bias gradient sums
    terms of both signs over up to 16,384 rows, and one value turning at
    LeakyReLU's kink moves it by about 1e-2 of its size. So the bf16 outputs
    (out and dx, over all rows and over the real rows) and the float32
    weight and affine gradients are held at relative Frobenius norm 1e-2
    (encoder measured worst 4.9e-3 in PR 3), the conv biases' gradients (the
    decoder's dc1b, dcsb; rounding noise in exact arithmetic) by
    bias_grad_tol, and the statistics (mean, var, inv) at 1e-4 of their
    scale (|mean| + std, var, inv). Both are tighter than the JAX package's
    3e-2 for its fused block against float32 (tests/test_pallas_blocks.py:37).
    Repeat runs of both kernels are bit-equal. Returns the largest
    |kernel - plain| of out (forward) and dx (backward) in the full-batch
    cases, and the per-shape timings.
    """
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.ops import cuda_blocks as cb

    ops = cb.ENC_OPS if bb.kind == "enc" else cb.DEC_OPS
    fwd, bwd = f"{bb.kind}_block_fwd", f"{bb.kind}_block_bwd"
    shapes = sorted(set(bb.blocks), key=bb.blocks.index)
    err = {fwd: 0.0, bwd: 0.0}
    worst = {}
    for stride, L, ci, co in shapes:
        for case, (n_real, pad) in (("full", (B, None)), ("tail_415", (415, 1e4))):
            tag = f"s{stride} L{L} {ci}->{co} {case}"
            args, g = block_inputs(bb, stride, L, ci, co, n_real, pad, seed=L + co)
            got = ops.fwd_cuda(stride, *args)
            dgot = ops.bwd_cuda(stride, *args, *got[1:], g)
            with full_fp32():
                ref = ops.fwd_plain(stride, *args)
                dref = ops.bwd_plain(stride, *args, *got[1:], g)
            torch.cuda.synchronize()
            real = slice(0, n_real)
            rels = {"out": max(rel_err(got[0], ref[0]), rel_err(got[0][:, real], ref[0][:, real]))}
            for name, a, b in zip(bb.grads, dgot, dref):
                if a is None:  # no shortcut: the plain version's zeros
                    check(not b.any(), f"{tag}: plain {name} is not zero")
                    continue
                check(bool(torch.isfinite(a).all()), f"{tag}: kernel {name} not finite")
                if name in bb.bias_grads:
                    gi, si, di = bb.bias_grads[name]
                    d, tol = float((a - b).double().norm()), bias_grad_tol(g, args[gi], got[si], dref[di])
                    check(d <= tol, f"{tag}: {name} |kernel - plain| {d:.3g} > {tol:.3g}")
                    worst[f"{name}/limit"] = max(worst.get(f"{name}/limit", 0.0), d / tol)
                    continue
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
                again = ops.fwd_cuda(stride, *args)
                dagain = ops.bwd_cuda(stride, *args, *got[1:], g)
                check(all(torch.equal(a, b) for a, b in zip(again, got)), f"{tag}: forward repeat differs")
                check(all(a is None or torch.equal(a, b) for a, b in zip(dagain, dgot)),
                      f"{tag}: backward repeat differs")
            if pad is None:  # padded rows at +-1e4 make values whose one ulp is several units
                err[fwd] = max(err[fwd], float((got[0].float() - ref[0].float()).abs().max()))
                err[bwd] = max(err[bwd], float((dgot[0].float() - dref[0].float()).abs().max()))
            print(f"  {tag}: " + " ".join(f"{k} {v:.2e}" for k, v in rels.items()) + f" stats {st:.2e}")
    print(f"[{bb.label}] {fwd} and {bwd} agree with the plain version at {len(shapes)} shapes x 2 cases, "
          f"B={B}; worst " + " ".join(f"{k} {v:.2e}" for k, v in worst.items()) + "; repeat runs bit-equal")

    per_shape = {}
    for stride, L, ci, co in shapes:
        args, g = block_inputs(bb, stride, L, ci, co, 415, seed=L + co)
        st = ops.fwd_cuda(stride, *args)[1:]
        fns = {fwd: (lambda: ops.fwd_cuda(stride, *args), lambda: ops.fwd_plain(stride, *args)),
               bwd: (lambda: ops.bwd_cuda(stride, *args, *st, g),
                     lambda: ops.bwd_plain(stride, *args, *st, g))}
        bounds = block_bounds(bb, stride, L, ci, co)
        for name, (kernel, plain) in fns.items():
            ms, plain_ms = time_ms(kernel, n=50, warmup=5), time_ms(plain, n=20, warmup=3)
            dev_us, n_dev, split = device_profile(kernel)
            per_shape[(stride, L, ci, co, name)] = (ms, plain_ms, bounds[name][0], dev_us / 1e3,
                                                    bounds[name][1], n_dev)
            print(f"  {name} s{stride} L{L} {ci}->{co}: kernel {ms * 1e3:.1f} us/call "
                  f"({dev_us:.1f} us device in {n_dev:.0f} kernels), plain {plain_ms * 1e3:.1f} us/call, "
                  f"bound {bounds[name][0] * 1e3:.2f} us ({bounds[name][1]}) on {card}")
            print(f"    {name} s{stride} L{L} {ci}->{co} split: {split_line(split)}")
    return err, per_shape


def block_records(bb: Backbone, per_shape: dict, errs: dict, launches: dict, card: str):
    """The kernels-line records of a backbone's two block kernels: times and
    bounds summed over the full-width backbone's blocks."""
    kernels = []
    for d, line in zip(("fwd", "bwd"), bb.lines):
        name = f"{bb.kind}_block_{d}"
        rows = [per_shape[blk + (name,)] for blk in bb.blocks]
        tot = [sum(r[k] for r in rows) for k in range(4)]
        by_ops = sum(r[2] for r in rows if r[4] == "operations")
        bound_by = "operations" if by_ops >= tot[2] / 2 else "bytes"
        per_call = sorted({round(r[5]) for r in rows})
        print(f"  {name} over the {len(bb.blocks)} blocks ({bb.label}): kernel {tot[0]:.4f} ms ({tot[3]:.4f} ms device "
              f"in {'/'.join(map(str, per_call))} CUDA launches per call), "
              f"plain {tot[1]:.4f} ms, bound {tot[2]:.4f} ms ({by_ops:.4f} ms of it by operations) "
              f"on {card}")
        kernels.append({
            "name": name, "route": "cuda", "source": bb.source,
            "replaces": f"hippie_tpu/ops/pallas_blocks.py:{line}", "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot[0], "plain_ms": tot[1], "bound_ms": tot[2],
            "bound_by": bound_by, "library_ms": None,
        })
    return kernels


def decoder_input(model, bd, bs, bmask, eps):
    """What the trained model's decoder sees in a training forward of this batch."""
    import torch

    seen = {}
    m = copy.deepcopy(model).train()
    hook = m.decoder.register_forward_hook(lambda mod, args, out: seen.setdefault("d", args[0]))
    with torch.no_grad():
        m(bd, bs, None, eps=eps, mask=bmask)
    hook.remove()
    return seen["d"].detach()


def phase_pass(bb: Backbone, model, pool, idx, mask, card: str):
    """The trained model's full-width encoder or decoder in training, forward
    and backward, through backend="pallas" on the epoch's last pool batch
    (415 real rows of 512), with a fixed cotangent that is zero on the padded
    rows (as the masked loss gives). The decoder's input is what it sees in
    the model's training forward of that batch. Held against the same
    backbone through the plain block versions on the card (plain_blocks), and
    against the float32 backend="xla" one (cuDNN without TF32, eager masked
    BatchNorm).

    Limits. Output and BN buffers: 1e-2 against the plain blocks, 3e-2
    against float32 (tests/test_pallas_blocks.py:37); against the plain
    blocks the output may also take twice the plain path's own spread
    (measured as the gradients' below; the decoder's output moved by 8.1e-3
    under the 1e-6 input change on the card). Gradients: chained
    blocks pass a one-ulp bf16 flip on as a small move of the next block's
    statistics, and a value at LeakyReLU's kink turns its gradient from 1 to
    0.01; a BatchNorm bias gradient is a sum of terms of both signs, so a few
    such turns move it by a tenth. The plain path itself, given its input
    scaled by 1 + 1e-6, moves its whole gradient by about 4e-2 and single
    parameters' by up to about 0.13 (the encoder, measured on the card in
    PR 3). So the kernel path is held to the plain path as closely as the
    plain path holds to itself: the whole gradient within twice that spread
    (and 1e-2 at least), its cosine's distance from 1 within twice the
    spread's, each parameter within twice the worst parameter's spread, all
    measured in this run; the decoder's conv biases before a BatchNorm,
    whose gradients are rounding noise, are left out of the per-parameter
    check. Against float32 the whole gradient's cosine is above 0.97 (the
    JAX package's limit for its fused path, tests/test_pallas_blocks.py:245).
    The pass makes 8 forward and 8 backward block launches of its kind.
    Then times the pass with both backends and profiles it.
    """
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32

    bd, bs, bmask, eps = last_batch(model, pool, idx, mask)
    if bb.kind == "enc":
        module, x = model.encoder, bd[:, None, :]
        width = model.encoder.linear.out_features
    else:
        module, x = model.decoder, decoder_input(model, bd, bs, bmask, eps)
        width = model.decoder.linear_out.out_features
    cot = torch.from_numpy(np.random.default_rng(5).normal(size=(B, width)).astype(np.float32)).cuda()
    cot = cot * bmask[:, None]

    def run(mod, how, scale=1.0):
        mod.train()
        mod.zero_grad(set_to_none=True)
        with plain_blocks() if how == "plain" else contextlib.nullcontext():
            out = mod(x * scale, bmask, backend="xla" if how == "xla" else "pallas")
        (out * cot).sum().backward()
        return out.detach()

    mods = {how: copy.deepcopy(module) for how in ("pallas", "plain", "plain_eps", "xla")}
    reset_all_launches()
    outs = {"pallas": run(mods["pallas"], "pallas")}
    torch.cuda.synchronize()
    launches = all_launches()
    want = {k: (8 if k.startswith(bb.kind) else 0) for k in launches}
    check(launches == want, f"{bb.kind} pass made launches {launches}, expected {want}")
    with full_fp32():
        outs["plain"] = run(mods["plain"], "plain")
        outs["xla"] = run(mods["xla"], "xla")
        outs["plain_eps"] = run(mods["plain_eps"], "plain", 1 + 1e-6)
    real = bmask > 0
    check(bool(torch.isfinite(outs["pallas"]).all()), f"{bb.kind} output not finite")
    noise = re.compile(r"layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)\.bias$")

    def compare(a, b):
        grads = {n: rel_err(pa.grad, pb.grad) for (n, pa), pb in
                 zip(mods[a].named_parameters(), mods[b].parameters())}
        ga = torch.cat([p.grad.double().ravel() for p in mods[a].parameters()])
        gb = torch.cat([p.grad.double().ravel() for p in mods[b].parameters()])
        return {"out": rel_err(outs[a][real], outs[b][real]),
                "grads": {n: e for n, e in grads.items() if not noise.search(n)},
                "grad": rel_err(ga, gb), "cos": float(ga @ gb / (ga.norm() * gb.norm())),
                "buffers": max(rel_err(ba, bb_) for (n, ba), bb_ in zip(mods[a].named_buffers(),
                                                                        mods[b].buffers()) if "running" in n)}

    cmp = {"plain": compare("pallas", "plain"), "xla": compare("pallas", "xla"),
           "self": compare("plain_eps", "plain")}
    report = []
    for name, c in cmp.items():
        worst = sorted(c["grads"].items(), key=lambda kv: -kv[1])[:3]
        report.append(f"{name}: output {c['out']:.2e}, BN buffers {c['buffers']:.2e}, gradient "
                      f"{c['grad']:.2e} (cosine {c['cos']:.6f}), worst parameters "
                      + ", ".join(f"{k} {v:.2e}" for k, v in worst))
    label = "5c encoder" if bb.kind == "enc" else "5e decoder"
    print(f"[{label}] backend=pallas, one training pass at B={B} (tail {int(real.sum())} real rows): "
          f"launches {launches}\n  pallas vs " + "\n  pallas vs ".join(report[:2])
          + f"\n  plain(x * (1 + 1e-6)) vs plain: " + report[2].split(": ", 1)[1])
    own, got = cmp["self"], cmp["plain"]
    for ref, lim in (("plain", 1e-2), ("xla", 3e-2)):
        lim_out = max(lim, 2 * own["out"]) if ref == "plain" else lim
        check(cmp[ref]["out"] <= lim_out, f"{bb.kind} output vs {ref}: {cmp[ref]['out']:.3g} > {lim_out:.3g}")
        check(cmp[ref]["buffers"] <= lim, f"{bb.kind} BN buffers vs {ref}: {cmp[ref]['buffers']:.3g} > {lim}")
    check(got["grad"] <= max(1e-2, 2 * own["grad"]),
          f"{bb.kind} gradient vs plain {got['grad']:.3g}, over twice the plain path's own {own['grad']:.3g}")
    check(1 - got["cos"] <= max(1e-4, 2 * (1 - own["cos"])),
          f"{bb.kind} gradient cosine vs plain {got['cos']:.6f}, own {own['cos']:.6f}")
    lim = max(1e-2, 2 * max(own["grads"].values()))
    for name, e in got["grads"].items():
        check(e <= lim, f"{bb.kind} {name} gradient vs plain {e:.3g} > {lim:.3g}")
    check(cmp["xla"]["cos"] > 0.97, f"{bb.kind} gradient cosine vs float32 {cmp['xla']['cos']:.6f}")

    # timings: the pass's forward + backward, alternating the backends
    pass_ms = {"pallas": [], "xla": []}
    for how in ("pallas", "xla", "xla", "pallas"):
        pass_ms[how].append(time_ms(lambda: run(mods[how], how), n=20, warmup=3))
    print(f"  {bb.kind} fwd+bwd: pallas {pass_ms['pallas']} ms, xla (cuDNN defaults) {pass_ms['xla']} ms "
          f"on {card}")
    for how in ("pallas", "xla"):
        dev_us, n_dev, _ = device_profile(lambda: run(mods[how], how), n=5)
        ms = min(pass_ms[how])
        print(f"  profile {bb.kind} {how}: device busy {dev_us / 1e3:.3f} ms of {ms:.3f} ms "
              f"(idle share {1 - dev_us / 1e3 / ms:.3f}), {n_dev:.0f} device kernels and copies per pass")


def phase_embed(model, joint: bool = False, device="cuda"):
    """Eval-mode embeddings of the target: [392, z], finite, each row z-scored;
    agree with the same model in float64 on the host to atol 1e-4 (the embed
    path runs without TF32), on the first 64 rows. ``joint``: the joint
    model's embed_multimodal of (wave, isi), else embed_unimodal of wave."""
    import torch

    from hippie_tpu_torch.evaluate.embeddings import embed_multimodal, embed_unimodal
    from hippie_tpu_torch.train import pipeline

    pcfg = pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False, device=device)
    target = pipeline.load_dataset(pcfg, TARGET)
    embed = embed_multimodal if joint else embed_unimodal
    data = (target.wave, target.isi) if joint else (target.wave,)
    t0 = time.perf_counter()
    emb = embed(model, *data, target.source)
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
    ref = embed(ref_model, *(x[:64].cpu().double() for x in data), target.source[:64].cpu())
    diff = float((emb_host[:64].double() - ref).abs().max())
    check(diff <= 1e-4, f"embeddings differ from the float64 host model by {diff}")
    print(f"[{'8c joint embed' if joint else '6 embed'}] {TARGET}: {tuple(emb.shape)} in "
          f"{embed_s * 1e3:.1f} ms, max |row mean| {row_mean:.2g}, max |row std - 1| {row_std:.2g}, "
          f"max |card - float64 host| {diff:.3g}")


def joint_config():
    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.models import cvae

    return cvae.MultiModalConfig(z_dim=Z, output_size_wave=L, output_size_isi=L_ISI, class_hidden_dim=5,
                                 num_sources=registry.NUM_SOURCES, num_classes=5, num_blocks=(2, 2, 2, 2))


def phase_joint(pool, block_backend: str, device="cuda"):
    """Stage 1 of the joint pipeline for one epoch: the full-width joint cVAE
    (16,115,748 parameters) over the pool's waveforms and ISI histograms,
    B=512, AdamW with the global-norm clip at 1.0, loss_backend="pallas" (the
    loss kernel for the waveforms and the KL, the masked-SSE kernel for the
    ISI), no class labels, from the seeded initial weights, plan and noise
    (the same in every call). With block_backend="pallas" all 32 BasicBlocks
    of the four backbones run on the block kernels. Returns the state, the
    plan, this epoch's launch counts and its losses."""
    import torch

    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import optim, step

    cfg = joint_config()
    check(tuple(pool.isi.shape) == (2975, L_ISI), f"pool ISI {tuple(pool.isi.shape)}, expected (2975, {L_ISI})")
    model = cvae.multimodal_cvae_init(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = cvae.param_count(model)
    check(n_params == FULL_MM_PARAMS, f"{n_params} parameters, expected {FULL_MM_PARAMS}")
    ts = step.TrainState(model, optim.make_optimizer(model.parameters(), LR, WD, clip_val=CLIP))
    idx, mask = device_data.batch_plan(np.arange(len(pool)), B, shuffle=True,
                                       generator=torch.Generator().manual_seed(1))
    train_epoch, _ = step.make_multimodal_epoch_fns(beta=1.0, loss_backend="pallas",
                                                    block_backend=block_backend)
    gen = torch.Generator(device=device).manual_seed(2)

    reset_all_launches()
    t0 = time.perf_counter()
    ts, metrics = train_epoch(ts, pool.wave, pool.isi, pool.source, None, idx, mask, generator=gen)
    losses = metrics.loss.tolist()
    epoch_s = time.perf_counter() - t0
    launches = all_launches()

    nb = idx.shape[0]
    check(all(np.isfinite(losses)) and bool(torch.isfinite(metrics.mse).all()),
          f"non-finite loss in the joint epoch: {losses}")
    if device != "cpu":
        per_step = 2 * sum(cfg.num_blocks) if block_backend == "pallas" else 0  # blocks per kind
        want = {k: (per_step * nb if k.endswith(("block_fwd", "block_bwd")) else nb) for k in launches}
        check(launches == want, f"joint kernel launches {launches}, expected {want}")
    print(f"[8 joint, block_backend={block_backend}] {n_params:,} params; {nb} steps at B={B} "
          f"(tail {int(mask[-1].sum())} real rows), clip {CLIP}, in {epoch_s:.2f} s with the first call's "
          f"set-up; losses {[round(x, 5) for x in losses]}; launches {launches}")
    return ts, idx, mask, launches, losses


def phase_joint_step_parity(model, pool, idx, mask, device="cuda"):
    """One joint step against the same step on the plain versions
    (step_parity, clip 1.0), on the epoch's last pool batch (the masked tail)."""
    import torch

    from hippie_tpu_torch.train import step

    bi = torch.as_tensor(idx[-1], device=device).long()
    _, bs, bmask, eps = last_batch(model, pool, idx, mask, device)
    b1, b2 = pool.wave[bi], pool.isi[bi]

    def run(block_backend, ts, scale):
        batch_step, _ = step.make_multimodal_steps(beta=1.0, loss_backend="pallas",
                                                   block_backend=block_backend)
        return batch_step(ts, b1 * scale, b2 * scale, bs, None, bmask, eps=eps)[1].loss

    step_parity(model, run, "8b joint step parity",
                {"vae_sums_fwd": 1, "vae_sums_bwd": 1, "masked_sse_fwd": 1, "enc_block_fwd": 16,
                 "enc_block_bwd": 16, "dec_block_fwd": 16, "dec_block_bwd": 16}, clip_val=CLIP)


def profile_epoch(run_epoch, steps: int, ms_step: float, label: str):
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
        print(f"  profile {label}: the profiler recorded no device time (device busy share not measured)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"  profile {label}: device busy {busy_ms:.3f} ms/step of {ms_step:.3f} ms/step "
          f"(idle share {1 - busy_ms / ms_step:.3f}); {sum(r[1] for r in rows) / steps:.0f} "
          f"device kernels and copies/step")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {us / 1e3 / steps:8.3f} ms/step {count / steps:6.1f}/step  {key[:90]}")
    for us, count, key in rows:
        if "vae_sums" in key or "masked_sse" in key:
            print(f"    kernel {key}: {us / count:.2f} us device time per launch")


def time_epochs(run_epoch, nb: int, label: str, card: str):
    """ms/step of ``run_epoch(block_backend)`` with each block backend, in
    turns (xla, pallas, pallas, xla; 3 epochs each, host clock around
    synchronised epochs), then one profiled epoch of each."""
    import torch

    epochs = 3
    ms_step = {"xla": [], "pallas": []}
    for bb in ("xla", "pallas", "pallas", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(epochs):
            metrics = run_epoch(bb)
        torch.cuda.synchronize()
        ms_step[bb].append((time.perf_counter() - t0) * 1e3 / (epochs * nb))
        check(bool(torch.isfinite(metrics.loss).all()), f"non-finite loss while timing {label} {bb}")
    print(f"[7 timings] {label} (B={B}, loss_backend=pallas, cuDNN defaults), ms/step over "
          f"{epochs} epochs of {nb} steps each, in turns: block_backend=xla {ms_step['xla']}, "
          f"block_backend=pallas {ms_step['pallas']} on {card}")
    for bb in ("xla", "pallas"):
        profile_epoch(lambda: run_epoch(bb), nb, min(ms_step[bb]), f"{label} block_backend={bb}")


def phase_timings(ts, pool, idx, mask, joint_ts, joint_plan, card: str, errs: dict, launches: dict):
    """ms/step of the unimodal and the joint train step with each block
    backend (time_epochs), then each loss kernel against its plain version,
    its bound and, for the masked SSE, one library call: F.mse_loss(dec,
    data, reduction="sum") on an all-real batch, the same function when every
    row is real."""
    import torch
    import torch.nn.functional as F

    from hippie_tpu_torch.ops import cuda_ops
    from hippie_tpu_torch.train import step

    gen = torch.Generator(device="cuda").manual_seed(4)
    uni = {bb: step.make_unimodal_epoch_fns(beta=1.0, loss_backend="pallas", block_backend=bb)[0]
           for bb in ("xla", "pallas")}
    time_epochs(lambda bb: uni[bb](ts, pool.wave, pool.source, None, idx, mask, generator=gen)[1],
                idx.shape[0], "train step", card)
    joint = {bb: step.make_multimodal_epoch_fns(beta=1.0, loss_backend="pallas", block_backend=bb)[0]
             for bb in ("xla", "pallas")}
    jidx, jmask = joint_plan
    time_epochs(lambda bb: joint[bb](joint_ts, pool.wave, pool.isi, pool.source, None, jidx, jmask,
                                     generator=gen)[1],
                jidx.shape[0], "joint train step", card)

    x = loss_inputs(415, device="cuda")
    g = torch.tensor([1.0 / (415 * L), 1.0 / 415], device="cuda")
    sse = sse_inputs(415, device="cuda")
    data_all, dec_all, _ = sse_inputs(B, device="cuda")
    fns = {
        "vae_sums_fwd": (lambda: cuda_ops.vae_sums_fwd_cuda(*x), lambda: cuda_ops.vae_sums_plain(*x), None),
        "vae_sums_bwd": (lambda: cuda_ops.vae_sums_bwd_cuda(*x, g),
                         lambda: cuda_ops.vae_sums_bwd_plain(*x, g), None),
        "masked_sse_fwd": (lambda: cuda_ops.masked_sse_fwd_cuda(*sse), lambda: cuda_ops.masked_sse_plain(*sse),
                           lambda: F.mse_loss(dec_all, data_all, reduction="sum")),
    }
    bounds = {**vae_sums_bounds(*x[0].shape, x[2].shape[1]), "masked_sse_fwd": masked_sse_bound(B, L_ISI)}
    sources = {"vae_sums_fwd": "hippie_tpu/ops/pallas_ops.py:87",
               "vae_sums_bwd": "hippie_tpu/ops/pallas_ops.py:109",
               "masked_sse_fwd": "hippie_tpu/ops/pallas_ops.py:141"}
    kernels = []
    for name, (kernel, plain, library) in fns.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = None if library is None else time_ms(library)
        bound_ms, bound_by = bounds[name]
        print(f"  {name}: kernel {ms * 1e3:.2f} us/call, plain {plain_ms * 1e3:.2f} us/call, "
              + ("" if library is None else f"F.mse_loss(sum) {library_ms * 1e3:.2f} us/call, ")
              + f"bound {bound_ms * 1e3:.4f} us ({bound_by}) on {card}")
        if library is not None:  # host or device: each call's device time beside the library's
            for what, fn in (("kernel", kernel), ("F.mse_loss(sum)", library)):
                dev_us, n_dev, split = device_profile(fn, n=50)
                print(f"    {name} {what}: {dev_us:.2f} us device in {n_dev:g} launches per call "
                      f"({split_line(split)})")
        if name == "vae_sums_bwd":  # one launch: held to the device time of the smallest launch
            one = torch.zeros(1, device="cuda")
            for what, fn in (("kernel", kernel), ("one-element torch op (add_), the launch floor",
                                                  lambda: one.add_(1.0))):
                dev_us, n_dev, split = device_profile(fn, n=50)
                print(f"    {name} {what}: {dev_us:.2f} us device in {n_dev:g} launches per call "
                      f"({split_line(split)})")
        kernels.append({
            "name": name, "route": "cuda", "source": "hippie_tpu_torch/csrc/vae_sums.cu",
            "replaces": sources[name], "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return kernels


def n_batches(n: int, batch_size: int) -> int:
    """Batches of a batch_plan over n rows (at least one)."""
    return max(1, -(-n // batch_size))


def csv_table(path: str):
    """(header, data rows) of a CSV written by the port."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def check_ckpts(trackers: dict, fresh_model, device="cuda", state_dtype=None) -> int:
    """Each tracker's .ckpt against its best snapshot, bit for bit: the
    state_dict (weights and buffers), reloaded through
    export.load_model_from_ckpt too, and the optimizer state. AdamW: every
    state (step and both moments, written as float32 whatever
    ``state_dtype`` stores them in), then reloaded into ``fresh_model(key)``
    and a fresh optimizer of ``state_dtype`` on the card, equal again.
    Schedule-free: empty ``optimizer_states`` and a ``.sfstate`` sidecar
    that restores k, weight_sum, lr_max, z and exp_avg_sq into a fresh
    schedule-free optimizer equal to the snapshot's. Returns the number of
    files checked."""
    import os

    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import optim

    for key, tracker in trackers.items():
        ck = ckpt_mod.load_lightning_ckpt(tracker.path)
        sd = ckpt_mod.model_state_from_ckpt(ck)
        best = tracker.best_state_dict
        check(list(sd) == list(best) and all(torch.equal(sd[k], v.cpu()) for k, v in best.items()),
              f"{tracker.path}: state_dict differs from the tracker's best snapshot")
        loaded, _ = export.load_model_from_ckpt(tracker.path, device=device)
        check(all(torch.equal(v, best[k]) for k, v in loaded.state_dict().items()),
              f"{tracker.path}: export.load_model_from_ckpt differs from the snapshot")
        model = fresh_model(key)
        check(not ckpt_mod.load_model_state(model, sd), f"{tracker.path}: keys left unloaded")
        sf = optim.find_schedule_free_state(tracker.best_opt)
        if sf is not None:
            check(ck["optimizer_states"] == [] and os.path.exists(tracker.path + optim.SF_SIDECAR_SUFFIX),
                  f"{tracker.path}: schedule-free checkpoint without empty optimizer_states and sidecar")
            opt = optim.make_optimizer(model.parameters(), 1e-4, WD, algorithm="schedule-free")
            optim.load_schedule_free_sidecar(tracker.path, opt, ckpt_mod.parameter_key_order(model))
            got = optim.find_schedule_free_state(opt)
            check(all(torch.equal(getattr(got, n), getattr(sf, n)) for n in ("k", "weight_sum", "lr_max"))
                  and all(torch.equal(a, b) for a, b in zip(got.z + got.exp_avg_sq, sf.z + sf.exp_avg_sq)),
                  f"{tracker.path}: the sidecar's state differs from the snapshot's")
            continue
        opt_saved = ck["optimizer_states"][0]["state"]
        opt_best = tracker.best_opt["state"]
        check(len(opt_saved) == len(opt_best) == len(sd) - sum("running_" in k or "batches" in k
                                                              for k in sd),
              f"{tracker.path}: {len(opt_saved)} optimizer states for {len(opt_best)} parameters")
        for i, e in opt_best.items():
            check(float(opt_saved[i]["step"]) == float(e["step"]) and all(
                opt_saved[i][m].dtype == np.float32
                and np.array_equal(opt_saved[i][m], e[m].float().cpu().numpy()) for m in ("exp_avg", "exp_avg_sq")),
                f"{tracker.path}: AdamW state {i} differs from the tracker's best snapshot")
        opt = optim.make_optimizer(model.parameters(), 1e-4, WD, state_dtype=state_dtype)
        ckpt_mod.load_optimizer_state(opt, ck["optimizer_states"][0])
        check(all(torch.equal(v, best[k]) for k, v in model.state_dict().items())
              and all(torch.equal(opt.state_dict()["state"][i][m], e[m])
                      for i, e in opt_best.items() for m in ("exp_avg", "exp_avg_sq")),
              f"{tracker.path}: the reloaded model or optimizer differs from the snapshot")
    return len(trackers)


def writer_split(trackers: dict) -> str:
    """Each checkpoint's background writes, split into the D2H fetch (of it
    the pinned buffer, the copy and the host-side split), the conversion and
    torch.save, and the foreground's wait for them (s)."""
    return json.dumps({key: {"writes": [{k: round(v, 4) for k, v in w.items()} for w in t.writes],
                             "wait_s": round(t.wait_s, 4)} for key, t in trackers.items()})


def check_tables(out_dir: str, tables: dict, classes: set):
    """Each CSV's header and row count; the embedding files' values finite
    and their labels known."""
    import math

    for name, (header, rows) in tables.items():
        got_header, got_rows = csv_table(f"{out_dir}/{name}")
        check(got_header == header, f"{name}: header {got_header[:4]}..., expected {header[:4]}...")
        check(len(got_rows) == rows, f"{name}: {len(got_rows)} rows, expected {rows}")
        if name.endswith("_embeddings.csv") and not name.startswith("pretraining"):
            check(all(math.isfinite(float(v)) for r in got_rows for v in r[1:-1])
                  and {r[-1] for r in got_rows} <= classes, f"{name}: non-finite value or unknown label")


def phase_pipeline(card: str, workdir: str, device="cuda", optimizer: str = "adamw",
                   label: str = "9 pipeline") -> dict:
    """The port's unimodal 3-stage pipeline, run_unimodal_pipeline, at full
    width (z=10, ResNet18: 8,056,639 parameters per stage-1 model) on
    datasets/cellexplorer-celltype, one epoch per stage, with the loss and
    block kernels (loss_backend and block_backend "pallas"), outputs under
    ``workdir``. Checks the 13 outputs (names, CSV headers and row counts),
    that each .ckpt reloads into the port equal bit for bit to its tracker's
    best snapshot (weights, buffers and AdamW moments), that the 45 balanced
    accuracies are finite, and that kernels 1, 2 and 4-7 were launched
    exactly (train steps) x (launches per step) times; vae_sums_fwd also
    runs in every validation step. Prints each checkpoint's background write
    split (BestTracker.writes: D2H fetch, conversion, torch.save) and the
    foreground's wait. ``optimizer="schedule-free"`` (phase 12) writes its
    outputs under ``workdir/sf_*`` and holds its checkpoints to the
    schedule-free layout. Returns the stage-3 checkpoints' paths ("wave",
    "time")."""
    import math

    import torch

    from hippie_tpu_torch.data import sampling
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import pipeline

    sub = "" if optimizer == "adamw" else "sf_"
    cfg = pipeline.PipelineConfig(z_dim=Z, dataset=TARGET, data_root=DATA_ROOT,
                                  output_dir=f"{workdir}/{sub}out", checkpoint_dir=f"{workdir}/{sub}checkpoints",
                                  loss_backend="pallas", block_backend="pallas", device=device,
                                  verbose=False, optimizer=optimizer)
    trackers = {}
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    reset_all_launches()
    sync()
    t0 = time.perf_counter()
    results = pipeline.run_unimodal_pipeline(cfg, trackers=trackers)
    sync()
    wall = time.perf_counter() - t0
    launches = all_launches()

    # the steps of one epoch per stage and model
    n_pool, n_target = 2975, 392
    n_tr = int(cfg.train_val_split * n_pool)
    n_ft = int(cfg.finetune_split * n_target)
    n_stream = len(sampling.balanced_indices(results["label_train"], seed=cfg.seed))
    train = 2 * (n_batches(n_tr, cfg.batch_size) + n_batches(n_ft, cfg.batch_size)
                 + n_batches(n_stream, cfg.supervised_batch_size))
    val = 2 * (n_batches(n_pool - n_tr, cfg.batch_size) + n_batches(n_target - n_ft, cfg.batch_size)
               + n_batches(len(results["label_val"]), cfg.supervised_batch_size))
    blocks = sum(cfg.num_blocks)
    want = {"vae_sums_fwd": train + val, "vae_sums_bwd": train, "masked_sse_fwd": 0,
            **{k: blocks * train for k in ("enc_block_fwd", "enc_block_bwd", "dec_block_fwd",
                                           "dec_block_bwd")}}
    check(launches == want or device == "cpu", f"pipeline kernel launches {launches}, expected "
                                               f"{want} ({train} train and {val} val steps)")

    ds, n_val = TARGET, len(results["label_val"])
    tables = {f"pretraining_{ds}_{k}_embeddings.csv": (["", "embeddings"], n_ft)
              for k in ("waveform", "isi", "joint")}
    for kind, width in (("waveform", Z), ("isi", Z), ("joint", 2 * Z)):
        tables[f"{ds}_{kind}_knn.csv"] = (["", "pred", "true"], n_val)
        tables[f"{ds}_{kind}_embeddings.csv"] = ([""] + [str(j) for j in range(width)] + ["label"],
                                                 n_target)
    check_tables(cfg.output_dir, tables, set(results["label_encoder"].classes_.tolist()))

    n_classes = results["num_class_labels"]
    check_ckpts(trackers, lambda key: cvae.unimodal_cvae_init(
        pipeline.model_config(cfg, key.split("_")[0], n_classes if "supervised" in key else 5),
        torch.Generator().manual_seed(0), device=device), device)
    ckpts = sorted(pathlib.Path(cfg.checkpoint_dir).glob("*.ckpt"))
    check([p.name for p in ckpts] == sorted(f"{ds}_{m}_model{s}.ckpt" for m in ("wave", "time")
                                            for s in ("", "_supervised")),
          f"checkpoints {[p.name for p in ckpts]}")
    sidecars = sorted(p.name for p in pathlib.Path(cfg.checkpoint_dir).glob("*.sfstate"))
    check(sidecars == ([] if optimizer == "adamw" else [p.name + ".sfstate" for p in ckpts]),
          f"sidecars {sidecars}")
    accs = [a for kind in results["balanced_accuracy"].values() for a in kind]
    check(len(accs) == 45 and all(math.isfinite(a) for a in accs), f"balanced accuracies {accs}")

    timings = results["timings"]
    fits = {k: round(v, 3) for k, v in timings.items() if k.split("_")[0] in ("pretrain", "finetune",
                                                                              "supervised")}
    print(f"[{label}] run_unimodal_pipeline on {ds}, z={Z}, num_blocks={cfg.num_blocks}, one epoch per "
          f"stage, optimizer={optimizer}, loss_backend=pallas block_backend=pallas: {wall:.3f} s wall on "
          f"{card}; {train} train and {val} val steps; launches {launches}")
    print(f"  stage fits (s): {json.dumps(fits)}")
    print(f"  stage timings (StageTimer): {json.dumps({k: round(v, 3) for k, v in timings.items()})}")
    print(f"  checkpoint writes in the background (s): {writer_split(trackers)}")
    print(f"  13 outputs checked ({len(tables)} CSVs, {len(ckpts)} .ckpt reloaded equal to their "
          f"snapshots{'' if optimizer == 'adamw' else ', with their sidecars'}); best balanced accuracy "
          + ", ".join(f"{k} {v['balanced_accuracy']:.4f} (k={v['k']})" for k, v in results["best"].items()))
    return {m: trackers[f"{m}_supervised"].path for m in ("wave", "time")}


def phase_joint_pipeline(card: str, workdir: str, device="cuda", opt_state_dtype=None,
                         label: str = "10 joint pipeline"):
    """The port's joint 3-stage pipeline, run_pipeline(model_type=
    "multimodal"), at full width (z=10, four ResNet18 backbones: 16,115,748
    parameters in stage 1) on datasets/cellexplorer-celltype, one epoch per
    stage, with the loss and block kernels, outputs under ``workdir``. Checks
    the 5 outputs (CSV headers and row counts; the stage-2 embeddings are the
    fine-tune val split's), that both .ckpt files reload equal bit for bit to
    their trackers' snapshots (weights, buffers, AdamW moments), the 15
    finite balanced accuracies, and every kernel's exact launches: per joint
    train step one of each loss kernel and 16 of each block kernel (two
    backbones of 8 blocks per kind), per val step one vae_sums_fwd and one
    masked_sse_fwd (18 train and 5 val steps at this data). Prints each
    checkpoint's background write split and the foreground's wait.
    ``opt_state_dtype="bfloat16"`` (phase 12) writes under ``workdir/bf16_*``
    and checks the checkpoints' moments float32. Returns the launch counts
    and the supervised checkpoint's path."""
    import math

    import torch

    from hippie_tpu_torch.data import sampling
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import pipeline

    t_phase = time.perf_counter()
    sub = "" if opt_state_dtype is None else "bf16_"
    cfg = pipeline.PipelineConfig(model_type="multimodal", z_dim=Z, num_blocks=(2, 2, 2, 2), dataset=TARGET,
                                  data_root=DATA_ROOT, output_dir=f"{workdir}/{sub}joint_out",
                                  checkpoint_dir=f"{workdir}/{sub}joint_checkpoints", loss_backend="pallas",
                                  block_backend="pallas", device=device, verbose=False,
                                  opt_state_dtype=opt_state_dtype)
    with torch.device("meta"):
        n_params = cvae.param_count(cvae.MultiModalCVAE(pipeline.joint_model_config(cfg, 5)))
    check(n_params == FULL_MM_PARAMS, f"{n_params} stage-1 parameters, expected {FULL_MM_PARAMS}")
    trackers = {}
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    reset_all_launches()
    sync()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pipeline.run_pipeline(cfg, trackers=trackers)
    sync()
    wall = time.perf_counter() - t0
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20 if device != "cpu" else float("nan")

    n_pool, n_target = 2975, 392
    n_tr = int(cfg.train_val_split * n_pool)
    n_ft = int(cfg.finetune_split * n_target)
    n_val = len(results["label_val"])
    n_stream = len(sampling.balanced_indices(results["label_train"], seed=cfg.seed))
    train = (n_batches(n_tr, cfg.batch_size) + n_batches(n_ft, cfg.batch_size)
             + n_batches(n_stream, cfg.supervised_batch_size))
    val = (n_batches(n_pool - n_tr, cfg.batch_size) + n_batches(n_target - n_ft, cfg.batch_size)
           + n_batches(n_val, cfg.supervised_batch_size))
    blocks = 2 * sum(cfg.num_blocks)
    want = {"vae_sums_fwd": train + val, "vae_sums_bwd": train, "masked_sse_fwd": train + val,
            **{k: blocks * train for k in ("enc_block_fwd", "enc_block_bwd", "dec_block_fwd",
                                           "dec_block_bwd")}}
    check(launches == want or device == "cpu", f"joint pipeline kernel launches {launches}, expected "
                                               f"{want} ({train} train and {val} val steps)")
    check(device == "cpu" or (train, val) == (18, 5), f"{train} train and {val} val steps, expected 18 and 5")

    ds = TARGET
    tables = {f"pretraining_{ds}_joint_embeddings.csv": (["", "embeddings"], n_target - n_ft),
              f"{ds}_joint_knn.csv": (["", "pred", "true"], n_val),
              f"{ds}_joint_embeddings.csv": ([""] + [str(j) for j in range(Z)] + ["label"], n_target)}
    check(sorted(p.name for p in pathlib.Path(cfg.output_dir).iterdir()) == sorted(tables),
          f"joint outputs {sorted(p.name for p in pathlib.Path(cfg.output_dir).iterdir())}")
    check_tables(cfg.output_dir, tables, set(results["label_encoder"].classes_.tolist()))
    n_classes = results["num_class_labels"]
    check_ckpts(trackers, lambda key: cvae.multimodal_cvae_init(
        pipeline.joint_model_config(cfg, n_classes if key == "joint_supervised" else 5),
        torch.Generator().manual_seed(0), device=device), device, state_dtype=opt_state_dtype)
    if opt_state_dtype is not None:
        check(all(e[m].dtype == getattr(torch, opt_state_dtype) for t in trackers.values()
                  for e in t.best_opt["state"].values() for m in ("exp_avg", "exp_avg_sq")),
              f"the snapshots' moments are not {opt_state_dtype}")
    ckpts = sorted(p.name for p in pathlib.Path(cfg.checkpoint_dir).glob("*.ckpt"))
    check(ckpts == [f"{ds}_joint_model.ckpt", f"{ds}_joint_model_supervised.ckpt"], f"checkpoints {ckpts}")
    accs = results["balanced_accuracy"]["joint"]
    check(len(accs) == 15 and all(math.isfinite(a) for a in accs), f"balanced accuracies {accs}")

    timings = {k: round(v, 3) for k, v in results["timings"].items()}
    print(f"[{label}] run_pipeline(model_type=multimodal) on {ds}, z={Z}, {n_params:,} stage-1 "
          f"params, one epoch per stage, opt_state_dtype={opt_state_dtype}, loss_backend=pallas "
          f"block_backend=pallas: {wall:.3f} s wall on {card}; {train} train and {val} val steps; "
          f"launches {launches}")
    print(f"  stage timings (StageTimer): {json.dumps(timings)}")
    print(f"  checkpoint writes in the background (s): {writer_split(trackers)}")
    print(f"  peak device memory allocated over the pipeline: {peak:.1f} MiB")
    best = results["best"]["joint"]
    print(f"  5 outputs checked (3 CSVs, 2 .ckpt reloaded equal to their snapshots); 15 finite balanced "
          f"accuracies, best {best['balanced_accuracy']:.4f} (k={best['k']}); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, trackers["joint_supervised"].path


def clustering_vs_host(x, method: str, k: int = 4, seed: int = 42, reps: int = 5, device="cuda"):
    """``method`` of hippie_tpu_torch/ops/clustering.py on the card against
    the same call on the host (same seed, so the same k-means++ draws from
    the CPU generator). The assignments must be equal, every float (centres,
    means, variances, weights) within 1e-4 of the host's relative to the
    largest magnitude, inertia and log-likelihood rtol 1e-4: the two sides
    differ only in the summation order of float32 reductions over at most
    16,564 rows (about sqrt(n) * 6e-8, 8e-6 relative), far below these
    limits, and a row whose assignment flips between devices would need its
    two nearest centres (or two largest log-probabilities) within that
    rounding of each other. Returns the card's ms per call (CUDA-synchronised
    wall time, median of ``reps`` after one warm-up call)."""
    import torch

    from hippie_tpu_torch.ops import clustering

    fn = getattr(clustering, method)
    xd = torch.as_tensor(x, dtype=torch.float32).to(device)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    got = [v.cpu() for v in fn(xd, k, seed=seed)]
    ref = fn(xd.cpu(), k, seed=seed)
    check(torch.equal(got[0], ref[0]),
          f"{method}: {int((got[0] != ref[0]).sum())} of {len(got[0])} assignments differ on the card")
    for a, b in zip(got[1:-1], ref[1:-1]):
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        check(err <= 1e-4, f"{method}: card and host differ by {err:.3g} (relative)")
    check(abs(float(got[-1]) - float(ref[-1])) <= 1e-4 * abs(float(ref[-1])),
          f"{method}: {float(got[-1])} on the card, {float(ref[-1])} on the host")
    times = []
    for _ in range(reps + 1):
        sync()
        t0 = time.perf_counter()
        fn(xd, k, seed=seed)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def phase_inference(card: str, workdir: str, uni_ckpts: dict, joint_ckpt: str, device="cuda"):
    """The port's inference CLI, in process, on the card: on phase 9's
    stage-3 wave and time checkpoints with ``--cluster 4 --cluster-method
    kmeans``, and on phase 10's supervised joint checkpoint with ``gmm``.
    Every CSV has the dataset's 392 rows; each embedding file is within
    1e-5 of embed_unimodal / embed_multimodal of the checkpoint's model
    (export.load_model_from_ckpt) called directly on the same inputs (the
    CLI's labels are the dummy zeros, so the source is 0); the clusters are
    ids below 4. Then k-means and the GMM (k=4) on the card against the
    host (clustering_vs_host) on the joint model's embeddings and on 16,564
    x 20 rows drawn with numpy (four blobs; the largest reference dataset at
    2z for z=10), with the card's ms per call."""
    import io

    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.evaluate.embeddings import embed_multimodal, embed_unimodal
    from hippie_tpu_torch.ops import preprocess
    from hippie_tpu_torch.scripts import inference_from_trained_model as inference

    t_phase = time.perf_counter()
    wf, isi = registry.load_raw(DATA_ROOT, TARGET, dropna=True)
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=device)
    source = torch.zeros(len(wf), dtype=torch.long, device=device)
    n = len(wf)
    joint_emb = None
    for mode, flags, method in (
            ("dual", ["--wave-checkpoint", uni_ckpts["wave"], "--time-checkpoint", uni_ckpts["time"]], "kmeans"),
            ("joint", ["--joint-checkpoint", joint_ckpt], "gmm")):
        out = f"{workdir}/inference_{mode}"
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            inference.main(["--dataset", TARGET, "--data-root", DATA_ROOT, "--output-dir", out,
                            "--cluster", "4", "--cluster-method", method, "--device", device, *flags])
        cli_s = time.perf_counter() - t0
        said = said.getvalue()
        check("Inference completed successfully!" in said and "were skipped" not in said,
              f"inference {mode}: {said[-400:]}")
        if mode == "dual":
            mw, _ = export.load_model_from_ckpt(uni_ckpts["wave"], device=device)
            mt, _ = export.load_model_from_ckpt(uni_ckpts["time"], device=device)
            e_wave, e_isi = embed_unimodal(mw, wave, source), embed_unimodal(mt, isi_p, source)
            direct = {"waveform": e_wave, "isi": e_isi, "joint": torch.cat([e_wave, e_isi], dim=1)}
        else:
            mj, _ = export.load_model_from_ckpt(joint_ckpt, device=device)
            joint_emb = embed_multimodal(mj, wave, isi_p, source)
            direct = {"joint": joint_emb}
        worst = 0.0
        for kind, ref in direct.items():
            header, rows = csv_table(f"{out}/{TARGET}_{kind}_embeddings.csv")
            check(header == [str(j) for j in range(ref.shape[1])] + ["label", "label_name"],
                  f"{kind} embeddings header {header}")
            check(len(rows) == n and all(r[-2:] == ["0", "unknown"] for r in rows),
                  f"{kind} embeddings: {len(rows)} rows or labels not (0, unknown)")
            got = np.asarray([[float(v) for v in r[:-2]] for r in rows], np.float32)
            err = float(np.abs(got - ref.cpu().numpy()).max())
            check(err <= 1e-5, f"inference {mode} {kind}: {err} from the direct embedding")
            worst = max(worst, err)
        header, rows = csv_table(f"{out}/{TARGET}_joint_clusters.csv")
        check(header == ["cluster", "label"] and len(rows) == n and {int(r[0]) for r in rows} <= set(range(4)),
              f"{mode} clusters: header {header}, {len(rows)} rows")
        print(f"[11 inference] {mode}: {sorted(direct)} embeddings and {method} clusters of {n} rows in "
              f"{cli_s:.2f} s (the CLI in process, with the checkpoints' loading); max |CSV - direct| "
              f"{worst:.3g}")
    r = np.random.default_rng(0)
    centres = 6.0 * r.normal(size=(4, 2 * Z))
    synthetic = (centres[r.integers(0, 4, size=16_564)] + r.normal(size=(16_564, 2 * Z))).astype(np.float32)
    ms = {}
    for label, x in (("joint embeddings 392x10", joint_emb), ("synthetic 16564x20", synthetic)):
        for method in ("kmeans", "gmm"):
            ms[f"{method} {label}"] = round(clustering_vs_host(x, method, device=device), 3)
    print(f"  clustering k=4 on the card, equal to the host's (ms per call): {json.dumps(ms)} on {card}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")


def optimizer_steps_vs_cpu(card: str, device="cuda"):
    """One step of schedule-free AdamW and one of AdamW with bf16 moments
    (clip 1.0) on the full-width unimodal model (8,056,639 parameters) on
    the card, each against the same update on the CPU from the same state
    (one host step from fresh, loaded into the card's optimizer) and the same
    numpy gradients: parameters and schedule-free states rtol 1e-5 / atol
    1e-7, k exact (tests/test_torch_schedule_free.py); bf16 moments within
    one bf16 ulp (tests/test_torch_bf16_moments.py) plus rtol 1e-5 of the
    moment update's terms, since the clip's global norm over 8 M elements
    differs between card and host in its last bits."""
    import torch

    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import optim

    r = np.random.default_rng(0)
    host = cvae.unimodal_cvae_init(full_config(), torch.Generator().manual_seed(0), device="cpu")
    shapes = [tuple(p.shape) for p in host.parameters()]
    grads = [[r.normal(size=s).astype(np.float32) for s in shapes] for _ in range(2)]

    def set_grads(ps, g):
        for p, gi in zip(ps, g):
            p.grad = torch.from_numpy(gi.copy()).to(p.device)  # the clip scales in place

    out = {}
    for algorithm, state_dtype in (("schedule-free", None), ("adamw", "bfloat16")):
        def make(ps):
            return optim.make_optimizer(ps, LR, WD, CLIP, state_dtype=state_dtype, algorithm=algorithm)

        cp = [torch.nn.Parameter(p.detach().clone()) for p in host.parameters()]
        co = make(cp)
        set_grads(cp, grads[0])
        co.step()
        gp = [torch.nn.Parameter(p.detach().clone().to(device)) for p in cp]
        go = make(gp)
        go.load_state_dict(copy.deepcopy(co.state_dict()))  # no tensor shared with the host's
        before = {m: [co.state[p][m].float().numpy().copy() for p in cp] for m in ("exp_avg", "exp_avg_sq")
                  if state_dtype is not None}
        for ps, opt in ((cp, co), (gp, go)):
            set_grads(ps, grads[1])
            opt.step()
        pairs = [(a.detach(), b.detach()) for a, b in zip(gp, cp)]
        if algorithm == "schedule-free":
            gs, cs = optim.find_schedule_free_state(go), optim.find_schedule_free_state(co)
            check(int(gs.k) == int(cs.k) == 2, f"schedule-free k {int(gs.k)} on the card, {int(cs.k)} on the host")
            check(gs.k.device == gp[0].device, f"schedule-free k on {gs.k.device}, the parameters on {gp[0].device}")
            pairs += list(zip(gs.z + gs.exp_avg_sq, cs.z + cs.exp_avg_sq))
        else:
            for j, (a, b) in enumerate(zip(gp, cp)):
                for m in ("exp_avg", "exp_avg_sq"):
                    x, y = go.state[a][m], co.state[b][m]
                    check(x.dtype == y.dtype == torch.bfloat16, f"{m} stored as {x.dtype} / {y.dtype}")
                    x, y = x.float().cpu().numpy(), y.float().numpy()
                    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(y), 1e-30))) - 7)
                    # plus rtol 1e-5 of the update's terms: the card's clip norm differs from the
                    # host's in its last bits, and where b*m and (1-b)*g cancel the float32
                    # moments differ by more than the bf16 spacing of their small result
                    g = b.grad.numpy()
                    terms = (0.9 * np.abs(before[m][j]) + 0.1 * np.abs(g) if m == "exp_avg"
                             else 0.999 * before[m][j] + 0.001 * g * g)
                    bad = np.abs(x - y) > ulp + 1e-5 * terms
                    check(not bad.any(), f"bf16 {m} of shape {tuple(x.shape)} beyond one ulp of the host's at "
                                         f"{int(bad.sum())} elements, e.g. card {x[bad][:4].tolist()} host "
                                         f"{y[bad][:4].tolist()} (stored before this step: "
                                         f"{before[m][j][bad][:4].tolist()})")
        worst = 0.0
        for a, b in pairs:
            a, b = a.cpu().numpy(), b.numpy()
            check(np.allclose(a, b, rtol=1e-5, atol=1e-7), f"{algorithm} step on the card differs from the host's")
            worst = max(worst, float(np.abs(a - b).max()))
        out[f"{algorithm}{'' if state_dtype is None else ' ' + state_dtype}"] = worst
    print(f"  one optimizer step of the full-width model on the card against the host from the same state "
          f"(max abs diff, rtol 1e-5 / atol 1e-7): {json.dumps({k: float(f'{v:.3g}') for k, v in out.items()})} "
          f"on {card}")


def optimizer_memory(card: str, device="cuda") -> dict:
    """AdamW's device memory on the full-width joint model (16,115,748
    parameters, clip 1.0) with float32 and with bf16 moments: the moments'
    bytes and the step's transient peak above what was allocated before it
    (the second step, the states made by the first). bf16 moments must take
    less in all: their float32 copies are made one bucket at a time
    (optim.UPCAST_BUCKET elements)."""
    import torch

    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import optim

    out = {}
    for state_dtype in (None, "bfloat16"):
        model = cvae.multimodal_cvae_init(joint_config(), torch.Generator().manual_seed(0), device=device)
        ps = list(model.parameters())
        opt = optim.make_optimizer(ps, LR, WD, CLIP, state_dtype=state_dtype)
        g = torch.Generator(device=device).manual_seed(0)
        for _ in range(2):
            for p in ps:
                p.grad = torch.randn(p.shape, device=device, generator=g)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            opt.step()
            torch.cuda.synchronize()
        state = sum(opt.state[p][m].nbytes for p in ps for m in ("exp_avg", "exp_avg_sq"))
        step_peak = torch.cuda.max_memory_allocated() - before
        out[str(state_dtype or "float32")] = {"moments_MiB": state / 2**20, "step_peak_MiB": step_peak / 2**20,
                                              "total_MiB": (state + step_peak) / 2**20}
        del model, ps, opt
    check(out["bfloat16"]["total_MiB"] < out["float32"]["total_MiB"],
          f"bf16 moments take more device memory than float32 ones: {out}")
    print(f"  AdamW device memory on the joint model, moments plus the step's transient peak: "
          f"{json.dumps({k: {n: round(x, 1) for n, x in v.items()} for k, v in out.items()})} on {card}")
    return out


def phase_optimizers(card: str, workdir: str, device="cuda"):
    """Phase 12: the unimodal pipeline at full width with
    optimizer="schedule-free" and the joint pipeline with
    opt_state_dtype="bfloat16", one epoch per stage, both on the kernels,
    with every check of phases 9 and 10 (the same exact kernel launches: the
    optimizer does not change the step's kernels; the outputs; finite
    accuracies; each checkpoint reloaded through export.load_model_from_ckpt
    and equal to its snapshot), the schedule-free ones with empty
    optimizer_states and a sidecar, the bf16 ones with float32 moments; then
    one schedule-free and one bf16-moment step on the card against the host
    (optimizer_steps_vs_cpu) and AdamW's device memory with float32 and
    bf16 moments (optimizer_memory)."""
    t0 = time.perf_counter()
    phase_pipeline(card, workdir, device, optimizer="schedule-free", label="12 schedule-free pipeline")
    phase_joint_pipeline(card, workdir, device, opt_state_dtype="bfloat16", label="12 bf16-moment joint pipeline")
    optimizer_steps_vs_cpu(card, device)
    optimizer_memory(card, device)
    print(f"  phase 12 {time.perf_counter() - t0:.1f} s")


def _free_server(argv: list, timeout: float = 300.0):
    """Start the port's server (python -m hippie_tpu_torch.scripts.serve_embeddings
    ``argv`` --port 0) and return (process, url) once it says where it serves."""
    import queue
    import threading

    proc = subprocess.Popen([sys.executable, "-m", "hippie_tpu_torch.scripts.serve_embeddings", *argv,
                             "--host", "127.0.0.1", "--port", "0"], cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
                     daemon=True).start()
    said, deadline = [], time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.perf_counter()))
        except queue.Empty:
            break
        if line is None:
            break
        said.append(line.rstrip())
        m = re.search(r"on (http://127\.0\.0\.1:\d+)", line)
        if m:
            return proc, m.group(1), said
    proc.kill()
    proc.wait()
    raise PhaseError(f"the server did not start: {said[-10:]}")


def _post(url: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url + "/embed", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def phase_serving(card: str, uni_ckpts: dict, joint_ckpt: str, device="cuda") -> dict:
    """Phase 13: the port's embedding server on the card, in a process of
    its own on 127.0.0.1 at a free port, warmed with the ladder 512,1024:
    with phase 9's stage-3 wave and time checkpoints (dual) and with phase
    10's supervised joint one. The target's raw rows go in 7 requests of up
    to 64 rows (source 0); every reply is within 1e-5 of the checkpoint's
    model called directly (export.load_model_from_ckpt, embed_unimodal /
    embed_multimodal) on preprocess_pair of the same rows. Then the port's
    load-test client at its defaults (16 clients x 20 requests x 64 rows,
    raw widths 41/91) prints requests/s, p50/p99 and the server's device
    dispatches and coalesced requests. The server is stopped after. Returns
    the replies, {mode: {kind: [rows, width]}}, for phase 14."""
    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.evaluate.embeddings import embed_multimodal, embed_unimodal
    from hippie_tpu_torch.ops import preprocess

    t_phase = time.perf_counter()
    wf, isi = target_raw_rows()
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=device)
    source = torch.zeros(len(wf), dtype=torch.long, device=device)
    replies = {}
    for mode, flags in (("dual", ["--wave-checkpoint", uni_ckpts["wave"], "--time-checkpoint", uni_ckpts["time"]]),
                        ("joint", ["--joint-checkpoint", joint_ckpt])):
        if mode == "dual":
            mw, _ = export.load_model_from_ckpt(uni_ckpts["wave"], device=device)
            mt, _ = export.load_model_from_ckpt(uni_ckpts["time"], device=device)
            e_w, e_i = embed_unimodal(mw, wave, source), embed_unimodal(mt, isi_p, source)
            direct = {"waveform": e_w, "isi": e_i, "joint": torch.cat([e_w, e_i], dim=1)}
        else:
            mj, _ = export.load_model_from_ckpt(joint_ckpt, device=device)
            direct = {"joint": embed_multimodal(mj, wave, isi_p, source)}
        direct = {k: v.cpu().numpy() for k, v in direct.items()}
        got, res, stats, start_s, said = serve_and_load(flags, wf, isi, device)
        check(all(got[kind].shape == ref.shape for kind, ref in direct.items()),
              f"{mode} replies of shapes {[v.shape for v in got.values()]}")
        worst = max(float(np.abs(got[kind] - ref).max()) for kind, ref in direct.items())
        check(worst <= 1e-5, f"serving {mode}: a reply {worst} from the model called directly")
        replies[mode] = got
        print(f"[13 serving] {mode}: the server started and warmed (512, 1024) in {start_s:.1f} s "
              f"({'; '.join(x for x in said if x.startswith('warmup'))}); {n_requests(wf)} requests of the "
              f"target's {len(wf)} raw rows, max |reply - direct| {worst:.3g} (limit 1e-5)")
        print(load_test_line(res, stats, card))
    print(f"  phase 13 {time.perf_counter() - t_phase:.1f} s")
    return replies


def target_raw_rows():
    """The target's raw waveform and ISI rows (NaN columns dropped), float32."""
    from hippie_tpu_torch.data import registry

    wf, isi = registry.load_raw(DATA_ROOT, TARGET, dropna=True)
    return np.asarray(wf, np.float32), np.asarray(isi, np.float32)


def n_requests(wf) -> int:
    return -(-len(wf) // 64)


def serve_and_load(flags: list, wf, isi, device="cuda"):
    """Start the port's server with ``flags`` (warmed with 512,1024), send
    the raw rows in requests of up to 64 rows (source 0), run the load-test
    client at its defaults, stop the server. Returns (replies {kind: [rows,
    width]}, the load test's result, the server's /stats, start-up seconds,
    the server's lines)."""
    import contextlib
    import io

    from hippie_tpu_torch.scripts import serving_load_test

    t0 = time.perf_counter()
    proc, url, said = _free_server(flags + ["--warmup-buckets", "512,1024", "--device", device])
    start_s = time.perf_counter() - t0
    try:
        parts = {}
        for lo in range(0, len(wf), 64):
            rows = slice(lo, lo + 64)
            reply = _post(url, {"waveforms": wf[rows].tolist(), "isi_dists": isi[rows].tolist()})
            for kind in ("waveform", "isi", "joint"):
                if kind in reply:
                    parts.setdefault(kind, []).append(np.asarray(reply[kind], np.float32))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = serving_load_test.main(["--url", url])
        stats = json.loads(urllib_get(url + "/stats"))
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    check(res["requests"] == 16 * 20, f"load test: {res['requests']} requests")
    replies = {k: np.concatenate(v) for k, v in parts.items()}
    check(all(v.shape[0] == len(wf) for v in replies.values()),
          f"replies of {[v.shape for v in replies.values()]} rows for {len(wf)}")
    return replies, res, stats, start_s, said


def load_test_line(res: dict, stats: dict, card: str) -> str:
    return (f"  load test (16 clients x 20 requests x 64 rows, widths 41/91) on {card}: "
            f"{res['req_per_s']} req/s, {res['rows_per_s']} rows/s, client p50 {res['client_p50_ms']} ms, "
            f"p99 {res['client_p99_ms']} ms, max {res['client_max_ms']} ms; {res['device_dispatches']} "
            f"device dispatches for {res['requests']} requests "
            f"({res['device_dispatches'] / res['requests']:.3f} per request), {res['coalesced_requests']} "
            f"coalesced; server /stats p50 {stats['p50_latency_ms']} ms, p99 {stats['p99_latency_ms']} ms")


# ---------------------------------------------------------------------------
# Phases 14-16: the embedding artifact, K-replica training, k-fold
# ---------------------------------------------------------------------------

ARTIFACT_ROWS = (1, 415, 4096)  # the replies held to the checkpoint's model
BENCH_ROWS = "512,4096,16384"  # bench_artifact's row counts
ARTIFACTS = ("wave", "time", "joint")


def artifact_inputs(seed: int = 14) -> dict:
    """Preprocessed-width rows drawn with numpy, 4,096 per artifact: {name:
    (data..., source)}; each row count of ARTIFACT_ROWS takes a prefix."""
    r = np.random.default_rng(seed)
    n = max(ARTIFACT_ROWS)
    src = r.integers(0, 5, size=n).astype(np.int64)
    wave, isi = (r.normal(size=(n, w)).astype(np.float32) for w in (L, L_ISI))
    return {"wave": (wave, src), "time": (isi, src), "joint": (wave, isi, src)}


def artifact_replies(workdir: str, device: str = "cuda"):
    """In a fresh process (``chip_smoke.py --artifact-replies WORKDIR``):
    load each artifact of phase 14 with export.load_artifact on the card,
    the "highest" one and its "default" (TF32) twin, reply at each row count
    of ARTIFACT_ROWS, then run bench_artifact on the "highest" one; writes
    the replies to ``replies.npz`` and the load seconds and bench records to
    ``replies.json`` under ``workdir``."""
    import contextlib
    import io

    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.scripts import bench_artifact

    inputs = artifact_inputs()
    out, meta = {}, {"load_s": {}, "bench": {}}
    for name in ARTIFACTS:
        for tag in ("", "_tf32"):
            t0 = time.perf_counter()
            call, _ = export.load_artifact(f"{workdir}/{name}{tag}.hippie", device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            meta["load_s"][name + tag] = time.perf_counter() - t0
            for n in ARTIFACT_ROWS:
                out[f"{name}{tag}_{n}"] = call(*(a[:n] for a in inputs[name])).cpu().numpy()
        with contextlib.redirect_stdout(io.StringIO()):
            meta["bench"][name] = bench_artifact.main(["--artifact", f"{workdir}/{name}.hippie",
                                                       "--rows", BENCH_ROWS, "--device", device])
    np.savez(f"{workdir}/replies.npz", **out)
    with open(f"{workdir}/replies.json", "w") as f:
        json.dump(meta, f)


def checkpoint_path_ms(model, arrays, embed, rows: int, iters: int = 20) -> float:
    """The checkpoint path's warm ms per call at ``rows`` rows, measured as
    bench_artifact measures an artifact: numpy rows up, the reply down."""
    import torch

    dev = next(model.parameters()).device

    def call():
        t = [torch.from_numpy(a[:rows]).to(dev) for a in arrays]
        return embed(model, *t).cpu()

    call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_artifacts(card: str, workdir: str, uni_ckpts: dict, joint_ckpt: str, ckpt_replies: dict,
                    device="cuda"):
    """Phase 14: the deployable artifact. Exports phase 9's stage-3 wave and
    time checkpoints and phase 10's supervised joint one with the
    export_model CLI (precision "highest"), writes each one's "default"
    (TF32) twin (the same program; torch applies the precision around each
    call, export.py), and loads them in a fresh process on the card
    (artifact_replies). Every "highest" reply at 1, 415 and 4,096 rows is
    within 1e-5 of embed_unimodal / embed_multimodal of the checkpoint's
    model (export.load_model_from_ckpt) on the same rows; the TF32 drift is
    printed as the least row cosine and the max |difference|. Prints the
    fresh process's bench_artifact records (rows 512, 4096, 16384) beside
    the checkpoint path's warm ms measured the same way, and the export and
    load seconds. Then the server on the artifacts (--wave-artifact
    --time-artifact, and --joint-artifact) with phase 13's requests and load
    test: every reply within 1e-5 of the checkpoint server's."""
    import contextlib
    import io
    import zipfile

    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.evaluate.embeddings import embed_multimodal, embed_unimodal
    from hippie_tpu_torch.scripts import export_model

    t_phase = time.perf_counter()
    art_dir = f"{workdir}/artifacts"
    os.makedirs(art_dir, exist_ok=True)
    ckpts = {"wave": uni_ckpts["wave"], "time": uni_ckpts["time"], "joint": joint_ckpt}
    export_s, sizes = {}, {}
    for name, ckpt in ckpts.items():
        path = f"{art_dir}/{name}.hippie"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            manifest = export_model.main(["--checkpoint", ckpt, "--output", path, "--precision", "highest",
                                          "--device", device])
        export_s[name] = time.perf_counter() - t0
        sizes[name] = os.path.getsize(path)
        with zipfile.ZipFile(path) as zf:
            check(sorted(zf.namelist()) == ["manifest.json", "model.pt2"], f"{name} artifact holds {zf.namelist()}")
            blob = zf.read("model.pt2")
        export.save_artifact(f"{art_dir}/{name}_tf32.hippie", blob, dict(manifest, precision="default"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--artifact-replies", art_dir, device],
                          cwd=str(REPO), capture_output=True, text=True, timeout=600)
    fresh_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the fresh process failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    replies = np.load(f"{art_dir}/replies.npz")
    with open(f"{art_dir}/replies.json") as f:
        meta = json.load(f)

    inputs = artifact_inputs()
    for name, ckpt in ckpts.items():
        t0 = time.perf_counter()
        model, _ = export.load_model_from_ckpt(ckpt, device=device)
        load_ckpt_s = time.perf_counter() - t0
        embed = embed_multimodal if name == "joint" else embed_unimodal
        err = drift = 0.0
        cos = 1.0
        for n in ARTIFACT_ROWS:
            ref = embed(model, *(torch.from_numpy(a[:n]).to(device) for a in inputs[name])).cpu().numpy()
            got, tf32 = replies[f"{name}_{n}"], replies[f"{name}_tf32_{n}"]
            check(got.shape == ref.shape, f"{name} artifact reply of shape {got.shape} at {n} rows")
            err = max(err, float(np.abs(got - ref).max()))
            drift = max(drift, float(np.abs(tf32 - got).max()))
            cos = min(cos, float((np.sum(tf32 * got, 1) / (np.linalg.norm(tf32, axis=1)
                                                          * np.linalg.norm(got, axis=1))).min()))
        check(err <= 1e-5, f"{name} artifact: {err} from the checkpoint's model called directly")
        bench = {r["rows"]: r for r in meta["bench"][name]}
        ckpt_ms = {rows: round(checkpoint_path_ms(model, inputs[name] if rows <= max(ARTIFACT_ROWS) else
                                                  tuple(np.resize(a, (rows,) + a.shape[1:]) for a in inputs[name]),
                                                  embed, rows), 3)
                   for rows in bench}
        print(f"[14 artifacts] {name} on {card}: export_model {export_s[name]:.2f} s ({sizes[name] / 1e6:.1f} MB), "
              f"load_artifact in a fresh process {meta['load_s'][name]:.2f} s (load_model_from_ckpt "
              f"{load_ckpt_s:.2f} s); max |artifact - checkpoint model| {err:.3g} at rows "
              f"{list(ARTIFACT_ROWS)} (limit 1e-5); TF32 ('default') drift: max |d| {drift:.3g}, least "
              f"row cosine {cos:.7f}")
        print(f"  bench_artifact on {card} (ms per call, host copies included): "
              + "; ".join(f"{rows} rows cold {r['cold_ms']} warm {r['warm_ms']} ({r['rows_per_sec']:.0f} rows/s), "
                          f"checkpoint path warm {ckpt_ms[rows]}" for rows, r in bench.items()))
    print(f"  the fresh process (6 loads, replies, 3 benches) {fresh_s:.1f} s on {card}")

    wf, isi = target_raw_rows()
    for mode, flags in (("dual", ["--wave-artifact", f"{art_dir}/wave.hippie",
                                  "--time-artifact", f"{art_dir}/time.hippie"]),
                        ("joint", ["--joint-artifact", f"{art_dir}/joint.hippie"])):
        got, res, stats, start_s, said = serve_and_load(flags, wf, isi, device)
        ref = ckpt_replies[mode]
        check(sorted(got) == sorted(ref), f"artifact server {mode} replies {sorted(got)}")
        worst = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
        check(worst <= 1e-5, f"artifact server {mode}: a reply {worst} from the checkpoint server's")
        print(f"[14 artifact server] {mode} on {card}: started and warmed (512, 1024) in {start_s:.1f} s; "
              f"{n_requests(wf)} requests, max |reply - checkpoint server's| {worst:.3g} (limit 1e-5)")
        print(load_test_line(res, stats, card))
    print(f"  phase 14 {time.perf_counter() - t_phase:.1f} s on {card}")


def max_abs_diff(a: dict, b: dict) -> float:
    """The largest |a - b| over the float tensors of two state_dicts (or
    other dicts of tensors); inf when an integer one differs."""
    worst = 0.0
    for k, v in a.items():
        if v.is_floating_point():
            worst = max(worst, float((v.double() - b[k].double()).abs().max()))
        elif not bool((v == b[k]).all()):
            return float("inf")
    return worst


def phase_ensemble(card: str, workdir: str, pool, cfg_m=None, device="cuda", k_replicas: int = 4):
    """Phase 15: K-replica training. One stage-1 epoch over phase 4's pool
    plan of a K=4 unimodal ensemble at full width (z=10, (2,2,2,2)) with
    learning rates 1e-3, 2e-3, 5e-4, 3e-3, block_backend="pallas" and
    loss_backend="pallas" (ensemble.make_unimodal_ensemble_epoch_fns, each
    replica's noise from its own generator), timed after the four
    single-model epochs below and against their median after the first
    (which warms the path). Its kernel launches must be
    exactly 4x a single-model epoch's. Replica k must equal a single-model
    epoch (step.make_unimodal_epoch_fns) from the same init, lr and noise:
    bit for bit where two runs of the single model agree bit for bit,
    otherwise within twice their spread (weights, buffers and the per-step
    losses), measured here and printed. Then the lr_sweep CLI with
    --modality wave and --modality joint, K=4, one epoch, --export-winner,
    at z=10 and the pipeline's stage-1 geometry; each winner is loaded
    through its pipeline's stage-1 seam (pipeline._seed_stage1) and must
    equal the file."""
    import contextlib
    import io
    import math

    import torch

    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.scripts import lr_sweep
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import ensemble, loop, optim, pipeline, step

    t_phase = time.perf_counter()
    cfg_m = full_config() if cfg_m is None else cfg_m
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    lrs = [1e-3, 2e-3, 5e-4, 3e-3][:k_replicas]
    key, epoch_key = 15, loop.epoch_key(15, 0, 1)
    idx, mask = device_data.batch_plan(np.arange(len(pool)), B, shuffle=True,
                                       generator=torch.Generator().manual_seed(1))

    def noise(k):
        return loop.key_generator(epoch_key, 1, k, device=device)

    single_epoch, _ = step.make_unimodal_epoch_fns(loss_backend="pallas", block_backend="pallas")

    def single(k):
        model = cvae.unimodal_cvae_init(cfg_m, loop.key_generator(key, k), device=device)
        ts = step.TrainState(model, optim.make_optimizer(model.parameters(), lrs[k], WD))
        reset_all_launches()
        sync()
        t0 = time.perf_counter()
        ts, m = single_epoch(ts, pool.wave, pool.source, None, idx, mask, generator=noise(k))
        losses = m.loss.cpu()
        sync()
        return ts.model.state_dict(), losses, all_launches(), time.perf_counter() - t0

    runs = [single(k) for k in range(k_replicas)]

    states = ensemble.init_unimodal_ensemble(key, cfg_m, lambda ps: optim.make_optimizer(ps, LR, WD),
                                             k_replicas, device=device)
    states = ensemble.set_ensemble_lr(states, lrs)
    train_epoch, _ = ensemble.make_unimodal_ensemble_epoch_fns(loss_backend="pallas", block_backend="pallas")
    reset_all_launches()
    sync()
    t0 = time.perf_counter()
    states, ms = train_epoch(states, pool.wave, pool.source, None, idx, mask,
                             generators=[noise(k) for k in range(k_replicas)])
    ens_losses = ms.loss.cpu()
    sync()
    ens_s = time.perf_counter() - t0
    ens_launches = all_launches()

    runs.append(single(0))  # the single model's spread: its first run against this one
    want = {name: k_replicas * n for name, n in runs[0][2].items()}
    check(ens_launches == want, f"ensemble epoch launches {ens_launches}, expected {k_replicas} x "
                                f"{runs[0][2]}")
    spread = max(max_abs_diff(runs[0][0], runs[-1][0]),
                 float((runs[0][1] - runs[-1][1]).abs().max()))
    diffs = []
    for k in range(k_replicas):
        d = max(max_abs_diff(states[k].model.state_dict(), runs[k][0]),
                float((ens_losses[:, k] - runs[k][1]).abs().max()))
        check(d == 0.0 if spread == 0.0 else d <= 2 * spread,
              f"replica {k}: {d} from its single-model epoch (two single runs differ by {spread})")
        diffs.append(d)
    single_s = [r[3] for r in runs]
    warm = float(np.median(single_s[1:]))
    print(f"[15 ensemble] K={k_replicas} unimodal ensemble, z={cfg_m.z_dim}, num_blocks={cfg_m.num_blocks}, "
          f"lrs {lrs}, one stage-1 epoch of {idx.shape[0]} steps on the pool, loss_backend=pallas "
          f"block_backend=pallas: {ens_s:.3f} s wall on {card}, {ens_s / warm:.2f}x the median single-model "
          f"epoch after the first (single epochs in run order, the ensemble's between the 4th and 5th: "
          f"{[round(x, 3) for x in single_s]} s); launches {ens_launches} = {k_replicas} x the single epoch's")
    print(f"  replica k against its single-model epoch (same init, lr, noise): max |diff| "
          f"{[f'{d:.3g}' for d in diffs]}; two runs of the single model differ by {spread:.3g} "
          f"({'bit for bit' if spread == 0.0 else 'limit twice that'})")

    for modality in ("wave", "joint"):
        path = f"{workdir}/sweep_{modality}_winner.ckpt"
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = lr_sweep.main(["--dataset", TARGET, "--data-root", DATA_ROOT, "--modality", modality,
                                "--lrs", "1e-3,3e-3,1e-4,3e-4", "--max-epochs", "1", "--z-dim", str(cfg_m.z_dim),
                                "--num-blocks", ",".join(map(str, cfg_m.num_blocks)), "--export-winner", path,
                                "--device", device])
        sweep_s = time.perf_counter() - t0
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        check(rc == 0 and rec["exported"] == path and len(rec["best_val_loss"]) == 4
              and all(math.isfinite(v) for v in rec["best_val_loss"]), f"lr_sweep {modality}: {rec}")
        pcfg = pipeline.PipelineConfig(z_dim=cfg_m.z_dim, num_blocks=tuple(cfg_m.num_blocks), dataset=TARGET,
                                       data_root=DATA_ROOT, device=device, verbose=False)
        joint = modality == "joint"
        seam_cfg = pipeline.joint_model_config(pcfg, 5) if joint else pipeline.model_config(pcfg, "wave", 5)
        t0 = time.perf_counter()
        seeded = pipeline._seed_stage1(pcfg, pipeline.BestTracker(f"{workdir}/seam_{modality}.ckpt"), path,
                                       seam_cfg, "joint" if joint else "wave")
        seam_s = time.perf_counter() - t0
        want_sd = ckpt_mod.model_state_from_ckpt(ckpt_mod.load_lightning_ckpt(path))
        d = max_abs_diff({k: v.cpu() for k, v in seeded.model.state_dict().items()}, want_sd)
        check(d == 0.0, f"the {modality} stage-1 seam holds {d} from the sweep's winner")
        print(f"[15 lr_sweep] --modality {modality}, K=4 (lrs {rec['lrs']}), 1 epoch: {sweep_s:.2f} s wall on "
              f"{card}; best val {[round(v, 4) for v in rec['best_val_loss']]}, winner {rec['winner']}; the "
              f"winner loaded through the {'joint' if joint else 'wave'} stage-1 seam in {seam_s:.2f} s, "
              f"equal to the file ({cvae.param_count(seeded.model):,} params)")
    print(f"  phase 15 {time.perf_counter() - t_phase:.1f} s on {card}")


def phase_kfold(card: str, workdir: str, uni_ckpts: dict, joint_ckpt: str, device="cuda"):
    """Phase 16: the kfold_eval CLI on phase 9's stage-3 checkpoints (the
    dual pair) and phase 10's supervised joint one: embed-once at 5 folds;
    then --refit --refit-epochs 1 --folds 5, sequential; then the same with
    --fold-parallel, which runs the sequential refits: its per-fold refit
    embeddings must equal the sequential run's bit for bit (phase 15's rule:
    the kernel path repeats bit for bit on the card). Checks both CSVs' rows
    and that every accuracy lies in [0, 1]."""
    import contextlib
    import io

    from hippie_tpu_torch.scripts import kfold_eval

    t_phase = time.perf_counter()
    for mode, flags in (("dual", ["--wave-checkpoint", uni_ckpts["wave"], "--time-checkpoint", uni_ckpts["time"]]),
                        ("joint", ["--joint-checkpoint", joint_ckpt])):
        base = ["--dataset", TARGET, "--data-root", DATA_ROOT, "--folds", "5", "--device", device, *flags]
        runs, walls, said = {}, {}, {}
        for name, extra in (("embed_once", []), ("sequential", ["--refit", "--refit-epochs", "1"]),
                            ("fold_parallel", ["--refit", "--refit-epochs", "1", "--fold-parallel"])):
            out_dir = f"{workdir}/kfold_{mode}_{name}"
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                runs[name] = kfold_eval.main(base + extra + ["--output-dir", out_dir])
            walls[name] = round(time.perf_counter() - t0, 3)
            said[name] = out.getvalue()
            kinds = ["joint"] if mode == "joint" else ["waveform", "isi", "joint"]
            modes = ["embed_once"] + (["refit"] if extra else [])
            header, rows = csv_table(f"{out_dir}/{TARGET}_kfold_knn.csv")
            check(header == ["mode", "kind", "k", "mean_balanced_accuracy", "std_balanced_accuracy", "folds"]
                  and len(rows) == len(modes) * len(kinds) * len(kfold_eval.KS)
                  and all(0.0 <= float(r[3]) <= 1.0 and r[5] == "5" for r in rows),
                  f"kfold {mode} {name}: {header}, {len(rows)} rows")
            _, fold_rows = csv_table(f"{out_dir}/{TARGET}_kfold_knn_folds.csv")
            check(len(fold_rows) == 5 * len(rows), f"kfold {mode} {name}: {len(fold_rows)} fold rows")
        seq, par = (runs[n]["refit"] for n in ("sequential", "fold_parallel"))
        diff = max(float(np.abs(a - b).max()) for kind in seq for a, b in zip(seq[kind], par[kind]))
        check(diff == 0.0, f"kfold {mode}: fold-parallel refit embeddings {diff} from the sequential ones")
        lines = [x for x in said["fold_parallel"].splitlines() if "embed-once" in x]
        print(f"[16 kfold] {mode}: wall s on {card}: {json.dumps(walls)}; fold-parallel refit embeddings "
              f"{diff:.3g} from the sequential run's (bit for bit); {' | '.join(lines)}")
    print(f"  phase 16 {time.perf_counter() - t_phase:.1f} s on {card}")


def urllib_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def phases_of(checkout: str):
    """In this process: build ``checkout``'s kernels and run its phase 9
    twice (cold, then warm) and its phase 10, with its own chip_smoke.py."""
    os.chdir(checkout)
    sys.path.insert(0, checkout)
    sys.modules.pop("chip_smoke", None)
    import chip_smoke as cs  # the checkout's, not this file

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
        cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="hippie_phases_") as wd:
        cs.phase_pipeline(card, wd)
        cs.phase_pipeline(card, wd)
        cs.phase_joint_pipeline(card, wd)


def compare(other: str, pairs: int) -> int:
    """Phases 9 (cold, warm) and 10 of ``other`` and of this tree, each run
    in a fresh process, ``pairs`` times in turns; prints each run's wall
    times and ckpt_save (s) and the medians per tree."""
    trees = {"other": str(pathlib.Path(other).resolve()), "this": str(REPO)}
    runs = {k: [] for k in trees}
    for i in range(pairs):
        for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
            proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--phases-of", trees[name]],
                                  capture_output=True, text=True, timeout=900)
            walls = [float(w) for w in re.findall(r"^\[(?:9|10)[^\]]*\].*?: ([0-9.]+) s wall", proc.stdout, re.M)]
            saves = [json.loads(t).get("ckpt_save", 0.0)
                     for t in re.findall(r"stage timings \(StageTimer\): (\{.*\})", proc.stdout)]
            if proc.returncode != 0 or len(walls) != 3 or len(saves) != 3:
                print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n")
                print(f"chip_smoke: FAILED: the {name} tree's phases (rc {proc.returncode})", file=sys.stderr)
                return 1
            run = {"phase9_cold": walls[0], "phase9_warm": walls[1], "phase10": walls[2],
                   "ckpt_save": saves}
            runs[name].append(run)
            print(f"[compare {i}] {name} ({trees[name]}): {json.dumps(run)}", flush=True)
    for name, rs in runs.items():
        med = {k: float(np.median([r[k] for r in rs])) for k in ("phase9_cold", "phase9_warm", "phase10")}
        print(f"[compare] {name} medians over {len(rs)} runs (s): {json.dumps(med)}")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--artifact-replies"]:
        artifact_replies(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--phases-of"]:
        phases_of(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--compare"]:
        pairs = int(sys.argv[4]) if sys.argv[3:4] == ["--pairs"] else 5
        return compare(sys.argv[2], pairs)
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
        ts, pool, idx, mask, _, losses = phase_slice(full_config())
        # the unimodal main path: both backbones' blocks on the fused block kernels
        _, _, _, _, _, main_losses = phase_slice(full_config(), "pallas", pool=pool)
        rel = abs(main_losses[0] - losses[0]) / abs(losses[0])
        print(f"  first step from the same weights and batch: loss {main_losses[0]:.6f} with "
              f"block_backend=pallas, {losses[0]:.6f} with xla (rel {rel:.3g}; limit 5e-2, "
              f"tests/test_pallas_blocks.py:231)")
        check(rel <= 5e-2, f"block_backend=pallas first loss {main_losses[0]} vs xla {losses[0]}")
        phase_step_parity(ts.model, pool, idx, mask)
        # the joint model's stage 1 from the same weights with each block
        # backend; the "pallas" epoch runs every kernel of the port
        _, jidx, jmask, _, jlosses_xla = phase_joint(pool, "xla")
        jts, _, _, joint_launches, jlosses = phase_joint(pool, "pallas")
        rel = abs(jlosses[0] - jlosses_xla[0]) / abs(jlosses_xla[0])
        print(f"  joint first step from the same weights and batch: loss {jlosses[0]:.6f} with "
              f"block_backend=pallas, {jlosses_xla[0]:.6f} with xla (rel {rel:.3g}; limit 5e-2)")
        check(rel <= 5e-2, f"joint block_backend=pallas first loss {jlosses[0]} vs xla {jlosses_xla[0]}")
        phase_joint_step_parity(jts.model, pool, jidx, jmask)
        block_kernels, block_errs = [], {}
        for bb in (ENC, DEC, isi_backbone()):
            bb_errs, per_shape = phase_blocks(bb, card)
            for name, limit in BLOCK_LAUNCH_LIMITS.items():
                calls = [v[5] for k, v in per_shape.items() if k[-1] == name]
                check(not calls or max(calls) <= limit,
                      f"{bb.label}: {name} makes {max(calls or [0]):g} CUDA launches per call, over {limit}")
            records = block_records(bb, per_shape, bb_errs, joint_launches, card)
            if bb.label != ISI_LABEL:  # the records: times of the waveform model's backbones
                phase_pass(bb, ts.model, pool, idx, mask, card)
                block_kernels += records
            for k, v in bb_errs.items():
                block_errs[k] = max(block_errs.get(k, 0.0), v)
        for record in block_kernels:  # errors over every shape held, the ISI encoder's too
            record["max_abs_err"] = block_errs[record["name"]]
        phase_embed(ts.model)
        phase_embed(jts.model, joint=True)
        kernels = phase_timings(ts, pool, idx, mask, jts, (jidx, jmask), card, errs, joint_launches)
        kernels += block_kernels
        with tempfile.TemporaryDirectory(prefix="hippie_pipeline_") as workdir:
            uni_ckpts = phase_pipeline(card, workdir)
            # the slice's main path, which runs all seven kernels: its launches go on the kernels line
            pipeline_launches, joint_ckpt = phase_joint_pipeline(card, workdir)
            for record in kernels:
                record["launches"] = pipeline_launches[record["name"]]
            phase_inference(card, workdir, uni_ckpts, joint_ckpt)
            phase_optimizers(card, workdir)
            ckpt_replies = phase_serving(card, uni_ckpts, joint_ckpt)
            phase_artifacts(card, workdir, uni_ckpts, joint_ckpt, ckpt_replies)
            phase_ensemble(card, workdir, pool)
            phase_kfold(card, workdir, uni_ckpts, joint_ckpt)
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
