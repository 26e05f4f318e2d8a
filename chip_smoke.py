#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hippie_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from hippie_tpu_torch/csrc/, loads
them in a fresh process without nvcc from a filled kernel-library cache
(2b, the ``--aot-dir`` of every CLI it runs, which it points at its own
build root), holds the fused VAE-loss and masked-SSE kernels against their
plain PyTorch versions at the train steps' shapes (the loss backward for
every pattern of gradients asked for), and trains the full-width waveform cVAE
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
both block backends and each kernel (vae_sums_bwd with the train step's
gradients and with all four, alone and in a CUDA graph behind the kernel
that writes its g, beside the device time of a one-element torch op, the
launch floor). Last it runs the port's unimodal
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
directly, and k-means and the GMM run on the card against the host and,
their Lloyd and EM iterations replayed from CUDA graphs, against the same
iterations looped eagerly on the card, bit for bit. Then
the unimodal pipeline with schedule-free AdamW and the joint one with bf16
Adam moments (12), with one step of each optimizer on the full-width model
against the host and the optimizer's device memory with float32 and bf16
moments, the embedding server on both pipelines'
checkpoints with its load test (13: one CUDA graph per ladder bucket and
none while serving; in this process the same service's replays bit-equal
to its eager program), the deployable artifact (14: the
three stage-3 checkpoints exported, loaded in a fresh process, held to the
models called directly and to the call's eager twin, one graph per row
bucket, timed with bench_artifact, served; its exports run
before 13, so that the four servers of 13-14 start at once), K-replica
training (15: a K=4 ensemble epoch through the kernels, exactly 4x the
launches, each replica its single-model epoch; the K=4 fit on the device
loop, ensemble.device_fit_ensemble, one CUDA graph per step kind for all
four replicas, equal to the host loop bit for bit with 4x one model's
launches counted by torch.profiler; the lr_sweep CLI on its default device
loop with its winners through the stage-1 seams, and a K=2 sweep with each
loop giving the same numbers and winner bytes) and k-fold (16: kfold_eval embed-once,
the sequential refit, and --fold-parallel, the folds side by side in
replica-plan fits, one CUDA graph per step kind and group, bit-equal to it
with the same captures as groups; 16b, this slice's main path whose
launches are the kernels line's: K=3 replica-plan fits of both full-width
models on the loss and block kernels, equal to the host fit bit for bit).
Then mid-run resume (17, the slice's main path, whose launches are the
kernels line's: the joint pipeline at 2 epochs per stage stopped inside its
supervised fit and resumed, against the uninterrupted run; a unimodal stage
fit with schedule-free AdamW and with bf16 moments; lr_sweep --resume-dir
on the device loop)
and the rest of the CLI with the "fused" and "bf16" block backends (18:
hippie-tpu-torch train with --profile-dir --discover-datasets --wandb,
sweep_targets, profile_train_step with each backend, a stage-1 epoch with
"fused" and "bf16"). Then data parallelism and FSDP (19, whose segmented
block entries' launches are the kernels line's): one rank over NCCL equal
to the single process bit for bit, the segmented block entry points equal
to the unsegmented ones and held to their plain versions, two gloo ranks
sharing the card within the JAX envelope of one process, FSDP beside them,
and the joint pipeline on the two ranks with rank 0 the only writer. Phases
9-19 run the host fit loop (``fit_loop="host"``), whose launches the
wrappers' counters count one by one. Last the device fit loop (20, this
slice's main path: each stage fit's steps as CUDA graphs replayed, the
default of both training CLIs): every kernel wrapper and the train and eval
steps of both models on every block backend replayed bit-equal to their
eager calls with no host sync in an epoch, the unimodal stage-1 fit equal
to the host loop's bit for bit with each loop's ms/step and the replayed
step's kernels and runtime calls (and with schedule-free, bf16 moments and
the "xla" loss), both training CLIs writing the same bytes with either loop
(the joint one's device-loop launches at 1 epoch per stage, counted by
torch.profiler with the graphs' replays, are the kernels line's for the
seven kernels; the wrappers count only the launches they make), a joint
pipeline stopped with the device loop and resumed with the host loop, the
clip's
launches before and after its repair, and in one NCCL rank (run in 19a's
rank) the device fit (20e), an FSDP stage fit with AdamW and with
schedule-free on the device loop equal to the host loop with each loop's
ms/step and peak memory, and device_fit_ensemble(mesh=) at K=2 stopped and
resumed equal to the uninterrupted fit (20f). Then the benchmark (21,
``hippie-tpu-torch bench``, the root bench.py's stage-1 throughput on the
device loop's replayed train epoch): the CLI in a fresh process with its
default "pallas" backends and with "xla", each JSON line checked (keys,
finite values, the FLOPs of utils/flops.py, busy time within the step's)
and its profiled epoch's kernel launches counted by torch.profiler; and in
this process the bench's graphed epochs equal to train/step.py's eager
epochs on the same data, plan, noise and weights bit for bit, with their
launches counted by the profiler. Each block kernel is split by kernel
(device time and launches per call; at most 5 per enc_block_fwd and
dec_block_fwd call and 8 per enc_block_bwd and dec_block_bwd call), and the
block libraries' SASS is checked for wgmma (HGMMA).

Every phase prints one line, and the script its total seconds. The
second-to-last line is the ``kernels`` JSON record, the last the device
record. Exits non-zero, printing neither, when no
CUDA device is present, outside the repository, or when any phase fails.

To compare the pipelines of another checkout (a parent commit unpacked with
``git archive``) with this one on the same card:

    python3 chip_smoke.py --compare CHECKOUT [--pairs N]

runs, N times in turns (CHECKOUT then this tree, then this tree then
CHECKOUT, ...), a fresh process per run that builds that tree's kernels and
runs its phase 9 twice (cold: the process's first pipeline, as a CLI run;
then warm) and its phase 10, and prints each run's wall times and
``ckpt_save`` and the medians. With ``--whole [--log-dir DIR]`` it runs
each tree's whole script instead (N defaults to 1: CHECKOUT, then this
tree), and prints each run's exit code, total and per-phase seconds side
by side (each run's output into DIR). ``python3 chip_smoke.py --artifact-replies
DIR [DEVICE]`` is phase 14's fresh process. ``python3 chip_smoke.py
--dp-walls`` (2 or more GPUs of one host) times the joint training CLI on
1, 2 and all the GPUs over NCCL, and with --fsdp; ``python3 chip_smoke.py
--fsdp-nccl`` (2 or more GPUs) runs 20f's FSDP stage fits on two NCCL
ranks, each loop against the other.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

# H100 SXM peaks (NVIDIA's data sheet) and the profiler's readings, the
# port's (neither module imports torch on import)
from hippie_tpu_torch.utils.flops import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_F32_FLOPS, step_flops
from hippie_tpu_torch.utils.kernel_profile import (MARKER_KERNELS, device_events, device_profile, kernel_name,
                                                   marker_launches)

REPO = pathlib.Path(__file__).resolve().parent
# every CLI run gets the script's build root as its kernel-library cache: its
# kernels load from build/kernels (the second directory looked in; see
# hippie_tpu_torch/ops/_build.py), so no CLI builds them again and none
# writes under the home directory
AOT_DIR = ["--aot-dir", str(REPO / "build")]
DATA_ROOT = str(REPO / "datasets")
TARGET = "cellexplorer-celltype"
B, L, Z = 512, 50, 10  # the train step's batch, waveform length, latent width
L_ISI = 100  # the ISI histogram's length
LR, WD = 1e-3, 0.01  # stage-1 AdamW (the JAX pipeline's defaults)
CLIP = 1.0  # the joint pipeline always clips the gradients' global norm (quirk Q7)
FULL_PARAMS = 8_056_639
FULL_MM_PARAMS = 16_115_748
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


STEP_GRADS = (False, True, True, True)  # the train step's backward: ddec, dmu, dlogvar (its data needs none)


def vae_sums_bounds(b: int, l: int, z: int, want=STEP_GRADS):
    """Least time (ms) on the card for the forward and for the backward that
    writes the gradients ``want`` flags (ddata, ddec, dmu, dlogvar): each
    input read once, each output written once, against the float32
    operations."""
    f4 = 4
    in_bytes = f4 * (2 * b * l + 2 * b * z + b)
    fwd_bytes = in_bytes + f4 * 2
    bwd_bytes = in_bytes + f4 * 2 + f4 * sum(n for n, w in zip((b * l, b * l, b * z, b * z), want) if w)
    fwd_ops = 4 * b * l + 9 * b * z  # sub, square, mask, add; the KL's 8 ops and an exp
    bwd_ops = (3 * b * l if want[0] or want[1] else 0) + b * l * (want[0] + want[1]) \
        + 3 * b * z * want[2] + 5 * b * z * want[3]  # d = (dec - data) * m, one product per output
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
    print(f"[2 build] {len(secs)} source(s) {sorted(secs)} built with nvcc in {wall:.2f} s "
          f"(seconds each, 0.0 where already built: {json.dumps({k: round(v, 2) for k, v in secs.items()})})")
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


def phase_aot_cache(card: str):
    """The kernel-library cache (``--aot-dir``; hippie_tpu_torch/ops/_build.py):
    the libraries phase 2 built are copied into a fresh cache directory's
    torch_kernels/, as onto a card without the CUDA toolkit, and a fresh
    process (``--aot-load DIR``) with nvcc out of reach and the package's
    build/kernels hidden loads every one from there, builds nothing (0.0 s
    each), and holds vae_sums_fwd and vae_sums_bwd against their plain
    versions (phase 3's limits)."""
    from hippie_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hippie_aot_") as root:
        kdir = pathlib.Path(root) / _build.SUBDIR
        kdir.mkdir()
        for name in _build.sources():
            shutil.copy(_build.so_path(name), kdir)
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--aot-load", root],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n")
        check(proc.returncode == 0, f"the fresh process on the filled cache failed (rc {proc.returncode})")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        check(sorted(rec["build_s"]) == _build.sources() and not any(rec["build_s"].values()),
              f"the fresh process built: {rec['build_s']}")
        check(all(pathlib.Path(p).parent == kdir for p in rec["libs"].values()),
              f"libraries loaded from elsewhere than {kdir}: {rec['libs']}")
    print(f"[2b aot cache] a fresh process without nvcc loaded {len(rec['libs'])} libraries "
          f"{sorted(rec['libs'])} from a filled --aot-dir in {rec['load_s']:.3f} s, built nothing "
          f"(build s {rec['build_s']}); vae_sums_fwd |kernel - plain| {rec['fwd_err']:.3g}, vae_sums_bwd "
          f"{rec['bwd_err']:.3g}; {time.perf_counter() - t0:.1f} s with the process on {card}")


def aot_load(root: str) -> int:
    """Phase 2b's fresh process: the cache root ``root`` only, no nvcc."""
    import torch

    from hippie_tpu_torch.ops import _build, cuda_ops

    def no_nvcc():
        raise RuntimeError("nvcc is out of reach in this check")

    _build._nvcc = no_nvcc
    _build.BUILD_DIR = pathlib.Path(root) / "package_build_hidden"
    _build.set_default_dir(root)
    t0 = time.perf_counter()
    secs = _build.build()
    for name in _build.sources():
        _build.load(name)
    load_s = time.perf_counter() - t0
    x = loss_inputs(415, 1e4)
    got, ref = cuda_ops.vae_sums_fwd_cuda(*x), cuda_ops.vae_sums_plain(*x)
    torch.testing.assert_close(got, ref, rtol=4e-6, atol=0)
    g = torch.tensor([1.0 / (415 * L), 1.0 / 415], device="cuda")
    bwd_err = 0.0
    for want in (STEP_GRADS, cuda_ops.ALL_GRADS):
        grads = cuda_ops.vae_sums_bwd_cuda(*x, g, want=want)
        for a, b in zip(grads, cuda_ops.vae_sums_bwd_plain(*x, g, want=want)):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
                bwd_err = max(bwd_err, float((a - b).abs().max()))
    torch.cuda.synchronize()
    check(not _build.BUILD_DIR.exists(), "the hidden package directory was made")
    print(json.dumps({"build_s": secs, "libs": {n: str(_build.so_path(n)) for n in _build.sources()},
                      "load_s": load_s, "fwd_err": float((got - ref).abs().max()), "bwd_err": bwd_err}))
    return 0


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
        fwd_err = float((got - ref).abs().max())
        err["vae_sums_fwd"] = max(err["vae_sums_fwd"], fwd_err)
        rel64 = float(((got.double() - exact).abs() / exact.abs()).max())
        print(f"  {case}: sums {got.tolist()} |kernel - plain| {fwd_err:.3g} "
              f"(kernel vs float64 rel {rel64:.3g})")
    # the backward for each of the 15 patterns of gradients asked for, on the
    # cases above and on the first 100 rows and the first row of the full batch
    full = loss_inputs(B, device=device)
    bwd_cases = {case: (loss_inputs(n_real, pad, device=device), n_real) for case, (n_real, pad) in cases.items()}
    bwd_cases.update({"B100": (tuple(t[:100] for t in full), 100), "B1": (tuple(t[:1] for t in full), 1)})
    for case, (x, n_real) in bwd_cases.items():
        g = torch.tensor([1.0 / (n_real * L), 1.0 / n_real], device=device)
        worst = 0.0
        for want in itertools.product((False, True), repeat=4):
            if not any(want):
                continue
            grads = cuda_ops.vae_sums_bwd_cuda(*x, g, want=want)
            again = cuda_ops.vae_sums_bwd_cuda(*x, g, want=want)
            ref_grads = cuda_ops.vae_sums_bwd_plain(*x, g, want=want)
            for name, a, b, c, w in zip(("ddata", "ddec", "dmu", "dlogvar"), grads, ref_grads, again, want):
                check((a is None) == (b is None) == (c is None) == (not w), f"{case} {want}: {name} slot")
                if not w:
                    continue
                check(bool(torch.isfinite(a).all()), f"{case}: {name} not finite")
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=lambda m: f"{case} {name}: {m}")
                check(torch.equal(a, c), f"{case} {want}: {name} differs on a repeat")
                worst = max(worst, float((a - b).abs().max()))
        torch.cuda.synchronize()
        err["vae_sums_bwd"] = max(err["vae_sums_bwd"], worst)
        print(f"  vae_sums_bwd {case}: 15 patterns of gradients asked for, |kernel - plain| {worst:.3g}, "
              f"repeats bit-equal")
    x = loss_inputs(415, device=device)
    _, n_fwd, split = device_profile(lambda: cuda_ops.vae_sums_fwd_cuda(*x), n=50)
    print(f"  vae_sums_fwd: {n_fwd:g} CUDA launches per call ({split_line(split)})")
    check(n_fwd <= 1, f"vae_sums_fwd makes {n_fwd:g} CUDA launches per call, over 1")
    print(f"[3 kernel vs plain] vae_sums_fwd agrees with the plain version on {len(cases)} cases at "
          f"B={B} L={L} z={Z}, vae_sums_bwd on {len(bwd_cases)} (B={B}, 100, 1) for every pattern of "
          f"gradients asked for")
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
        "vae_sums_bwd": (lambda: cuda_ops.vae_sums_bwd_cuda(*x, g, want=STEP_GRADS),
                         lambda: cuda_ops.vae_sums_bwd_plain(*x, g, want=STEP_GRADS), None),
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
            bwd_report(x, g, card)
        kernels.append({
            "name": name, "route": "cuda", "source": "hippie_tpu_torch/csrc/vae_sums.cu",
            "replaces": sources[name], "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    return kernels


def bwd_in_graph(bwd, g, pairs: int = 20) -> dict:
    """``bwd(g2)`` behind the kernel that writes its g2 (``g * 1.0``, as a
    step's backward feeds the loss backward), ``pairs`` times in one CUDA
    graph, and the predecessors alone in another: µs per pair and per
    predecessor (CUDA events over 50 replays), their difference (what the
    backward adds to a replayed step), and the backward's device µs per
    launch in the replays (torch.profiler)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    graphs = {}
    with torch.cuda.stream(s):
        for what, body in (("pair", lambda: bwd(g * 1.0)), ("predecessor", lambda: g * 1.0)):
            body()  # made on this stream before the capture
            graphs[what] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[what], stream=s):
                for _ in range(pairs):
                    body()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    us = {what: time_ms(graph.replay, n=50, warmup=5) * 1e3 / pairs for what, graph in graphs.items()}
    _, _, split = device_profile(graphs["pair"].replay, n=5)
    mine = [v for k, v in split.items() if k.startswith("vae_sums_bwd_kernel")]
    kernel_us = sum(t for t, _ in mine) / max(sum(c for _, c in mine), 1e-9) if mine else float("nan")
    return {"pair_us": us["pair"], "predecessor_us": us["predecessor"],
            "added_us": us["pair"] - us["predecessor"], "kernel_device_us": kernel_us}


def bwd_report(x, g, card: str, label: str = "vae_sums_bwd") -> dict:
    """vae_sums_bwd's times at the step's shapes: the work the train step
    asks for (STEP_GRADS) and all four gradients, each alone (device µs,
    torch.profiler) and in a CUDA graph behind its predecessor
    (bwd_in_graph), beside the launch floor (the device time of a
    one-element add_) and the byte bounds."""
    import torch

    from hippie_tpu_torch.ops import cuda_ops

    one = torch.zeros(1, device="cuda")
    floor_us, n_floor, _ = device_profile(lambda: one.add_(1.0), n=50)
    floor_us /= max(n_floor, 1e-9)
    out = {"floor_us": floor_us}
    for tag, want in (("step", STEP_GRADS), ("all", cuda_ops.ALL_GRADS)):
        dev_us, n_dev, split = device_profile(lambda: cuda_ops.vae_sums_bwd_cuda(*x, g, want=want), n=50)
        dev_us /= max(n_dev, 1e-9)  # per launch: the tracer may have dropped some calls' events
        graph = bwd_in_graph(lambda g2: cuda_ops.vae_sums_bwd_cuda(*x, g2, want=want), g)
        bound_ms, by = vae_sums_bounds(*x[0].shape, x[2].shape[1], want)["vae_sums_bwd"]
        out[tag] = {"device_us": dev_us, **graph, "bound_us": bound_ms * 1e3}
        print(f"    {label} ({tag}: {'ddata, ' if want[0] else ''}ddec, dmu, dlogvar): {dev_us:.3f} us device "
              f"alone per launch ({n_dev:g} launches seen per call: {split_line(split)}); in a graph behind "
              f"its predecessor "
              f"{graph['kernel_device_us']:.3f} us device per launch, {graph['added_us']:.3f} us added per "
              f"pair ({graph['pair_us']:.3f} us per pair, {graph['predecessor_us']:.3f} per predecessor "
              f"alone); bound {bound_ms * 1e3:.4f} us ({by}); launch floor {floor_us:.3f} us device "
              f"(one-element add_) on {card}")
    return out


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
                                  verbose=False, optimizer=optimizer, fit_loop="host")
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
                                  opt_state_dtype=opt_state_dtype, fit_loop="host")
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


def eager_clustering(x, method: str, k: int = 4, seed: int = 42, iters=None):
    """``method`` of ops/clustering.py with its Lloyd and EM iterations
    looped eagerly (the module's own _seed, _lloyd and _em): the reference
    its replayed iterations are held to on the card."""
    import torch

    from hippie_tpu_torch.evaluate.knn_eval import pairwise_sq_dists
    from hippie_tpu_torch.ops import clustering

    iters = iters if iters is not None else (50 if method == "kmeans" else 100)
    centers = clustering._seed(x, k, torch.Generator().manual_seed(seed))
    for _ in range(iters if method == "kmeans" else 10):
        clustering._lloyd(x, centers, k)
    dists = pairwise_sq_dists(x, centers)
    if method == "kmeans":
        return torch.argmin(dists, dim=1), centers, dists.min(dim=1).values.sum()
    counts = torch.clamp(clustering._onehot(torch.argmin(dists, dim=1), k, x.dtype).sum(dim=0), min=1.0)
    means, var, weights = centers, torch.ones_like(centers), counts / x.shape[0]
    for _ in range(iters):
        clustering._em(x, means, var, weights)
    lp = clustering._log_prob(x, means, var, weights)
    return torch.argmax(lp, dim=1), means, var, weights, torch.logsumexp(lp, dim=1).sum()


def clustering_replay_vs_eager(x, method: str, k: int = 4, seed: int = 42, reps: int = 5, device="cuda") -> dict:
    """``method`` on the card (its iterations replayed from the graphs of
    x's shape) against eager_clustering on the same points: every output
    equal bit for bit. Returns the largest |difference| (0 when equal) and
    both ms per call (CUDA-synchronised wall time, median of ``reps`` after
    one call)."""
    import torch

    from hippie_tpu_torch.ops import clustering

    fn = getattr(clustering, method)
    xd = torch.as_tensor(x, dtype=torch.float32).to(device)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    got, want = fn(xd, k, seed=seed), eager_clustering(xd, method, k, seed)
    diff = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{method}: the replayed iterations differ from the eager loop by {diff:.3g}")
    out = {"max_diff": diff}
    for name, run in (("replayed_ms", lambda: fn(xd, k, seed=seed)),
                      ("eager_ms", lambda: eager_clustering(xd, method, k, seed))):
        times = []
        for _ in range(reps + 1):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = round(float(np.median(times[1:])), 3)
    return out


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
    2z for z=10), with the card's ms per call; and on the same points the
    replayed iterations against the same iterations looped eagerly on the
    card (clustering_replay_vs_eager), bit for bit, with both ms per call."""
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
    ms, replay = {}, {}
    for label, x in (("joint embeddings 392x10", joint_emb), ("synthetic 16564x20", synthetic)):
        for method in ("kmeans", "gmm"):
            ms[f"{method} {label}"] = round(clustering_vs_host(x, method, device=device), 3)
            replay[f"{method} {label}"] = clustering_replay_vs_eager(x, method, device=device)
    print(f"  clustering k=4 on the card, equal to the host's (ms per call): {json.dumps(ms)} on {card}")
    print(f"  clustering k=4 on the card, its Lloyd and EM iterations replayed from CUDA graphs, equal to the "
          f"same iterations looped eagerly on the card bit for bit; ms per call, replayed and eager: "
          f"{json.dumps(replay)} on {card}; phase {time.perf_counter() - t_phase:.1f} s")


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


def _spawn_server(argv: list) -> dict:
    """Start the port's server (python -m hippie_tpu_torch.scripts.serve_embeddings
    ``argv`` --port 0) without waiting: its process, a queue of its lines
    with their arrival times, and its start time."""
    import queue
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "hippie_tpu_torch.scripts.serve_embeddings", *argv,
                             "--host", "127.0.0.1", "--port", "0"], cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=lambda: [lines.put((time.perf_counter(), x)) for x in proc.stdout] + [lines.put(None)],
                     daemon=True).start()
    return {"proc": proc, "lines": lines, "t0": t0}


def _await_server(srv: dict, timeout: float = 300.0):
    """Wait until a spawned server says where it serves: (process, url, its
    lines, seconds from its start to that line, the queue of its later
    lines)."""
    import queue

    proc, said, deadline = srv["proc"], [], time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        try:
            item = srv["lines"].get(timeout=max(0.1, deadline - time.perf_counter()))
        except queue.Empty:
            break
        if item is None:
            break
        at, line = item
        said.append(line.rstrip())
        m = re.search(r"on (http://127\.0\.0\.1:\d+)", line)
        if m:
            return proc, m.group(1), said, at - srv["t0"], srv["lines"]
    _stop(proc)
    raise PhaseError(f"the server did not start: {said[-10:]}")


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def start_servers(configs: dict, device="cuda") -> dict:
    """Start every server of ``configs`` ({name: flags}, each warmed with
    512,1024) at once and wait until all serve: {name: (process, url, its
    lines, its start-up seconds)}. Prints the wall time of the joint start
    against the sum of the start-ups, the seconds the overlap saved."""
    t0 = time.perf_counter()
    spawned = {name: _spawn_server(flags + ["--warmup-buckets", "512,1024", "--device", device, *AOT_DIR])
               for name, flags in configs.items()}
    servers = {}
    try:
        for name, srv in spawned.items():
            servers[name] = _await_server(srv)
    except BaseException:
        for srv in spawned.values():
            if srv["proc"].poll() is None:
                _stop(srv["proc"])
        raise
    wall = time.perf_counter() - t0
    each = {name: round(v[3], 1) for name, v in servers.items()}
    print(f"[13 serving] the {len(servers)} servers of phases 13-14 started together in {wall:.1f} s wall; their "
          f"start-ups {each} s add up to {sum(each.values()):.1f} s: {sum(each.values()) - wall:.1f} s saved by "
          f"starting them at once")
    return servers


def stop_servers(servers: dict):
    for proc, *_ in servers.values():
        if proc.poll() is None:
            _stop(proc)


def _post(url: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url + "/embed", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def phase_serving(card: str, uni_ckpts: dict, joint_ckpt: str, servers: dict, device="cuda") -> dict:
    """Phase 13: the port's embedding server on the card, in a process of
    its own on 127.0.0.1 at a free port, warmed with the ladder 512,1024:
    with phase 9's stage-3 wave and time checkpoints (dual) and with phase
    10's supervised joint one (``servers["dual"]``, ``servers["joint"]``,
    started with phase 14's by start_servers). The target's raw rows go in 7 requests of up
    to 64 rows (source 0); every reply is within 1e-5 of the checkpoint's
    model called directly (export.load_model_from_ckpt, embed_unimodal /
    embed_multimodal) on preprocess_pair of the same rows. Then the port's
    load-test client at its defaults (16 clients x 20 requests x 64 rows,
    raw widths 41/91) prints requests/s, p50/p99 and the server's device
    dispatches and coalesced requests. The server is stopped after. The
    server captures one CUDA graph per bucket of its ladder and none while
    it serves (serve_and_load, from its printed lines). The same service in
    this process (service_replays) replays each request bit-equal to
    _run_group's eager program. Returns the replies, {mode: {kind: [rows,
    width]}}, for phase 14."""
    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.evaluate.embeddings import embed_multimodal, embed_unimodal
    from hippie_tpu_torch.ops import preprocess

    t_phase = time.perf_counter()
    wf, isi = target_raw_rows()
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=device)
    source = torch.zeros(len(wf), dtype=torch.long, device=device)
    replies = {}
    for mode in ("dual", "joint"):
        if mode == "dual":
            mw, _ = export.load_model_from_ckpt(uni_ckpts["wave"], device=device)
            mt, _ = export.load_model_from_ckpt(uni_ckpts["time"], device=device)
            e_w, e_i = embed_unimodal(mw, wave, source), embed_unimodal(mt, isi_p, source)
            direct = {"waveform": e_w, "isi": e_i, "joint": torch.cat([e_w, e_i], dim=1)}
        else:
            mj, _ = export.load_model_from_ckpt(joint_ckpt, device=device)
            direct = {"joint": embed_multimodal(mj, wave, isi_p, source)}
        direct = {k: v.cpu().numpy() for k, v in direct.items()}
        got, res, stats, start_s, said = serve_and_load(servers[mode], wf, isi)
        check(all(got[kind].shape == ref.shape for kind, ref in direct.items()),
              f"{mode} replies of shapes {[v.shape for v in got.values()]}")
        worst = max(float(np.abs(got[kind] - ref).max()) for kind, ref in direct.items())
        check(worst <= 1e-5, f"serving {mode}: a reply {worst} from the model called directly")
        replies[mode] = got
        print(f"[13 serving] {mode}: the server started and warmed (512, 1024) in {start_s:.1f} s, beside the others "
              f"({'; '.join(x for x in said if x.startswith('warmup'))}); it captured one CUDA graph per bucket "
              f"of the ladder and none after; {n_requests(wf)} requests of the target's {len(wf)} raw rows, max "
              f"|reply - direct| {worst:.3g} (limit 1e-5)")
        print(load_test_line(res, stats, card))
        kw = ({"wave_ckpt": uni_ckpts["wave"], "time_ckpt": uni_ckpts["time"]} if mode == "dual"
              else {"joint_ckpt": joint_ckpt})
        here = service_replays(kw, wf, isi, f"13 {mode}", card, device)
        print(f"  13 {mode}: max |server's reply - this process's replayed reply| "
              f"{max(float(np.abs(got[k] - here[k]).max()) for k in got):.3g}")
    print(f"  phase 13 {time.perf_counter() - t_phase:.1f} s")
    return replies


def service_replays(kw: dict, wf, isi, label: str, card: str, device="cuda") -> dict:
    """In this process, an EmbeddingService on the card built from ``kw``
    (the checkpoints of one of phase 13's servers): its
    ladder (512, 1024) captures two graphs; each request of up to 64 of the
    raw rows replays the 512-row one, and its reply equals _run_group's
    eager program (the same preprocessing and model calls without the
    graph) on the same rows bit for bit; no request captures. Returns the
    replies {kind: [rows, width]}."""
    import torch

    from hippie_tpu_torch.scripts import serve_embeddings as se

    t0 = time.perf_counter()
    service = se.EmbeddingService(z_dim=Z, device=device, **kw)
    service.warmup([512, 1024])
    ladder_s = time.perf_counter() - t0
    check(service.graph_captures == 2, f"{label}: the ladder of 2 buckets captured {service.graph_captures} graphs")
    parts = {}
    for lo in range(0, len(wf), 64):
        rows = slice(lo, lo + 64)
        w, i, j, _ = service.embed(wf[rows], isi[rows], 0, False)
        item = se._Item(wf[rows], isi[rows], 0, False)
        service._run_group([item], eager=True)
        check(np.array_equal(j, item.out[2]),
              f"{label}: a replayed reply differs from the eager program by {np.abs(j - item.out[2]).max():.3g}")
        for kind, v in (("waveform", w), ("isi", i), ("joint", j)):
            if v is not None:
                parts.setdefault(kind, []).append(v)
    n = n_requests(wf)
    check((service.graph_captures, service.graph_replays) == (2, 2 + n),
          f"{label}: {service.graph_captures} captures and {service.graph_replays} replays, expected 2 and {2 + n}")
    print(f"  {label} in this process: the ladder (512, 1024) captured 2 graphs in {ladder_s:.2f} s (the "
          f"models' loading included); {n} requests replayed the 512-row graph, each reply equal to _run_group's "
          f"eager program on the same rows bit for bit, no capture, on {card}")
    del service
    if device != "cpu":
        torch.cuda.empty_cache()
    return {k: np.concatenate(v) for k, v in parts.items()}


def target_raw_rows():
    """The target's raw waveform and ISI rows (NaN columns dropped), float32."""
    from hippie_tpu_torch.data import registry

    wf, isi = registry.load_raw(DATA_ROOT, TARGET, dropna=True)
    return np.asarray(wf, np.float32), np.asarray(isi, np.float32)


def n_requests(wf) -> int:
    return -(-len(wf) // 64)


CAPTURED = "captured the program of bucket"  # the server's line per capture


def serve_and_load(server: tuple, wf, isi):
    """With a running server of start_servers: send the raw rows in
    requests of up to 64 rows (source 0), run the load-test client at its
    defaults, stop the server. The server captured one graph per bucket of
    its ladder (512, 1024) before it served, and captures none while these
    requests and the load test run: every dispatch is a replay. Returns
    (replies {kind: [rows, width]}, the load test's result, the server's
    /stats, its start-up seconds, its lines)."""
    import contextlib
    import io
    import queue

    from hippie_tpu_torch.scripts import serving_load_test

    proc, url, said, start_s, lines = server
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
        _stop(proc)
    later = []
    while True:
        try:
            item = lines.get(timeout=5)
        except queue.Empty:
            break
        if item is None:
            break
        later.append(item[1].rstrip())
    check(res["requests"] == 16 * 20, f"load test: {res['requests']} requests")
    replies = {k: np.concatenate(v) for k, v in parts.items()}
    check(all(v.shape[0] == len(wf) for v in replies.values()),
          f"replies of {[v.shape for v in replies.values()]} rows for {len(wf)}")
    at_start = [x for x in said if CAPTURED in x]
    check(len(at_start) == 2, f"the server captured {len(at_start)} graphs for its ladder of 2 buckets: {said[-6:]}")
    check(not any(CAPTURED in x for x in later),
          f"the server captured while serving: {[x for x in later if CAPTURED in x]}")
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
    out, meta = {}, {"load_s": {}, "bench": {}, "replay_diff": {}, "graphs": {}}
    for name in ARTIFACTS:
        for tag in ("", "_tf32"):
            t0 = time.perf_counter()
            call, _ = export.load_artifact(f"{workdir}/{name}{tag}.hippie", device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            meta["load_s"][name + tag] = time.perf_counter() - t0
            diff = 0.0
            for n in ARTIFACT_ROWS:
                rows = tuple(a[:n] for a in inputs[name])
                got = call(*rows)
                diff = max(diff, float((got - call.eager(*rows)).abs().max()))
                out[f"{name}{tag}_{n}"] = got.cpu().numpy()
            meta["replay_diff"][name + tag] = diff
            meta["graphs"][name + tag] = [call.space.captures, call.space.replays]
        with contextlib.redirect_stdout(io.StringIO()):
            meta["bench"][name] = bench_artifact.main(["--artifact", f"{workdir}/{name}.hippie",
                                                       "--rows", BENCH_ROWS, "--device", device])
    np.savez(f"{workdir}/replies.npz", **out)
    with open(f"{workdir}/replies.json", "w") as f:
        json.dump(meta, f)


def checkpoint_path_ms(model, arrays, embed, rows: int, iters: int = 10) -> float:
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


def export_artifacts(workdir: str, uni_ckpts: dict, joint_ckpt: str, device="cuda") -> dict:
    """Phase 14's exports, run before phase 13 so that its artifact servers
    start with phase 13's: phase 9's stage-3 wave and time checkpoints and
    phase 10's supervised joint one through the export_model CLI (precision
    "highest"), each with its "default" (TF32) twin (the same program;
    torch applies the precision around each call, export.py). Returns
    {"dir", "export_s", "sizes"}."""
    import contextlib
    import io
    import zipfile

    from hippie_tpu_torch import export
    from hippie_tpu_torch.scripts import export_model

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
    return {"dir": art_dir, "export_s": export_s, "sizes": sizes}


def server_configs(uni_ckpts: dict, joint_ckpt: str, art_dir: str) -> dict:
    """The four servers of phases 13-14: on the checkpoints (dual, joint) and
    on the artifacts (art_dual, art_joint)."""
    return {"dual": ["--wave-checkpoint", uni_ckpts["wave"], "--time-checkpoint", uni_ckpts["time"]],
            "joint": ["--joint-checkpoint", joint_ckpt],
            "art_dual": ["--wave-artifact", f"{art_dir}/wave.hippie", "--time-artifact", f"{art_dir}/time.hippie"],
            "art_joint": ["--joint-artifact", f"{art_dir}/joint.hippie"]}


def phase_artifacts(card: str, uni_ckpts: dict, joint_ckpt: str, ckpt_replies: dict, exported: dict,
                    servers: dict, device="cuda"):
    """Phase 14: the deployable artifact. The artifacts of export_artifacts
    (``exported``) are loaded in a fresh process on the card
    (artifact_replies). Every "highest" reply at 1, 415 and 4,096 rows is
    within 1e-5 of embed_unimodal / embed_multimodal of the checkpoint's
    model (export.load_model_from_ckpt) on the same rows; the TF32 drift is
    printed as the least row cosine and the max |difference|. Prints the
    fresh process's bench_artifact records (rows 512, 4096, 16384) beside
    the checkpoint path's warm ms measured the same way, and the export and
    load seconds. Then the servers on the artifacts (``servers["art_dual"]``
    with --wave-artifact --time-artifact, ``servers["art_joint"]`` with
    --joint-artifact, started with phase 13's) take phase 13's requests and
    load test: every reply within 1e-5 of the checkpoint server's, one graph
    captured per bucket of the ladder and none while serving (the artifact's
    program inside a graph is held to its eager run in the fresh process,
    below; phase 13 holds the server's replays to its eager program). In
    the fresh process, each artifact's call captures
    one graph per row bucket of ARTIFACT_ROWS and its replies equal the
    call's eager twin bit for bit; bench_artifact's cold call includes the
    bucket's capture, its warm calls are replays."""
    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.evaluate import eval_graph
    from hippie_tpu_torch.evaluate.embeddings import embed_multimodal, embed_unimodal

    t_phase = time.perf_counter()
    art_dir, export_s, sizes = exported["dir"], exported["export_s"], exported["sizes"]
    ckpts = {"wave": uni_ckpts["wave"], "time": uni_ckpts["time"], "joint": joint_ckpt}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--artifact-replies", art_dir, device],
                          cwd=str(REPO), capture_output=True, text=True, timeout=600)
    fresh_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the fresh process failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    replies = np.load(f"{art_dir}/replies.npz")
    with open(f"{art_dir}/replies.json") as f:
        meta = json.load(f)

    buckets = sorted({eval_graph.bucket_rows(n) for n in ARTIFACT_ROWS})
    for name, diff in meta["replay_diff"].items():
        check(diff == 0.0, f"{name} artifact: a replayed reply differs from its eager twin by {diff:.3g}")
        check(meta["graphs"][name] == [len(buckets), len(ARTIFACT_ROWS)],
              f"{name} artifact: {meta['graphs'][name]} captures and replays for rows {ARTIFACT_ROWS}")
    print(f"[14 artifacts] in the fresh process, load_artifact's call at rows {list(ARTIFACT_ROWS)}: "
          f"{len(buckets)} CUDA graphs (buckets {buckets}) captured and {len(ARTIFACT_ROWS)} replays per "
          f"artifact, each reply equal to the call's eager twin bit for bit (all 6 artifacts) on {card}")
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
        print(f"  bench_artifact on {card} (ms per call, host copies included; cold: the bucket's capture "
              f"included, warm: replays): "
              + "; ".join(f"{rows} rows cold {r['cold_ms']} warm {r['warm_ms']} ({r['rows_per_sec']:.0f} rows/s), "
                          f"checkpoint path warm {ckpt_ms[rows]}" for rows, r in bench.items()))
    print(f"  the fresh process (6 loads, replies, 3 benches) {fresh_s:.1f} s on {card}")

    wf, isi = target_raw_rows()
    for mode in ("dual", "joint"):
        got, res, stats, start_s, said = serve_and_load(servers[f"art_{mode}"], wf, isi)
        ref = ckpt_replies[mode]
        check(sorted(got) == sorted(ref), f"artifact server {mode} replies {sorted(got)}")
        worst = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
        check(worst <= 1e-5, f"artifact server {mode}: a reply {worst} from the checkpoint server's")
        print(f"[14 artifact server] {mode} on {card}: started and warmed (512, 1024) in {start_s:.1f} s (with "
              f"phase 13's); one CUDA graph captured per bucket of the ladder and none after; "
              f"{n_requests(wf)} requests, max |reply - checkpoint server's| {worst:.3g} (limit 1e-5)")
        print(load_test_line(res, stats, card))
    print(f"  phase 14 {time.perf_counter() - t_phase:.1f} s on {card}, and its exports "
          f"{sum(export_s.values()):.1f} s before phase 13")


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


def ensemble_fit(pool, cfg_m, lrs, fit_loop: str, max_epochs: int = 2, device="cuda", mesh=None,
                 resume_dir=None, key: int = 15):
    """A K-replica stage-1 fit over phase 4's pool (every row trains, the
    first 2B rows validate), the loss and block kernels, with fit_loop
    "device" (ensemble.device_fit_ensemble) or "host" (host_fit_ensemble);
    with ``mesh`` this rank's replicas (shard_replicas) and ``resume_dir``."""
    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.train import ensemble, optim, step

    states = ensemble.set_ensemble_lr(ensemble.init_unimodal_ensemble(
        key, cfg_m, lambda ps: optim.make_optimizer(ps, LR, WD), len(lrs), device=device), lrs)
    if mesh is not None:
        states = ensemble.shard_replicas(states, mesh)
    val = device_data.batch_plan(np.arange(2 * B), B, shuffle=False)
    kw = dict(arrays=(pool.wave,), source=pool.source, class_=None, train_stream=np.arange(len(pool)),
              batch_size=B, val_idx=val[0], val_mask=val[1], max_epochs=max_epochs, seed=15, mesh=mesh,
              resume_dir=resume_dir)
    backends = dict(loss_backend="pallas", block_backend="pallas")
    if fit_loop == "device":
        batch_step, eval_step = step.make_unimodal_steps(**backends)
        return ensemble.device_fit_ensemble(states, batch_step=batch_step, eval_step=eval_step, **kw)
    return ensemble.host_fit_ensemble(states, epoch_fns=ensemble.make_unimodal_ensemble_epoch_fns(**backends),
                                      **kw)


def single_device_fit(pool, cfg_m, max_epochs: int = 1, device="cuda"):
    """One model's device fit over ensemble_fit's plans (device_fit.device_fit)."""
    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import device_fit, loop, optim, step

    model = cvae.unimodal_cvae_init(cfg_m, loop.key_generator(15, 0), device=device)
    ts = step.TrainState(model, optim.make_optimizer(model.parameters(), LR, WD))
    val = device_data.batch_plan(np.arange(2 * B), B, shuffle=False)
    batch_step, eval_step = step.make_unimodal_steps(loss_backend="pallas", block_backend="pallas")
    return device_fit.device_fit(ts, batch_step=batch_step, eval_step=eval_step, arrays=(pool.wave,),
                                 source=pool.source, class_=pool.source, train_stream=np.arange(len(pool)),
                                 batch_size=B, val_idx=val[0], val_mask=val[1], max_epochs=max_epochs,
                                 early_stopping_patience=None, seed=15, use_class_labels=False, shuffle=True,
                                 verbose=False)


def ensemble_diff(a, b, losses: bool = True) -> list:
    """Where two K-replica fits differ (empty: bit for bit): the [K] arrays,
    the losses (with ``losses``), every replica's model and optimizer state,
    the bests."""
    import torch

    names = ("best_val_loss", "best_epoch") + (("train_losses", "val_losses") if losses else ())
    bad = [name for name in names if not np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))]
    bad += ["epochs_run"] if a.epochs_run != b.epochs_run else []
    for r, (x, y) in enumerate(zip(a.state, b.state)):
        for tag, u, v in (("model", x.model.state_dict(), y.model.state_dict()),
                          ("opt", flat_tensors(x.optimizer.state_dict()), flat_tensors(y.optimizer.state_dict())),
                          ("best", a.best_state_dict[r], b.best_state_dict[r])):
            bad += [f"{tag}{r}.{k}" for k, t in u.items() if not torch.equal(t, v[k])]
    return bad


def ensemble_step_calls(pool, cfg_m, lrs, idx, mask, device="cuda") -> tuple:
    """The runtime calls and device work of ONE replayed train step of the K
    replicas (train/device_fit.py:StepGraph over K step functions, as
    device_fit_ensemble builds it), and its ms with the host's dispatch."""
    import torch

    from hippie_tpu_torch.train import device_fit, ensemble, optim, step

    states = ensemble.set_ensemble_lr(ensemble.init_unimodal_ensemble(
        15, cfg_m, lambda ps: optim.make_optimizer(ps, LR, WD), len(lrs), device=device), lrs)
    batch_step, _ = step.make_unimodal_steps(loss_backend="pallas", block_backend="pallas")
    fns = [lambda i, m, e, ts=ts: batch_step(ts, pool.wave[i], pool.source[i], None, m, eps=e)[1] for ts in states]

    def zero():
        for ts in states:
            ts.optimizer.zero_grad(set_to_none=True)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        g = device_fit.StepGraph(fns, nb=1, batch=B, noise_shape=(B, cfg_m.z_dim), dtype=torch.float32,
                                 device=torch.device(device), stream=s, pool=torch.cuda.graph_pool_handle(),
                                 before_capture=zero)
        g.load_plan(idx[:1], mask[:1])
        gens = [torch.Generator(device=device).manual_seed(k) for k in range(len(states))]
        g(gens)  # each replica's eager step
        g.row.zero_()
        g(gens)  # captured, replayed
        prof = api_profile(lambda: (g.row.zero_(), g(gens)), n=3)
        ms = time_ms(lambda: (g.row.zero_(), g(gens)), n=20, warmup=2)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g.graph = None
    zero()
    return prof, ms


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
    at z=10 and the pipeline's stage-1 geometry, on the CLI's default
    device loop; each winner is loaded through its pipeline's stage-1 seam
    (pipeline._seed_stage1) and must equal the file. Between them the K=4
    fit (2 epochs, 6 train and 2 val steps each) on the device loop
    (ensemble.device_fit_ensemble) must equal the host loop's bit for bit,
    its launches in one epoch, counted by torch.profiler's marker kernels,
    must be 4x one model's device fit's, and one replayed K-step's runtime
    calls are printed; after them a K=2 wave sweep with each loop must give
    the same best losses, best epochs and winner bytes. Returns the device
    ensemble's launches and each loop's ms per epoch."""
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

    # the K replicas on the device loop: one CUDA graph per step kind for all K
    fits = {fl: ensemble_fit(pool, cfg_m, lrs, fl, device=device) for fl in ("host", "device")}
    diff = ensemble_diff(fits["device"], fits["host"])
    check(not diff, f"the K={k_replicas} device-loop fit differs from the host loop's in {diff[:5]}")
    g = fits["device"].graphs
    check(g.get("captured") and g["train_replays"] > 0 and g["eval_replays"] > 0, f"no replays: {g}")
    _, ens_markers, _ = profiled_launches(lambda: ensemble_fit(pool, cfg_m, lrs, "device", 1, device))
    _, one_markers, _ = profiled_launches(lambda: single_device_fit(pool, cfg_m, 1, device))
    path_kernels = ("vae_sums_fwd", "vae_sums_bwd", "enc_block_fwd", "enc_block_bwd", "dec_block_fwd",
                    "dec_block_bwd")
    check(ens_markers == {k: k_replicas * v for k, v in one_markers.items()}
          and all(ens_markers[k] > 0 for k in path_kernels),
          f"device-loop ensemble launches {ens_markers}, expected {k_replicas} x {one_markers}")
    calls, k_step_ms = ensemble_step_calls(pool, cfg_m, lrs, idx, mask, device)
    api = {k: round(v, 2) for k, v in sorted(calls["api"].items(), key=lambda kv: -kv[1])[:5]}
    n_steps = -(-len(pool) // B) + 2
    ms_epoch = {fl: [round(1e3 * x, 1) for x in f.epoch_s] for fl, f in fits.items()}
    print(f"[15 device ensemble] K={k_replicas}, the same replicas, {n_steps - 2} train + 2 val steps per epoch, 2 "
          f"epochs, loss and block kernels: device_fit_ensemble equals host_fit_ensemble bit for bit (every "
          f"replica's state, optimizer state, best snapshot, losses); ms per epoch device {ms_epoch['device']} "
          f"(the first with the captures, {g['capture_s']:.3f} s), host {ms_epoch['host']} on {card}; "
          f"{g['train_replays']} train and {g['eval_replays']} eval replays of the K-step graphs")
    print(f"  one replayed K={k_replicas} train step: {k_step_ms:.3f} ms (CUDA events, dispatch included), "
          f"{calls['device_us'] / 1e3:.3f} ms device in {calls['kernels']:.1f} kernels and copies, runtime calls "
          f"{api}; launches of one device-loop epoch counted by torch.profiler: ensemble {ens_markers}, "
          f"one model {one_markers} (x{k_replicas})")
    out = {"launches": ens_markers, "ms_epoch": ms_epoch}

    for modality in ("wave", "joint"):
        path = f"{workdir}/sweep_{modality}_winner.ckpt"
        out = io.StringIO()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = lr_sweep.main(["--dataset", TARGET, "--data-root", DATA_ROOT, "--modality", modality,
                                "--lrs", "1e-3,3e-3,1e-4,3e-4", "--max-epochs", "1", "--z-dim", str(cfg_m.z_dim),
                                "--num-blocks", ",".join(map(str, cfg_m.num_blocks)), "--export-winner", path,
                                "--device", device, *AOT_DIR])
        sweep_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20 if device != "cpu" else float("nan")
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        check("device loop" in out.getvalue(), f"lr_sweep {modality} did not run its default device loop")
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
        print(f"[15 lr_sweep] --modality {modality}, K=4 (lrs {rec['lrs']}), 1 epoch on the device loop: "
              f"{sweep_s:.2f} s wall, peak {peak:.1f} MiB on "
              f"{card}; best val {[round(v, 4) for v in rec['best_val_loss']]}, winner {rec['winner']}; the "
              f"winner loaded through the {'joint' if joint else 'wave'} stage-1 seam in {seam_s:.2f} s, "
              f"equal to the file ({cvae.param_count(seeded.model):,} params)")

    # one K=2 sweep with each loop: the same JSON numbers and winner bytes
    got = {}
    for fit_loop in ("device", "host"):
        path = f"{workdir}/sweep_k2_winner.ckpt"
        out_s = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_s):
            rc = lr_sweep.main(["--dataset", TARGET, "--data-root", DATA_ROOT, "--modality", "wave", "--lrs",
                                "1e-3,3e-3", "--max-epochs", "2", "--z-dim", str(cfg_m.z_dim), "--export-winner",
                                path, "--fit-loop", fit_loop, "--device", device, *AOT_DIR])
        rec = json.loads(out_s.getvalue().strip().splitlines()[-1])
        with open(path, "rb") as f:
            got[fit_loop] = (rc, rec["best_val_loss"], rec["best_epoch"], f.read(), time.perf_counter() - t0)
    check(got["device"][:4] == got["host"][:4],
          f"lr_sweep K=2: device loop {got['device'][1:3]}, host loop {got['host'][1:3]} (or the exported bytes)")
    print(f"[15 lr_sweep loops] --modality wave, K=2, 2 epochs: --fit-loop device and host give the same best val "
          f"{got['device'][1]}, best epochs {got['device'][2]} and winner .ckpt bytes; "
          f"{got['device'][4]:.2f} / {got['host'][4]:.2f} s wall on {card}")
    print(f"  phase 15 {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


@contextlib.contextmanager
def recorded_fits(module, name: str, calls: list):
    """Within it, each call of ``module.name`` (a stage fit, ``device_fit``,
    or a replica-plan fit, ``device_fit_replica_plans``) appends (its
    replicas, its result's ``graphs``, {each replica's seed: the epochs it
    ran}) to ``calls``."""
    orig = getattr(module, name)

    def recording(first, **kw):
        res = orig(first, **kw)
        if isinstance(first, list):  # a replica's epochs end at its first NaN train loss
            ran = np.isfinite(np.asarray(res.train_losses).reshape(-1, len(first))).sum(axis=0)
            calls.append((len(first), res.graphs, dict(zip(kw["seeds"], ran.tolist()))))
        else:
            calls.append((1, res.graphs, {kw["seed"]: res.epochs_run}))
        return res

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, orig)


# phase 16's refit: 2 fine-tune epochs (a capture and a replay of each step
# kind per fit), patience 1 (a fold whose second epoch does not improve
# stops there: frozen and restored); and each mode's fold-parallel groups
KFOLD_REFIT = ["--refit", "--refit-epochs", "2", "--refit-patience", "1"]
KFOLD_GROUPS = {"dual": ("fold_parallel", [5]), "joint": ("fold_parallel_g2", [2, 2, 1])}


def phase_kfold(card: str, workdir: str, uni_ckpts: dict, joint_ckpt: str, pool, device="cuda") -> dict:
    """Phase 16: the kfold_eval CLI on phase 9's stage-3 checkpoints (the
    dual pair) and phase 10's supervised joint one at 5 folds: embed-once;
    then the sequential refit (KFOLD_REFIT: one ``device_fit`` per fold and
    modality); then the same with --fold-parallel (KFOLD_GROUPS): the dual
    pair's 5 folds as one replica-plan fit per modality, the joint model's
    with --fold-parallel-max-replicas 2 (groups of 2, 2 and 1). The
    fold-parallel run's per-fold refit embeddings must equal the sequential
    run's bit for bit (phase 15's rule: the kernel path repeats bit for bit
    on the card), each fold must run the sequential fit's epochs, it must
    print no fallback line, and its replica-plan fits must be one per group
    and modality, each with its graphs captured. Checks both CSVs' rows and
    that every accuracy lies in [0, 1]. Then 16b
    (``phase_replica_plans``). Returns 16b's launches."""
    import contextlib
    import io

    from hippie_tpu_torch.scripts import kfold_eval
    from hippie_tpu_torch.train import device_fit, ensemble

    t_phase = time.perf_counter()
    for mode, flags in (("dual", ["--wave-checkpoint", uni_ckpts["wave"], "--time-checkpoint", uni_ckpts["time"]]),
                        ("joint", ["--joint-checkpoint", joint_ckpt])):
        base = ["--dataset", TARGET, "--data-root", DATA_ROOT, "--folds", "5", "--device", device, *flags, *AOT_DIR]
        refit, (par_name, groups) = KFOLD_REFIT, KFOLD_GROUPS[mode]
        g_flags = ["--fold-parallel-max-replicas", str(groups[0])] if len(groups) > 1 else []
        runs, walls, said, fits = {}, {}, {}, {}
        for name, extra in (("embed_once", []), ("sequential", refit),
                            (par_name, [*refit, "--fold-parallel", *g_flags])):
            out_dir = f"{workdir}/kfold_{mode}_{name}"
            out, fits[name] = io.StringIO(), []
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), recorded_fits(device_fit, "device_fit", fits[name]), \
                    recorded_fits(ensemble, "device_fit_replica_plans", fits[name]):
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
        seq, par = runs["sequential"]["refit"], runs[par_name]["refit"]
        check([n for n, _, _ in fits["sequential"]] == [1] * (10 if mode == "dual" else 5),
              f"kfold {mode}: the sequential refit made fits of {[n for n, _, _ in fits['sequential']]} models")
        diff = max(float(np.abs(a - b).max()) for kind in seq for a, b in zip(seq[kind], par[kind]))
        check(diff == 0.0, f"kfold {mode} {par_name}: refit embeddings {diff} from the sequential ones")
        check("fold-parallel:" not in said[par_name], f"kfold {mode} {par_name} fell back: {said[par_name]}")
        sizes = [n for n, _, _ in fits[par_name]]
        want = groups * (2 if mode == "dual" else 1)  # the dual pair: each modality's groups
        check(sizes == want and (device == "cpu" or all(g["captured"] for _, g, _ in fits[par_name])),
              f"kfold {mode} {par_name}: replica-plan fits of {sizes} folds, graphs "
              f"{[g for _, g, _ in fits[par_name]]}; expected {want}, each captured")
        epochs = {name: {seed: e for _, _, ran in fits[name] for seed, e in ran.items()}
                  for name in ("sequential", par_name)}
        check(epochs[par_name] == epochs["sequential"],
              f"kfold {mode}: epochs per fold {epochs[par_name]}, sequential {epochs['sequential']}")
        lines = []
        for name in ("sequential", par_name):
            gs = [g for _, g, _ in fits[name]]
            lines.append(f"{name}: {len(gs)} fits of {[n for n, _, _ in fits[name]]} folds, "
                         f"{sum(g['captured'] for g in gs)} of them captured, "
                         f"{sum(g['train_replays'] for g in gs)} train and {sum(g['eval_replays'] for g in gs)} "
                         f"eval replays, {sum(g['capture_s'] for g in gs):.3f} s capturing")
        accs = [x for x in said[par_name].splitlines() if "embed-once" in x]
        print(f"[16 kfold] {mode} ({' '.join(refit)}): wall s on {card}: {json.dumps(walls)}; {par_name} "
              f"refit embeddings {diff:.3g} from the sequential run's, epochs per fold the same "
              f"{sorted(epochs[par_name].values())}; {'; '.join(lines)}; {' | '.join(accs)}")
    launches = phase_replica_plans(card, pool, device)
    print(f"  phase 16 {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def replica_plan_fit(pool, joint: bool, fit_loop: str, device="cuda"):
    """K=3 replicas of the full-width unimodal (or joint) cVAE on the loss
    and block kernels, each on its own fixed plan over phase 4's pool rows
    (2 train batches of B, the second padded, and 1 val batch) with its own
    seed, patience 1, 2 epochs; the joint one with seeded class labels.
    ``fit_loop`` "device": ensemble.device_fit_replica_plans; "host":
    host_fit_replica_plans."""
    import torch

    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import ensemble, loop, optim, step

    init, cfg_m = (cvae.multimodal_cvae_init, joint_config()) if joint else (cvae.unimodal_cvae_init, full_config())
    states = []
    for k in range(3):
        model = init(cfg_m, loop.key_generator(16, k), device=device)
        states.append(step.TrainState(model, optim.make_optimizer(model.parameters(), LR, WD, 1.0 if joint else None)))
    t_idx, t_mask = (np.stack(p) for p in zip(*(device_data.batch_plan(np.arange(a, a + 900), B, shuffle=False)
                                                 for a in (0, 700, 1400))))
    v_idx, v_mask = (np.stack(p) for p in zip(*(device_data.batch_plan(np.arange(a, a + 300), B, shuffle=False)
                                                 for a in (2400, 2500, 2600))))
    labels = torch.from_numpy(np.random.default_rng(16).integers(0, 5, size=len(pool))).to(device)
    kw = dict(arrays=(pool.wave, pool.isi) if joint else (pool.wave,), source=pool.source,
              class_=labels if joint else None, train_idx=t_idx, train_mask=t_mask, val_idx=v_idx, val_mask=v_mask,
              max_epochs=2, early_stopping_patience=1, seeds=[1002, 1012, 1022])
    backends = dict(loss_backend="pallas", block_backend="pallas")
    if fit_loop == "device":
        batch_step, eval_step = (step.make_multimodal_steps if joint else step.make_unimodal_steps)(**backends)
        return ensemble.device_fit_replica_plans(states, batch_step=batch_step, eval_step=eval_step,
                                                 use_class_labels=joint, **kw)
    fns = (ensemble.make_multimodal_ensemble_epoch_fns if joint else ensemble.make_unimodal_ensemble_epoch_fns)(
        use_class_labels=joint, **backends)
    return ensemble.host_fit_replica_plans(states, epoch_fns=fns, **kw)


def phase_replica_plans(card: str, pool, device="cuda") -> dict:
    """Phase 16b: the replica-plan fit (replica_plan_fit) of the unimodal
    and of the joint model on the device loop against the host loop: bit for
    bit (every replica's state, optimizer state, best snapshot, best epoch,
    losses), one capture per step kind, a replay at every K-step after the
    first, and each kernel's launches counted by torch.profiler's marker
    kernels (the replays' too) equal to the host fit's counted by the
    wrappers, every kernel of the path launched. Returns the launches of
    both device fits, summed: this slice's main path's, which become the
    kernels line's."""
    launches = {}
    for joint in (False, True):
        tag = "joint" if joint else "unimodal"
        t0 = time.perf_counter()
        reset_all_launches()
        host = replica_plan_fit(pool, joint, "host", device)
        host_s, host_launches = time.perf_counter() - t0, all_launches()
        t0 = time.perf_counter()
        dev, markers, wrappers = profiled_launches(lambda: replica_plan_fit(pool, joint, "device", device))
        dev_s = time.perf_counter() - t0
        diff = ensemble_diff(dev, host)
        check(not diff, f"16b {tag}: the replica-plan device fit differs from the host fit in {diff[:5]}")
        g = dev.graphs
        check(g.get("captured") and (g["train_replays"], g["eval_replays"]) == (2 * 2 - 1, 2 * 1 - 1),
              f"16b {tag}: graphs {g}, expected 3 train and 1 eval replays")
        path = [k for k in MARKER_KERNELS if joint or k != "masked_sse_fwd"]
        check(markers == host_launches and all(markers[k] > 0 for k in path),
              f"16b {tag}: device-fit launches {markers} (profiler), host fit {host_launches} (wrappers)")
        for k, v in markers.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[16b replica plans] {tag}, K=3 at full width, 2 epochs of 2 train and 1 val steps, patience 1, "
              f"loss and block kernels: device_fit_replica_plans equals host_fit_replica_plans bit for bit "
              f"(best epochs {dev.best_epoch.tolist()}); {g['train_replays']} train and {g['eval_replays']} eval "
              f"replays, capture {g['capture_s']:.3f} s; wall {dev_s:.2f} s under the profiler, host fit "
              f"{host_s:.2f} s on {card}; launches {markers} (of them {wrappers} eager)")
    return launches


# ---------------------------------------------------------------------------
# Phases 17-18: mid-run resume, the rest of the CLI, the "fused" and "bf16"
# block backends
# ---------------------------------------------------------------------------


def flat_tensors(tree, prefix: str = "") -> dict:
    """The tensors, numpy arrays and numbers of nested dicts, lists and tuples
    (a state_dict, an optimizer's state_dict, a .ckpt's optimizer_states),
    keyed by their path, as tensors on the host."""
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu()}
    if isinstance(tree, (np.ndarray, float, int)):
        return {prefix: torch.as_tensor(np.asarray(tree))}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(flat_tensors(v, f"{prefix}/{k}"))
    return out


def csv_diff(a: str, b: str) -> float:
    """0 for byte-equal files, else the largest |difference| of their numbers
    (inf when the text around the numbers or their count differs)."""
    ta, tb = pathlib.Path(a).read_text(), pathlib.Path(b).read_text()
    if ta == tb:
        return 0.0
    num = r"-?\d+\.?\d*(?:[eE][-+]?\d+)?"
    na, nb = re.findall(num, ta), re.findall(num, tb)
    if re.sub(num, "#", ta) != re.sub(num, "#", tb) or len(na) != len(nb):
        return float("inf")
    return float(np.max(np.abs(np.asarray(na, np.float64) - np.asarray(nb, np.float64))))


@contextlib.contextmanager
def timed_resume_writes(writes: list):
    """Within it, every train/resume.py:save_fit_state call appends (seconds,
    bytes of its epoch file, whether it wrote a best file too) to ``writes``."""
    from hippie_tpu_torch.train import resume

    orig = resume.save_fit_state

    def timed(directory, epoch, state, extras, best=None):
        t0 = time.perf_counter()
        orig(directory, epoch, state, extras, best=best)
        writes.append((time.perf_counter() - t0,
                       os.path.getsize(os.path.join(directory, f"epoch_{int(epoch):06d}{resume.SUFFIX}")),
                       best is not None))

    resume.save_fit_state = timed
    try:
        yield
    finally:
        resume.save_fit_state = orig


def writes_line(writes: list) -> str:
    s = [w[0] for w in writes]
    return (f"{len(writes)} resume writes (epoch entries, {sum(w[2] for w in writes)} with a best entry): "
            f"median {np.median(s):.3f} s, max {max(s):.3f} s per epoch, epoch file {writes[0][1] / 2**20:.1f} MB")


@contextlib.contextmanager
def crash_after(module, name: str, call: int, epochs: int = 1):
    """Within it, the ``call``-th call of ``module.name`` (a stage fit or an
    ensemble fit) runs to its epoch ``epochs`` (resumed or not), then raises
    KeyboardInterrupt, as a killed job would stop
    (tests/test_resume.py:162-175)."""
    orig, calls = getattr(module, name), []

    def crashing(*a, **kw):
        calls.append(1)
        if len(calls) == call:
            orig(*a, **{**kw, "max_epochs": epochs})
            raise KeyboardInterrupt
        return orig(*a, **kw)

    setattr(module, name, crashing)
    try:
        yield
    finally:
        setattr(module, name, orig)


def joint_resume_run(workdir: str, name: str, resume: bool, device="cuda", crash: int = 0,
                     fit_loop: str = "host", limits: bool = False, epochs=(2, 2, 2)) -> dict:
    """One joint pipeline run for phases 17 and 20d at full width, ``epochs``
    per stage (pretrain, fine-tune, supervised), with the loss and block
    kernels and ``fit_loop``; with ``limits``, 2 train and 1 val batch per
    epoch; with ``crash`` (> 0), its supervised stage fit (the third) stops
    after its epoch ``crash``. Returns its wall time, launches, accuracies,
    output and checkpoint paths."""
    import torch

    from hippie_tpu_torch.train import pipeline

    cfg = pipeline.PipelineConfig(model_type="multimodal", z_dim=Z, dataset=TARGET, data_root=DATA_ROOT,
                                  output_dir=f"{workdir}/{name}_out", checkpoint_dir=f"{workdir}/{name}_ck",
                                  loss_backend="pallas", block_backend="pallas", device=device, verbose=False,
                                  pretrain_max_epochs=epochs[0], finetune_max_epochs=epochs[1],
                                  supervised_max_epochs=epochs[2], resume=resume, fit_loop=fit_loop,
                                  limit_train_batches=2 if limits else None, limit_val_batches=1 if limits else None)
    trackers, writes = {}, []
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    reset_all_launches()
    sync()
    t0 = time.perf_counter()
    results = None
    with timed_resume_writes(writes):
        if crash:
            with crash_after(pipeline, "fit_multimodal_stage", 3, epochs=crash):
                try:
                    pipeline.run_pipeline(cfg, trackers=trackers)
                except KeyboardInterrupt:
                    pass
                else:
                    check(False, "the crashing run did not stop")
            for t in trackers.values():
                t.wait()  # the killed run's checkpoint write in flight finishes before the restart
        else:
            results = pipeline.run_pipeline(cfg, trackers=trackers)
    sync()
    return {"wall": time.perf_counter() - t0, "launches": all_launches(), "results": results, "cfg": cfg,
            "writes": writes, "trackers": trackers}


def joint_run_diff(a: dict, b: dict) -> dict:
    """How far two finished joint runs are apart: their .ckpt state dicts and
    optimizer states, their CSVs, their balanced accuracies."""
    from hippie_tpu_torch.train import checkpoint as ckpt_mod

    ck = 0.0
    for name in (f"{TARGET}_joint_model.ckpt", f"{TARGET}_joint_model_supervised.ckpt"):
        x, y = (ckpt_mod.load_lightning_ckpt(f"{r['cfg'].checkpoint_dir}/{name}") for r in (a, b))
        ck = max(ck, max_abs_diff(x["state_dict"], y["state_dict"]),
                 max_abs_diff(flat_tensors(x["optimizer_states"]), flat_tensors(y["optimizer_states"])))
    csvs = sorted(p.name for p in pathlib.Path(a["cfg"].output_dir).iterdir())
    check(csvs == sorted(p.name for p in pathlib.Path(b["cfg"].output_dir).iterdir()) and len(csvs) == 3,
          f"joint outputs {csvs}")
    csv = max(csv_diff(f"{a['cfg'].output_dir}/{n}", f"{b['cfg'].output_dir}/{n}") for n in csvs)
    acc = float(np.max(np.abs(np.asarray(a["results"]["balanced_accuracy"]["joint"])
                              - np.asarray(b["results"]["balanced_accuracy"]["joint"]))))
    return {"ckpt": ck, "csv": csv, "acc": acc}


def uni_resume_fit(pool, optimizer: str, state_dtype, max_epochs: int, resume_dir=None, device="cuda",
                   fit_loop: str = "host", **cfg):
    """A full-width unimodal stage-1 fit on the pool (pipeline.fit_unimodal_stage,
    the loss and block kernels unless ``cfg`` says otherwise) for phases 17
    and 20, with ``fit_loop`` and the other PipelineConfig fields of
    ``cfg``."""
    from hippie_tpu_torch.data.device_data import train_val_split
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import loop, pipeline, step

    cfg = pipeline.PipelineConfig(**{**dict(z_dim=Z, dataset=TARGET, data_root=DATA_ROOT, loss_backend="pallas",
                                            block_backend="pallas", device=device, verbose=False),
                                     **cfg, "optimizer": optimizer, "opt_state_dtype": state_dtype,
                                     "fit_loop": fit_loop})
    model = cvae.unimodal_cvae_init(full_config(), loop.key_generator(17, 0), device=device)
    ts = step.TrainState(model, pipeline._optimizer(cfg, model, LR, None))
    tr, va = train_val_split(len(pool), 0.8, loop.key_generator(17, 1))
    return pipeline.fit_unimodal_stage(cfg=cfg, ts=ts, data=pool.wave, source=pool.source, class_=pool.source,
                                       train_indices=tr, val_indices=va, batch_size=B, max_epochs=max_epochs,
                                       beta=1.0, use_class_labels=False, shuffle_train=True, stage_seed=10,
                                       lr=LR, resume_dir=resume_dir)


def fit_diff(a, b) -> float:
    """How far two stage fits' results are apart: the final model and
    optimizer states, the best snapshots, the losses of the epochs both ran."""
    import torch

    n = min(len(a.val_losses), len(b.val_losses))
    losses = torch.tensor(a.val_losses[-n:] + a.train_losses[-n:], dtype=torch.float64)
    return max(max_abs_diff(flat_tensors(a.state.model.state_dict()), flat_tensors(b.state.model.state_dict())),
               max_abs_diff(flat_tensors(a.state.optimizer.state_dict()),
                            flat_tensors(b.state.optimizer.state_dict())),
               max_abs_diff(flat_tensors(a.best_state_dict), flat_tensors(b.best_state_dict)),
               max_abs_diff(flat_tensors(a.best_opt_state), flat_tensors(b.best_opt_state)),
               float((losses - torch.tensor(b.val_losses[-n:] + b.train_losses[-n:],
                                            dtype=torch.float64)).abs().max()))


def phase_resume(card: str, workdir: str, pool, device="cuda") -> dict:
    """Phase 17, the slice's main path: mid-run resume at full width.

    The joint pipeline (16,115,748 parameters in stage 1) with the loss and
    block kernels at 2 epochs per stage, three times: uninterrupted (A), then
    with ``resume=True`` stopped after one epoch of its third stage fit (the
    supervised one; C), then with ``resume=True`` again (D). D's .ckpt state
    dicts and optimizer states, CSVs and balanced accuracies must equal A's
    bit for bit (every run of the card's kernels repeats bit for bit; two
    uninterrupted runs agreed exactly in every run that measured them, so
    the second is not run); D launches exactly the kernels of
    the one epoch it ran, and C + D exactly A's. Then a unimodal full-width
    stage fit on the pool (2 epochs), cut after one and resumed, with
    schedule-free AdamW and with bf16 Adam moments, each equal to its
    uninterrupted fit bit for bit; and the lr_sweep CLI with
    --resume-dir at K=2, cut after one of two epochs, whose winner and best
    validation losses must be the uninterrupted sweep's (on the device
    loop, the CLI's default: replayed K-step graphs). Prints the resume
    writes' seconds per epoch and file sizes for both models. Returns D's
    launches, the main path's."""
    import io

    from hippie_tpu_torch.data import sampling
    from hippie_tpu_torch.scripts import lr_sweep
    from hippie_tpu_torch.train import ensemble

    t_phase = time.perf_counter()
    a = joint_resume_run(workdir, "resume_a", False, device)
    c = joint_resume_run(workdir, "resume_cd", True, device, crash=1)
    d = joint_resume_run(workdir, "resume_cd", True, device)
    got = joint_run_diff(a, d)
    check(got == {"ckpt": 0.0, "csv": 0.0, "acc": 0.0},
          f"resumed joint pipeline: {got} from the uninterrupted run")
    n_val = len(d["results"]["label_val"])
    n_stream = len(sampling.balanced_indices(d["results"]["label_train"], seed=d["cfg"].seed))
    train, val = n_batches(n_stream, d["cfg"].supervised_batch_size), n_batches(n_val, d["cfg"].supervised_batch_size)
    blocks = 2 * sum(d["cfg"].num_blocks)
    want = {"vae_sums_fwd": train + val, "vae_sums_bwd": train, "masked_sse_fwd": train + val,
            **{k: blocks * train for k in ("enc_block_fwd", "enc_block_bwd", "dec_block_fwd", "dec_block_bwd")}}
    check(d["launches"] == want or device == "cpu",
          f"resumed joint pipeline launches {d['launches']}, expected {want} (one supervised epoch: {train} train "
          f"and {val} val steps)")
    check(device == "cpu" or all(v > 0 for v in d["launches"].values()),
          f"a kernel of the main path never ran: {d['launches']}")
    both = {k: c["launches"][k] + d["launches"][k] for k in want}
    check(both == a["launches"], f"crash + resume launches {both}, the uninterrupted run's {a['launches']}")
    print(f"[17 resume] joint pipeline, z={Z}, {FULL_MM_PARAMS:,} stage-1 params, 2 epochs per stage, "
          f"loss_backend=pallas block_backend=pallas, on {card}: uninterrupted {a['wall']:.3f} "
          f"s wall; with --resume, stopped after one epoch of the supervised fit "
          f"{c['wall']:.3f} s, resumed {d['wall']:.3f} s (launches {d['launches']}, exactly its one epoch; "
          f"the stopped run's and the resumed run's add up to the uninterrupted run's)")
    print(f"  resumed against uninterrupted, bit for bit: {json.dumps(got)} (max |diff| of the .ckpt tensors, "
          f"of the CSVs' numbers, of the 15 balanced accuracies)")
    print(f"  joint model: {writes_line(c['writes'] + d['writes'])}")

    uni_writes = []
    for optimizer, state_dtype in (("schedule-free", None), ("adamw", "bfloat16")):
        full = uni_resume_fit(pool, optimizer, state_dtype, 2, device=device)
        rdir = f"{workdir}/resume_uni_{optimizer}_{state_dtype}"
        with timed_resume_writes(uni_writes):
            uni_resume_fit(pool, optimizer, state_dtype, 1, rdir, device=device)
            resumed = uni_resume_fit(pool, optimizer, state_dtype, 2, rdir, device=device)
        g = fit_diff(full, resumed)
        check(g == 0.0 and resumed.epochs_run == 2 and len(resumed.val_losses) == 1,
              f"resumed {optimizer} ({state_dtype}) stage fit {g} from the uninterrupted one")
        print(f"[17 resume] unimodal stage-1 fit at full width ({FULL_PARAMS:,} params), optimizer={optimizer}, "
              f"opt_state_dtype={state_dtype}, 2 epochs on the pool, cut after one and resumed: equal to the "
              f"uninterrupted fit bit for bit")
    print(f"  unimodal model: {writes_line(uni_writes)}")

    base = ["--dataset", TARGET, "--data-root", DATA_ROOT, "--modality", "wave", "--lrs", "1e-3,3e-3",
            "--max-epochs", "2", "--z-dim", str(Z), "--fit-loop", "device", "--device", device, *AOT_DIR]

    def sweep(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = lr_sweep.main(base + extra)
        return rc, json.loads(out.getvalue().strip().splitlines()[-1]), out.getvalue()

    _, s1, _ = sweep([])
    rdir = f"{workdir}/resume_sweep"
    with crash_after(ensemble, "fit_ensemble", 1), contextlib.redirect_stdout(io.StringIO()):
        try:
            lr_sweep.main(base + ["--resume-dir", rdir])
        except KeyboardInterrupt:
            pass
    rc, s3, said = sweep(["--resume-dir", rdir, "--progress-every", "1"])
    check(rc == 0 and s3 == s1 and "Resumed ensemble" in said,
          f"resumed sweep {s3} against the uninterrupted {s1}")
    print(f"[17 resume] lr_sweep --resume-dir on the device loop (replayed K-step graphs), K=2 (lrs {s3['lrs']}), "
          f"cut after one of two epochs and resumed: its JSON line (best val losses {s3['best_val_loss']}, "
          f"best epochs {s3['best_epoch']}, winner {s3['winner']}) equals the uninterrupted sweep's bit for bit; "
          + "; ".join(x for x in said.splitlines() if x.startswith("ensemble progress")))
    print(f"  phase 17 {time.perf_counter() - t_phase:.1f} s on {card}")
    return d["launches"]


def phase_cli_backends(card: str, workdir: str, pool, xla_losses: list, device="cuda"):
    """Phase 18: the rest of the CLI and the "fused" and "bf16" backends.

    ``hippie-tpu-torch train`` (cli.main) at full width with --profile-dir,
    --discover-datasets, --wandb (a no-op: the wandb package's import is
    blocked for the call, so nothing goes online), the loss and block
    kernels and one batch per stage: its Chrome trace must name the
    enc_block, dec_block and vae_sums kernels. sweep_targets over
    cellexplorer-celltype and cellexplorer-area, one epoch per stage: two ok
    records and the aggregate. profile_train_step at B=512 with each of the
    four block backends (the loss kernels), its JSON printed. A full-width
    stage-1 epoch from phase 4's weights with "fused" and with "bf16"
    (phase_slice: no block kernel launches, one vae_sums pair per step), each
    first loss within 5e-2 of "xla"'s (the limit "pallas" is held to), and a
    second epoch timed for ms per step."""
    import io

    import torch

    from hippie_tpu_torch import cli
    from hippie_tpu_torch.scripts import profile_train_step, sweep_targets
    from hippie_tpu_torch.train import step
    from hippie_tpu_torch.utils import wandb_shim

    t_phase = time.perf_counter()
    pdir = f"{workdir}/trace"
    out = io.StringIO()
    t0 = time.perf_counter()
    # --wandb without the wandb package: a machine may have one installed, so
    # its import is blocked here; the run stays offline and the shim a no-op
    saved_wandb = sys.modules.get("wandb")
    sys.modules["wandb"] = None
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--dataset", TARGET, "--data-root", DATA_ROOT, "--z_dim", str(Z),
                           "--profile-dir", pdir, "--discover-datasets", "--wandb", "--loss-backend", "pallas",
                           "--block-backend", "pallas", "--limit-train-batches", "1", "--limit-val-batches",
                           "1", "--output-dir", f"{workdir}/cli_out", "--checkpoint-dir", f"{workdir}/cli_ck",
                           "--device", device, *AOT_DIR])
    finally:
        if saved_wandb is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = saved_wandb
    check(not wandb_shim.is_enabled(), "--wandb logged somewhere")
    wall = time.perf_counter() - t0
    traces = sorted(pathlib.Path(pdir).glob("trace_*.json"))
    check(rc == 0 and len(traces) == 1, f"hippie-tpu-torch train: rc {rc}, traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {lib: sorted({kernel_name(n) for n in names if any(k in n for k in ks)})
               for lib, ks in (("enc_block", ("fwd_conv_kernel",)), ("dec_block", ("dec_fwd_conv2_kernel",)),
                               ("vae_sums", ("vae_sums_fwd_kernel", "vae_sums_bwd_kernel")))}
    check(device == "cpu" or all(kernels.values()), f"the trace names no kernel of {kernels}")
    accs = [x for x in out.getvalue().splitlines() if x.startswith("best_balanced_accuracy")]
    print(f"[18 cli] hippie-tpu-torch train --profile-dir --discover-datasets --wandb --block-backend pallas "
          f"--loss-backend pallas, one batch per stage, at full width: {wall:.2f} s wall on {card} with the "
          f"profiler; trace {traces[0].stat().st_size / 2**20:.1f} MB, {len(events)} events, naming {kernels}; "
          f"{' | '.join(accs)}")

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = sweep_targets.main(["--datasets", "cellexplorer-celltype,cellexplorer-area", "--data-root", DATA_ROOT,
                                 "--z_dim", str(Z), "--loss-backend", "pallas", "--block-backend", "pallas",
                                 "--output-dir", f"{workdir}/sweep_out", "--checkpoint-dir",
                                 f"{workdir}/sweep_ck", "--device", device, *AOT_DIR])
    recs = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    check(rc == 0 and [r.get("ok") for r in recs[:2]] == [True, True] and recs[-1].get("ok") == 2,
          f"sweep_targets: rc {rc}, {recs}")
    print(f"[18 sweep_targets] one epoch per stage, loss and block kernels, on {card}, "
          f"{time.perf_counter() - t0:.2f} s wall: " + " | ".join(json.dumps(r) for r in recs))

    for backend in ("xla", "fused", "bf16", "pallas"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = profile_train_step.main(["--batch", str(B), "--iters", "10", "--conv-iters", "50",
                                          "--block-backend", backend, "--loss-backend", "pallas",
                                          "--device", device])
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        check(rc == 0 and all(v > 0 for v in rec["ms"].values()), f"profile_train_step {backend}: {rec}")
        print(f"[18 profile_train_step] --block-backend {backend} on {card}: {json.dumps(rec)}")

    for backend in ("fused", "bf16"):
        ts, _, idx, mask, launches, losses = phase_slice(full_config(), backend, pool=pool, device=device)
        rel = abs(losses[0] - xla_losses[0]) / abs(xla_losses[0])
        check(rel <= 5e-2, f"block_backend={backend} first loss {losses[0]} vs xla {xla_losses[0]}")
        train_epoch, _ = step.make_unimodal_epoch_fns(beta=1.0, loss_backend="pallas", block_backend=backend)
        sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        train_epoch(ts, pool.wave, pool.source, None, idx, mask,
                    generator=torch.Generator(device=device).manual_seed(5))
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / idx.shape[0]
        print(f"  block_backend={backend}: first loss {losses[0]:.6f} against xla's {xla_losses[0]:.6f} (rel "
              f"{rel:.3g}; limit 5e-2); launches {launches} (no block kernel); a second epoch "
              f"{ms:.2f} ms/step on {card}")
    print(f"  phase 18 {time.perf_counter() - t_phase:.1f} s on {card}")


# ---------------------------------------------------------------------------
# Phase 19: data parallelism and FSDP across processes
# ---------------------------------------------------------------------------

DP_STEPS = 2  # the steps the JAX envelope is held after (tests/test_parallel.py)
# 19b-c's runs: (model, block backend, FSDP); the float32 path once, the kernels' with both models
DP_RUNS_2 = (("unimodal", "xla", False), ("unimodal", "pallas", False), ("joint", "pallas", False),
             ("unimodal", "pallas", True), ("joint", "pallas", True))
DP_RUNS = tuple(dict.fromkeys((k, b) for k, b, _ in DP_RUNS_2))
ENVELOPE = 4.5e-3
SEG_NAMES = ("enc_block_fwd_seg", "enc_block_bwd_seg", "dec_block_fwd_seg", "dec_block_bwd_seg")


def dp_epoch(kind: str, pool, idx, mask, mesh, fsdp: bool = False, steps=None, perturb: float = 0.0,
             block: str = "pallas"):
    """A stage-1 epoch (the plan's first ``steps`` batches) of the unimodal or
    the joint model from phases 4 and 8's seeded weights, plan and noise,
    the block backend ``block`` and loss_backend="pallas", under ``mesh``
    (None: one process), the optimizer sharded with ``fsdp``; ``perturb`` is
    added to the waveforms. ``"xla"`` runs in full float32 (no TF32), the
    JAX envelope's own setting. Returns the losses and the model."""
    import torch

    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.parallel import mesh as pmesh
    from hippie_tpu_torch.parallel.fsdp import ShardedOptimizer
    from hippie_tpu_torch.train import optim, step

    joint = kind == "joint"
    init = cvae.multimodal_cvae_init if joint else cvae.unimodal_cvae_init
    model = init(joint_config() if joint else full_config(), torch.Generator().manual_seed(0), device="cuda")
    clip = CLIP if joint else None
    if fsdp:
        opt = ShardedOptimizer(model, mesh, lambda ps: optim.make_optimizer(ps, LR, WD), clip)
    else:
        opt = optim.make_optimizer(model.parameters(), LR, WD, clip_val=clip)
    make = step.make_multimodal_epoch_fns if joint else step.make_unimodal_epoch_fns
    train_epoch, _ = make(beta=1.0, loss_backend="pallas", block_backend=block)
    n = idx.shape[0] if steps is None else steps
    wave = pool.wave + perturb if perturb else pool.wave
    with pmesh.data_parallel(mesh), (full_fp32() if block == "xla" else contextlib.nullcontext()):
        _, ms = train_epoch(step.TrainState(model, opt), *((wave, pool.isi) if joint else (wave,)), pool.source,
                            None, idx[:n], mask[:n], generator=torch.Generator(device="cuda").manual_seed(2))
    return ms.loss.tolist(), model


def host_params(model) -> dict:
    """The parameters (not the BatchNorm buffers, which the JAX envelope does
    not bound: a running variance moves with the batch's) on the host."""
    return {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}


def param_diff(a: dict, b: dict) -> float:
    """The largest |a - b| over two models' parameters."""
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a)


def digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def merge_shapes(bb: Backbone) -> list:
    """(statistics, channels) of each bn_stats_merge of one pass of ``bb``'s
    blocks: two per segmented forward (the second merges the shortcut's too)."""
    out = []
    for stride, _, ci, co in bb.blocks:
        out += [(1, co if bb.kind == "enc" else ci), (2 if stride != 1 else 1, co)]
    return out


def dp_seg_checks(mesh, card: str) -> dict:
    """19a's kernel checks, at one rank: every segmented entry point against
    its unsegmented call, bit for bit, at the full-width backbones' distinct
    block shapes, B=512, a full batch and a 415-row tail padded at +-1e4; and
    against its plain version under the mesh, with phase 5b's limits
    (relative Frobenius 1e-2, statistics 1e-4 of their scale). Then each
    one's time beside the unsegmented call's and the plain version's, its
    CUDA launches per call, and bn_stats_merge against its plain version on
    two ranks' moments. Returns the kernels-line records of the five."""
    import torch

    from hippie_tpu_torch.nn.functional import full_fp32
    from hippie_tpu_torch.ops import cuda_blocks as cb
    from hippie_tpu_torch.parallel import mesh as pmesh

    records, errs, per = [], {}, {}
    for bb in (ENC, DEC):
        ops = cb.ENC_OPS if bb.kind == "enc" else cb.DEC_OPS
        fwd, bwd = f"{bb.kind}_block_fwd_seg", f"{bb.kind}_block_bwd_seg"
        errs[fwd] = errs[bwd] = 0.0
        for stride, L, ci, co in sorted(set(bb.blocks), key=bb.blocks.index):
            for n_real, pad in ((B, None), (415, 1e4)):
                tag = f"{bb.kind} s{stride} L{L} {ci}->{co} real {n_real}"
                args, g = block_inputs(bb, stride, L, ci, co, n_real, pad, seed=L + co)
                got, ref = ops.fwd_mesh(mesh, stride, *args), ops.fwd_cuda(stride, *args)
                dgot, dref = ops.bwd_mesh(mesh, stride, *args, *got[1:], g), ops.bwd_cuda(stride, *args, *ref[1:], g)
                check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{tag}: segmented forward differs")
                check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(dgot, dref)),
                      f"{tag}: segmented backward differs")
                with full_fp32(), pmesh.data_parallel(mesh):
                    pl = ops.fwd_plain(stride, *args)
                    dpl = ops.bwd_plain(stride, *args, *got[1:], g)
                rels = {"out": rel_err(got[0], pl[0]), "dx": rel_err(dgot[0], dpl[0])}
                for name, a, b in zip(bb.grads, dgot, dpl):
                    if a is not None and name not in bb.bias_grads:
                        rels[name] = rel_err(a, b)
                st = max(stats_err(a, b) for a, b in zip(got[1:], pl[1:]))
                check(max(rels.values()) <= 1e-2 and st <= 1e-4,
                      f"{tag}: segmented vs plain {rels}, statistics {st:.3g}")
                if pad is None:
                    errs[fwd] = max(errs[fwd], float((got[0].float() - pl[0].float()).abs().max()))
                    errs[bwd] = max(errs[bwd], float((dgot[0].float() - dpl[0].float()).abs().max()))
            args, g = block_inputs(bb, stride, L, ci, co, 415, seed=L + co)
            st = ops.fwd_cuda(stride, *args)[1:]
            bounds = block_bounds(bb, stride, L, ci, co)
            for name, seg, plain_fn, unseg in (
                    (fwd, lambda: ops.fwd_mesh(mesh, stride, *args), lambda: ops.fwd_plain(stride, *args),
                     lambda: ops.fwd_cuda(stride, *args)),
                    (bwd, lambda: ops.bwd_mesh(mesh, stride, *args, *st, g),
                     lambda: ops.bwd_plain(stride, *args, *st, g), lambda: ops.bwd_cuda(stride, *args, *st, g))):
                with pmesh.data_parallel(mesh):
                    plain_ms = time_ms(plain_fn, n=3, warmup=1)
                ms, unseg_ms = time_ms(seg, n=20, warmup=3), time_ms(unseg, n=20, warmup=3)
                dev_us, n_dev, _ = device_profile(seg, n=5)
                per[(stride, L, ci, co, name)] = (ms, plain_ms, bounds[name.removesuffix("_seg")][0], unseg_ms,
                                                  bounds[name.removesuffix("_seg")][1], n_dev)
        for d, line in zip(("fwd", "bwd"), bb.lines):
            name = f"{bb.kind}_block_{d}_seg"
            rows = [per[blk + (name,)] for blk in bb.blocks]
            tot = [sum(r[k] for r in rows) for k in range(4)]
            by_ops = sum(r[2] for r in rows if r[4] == "operations")
            n_dev = sorted({round(r[5]) for r in rows})
            print(f"  {name} over the {len(bb.blocks)} blocks, one rank over NCCL: {tot[0]:.4f} ms (unsegmented "
                  f"{tot[3]:.4f} ms, {tot[0] - tot[3]:+.4f}), plain {tot[1]:.4f} ms, bound {tot[2]:.4f} ms, "
                  f"{'/'.join(map(str, n_dev))} CUDA launches and copies per call on {card}")
            records.append({"name": name, "route": "cuda", "source": bb.source,
                            "replaces": f"hippie_tpu/ops/pallas_blocks.py:{line}", "launches": 0,
                            "max_abs_err": errs[name], "ms": tot[0], "plain_ms": tot[1], "bound_ms": tot[2],
                            "bound_by": "operations" if by_ops >= tot[2] / 2 else "bytes", "library_ms": None})

    # bn_stats_merge on two ranks' moments: one pass of both waveform backbones' merges
    r = torch.Generator(device="cuda").manual_seed(19)
    calls = []
    for ns, c in merge_shapes(ENC) + merge_shapes(DEC):
        rows = torch.rand((2, 3 * ns, c), generator=r, device="cuda") + 0.5
        rows[:, 0::3] = torch.tensor([256.0, 159.0], device="cuda").view(2, 1, 1) * 7  # counts
        rows[:, 1::3] *= 100.0  # sums
        sts = [torch.empty((3, c), device="cuda") for _ in range(ns)]
        calls.append((rows, sts))
    err = 0.0
    for rows, sts in calls:
        cb.bn_stats_merge_cuda(rows, *sts)
        ref = cb.bn_stats_merge_plain(rows)
        got = torch.cat(sts)
        check(bool(torch.allclose(got, ref, rtol=1e-5, atol=0)), "bn_stats_merge differs from its plain version")
        err = max(err, float((got - ref).abs().max()))
    ms = time_ms(lambda: [cb.bn_stats_merge_cuda(rows, *sts) for rows, sts in calls], n=20, warmup=3)
    plain_ms = time_ms(lambda: [cb.bn_stats_merge_plain(rows) for rows, _ in calls], n=5, warmup=1)
    nbytes = sum(4 * (rows.numel() + 3 * rows.shape[1] // 3 * rows.shape[2]) for rows, _ in calls)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"  bn_stats_merge, the {len(calls)} merges of one pass of both backbones on 2 ranks' moments: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes), max |err| {err:.3g} "
          f"(rtol 1e-5) on {card}")
    records.append({"name": "bn_stats_merge", "route": "cuda", "source": "hippie_tpu_torch/csrc/sm90_gemm.cuh",
                    "replaces": "hippie_tpu/ops/pallas_blocks.py:568", "launches": 0, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
    return records


def sf_layout(payload) -> dict:
    """A .sfstate payload's layout: its keys, scalar types, and every leaf's
    shape and dtype."""
    if payload is None:
        return {}
    return {k: ({n: (v.shape, str(v.dtype)) for n, v in x.items()} if isinstance(x, dict) else type(x).__name__)
            for k, x in payload.items()}


def fsdp_fit(pool, mesh, optimizer: str, fit_loop: str, fsdp: bool = True, max_epochs: int = 2) -> tuple:
    """20b's unimodal stage-1 fit (full width, B=512, the loss and block
    kernels, no patience) under ``mesh``, its optimizer (AdamW clipped at
    1.0, or schedule-free) sharded with ``fsdp`` (parallel/fsdp.py), on
    ``fit_loop``: (host_fit of the result, {ms/step per epoch, peak MiB,
    the .sfstate layout, the graphs})."""
    import torch

    from hippie_tpu_torch.data.device_data import train_val_split
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.parallel import mesh as pmesh
    from hippie_tpu_torch.parallel.fsdp import ShardedOptimizer
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import loop, optim, pipeline, step

    cfg = pipeline.PipelineConfig(z_dim=Z, dataset=TARGET, data_root=DATA_ROOT, loss_backend="pallas",
                                  block_backend="pallas", device="cuda", verbose=False, optimizer=optimizer,
                                  fit_loop=fit_loop, early_stopping_patience=None)
    model = cvae.unimodal_cvae_init(full_config(), loop.key_generator(17, 0), device="cuda")
    clip = CLIP if optimizer == "adamw" else None

    def make(ps, c=None):
        return optim.make_optimizer(ps, LR, WD, c, algorithm=optimizer)

    opt = ShardedOptimizer(model, mesh, make, clip) if fsdp else make(model.parameters(), clip)
    tr, va = train_val_split(len(pool), 0.8, loop.key_generator(17, 1))
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with pmesh.data_parallel(mesh):
        res = pipeline.fit_unimodal_stage(cfg=dataclasses.replace(cfg, log_fn=lambda rec: stamps.append(
            time.perf_counter()), progress_every=1), ts=step.TrainState(model, opt), data=pool.wave,
            source=pool.source, class_=pool.source, train_indices=tr, val_indices=va, batch_size=B,
            max_epochs=max_epochs, beta=1.0, use_class_labels=False, shuffle_train=True, stage_seed=10, lr=LR)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        payload = (optim.schedule_free_payload(res.state.optimizer, ckpt_mod.parameter_key_order(model))
                   if optimizer == "schedule-free" else None)
    steps = -(-len(tr) // B) + -(-len(va) // B)
    per = [round(1e3 * (b - a) / steps, 3) for a, b in zip([t0] + stamps, stamps)]
    return host_fit(res), {"ms_step": per, "peak_mib": round(peak, 1), "layout": sf_layout(payload),
                           "graphs": dict(res.graphs)}


def fsdp_checks(pool, mesh, workdir: str) -> dict:
    """In the NCCL rank: 20b's stage fit with FSDP on the device loop against
    the host loop, with AdamW and with schedule-free, and the schedule-free
    sidecar's layout against the replicated optimizer's; then
    device_fit_ensemble(mesh=) at K=2 stopped after one of two epochs and
    resumed from fresh replicas against the uninterrupted sharded fit."""
    out = {}
    for optimizer in ("adamw", "schedule-free"):
        fits = {fl: fsdp_fit(pool, mesh, optimizer, fl) for fl in ("host", "device")}
        out[optimizer] = {"diff": same_fit(fits["device"][0], fits["host"][0]),
                          **{fl: fits[fl][1] for fl in fits}}
    out["dp_layout"] = fsdp_fit(pool, mesh, "schedule-free", "device", fsdp=False, max_epochs=1)[1]["layout"]
    cfg_m, lrs = full_config(), [1e-3, 3e-3]
    rdir = f"{workdir}/sharded_ensemble_resume"
    t0 = time.perf_counter()
    full = ensemble_fit(pool, cfg_m, lrs, "device", 2, mesh=mesh)
    ensemble_fit(pool, cfg_m, lrs, "device", 1, mesh=mesh, resume_dir=rdir)
    resumed = ensemble_fit(pool, cfg_m, lrs, "device", 2, mesh=mesh, resume_dir=rdir, key=99)
    out["ensemble"] = {"diff": ensemble_diff(resumed, full, losses=False), "secs": time.perf_counter() - t0,
                       "graphs": dict(resumed.graphs), "epochs": (full.epochs_run, len(resumed.train_losses))}
    return out


def dp_rank_one(mesh, idx, mask, card: str, workdir: str) -> dict:
    """Phase 19a, in one rank over NCCL on cuda:0: the unimodal stage-1 epoch
    through parallel.mesh equals the single-process epoch bit for bit (losses
    and every tensor of the state), launching only the segmented entries;
    then the single-process references of 19b-c (the first DP_STEPS steps of
    each model, and the same with the waveforms moved by 1e-6: the path's own
    spread) and dp_seg_checks; then phase 20e: the unimodal stage-1 device
    fit of 20b through the mesh against the same fit without it; then
    fsdp_checks (20f)."""
    import torch

    from hippie_tpu_torch.ops import cuda_blocks as cb
    from hippie_tpu_torch.train import pipeline

    pool = pipeline.load_pretrain_pool(pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False))
    l0, m0 = dp_epoch("unimodal", pool, idx, mask, None)
    cb.reset_launches()
    t0 = time.perf_counter()
    l1, m1 = dp_epoch("unimodal", pool, idx, mask, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    seg, old = dict(cb.seg_launches), dict(cb.launches)
    check(l0 == l1, f"the one-rank epoch's losses {l1} differ from the single process's {l0}")
    diff = [k for k, v in m0.state_dict().items() if not torch.equal(v, m1.state_dict()[k])]
    check(not diff, f"the one-rank epoch differs from the single process's in {diff[:5]}")
    per = 8 * idx.shape[0]
    want = {**{k: per for k in SEG_NAMES}, "bn_stats_merge": 2 * 2 * per}
    check(seg == want and not any(old.values()), f"one-rank launches {seg} {old}, expected {want}")
    out = {"epoch": (l1, secs, seg), "refs": {}}
    del m0, m1
    for kind, block in DP_RUNS:
        losses, model = dp_epoch(kind, pool, idx, mask, None, steps=DP_STEPS, block=block)
        params = host_params(model)
        moved, pmodel = dp_epoch(kind, pool, idx, mask, None, steps=DP_STEPS, perturb=1e-6, block=block)
        out["refs"][(kind, block)] = (losses, params, param_diff(host_params(pmodel), params),
                                      [abs(a - b) / abs(b) for a, b in zip(moved, losses)])
    out["secs"] = time.perf_counter() - t0
    out["records"] = dp_seg_checks(mesh, card)
    t0 = time.perf_counter()
    out["device_fit"] = same_fit(dp_device_fit(pool, None), dp_device_fit(pool, mesh)), time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fsdp"] = fsdp_checks(pool, mesh, workdir)
    out["fsdp_s"] = time.perf_counter() - t0
    return out


def dp_rank_two(mesh, idx, mask, workdir: str) -> dict:
    """Phases 19b-d in each of two gloo ranks sharing cuda:0: the first
    DP_STEPS steps of each model data-parallel with each block backend (b)
    and with FSDP on the kernels (c), each with its losses, its parameters
    (rank 0's), a digest of its state, its launches and the rank's peak
    device memory; then the joint pipeline at 1 epoch per stage with
    dp_devices=2 (d), recording every file this rank writes."""
    import torch

    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.ops import cuda_blocks as cb
    from hippie_tpu_torch.ops import cuda_ops
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import pipeline, resume

    pool = pipeline.load_pretrain_pool(pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False))
    out = {}
    for kind, block, fsdp in DP_RUNS_2:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cb.reset_launches()
        t0 = time.perf_counter()
        losses, model = dp_epoch(kind, pool, idx, mask, mesh, fsdp=fsdp, steps=DP_STEPS, block=block)
        torch.cuda.synchronize()
        out[(kind, block, fsdp)] = {
            "losses": losses, "secs": time.perf_counter() - t0, "digest": digest(model),
            "params": host_params(model) if mesh.rank == 0 else None, "seg": dict(cb.seg_launches),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        del model

    writes = []

    def recorded(fn, what):
        def wrapper(*a, **kw):
            writes.append(what)
            return fn(*a, **kw)
        return wrapper

    registry.write_csv = pipeline.write_csv = recorded(registry.write_csv, "csv")
    ckpt_mod.save_lightning_ckpt = recorded(ckpt_mod.save_lightning_ckpt, "ckpt")
    resume._atomic_save = recorded(resume._atomic_save, "resume")
    cfg = pipeline.PipelineConfig(model_type="multimodal", z_dim=Z, num_blocks=(2, 2, 2, 2), dataset=TARGET,
                                  data_root=DATA_ROOT, output_dir=f"{workdir}/dp_joint_out",
                                  checkpoint_dir=f"{workdir}/dp_joint_checkpoints", loss_backend="pallas",
                                  block_backend="pallas", verbose=False, dp_devices=2, fit_loop="host")
    torch.cuda.synchronize()
    cb.reset_launches()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    results = pipeline.run_pipeline(cfg)
    torch.cuda.synchronize()
    out["pipeline"] = {"secs": time.perf_counter() - t0, "writes": writes,
                       "accs": results["balanced_accuracy"]["joint"], "timings": results["timings"],
                       "launches": {**cuda_ops.launches, **cb.launches}, "seg": dict(cb.seg_launches)}
    return out


def phase_data_parallel(card: str, workdir: str, idx, mask) -> list:
    """Phase 19: data parallelism and FSDP (parallel/mesh.py, parallel/fsdp.py)
    at full width, B=512 global. (a) One rank over NCCL (dp_rank_one): the
    mesh epoch equals the single-process one bit for bit, and the segmented
    block entry points equal the unsegmented ones bit for bit. (b) Two gloo
    ranks sharing cuda:0 (dp_rank_two; NCCL takes one rank per GPU): the
    first 2 steps of each model against the single process's, in the JAX
    envelope (tests/test_parallel.py: losses rtol 1e-3, atol 1e-4, every
    parameter within 4.5e-3) on the float32 path; on the kernels' bf16 path
    the first loss and the parameters in it and the second loss within 5e-2
    (its own spread under a 1e-6 input change exceeds the envelope); the
    ranks' states bit-equal, the segmented entries launched. (c) The same
    with FSDP, each rank's peak device memory beside (b)'s. (d)
    The joint pipeline with dp_devices=2 at 1 epoch per stage: rank 0 writes
    phase 10's files, rank 1 nothing, 15 finite balanced accuracies; its
    segmented launches are the kernels line's. These two ranks share one
    card: no number here is a scaling. Returns the five kernels-line records."""
    import math

    from hippie_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    one = pmesh.launch(dp_rank_one, 1, idx, mask, card, workdir, device="cuda")[0]
    t_one = time.perf_counter() - t_phase
    l1, secs, seg = one["epoch"]
    print(f"[19a one rank, NCCL] the unimodal stage-1 epoch ({idx.shape[0]} steps, B={B}) through the mesh: "
          f"losses and state equal to the single process's bit for bit; {secs:.3f} s; launches {seg}")
    diff, fit_s = one["device_fit"]
    check(not diff, f"20e: the one-rank NCCL device fit differs from the single process's in {diff[:5]}")
    print(f"[20e one NCCL rank] in 19a's rank: the unimodal stage-1 device fit (20b's) through the one-rank NCCL "
          f"mesh (segmented block kernels, captured all-reduces) equals the same fit without the mesh bit for "
          f"bit; both fits {fit_s:.1f} s")
    fs = one["fsdp"]
    for optimizer in ("adamw", "schedule-free"):
        r = fs[optimizer]
        check(not r["diff"], f"20f: the FSDP {optimizer} device fit differs from the host fit in {r['diff'][:5]}")
        check(r["device"]["graphs"].get("captured"), f"20f: the FSDP {optimizer} device fit did not capture")
        print(f"[20f FSDP device loop, one NCCL rank] 20b's unimodal stage fit (2 epochs) with its {optimizer} "
              f"state sharded (parallel/fsdp.py{', clip 1.0' if optimizer == 'adamw' else ''}): the device loop "
              f"(the reduce-scatter, sharded update and in-place gather captured) equals the host loop bit for "
              f"bit; ms/step per epoch device {r['device']['ms_step']}, host {r['host']['ms_step']}; peak "
              f"{r['device']['peak_mib']} / {r['host']['peak_mib']} MiB per rank (device / host) on {card}")
    check(fs["schedule-free"]["device"]["layout"] == fs["dp_layout"] and fs["dp_layout"],
          "20f: the FSDP schedule-free sidecar's layout differs from the replicated optimizer's")
    print("  20f: the FSDP schedule-free .sfstate payload has the replicated optimizer's keys, shapes and dtypes")
    ens = fs["ensemble"]
    check(not ens["diff"] and ens["epochs"] == (2, 1),
          f"20f: the sharded K=2 fit resumed differs from the uninterrupted one in {ens['diff'][:5]} {ens['epochs']}")
    print(f"[20f sharded replicas, one NCCL rank] device_fit_ensemble(mesh=) at K=2, stopped after one of two "
          f"epochs (rank 0 writing the unsharded payload) and resumed from fresh replicas, equals the uninterrupted "
          f"sharded fit bit for bit; {ens['secs']:.1f} s for the three fits; replays {ens['graphs']}; 20f in all "
          f"{one['fsdp_s']:.1f} s")
    t0 = time.perf_counter()
    ranks = pmesh.launch(dp_rank_two, 2, idx, mask, workdir, devices=["cuda:0", "cuda:0"], backend="gloo")
    t_two = time.perf_counter() - t0
    for kind, block, fsdp in DP_RUNS_2:
        tag = "19c FSDP" if fsdp else "19b data-parallel"
        r0, r1 = ranks[0][(kind, block, fsdp)], ranks[1][(kind, block, fsdp)]
        ref_losses, ref_params, spread, loss_spread = one["refs"][(kind, block)]
        d = param_diff(r0["params"], ref_params)
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref_losses)]
        check(r0["digest"] == r1["digest"], f"{tag} {kind} {block}: the ranks' states differ")
        check(r0["losses"] == r1["losses"], f"{tag} {kind} {block}: the ranks' losses differ")
        line = (f"[{tag}, block_backend={block}, 2 gloo ranks on one card] {kind}: losses "
                f"{[round(x, 6) for x in r0['losses']]} vs one process {[round(x, 6) for x in ref_losses]} "
                f"(rel {[f'{x:.2e}' for x in rel]}); max |param - one process| {d:.3g} (limit {ENVELOPE}); "
                f"the one process's own spread under a 1e-6 input change: params {spread:.3g}, losses rel "
                f"{[f'{x:.2e}' for x in loss_spread]}; ranks bit-equal; {r0['secs']:.2f} s for {DP_STEPS} "
                f"steps; peak device memory per rank {r0['peak_mib']:.1f} / {r1['peak_mib']:.1f} MiB")
        if fsdp:
            dp = ranks[0][(kind, block, False)]
            line += (f"; against 19b's data-parallel run: max |param| {param_diff(r0['params'], dp['params']):.3g}, "
                     f"peak {dp['peak_mib']:.1f} MiB")
        print(line + f"; launches {r0['seg']}")
        check(d < ENVELOPE, f"{tag} {kind} {block}: parameters {d:.3g} from one process's, limit {ENVELOPE}")
        # the JAX envelope's losses, rtol 1e-3 and atol 1e-4; on the kernels' bf16 path only the first
        # step's (the same parameters): its second loss moves with the first step's bf16 flips, by more
        # than the envelope under a 1e-6 input change alone, and is held to phase 4b's 5e-2
        n_env = DP_STEPS if block == "xla" else 1
        check(all(abs(a - b) <= 1e-4 + 1e-3 * abs(b) for a, b in zip(r0["losses"][:n_env], ref_losses)),
              f"{tag} {kind} {block}: losses {r0['losses']} outside the JAX envelope of {ref_losses}")
        check(all(x <= 5e-2 for x in rel), f"{tag} {kind} {block}: losses {rel} rel, limit 5e-2")
        if block == "pallas":
            check(all(r0["seg"][k] > 0 for k in (*SEG_NAMES, "bn_stats_merge")),
                  f"{tag} {kind}: a segmented entry was not launched: {r0['seg']}")
    p0, p1 = ranks[0]["pipeline"], ranks[1]["pipeline"]
    out_dir, ck_dir = pathlib.Path(workdir) / "dp_joint_out", pathlib.Path(workdir) / "dp_joint_checkpoints"
    files = sorted(p.name for p in out_dir.iterdir())
    want_files = sorted([f"pretraining_{TARGET}_joint_embeddings.csv", f"{TARGET}_joint_knn.csv",
                         f"{TARGET}_joint_embeddings.csv"])
    ckpts = sorted(p.name for p in ck_dir.glob("*.ckpt"))
    check(files == want_files, f"19d outputs {files}")
    check(ckpts == [f"{TARGET}_joint_model.ckpt", f"{TARGET}_joint_model_supervised.ckpt"], f"19d ckpts {ckpts}")
    check(p1["writes"] == [] and p0["writes"].count("csv") == 3 and p0["writes"].count("ckpt") == 2,
          f"19d writes: rank 0 {p0['writes']}, rank 1 {p1['writes']}")
    accs = p0["accs"]
    check(len(accs) == 15 and all(math.isfinite(a) for a in accs) and accs == p1["accs"],
          f"19d balanced accuracies {accs} / {p1['accs']}")
    train, val = 18, 5  # phase 10's steps at this data
    want = {"vae_sums_fwd": train + val, "vae_sums_bwd": train, "masked_sse_fwd": train + val,
            **{k: 0 for k in ("enc_block_fwd", "enc_block_bwd", "dec_block_fwd", "dec_block_bwd")}}
    want_seg = {**{k: 16 * train for k in SEG_NAMES}, "bn_stats_merge": 2 * 2 * 16 * train}
    check(p0["launches"] == want and p0["seg"] == want_seg,
          f"19d launches {p0['launches']} {p0['seg']}, expected {want} {want_seg}")
    print(f"[19d joint pipeline, dp_devices=2, 2 gloo ranks on one card] {p0['secs']:.3f} s wall "
          f"(rank 1 {p1['secs']:.3f} s); rank 0 wrote {files} and {ckpts}, rank 1 nothing; 15 finite "
          f"balanced accuracies, equal on both ranks; launches {p0['launches']} {p0['seg']}; stage timings "
          f"{json.dumps({k: round(v, 3) for k, v in p0['timings'].items()})}")
    records = one["records"]
    for record in records:
        record["launches"] = p0["seg"][record["name"]]
    print(f"[19 data parallelism] phase {time.perf_counter() - t_phase:.1f} s on {card}: the NCCL rank's launch "
          f"{t_one:.1f} s ({one['secs']:.1f} s of epochs and references), the two gloo ranks' {t_two:.1f} s")
    return records


def fsdp_nccl_rank(mesh) -> dict:
    """One NCCL rank of ``--fsdp-nccl``: fsdp_fit with AdamW and with
    schedule-free on each loop; each pair's differences, each fit's numbers
    and a digest of the device fit's final model."""
    from hippie_tpu_torch.train import pipeline

    pool = pipeline.load_pretrain_pool(pipeline.PipelineConfig(dataset=TARGET, data_root=DATA_ROOT, verbose=False))
    out = {}
    for optimizer in ("adamw", "schedule-free"):
        fits = {fl: fsdp_fit(pool, mesh, optimizer, fl) for fl in ("host", "device")}
        digest_ = fit_digest(fits["device"][0]["tensors"])
        out[optimizer] = {"diff": same_fit(fits["device"][0], fits["host"][0]), "digest": digest_,
                          **{fl: {k: v for k, v in fits[fl][1].items() if k != "layout"} for fl in fits}}
    return out


def fit_digest(tensors: dict) -> str:
    """A sha256 of a host_fit's final model tensors."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        if k.startswith("model."):
            h.update(tensors[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def fsdp_nccl() -> int:
    """``python3 chip_smoke.py --fsdp-nccl`` (2 or more GPUs of one host; not
    in the default run): 20f's FSDP stage fit (full width, B=512 over two
    NCCL ranks on cuda:0 and cuda:1, 2 epochs) with AdamW clipped at 1.0 and
    with schedule-free, each on the device loop against the host loop, bit
    for bit, the two ranks' models equal; prints each loop's ms/step per
    epoch and each rank's peak MiB. Returns 1 when a check fails."""
    import torch

    from hippie_tpu_torch.parallel import mesh as pmesh

    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --fsdp-nccl: {n} GPU(s); needs 2 or more", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"{n} x {card[0]}")
    phase_build()
    t0 = time.perf_counter()
    ranks = pmesh.launch(fsdp_nccl_rank, 2, device="cuda")
    ok = True
    for optimizer in ("adamw", "schedule-free"):
        rs = [r[optimizer] for r in ranks]
        same = not rs[0]["diff"] and not rs[1]["diff"] and rs[0]["digest"] == rs[1]["digest"]
        ok = ok and same and rs[0]["device"]["graphs"].get("captured", False)
        print(f"[fsdp nccl] {optimizer}, 2 NCCL ranks on {card[0]}: device loop {'=' if same else '!='} host loop "
              f"bit for bit (ranks equal: {rs[0]['digest'] == rs[1]['digest']}; diffs {rs[0]['diff'][:3]} "
              f"{rs[1]['diff'][:3]}); ms/step per epoch device {rs[0]['device']['ms_step']}, host "
              f"{rs[0]['host']['ms_step']}; peak MiB per rank device {[r['device']['peak_mib'] for r in rs]}, "
              f"host {[r['host']['peak_mib'] for r in rs]}")
    print(f"[fsdp nccl] {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


def dp_walls() -> int:
    """``python3 chip_smoke.py --dp-walls``: the joint training CLI at full
    width (one epoch per stage, the loss and block kernels) on 1, 2 and N
    data-parallel ranks over NCCL, N the visible GPUs, and on N with
    --fsdp, then on N again; a fresh command each, its wall (the ranks'
    start-up included; the first command also builds the kernels) and rank
    0's stage timings. Needs N >= 2 GPUs of one
    host; phase 19's two ranks share one card instead.
    Returns 1 when a run fails."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_smoke --dp-walls: {n} GPU(s); needs 2 or more", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"{n} x {card[0]}")
    with tempfile.TemporaryDirectory(prefix="hippie_dp_walls_") as workdir:
        for flags in ([], ["--dp-devices", "2"], ["--dp-devices", str(n)], ["--dp-devices", str(n), "--fsdp"],
                      ["--dp-devices", str(n)]):
            out = f"{workdir}/out"
            cmd = [sys.executable, "-m", "hippie_tpu_torch.scripts.train_model_with_multimodal", "--model-type",
                   "multimodal", "--fit-loop", "host", "--loss-backend", "pallas", "--block-backend", "pallas",
                   "--output-dir", out,
                   "--checkpoint-dir", f"{out}/ck", "--data-root", DATA_ROOT, *flags, *AOT_DIR]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=600)
            wall = time.perf_counter() - t0
            lines = [x for x in proc.stdout.splitlines() if x.startswith(("stage timings", "best_balanced"))]
            files = sorted(p.name for p in pathlib.Path(out).rglob("*") if p.is_file())
            print(f"[dp walls] {' '.join(flags) or '(one process)'}: rc {proc.returncode}, {wall:.3f} s wall; "
                  f"{len(files)} files {files}; " + "; ".join(lines))
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            subprocess.run(["rm", "-rf", out], check=True)
    return 0


def urllib_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


# ---------------------------------------------------------------------------
# Phase 20: the device fit loop (CUDA graphs)
# ---------------------------------------------------------------------------


def _tensors(x) -> list:
    """The tensors of a kernel wrapper's output, in order (None skipped)."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def replay_equals_eager(fn, tag: str):
    """``fn()``, a kernel wrapper's call on fixed inputs, run once eagerly on
    a side stream (which makes its workspace there), then captured into a
    CUDA graph on that stream and replayed: the replay's outputs (filled with
    NaN before it) equal the eager call's bit for bit."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        want = [t.clone() for t in _tensors(fn())]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
            out = _tensors(fn())
        for t in out:
            t.fill_(float("nan"))
        g.replay()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    check(len(out) == len(want) and all(torch.equal(a, b) for a, b in zip(out, want)),
          f"{tag}: the graph's replay differs from the eager call")


def kernel_replays():
    """20a, per kernel: each of the seven wrappers replayed from a CUDA graph
    equals its eager call, at the main path's shapes (B=512, a 415-row tail
    for the losses; every distinct full-width block shape of both
    backbones)."""
    from hippie_tpu_torch.ops import cuda_blocks as cb
    from hippie_tpu_torch.ops import cuda_ops

    x = loss_inputs(415)
    g = loss_inputs(415)[0].new_tensor([1.0 / (415 * L), 1.0 / 415])
    replay_equals_eager(lambda: cuda_ops.vae_sums_fwd_cuda(*x), "vae_sums_fwd")
    replay_equals_eager(lambda: cuda_ops.vae_sums_bwd_cuda(*x, g), "vae_sums_bwd")
    sse = sse_inputs(415, 1e4)
    replay_equals_eager(lambda: cuda_ops.masked_sse_fwd_cuda(*sse), "masked_sse_fwd")
    shapes = 0
    for bb in (ENC, DEC):
        ops = cb.ENC_OPS if bb.kind == "enc" else cb.DEC_OPS
        for stride, length, ci, co in sorted(set(bb.blocks), key=bb.blocks.index):
            args, gy = block_inputs(bb, stride, length, ci, co, 415, seed=length + co)
            st = ops.fwd_cuda(stride, *args)[1:]
            tag = f"{bb.kind} s{stride} L{length} {ci}->{co}"
            replay_equals_eager(lambda: ops.fwd_cuda(stride, *args), f"{bb.kind}_block_fwd {tag}")
            replay_equals_eager(lambda: ops.bwd_cuda(stride, *args, *st, gy), f"{bb.kind}_block_bwd {tag}")
            shapes += 1
    return shapes


def api_profile(fn, n: int = 10) -> dict:
    """Per call of ``fn``, from torch.profiler over ``n`` calls: the device
    kernels and copies and their device µs, the host's CUDA runtime calls by
    name, and each device kernel's (µs, count) by kernel_name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev, api = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            us, c = dev.get(kernel_name(e.key), (0.0, 0.0))
            dev[kernel_name(e.key)] = (us + e.self_device_time_total / n, c + e.count / n)
        elif e.key.startswith("cuda") and e.device_type == DeviceType.CPU:
            api[e.key] = api.get(e.key, 0.0) + e.count / n
    return {"device_us": sum(v[0] for v in dev.values()), "kernels": sum(v[1] for v in dev.values()),
            "api": api, "split": dev}


def step_replay(kind: str, backend: str, pool, card: str, profile: bool = False) -> dict:
    """20a, per step: the full-width train and eval steps of ``kind``
    ("unimodal" or "joint") with ``backend``'s blocks and the loss kernels,
    as the device fit loop runs them (train/device_fit.py:StepGraph). After
    a warm-up step, one eager step from a saved state, then the state
    restored and the same step captured and replayed: losses, parameters,
    BatchNorm buffers and AdamW's moments and steps equal bit for bit; the
    same for the eval step. Then a whole epoch of replays (the plan's H2D
    copy, the noise draws, 6 train and 6 eval replays) under
    torch.cuda.set_sync_debug_mode("error"). With ``profile``: the device
    time, kernels and runtime calls per eager and per replayed step."""
    import torch

    from hippie_tpu_torch.data import device_data
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import device_fit, loop, optim, step

    joint = kind == "joint"
    init = torch.Generator().manual_seed(20)
    model = (cvae.multimodal_cvae_init(joint_config(), init, device="cuda") if joint
             else cvae.unimodal_cvae_init(full_config(), init, device="cuda"))
    opt = optim.make_optimizer(model.parameters(), LR, WD, clip_val=CLIP if joint else None)
    ts = step.TrainState(model, opt)
    make = step.make_multimodal_steps if joint else step.make_unimodal_steps
    batch_step, eval_step = make(beta=1.0, loss_backend="pallas", block_backend=backend)
    arrays = (pool.wave, pool.isi) if joint else (pool.wave,)

    def gather(idx):
        return [a[idx] for a in arrays] + [pool.source[idx], None]

    def train_fn(idx, mask, eps):
        return batch_step(ts, *gather(idx), mask, eps=eps)[1]

    def eval_fn(idx, mask, eps):
        return eval_step(ts.model, *gather(idx), mask, eps=eps)

    idx, mask = device_data.batch_plan(np.arange(len(pool)), B, shuffle=True,
                                       generator=torch.Generator().manual_seed(1))
    nb = idx.shape[0]

    def noise(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    common = dict(nb=nb, batch=B, noise_shape=(B, Z), dtype=torch.float32, device=torch.device("cuda"),
                  stream=s, pool=torch.cuda.graph_pool_handle())
    with torch.cuda.stream(s):
        tg = device_fit.StepGraph([train_fn], before_capture=lambda: opt.zero_grad(set_to_none=True), **common)
        vg = device_fit.StepGraph([eval_fn], **common)
        tg.load_plan(idx, mask)
        vg.load_plan(idx, mask)
        tg([noise(0)])  # the warm-up: row 0, eagerly
        vg([noise(0)])
        start = loop.snapshot(ts)
        tg.eps[0].normal_(0.0, 1.0, generator=noise(5))
        tg._body()  # the eager step on row 1
        eager = loop.snapshot(ts), tg.metrics[:, 0, 1].clone()
        ts.model.load_state_dict(start[0])
        opt.load_state_dict(start[1])
        tg.row.fill_(1)
        tg.calls = 1  # captured and replayed on this call
        tg([noise(5)])
        graphed = loop.snapshot(ts), tg.metrics[:, 0, 1].clone()
        vg.eps[0].normal_(0.0, 1.0, generator=noise(6))
        vg.row.fill_(1)
        vg._body()
        eval_eager = vg.metrics[:, 0, 1].clone()
        vg.row.fill_(1)
        vg.calls = 1
        vg([noise(6)])
        eval_graphed = vg.metrics[:, 0, 1].clone()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    tag = f"{kind} {backend}"
    check(torch.equal(eager[1], graphed[1]), f"{tag}: replayed train losses {graphed[1]} != eager {eager[1]}")
    want, got = flat_tensors(eager[0]), flat_tensors(graphed[0])
    diff = [k for k, v in want.items() if not torch.equal(v, got[k])]
    check(not diff, f"{tag}: the replayed train step differs from the eager one in {diff[:5]}")
    check(torch.equal(eval_eager, eval_graphed), f"{tag}: replayed eval {eval_graphed} != eager {eval_eager}")

    # a whole epoch of replays without a host sync
    idx2, mask2 = device_data.batch_plan(np.arange(len(pool)), B, shuffle=True,
                                         generator=torch.Generator().manual_seed(2))
    with torch.cuda.stream(s):
        torch.cuda.set_sync_debug_mode("error")
        try:
            tg.load_plan(idx2, mask2)
            gen = [noise(7)]
            for _ in range(nb):
                tg(gen)
            vg.row.zero_()
            for _ in range(nb):
                vg(gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.current_stream().wait_stream(s)
    losses = tg.metrics[0, 0].tolist()
    check(all(np.isfinite(losses)), f"{tag}: non-finite losses in the replayed epoch {losses}")
    out = {"losses": losses, "capture_s": tg.capture_s + vg.capture_s}
    if profile:
        gen = [noise(8)]
        with torch.cuda.stream(s):
            out["replay"] = api_profile(lambda: (tg.row.zero_(), tg(gen)))
            out["eval_replay"] = api_profile(lambda: (vg.row.zero_(), vg(gen)))
            out["eager"] = api_profile(lambda: (tg.row.zero_(), tg.eps[0].normal_(generator=gen[0]), tg._body()), n=3)
            # ms per replayed train step, the host's dispatch included (phase 7 times the eager one)
            out["replay_ms"] = time_ms(lambda: (tg.row.zero_(), tg(gen)), n=30, warmup=3)
        torch.cuda.current_stream().wait_stream(s)
    opt.zero_grad(set_to_none=True)
    tg.graph = vg.graph = None
    print(f"  20a {tag}: the train step (loss {float(eager[1][0]):.5f}) and the eval step replayed from a "
          f"CUDA graph equal the eager steps bit for bit ({len(want)} tensors); an "
          f"epoch of {nb} + {nb} replays made no host sync; capture {out['capture_s']:.3f} s")
    return out


def dp_device_fit(pool, mesh) -> dict:
    """Phase 20e: the unimodal stage-1 device fit of 20b (4 epochs, patience
    1), through ``mesh`` (None: a single process); its results on the host."""
    from hippie_tpu_torch.parallel import mesh as pmesh

    with pmesh.data_parallel(mesh) if mesh is not None else contextlib.nullcontext():
        return host_fit(uni_resume_fit(pool, "adamw", None, 4, fit_loop="device", early_stopping_patience=1))


def host_fit(res) -> dict:
    """A FitResult's numbers and tensors, on the host."""
    return {"losses": (res.train_losses, res.val_losses, res.best_epoch, res.epochs_run, res.best_val_loss),
            "tensors": {k: v.cpu() for k, v in {**flat_tensors(res.state.model.state_dict(), "model."),
                                                **flat_tensors(res.state.optimizer.state_dict(), "opt."),
                                                **flat_tensors(res.best_state_dict, "best."),
                                                **flat_tensors(res.best_opt_state, "best_opt.")}.items()}}


def same_fit(a: dict, b: dict) -> list:
    """The keys where two host_fit results differ (losses first)."""
    import torch

    bad = [] if a["losses"] == b["losses"] else ["losses"]
    return bad + [k for k, v in a["tensors"].items()
                  if k not in b["tensors"] or not torch.equal(v, b["tensors"][k])]


def cli_run(workdir: str, joint: bool, epochs: int, limit: bool, flags=()) -> tuple:
    """One training CLI (train_model, or train_model_with_multimodal
    --model-type multimodal) in this process, the loss and block kernels,
    ``epochs`` per stage (with ``limit``: 2 train and 1 val batch), into
    ``cli20_ck`` under ``workdir`` with ``flags``: (wall s, the .ckpt and CSV
    bytes, the --log-file records, the printed epoch lines); its files are
    removed."""
    import io

    import torch

    from hippie_tpu_torch.scripts import train_model, train_model_with_multimodal

    argv = ["--dataset", TARGET, "--data-root", DATA_ROOT, "--loss-backend", "pallas", "--block-backend", "pallas",
            "--pretrain-max-epochs", str(epochs), "--finetune-max-epochs", str(epochs),
            "--supervised-max-epochs", str(epochs), *AOT_DIR]
    argv += ["--model-type", "multimodal"] if joint else ["--z_dim", str(Z)]
    if limit:
        argv += ["--limit-train-batches", "2", "--limit-val-batches", "1"]
    out, ck = f"{workdir}/cli20_out", f"{workdir}/cli20_ck"
    argv += ["--output-dir", out, "--checkpoint-dir", ck, "--log-file", f"{out}/log.jsonl", *flags]
    said = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        if joint:
            train_model_with_multimodal.main(argv)
        else:
            train_model.run(train_model.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    files = {p.name: p.read_bytes() for p in sorted(pathlib.Path(ck).glob("*.ckpt"))}
    files.update({p.name: p.read_bytes() for p in sorted(pathlib.Path(out).glob("*.csv"))})
    recs = [json.loads(x) for x in pathlib.Path(f"{out}/log.jsonl").read_text().splitlines()]
    for r in recs:
        r.pop("ts")
    lines = [x for x in said.getvalue().splitlines() if x.startswith("Average")]
    subprocess.run(["rm", "-rf", ck, out], check=True)
    return wall, files, recs, lines


def cli_pair(workdir: str, joint: bool, epochs: int, limit: bool, card: str, profile: bool = False) -> dict:
    """20c: one training CLI (cli_run) with the default --fit-loop device
    (plus --progress-every 1 --log-every-step above 1 epoch) and with
    --fit-loop host, into the same checkpoint directory name in turn: the
    .ckpt and CSV bytes, the epoch records of --log-file and the printed
    epoch lines must be equal; returns both walls. With ``profile`` the
    device run goes under torch.profiler, which counts every wrapper's
    launches, the replays' too (profiled_launches): they must equal the
    host run's, where every launch goes through a wrapper and is counted
    there; returns them too."""
    flags = ["--progress-every", "1", "--log-every-step"] if epochs > 1 else []
    if profile:
        (dw, dfiles, drecs, dlines), launches, eager = profiled_launches(
            lambda: cli_run(workdir, joint, epochs, limit, flags))
    else:
        dw, dfiles, drecs, dlines = cli_run(workdir, joint, epochs, limit, flags)
    reset_all_launches()
    hw, hfiles, hrecs, hlines = cli_run(workdir, joint, epochs, limit, ["--fit-loop", "host"])
    host_launches = all_launches()
    tag = f"{'joint' if joint else 'unimodal'} CLI, {epochs} epoch(s) per stage{', 2+1 batches' if limit else ''}"
    diff = sorted(k for k in set(dfiles) | set(hfiles) if dfiles.get(k) != hfiles.get(k))
    check(not diff and len(dfiles) >= 5, f"{tag}: files differ between the loops: {diff}")
    steps = [r for r in drecs if "train_loss_step" in r]
    check([r for r in drecs if "train_loss_step" not in r] == hrecs and hrecs,
          f"{tag}: the log's epoch records differ between the loops")
    check(dlines == hlines and hlines, f"{tag}: the printed epoch lines differ between the loops")
    check(epochs == 1 or steps, f"{tag}: --log-every-step wrote no step record")
    print(f"  20c {tag}: --fit-loop device {dw:.3f} s{' under torch.profiler' if profile else ''}, host "
          f"{hw:.3f} s wall; {len(dfiles)} files byte-equal, {len(hrecs)} epoch records and {len(hlines)} "
          f"printed lines equal, {len(steps)} step records")
    if not profile:
        return {"device_s": dw, "host_s": hw}
    check(launches == host_launches and all(v > 0 for v in launches.values()),
          f"{tag}: the device loop's launches {launches} (profiler) differ from the host loop's {host_launches}")
    print(f"[20c launches] {tag} on {card}: the device loop's launches, counted by torch.profiler (the "
          f"replays' too), {launches}, equal to the host loop's counted by the wrappers; of them the wrappers "
          f"launched {eager} eagerly (the warm-up steps; the graphs' replays launch the rest)")
    return {"device_s": dw, "host_s": hw, "launches": launches}


def profiled_launches(fn) -> tuple:
    """``fn()`` under torch.profiler (device activity only), with the
    wrappers' counters set to 0 just before it: (its result, each wrapper's
    launches counted by the profiler from its marker kernels, the wrappers'
    own counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset_all_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wrappers = all_launches()
    return out, marker_launches(device_events(prof)), wrappers


# 20b's fit again with the other optimizers and loss backend the pipelines
# run: (optimizer, moment dtype, loss backend)
VARIANTS_20B = (("schedule-free", None, "pallas"), ("adamw", "bfloat16", "pallas"), ("adamw", None, "xla"))


def clip_launches(card: str) -> dict:
    """The global-norm clip on gradients of the joint model's shapes (all
    its leaves, 16,115,748 values): device kernels, µs and runtime calls per
    call of the clip as it was (a vector norm per leaf, the norm of those,
    one scale by ``clip / norm``) and of train/optim.py:clip_by_global_norm_
    (one multi-tensor pass for the squares' sums, ``(g / n) * c``)."""
    import torch

    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import optim

    model = cvae.multimodal_cvae_init(joint_config(), torch.Generator().manual_seed(0), device="cuda")
    grads = [torch.randn_like(p) for p in model.parameters()]

    def before():
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        torch._foreach_mul_(grads, torch.where(norm < CLIP, torch.ones_like(norm), CLIP / norm))

    out = {"before": api_profile(before), "after": api_profile(lambda: optim.clip_by_global_norm_(grads, CLIP))}
    print(f"[20a clip] the global-norm clip on the joint model's {len(grads)} gradient leaves, per call on {card}: "
          + "; ".join(f"{k} {v['kernels']:.1f} kernels, {v['device_us']:.1f} us device, "
                      f"{v['api'].get('cudaLaunchKernel', 0):.1f} cudaLaunchKernel" for k, v in out.items()))
    del model, grads
    return out


def phase_device_loop(card: str, workdir: str, pool) -> dict:
    """Phase 20, this slice's main path: the device fit loop
    (train/device_fit.py), each stage fit's train and eval steps as CUDA
    graphs replayed on the card.

    (a) Capture safety: each of the seven kernel wrappers replayed from a
    graph equals its eager call; the full-width train and eval steps of
    both models with every block backend replay bit-equal to the eager
    steps, and an epoch of replays makes no host sync. (b) The unimodal
    stage-1 fit (8,056,639 parameters, B=512, phase 4's pool, 4 epochs,
    patience 1) with --fit-loop device equals the host loop's FitResult bit
    for bit; per epoch each loop's ms/step, and per step the device time,
    kernels and runtime calls of an eager and a replayed step, vae_sums_bwd's
    device µs inside the graph; then 2 epochs of the same fit with
    schedule-free, bf16 moments and the "xla" loss backend, each loop equal
    to the other. (c) Both training CLIs with each loop: the unimodal one at
    2 epochs per stage (2 train and 1 val batch per epoch, with
    --progress-every 1 --log-every-step), the joint one at 1 epoch per
    stage: the same .ckpt and CSV bytes, log records and prints; the joint
    CLI's device run under torch.profiler, which counts every wrapper's
    launches, the replays' too, equal to its host run's. (d) The joint
    pipeline at (1, 1, 2) epochs per stage (2 train, 1 val batch) stopped
    in its supervised fit with the device loop and resumed with the host
    loop equals the uninterrupted run. (e) The device fit of (b) in
    one NCCL rank equals the single process's bit for bit: run in phase
    19a's rank, which saves a rank's start (dp_rank_one). Returns the
    kernels' launches in (c)'s profiled joint device CLI run, which runs
    all seven."""
    import torch

    t_phase = time.perf_counter()
    shapes = kernel_replays()
    print(f"[20a capture] the seven kernel wrappers replayed from CUDA graphs equal their eager calls "
          f"(the losses at B=415 of 512, the blocks at {shapes} shapes)")
    prof = {}
    for kind in ("unimodal", "joint"):
        for backend in ("xla", "bf16", "fused", "pallas"):
            prof[(kind, backend)] = step_replay(kind, backend, pool, card, profile=backend == "pallas")
    for kind in ("unimodal", "joint"):
        p = prof[(kind, "pallas")]
        for what in ("eager", "replay", "eval_replay"):
            r = p[what]
            api = {k: round(v, 2) for k, v in sorted(r["api"].items(), key=lambda kv: -kv[1])[:6]}
            print(f"  20a {kind} pallas {what} step: {r['device_us'] / 1e3:.3f} ms device, {r['kernels']:.1f} "
                  f"kernels and copies, runtime calls {api} per step on {card}")
        print(f"  20a {kind} pallas train step: {p['replay_ms']:.3f} ms replayed (CUDA events, the host's "
              f"dispatch included; phase 7 times the eager step) on {card}")
        bwd = [v for k, v in p["replay"]["split"].items() if k.startswith("vae_sums_bwd_kernel")]
        if bwd:
            us, count = sum(t for t, _ in bwd), sum(c for _, c in bwd)
            print(f"  20a {kind}: vae_sums_bwd inside the graph {us / count:.3f} us device per launch "
                  f"(x{count:g} per step)")

    clip_launches(card)
    print(f"  20a {time.perf_counter() - t_phase:.1f} s")

    # (b) the unimodal stage-1 fit, device loop against host loop
    fits, walls = {}, {}
    for fit_loop in ("host", "device"):
        stamps = []
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        res = uni_resume_fit(pool, "adamw", None, 4, fit_loop=fit_loop, early_stopping_patience=1,
                             log_fn=lambda rec: stamps.append(time.perf_counter()), progress_every=1)
        torch.cuda.synchronize()
        walls[fit_loop] = (time.perf_counter() - t0, [b - a for a, b in zip([t0] + stamps, stamps)])
        fits[fit_loop] = host_fit(res)
        if fit_loop == "device":
            eager_launches, stats = all_launches(), res.graphs
    diff = same_fit(fits["device"], fits["host"])
    check(not diff, f"20b: the device fit differs from the host fit in {diff[:5]}")
    want = ("vae_sums_fwd", "vae_sums_bwd", "enc_block_fwd", "enc_block_bwd", "dec_block_fwd", "dec_block_bwd")
    check(all(eager_launches[k] > 0 for k in want), f"20b: a kernel never launched eagerly: {eager_launches}")
    check(stats.get("train_replays", 0) > 0 and stats.get("eval_replays", 0) > 0, f"20b: no replay: {stats}")
    train_l, val_l, best_epoch, epochs_run, _ = fits["device"]["losses"]
    n_tr, n_va = -(-int(0.8 * len(pool)) // B), -(-(len(pool) - int(0.8 * len(pool))) // B)
    # both loops run the same kernels: the replays' device time (no launch
    # gaps in it) is each epoch's device work
    busy = (n_tr * prof[("unimodal", "pallas")]["replay"]["device_us"]
            + n_va * prof[("unimodal", "pallas")]["eval_replay"]["device_us"]) / 1e3
    for fit_loop in ("host", "device"):
        per = [1e3 * e / (n_tr + n_va) for e in walls[fit_loop][1]]
        print(f"  20b {fit_loop} loop: {walls[fit_loop][0]:.3f} s for {epochs_run} epochs; ms/step per epoch "
              f"{[round(x, 3) for x in per]}; device busy {busy / (n_tr + n_va):.3f} ms/step; idle share per "
              f"epoch {[round(1 - busy / (1e3 * e), 3) for e in walls[fit_loop][1]]}")
    print(f"[20b device fit] the unimodal stage-1 fit at full width (B={B}, {n_tr} train + {n_va} val steps, "
          f"4 epochs, patience 1) with --fit-loop device equals the host loop's bit for bit: epochs run "
          f"{epochs_run}, best epoch {best_epoch}, losses {[round(x, 5) for x in train_l]}; captures "
          f"{stats.get('capture_s', 0):.3f} s, {stats.get('train_replays')} train and "
          f"{stats.get('eval_replays')} eval replays; the wrappers' eager launches (the warm-up steps) "
          f"{eager_launches} on {card}")
    # the optimizers and the loss backend the pipelines also run, both loops
    t0 = time.perf_counter()
    for optimizer, state_dtype, loss_backend in VARIANTS_20B:
        got = {fl: host_fit(uni_resume_fit(pool, optimizer, state_dtype, 2, fit_loop=fl, early_stopping_patience=1,
                                           loss_backend=loss_backend)) for fl in ("host", "device")}
        diff = same_fit(got["device"], got["host"])
        check(not diff, f"20b {optimizer} {state_dtype} {loss_backend}: the loops differ in {diff[:5]}")
    print(f"[20b variants] the same fit, 2 epochs, with each of {VARIANTS_20B} (optimizer, moment dtype, "
          f"loss backend): the device loop equals the host loop bit for bit; {time.perf_counter() - t0:.1f} s")

    # (c) both training CLIs
    t0 = time.perf_counter()
    cli = {}
    for joint, epochs, limit in ((False, 2, True), (True, 1, False)):
        cli[(joint, epochs)] = cli_pair(workdir, joint, epochs, limit, card, profile=joint)
    launches = cli[(True, 1)]["launches"]
    print(f"[20c CLIs] both training CLIs give the same files, records and prints with either loop; walls "
          f"device / host: " + ", ".join(f"{'joint' if j else 'unimodal'} {e} ep {r['device_s']:.2f} / "
                                         f"{r['host_s']:.2f} s" for (j, e), r in cli.items())
          + f"; {time.perf_counter() - t0:.1f} s")

    # (d) resume across the loops: stopped with the device loop after the
    # supervised fit's first epoch, resumed with the host loop (the CPU
    # tests resume both ways)
    t0 = time.perf_counter()
    kw = dict(limits=True, epochs=(1, 1, 2))
    ref = joint_resume_run(workdir, "x20_ref", resume=False, fit_loop="device", **kw)
    for fit_loop, crash in (("device", 1), ("host", 0)):
        resumed = joint_resume_run(workdir, "x20_chain", resume=True, fit_loop=fit_loop, crash=crash, **kw)
    d = joint_run_diff(ref, resumed)
    check(d == {"ckpt": 0.0, "csv": 0.0, "acc": 0.0},
          f"20d: stopped with the device loop, resumed with the host loop: differs from the uninterrupted run {d}")
    print(f"[20d resume] the joint pipeline stopped in its supervised fit with the device loop and resumed with "
          f"the host loop equals the uninterrupted run (checkpoints, CSVs, accuracies), "
          f"{time.perf_counter() - t0:.1f} s")

    # (e) one NCCL rank: run in phase 19a's rank (dp_rank_one), checked there
    print(f"  phase 20 {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 21: hippie-tpu-torch bench
# ---------------------------------------------------------------------------

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "ms_per_batch", "mfu_vs_bf16_peak", "flops_per_batch",
              "device_busy_ms_per_batch", "idle_share", "block_backend", "loss_backend", "device")
BENCH_LAUNCHES = re.compile(r"kernel launches in the profiled epoch \(torch\.profiler\) (\{.*\})")


def bench_step_launches(backend: str) -> dict:
    """Each kernel wrapper's launches in one of the bench's train steps: with
    the "pallas" backends the loss kernels once and each block kernel once
    per BasicBlock of its backbone (8 at full width); with "xla" none."""
    blocks = sum(full_config().num_blocks) if backend == "pallas" else 0
    loss = int(backend == "pallas")
    return {"vae_sums_fwd": loss, "vae_sums_bwd": loss, "masked_sse_fwd": 0, "enc_block_fwd": blocks,
            "enc_block_bwd": blocks, "dec_block_fwd": blocks, "dec_block_bwd": blocks}


def bench_cli(card: str, backend=None) -> dict:
    """21: ``python -m hippie_tpu_torch.cli bench --aot-dir build`` in a
    fresh process, with its defaults (``backend`` None: "pallas" blocks and
    loss) or with ``--block-backend backend --loss-backend backend``. It
    must exit 0; its last line must hold every key of the bench's JSON
    line, finite positive numbers (the idle share at least 0: the busy time
    within its profiled window), bench.py's metric and unit, the backends,
    the FLOPs of utils/flops.py:step_flops at its shapes, a device busy
    time within 1.05 x the ms per batch (the profiler stretches the step)
    and this card; the kernel launches of its profiled epoch
    (torch.profiler, the wrappers' marker kernels) must be one step's per
    batch. Returns the line, the launches and the wall time."""
    from hippie_tpu_torch.scripts import bench

    flags = [] if backend is None else ["--block-backend", backend, "--loss-backend", backend]
    backend = backend or "pallas"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hippie_tpu_torch.cli", "bench", *AOT_DIR, *flags],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    wall = time.perf_counter() - t0
    tag = f"bench {' '.join(flags) or '(defaults)'}"
    if proc.returncode != 0:
        print(proc.stdout[-3000:], proc.stderr[-3000:], sep="\n", file=sys.stderr)
    check(proc.returncode == 0, f"{tag}: exit {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(tuple(line) == BENCH_KEYS, f"{tag}: keys {tuple(line)}, not {BENCH_KEYS}")
    check((line["metric"], line["unit"]) == ("cvae_pretrain_waveforms_per_sec", "waveforms/s/chip"),
          f"{tag}: metric and unit {line['metric']!r} {line['unit']!r}")
    check((line["block_backend"], line["loss_backend"], line["device"]) == (backend, backend, card),
          f"{tag}: backends and device {line['block_backend']}, {line['loss_backend']}, {line['device']!r}")
    numbers = {k: v for k, v in line.items() if isinstance(v, (int, float))}
    check(len(numbers) == 7 and all(np.isfinite(v) and (v > 0 or k == "idle_share" and v >= 0)
                                    for k, v in numbers.items()), f"{tag}: numbers {numbers}")
    want_flops = step_flops(bench.bench_config(), bench.BATCH_SIZE, bench.LENGTH)
    check(line["flops_per_batch"] == want_flops, f"{tag}: flops_per_batch {line['flops_per_batch']} != {want_flops}")
    # the busy time is read under the profiler, whose tracing stretches a
    # device-bound step: 4.257 ms against 4.223 unprofiled (NVIDIA H100 80GB HBM3, 700 W);
    # within its own window it is checked exactly (idle_share >= 0, above)
    check(line["device_busy_ms_per_batch"] <= 1.05 * line["ms_per_batch"],
          f"{tag}: busy {line['device_busy_ms_per_batch']} ms over 1.05 x the step's {line['ms_per_batch']} ms")
    found = BENCH_LAUNCHES.search(proc.stderr)
    check(found is not None, f"{tag}: no profiled launches on stderr")
    launches = json.loads(found.group(1))
    nb = n_batches(bench.REFERENCE_EPOCH_SAMPLES, bench.BATCH_SIZE)
    want = {k: v * nb for k, v in bench_step_launches(backend).items()}
    check(launches == want, f"{tag}: the profiled epoch's launches {launches}, not {want}")
    said = [x for x in proc.stderr.splitlines() if x.startswith("bench:")]
    print(f"[21 bench] {tag} on {card}: {json.dumps(line)}; {wall:.1f} s wall with the process's start")
    print(f"  21 {tag}: {said[-1] if said else '(no bench: line on stderr)'}")
    print(f"  21 {tag}: launches in its profiled epoch of {nb} batches, counted by torch.profiler from the "
          f"wrappers' marker kernels: {launches}")
    return {"line": line, "launches": launches, "wall": wall}


def bench_epoch(card: str) -> dict:
    """21, in this process: the bench's timed program (its data, plan, seeded
    weights, noise generator and StepGraph, train/device_fit.py:
    run_graphed_epoch) for its warm-up epoch (the first step eager, the
    second captured, the rest replayed) against train/step.py's eager epoch
    with the same data, plan, generator and weights: the per-batch losses,
    parameters, BatchNorm buffers and AdamW state equal bit for bit. The
    graphed epoch goes under torch.profiler with the wrappers' counters set
    to 0 just before it (run again from the same weights, up to 3 times,
    while the profiler counts fewer launches than the epoch makes and more
    of none: the tracer dropped events); returns its launches (the
    replays' too)."""
    import torch

    from hippie_tpu_torch.scripts import bench
    from hippie_tpu_torch.train import device_fit, step

    cfg, n, b = bench.bench_config(), bench.REFERENCE_EPOCH_SAMPLES, bench.BATCH_SIZE
    data, source = bench.make_data(n, "cuda")
    idx, mask = bench.make_plan(n, b)
    nb = idx.shape[0]

    def graphed():
        ts = bench.make_state(cfg, "cuda")
        with device_fit.graph_stream(torch.device("cuda")) as (stream, pool):
            train = bench.make_train_graph(ts, data, source, nb=nb, batch_size=b, stream=stream, pool=pool,
                                           block_backend="pallas", loss_backend="pallas")
            losses = device_fit.run_graphed_epoch(train, idx, mask, [bench.noise_generator(0, "cuda")])[0, 0].clone()
        train.graph = None
        ts.optimizer.zero_grad(set_to_none=True)
        return ts, losses, train.replays

    per = {k: v * nb for k, v in bench_step_launches("pallas").items()}
    t0 = time.perf_counter()
    for traces in range(1, 4):  # the tracer sometimes drops a replay's events: run the epoch again
        (ts_g, losses_g, replays), launches, eager_launches = profiled_launches(graphed)
        if launches == per or any(launches[k] > v for k, v in per.items()):
            break
    t_graphed = time.perf_counter() - t0
    train_epoch, _ = step.make_unimodal_epoch_fns(beta=1.0, loss_backend="pallas", block_backend="pallas")
    ts_e, ms = train_epoch(bench.make_state(cfg, "cuda"), data, source, None, idx, mask,
                           generator=bench.noise_generator(0, "cuda"))
    torch.cuda.synchronize()
    check(torch.equal(losses_g, ms.loss), f"21: the bench's graphed losses differ from the eager epoch's by "
                                          f"{(losses_g - ms.loss).abs().max().item()}")
    got = {**flat_tensors(ts_g.model.state_dict(), "model."), **flat_tensors(ts_g.optimizer.state_dict(), "opt.")}
    want = {**flat_tensors(ts_e.model.state_dict(), "model."), **flat_tensors(ts_e.optimizer.state_dict(), "opt.")}
    diff = sorted(k for k in set(got) | set(want) if k not in got or k not in want or not torch.equal(got[k], want[k]))
    check(not diff and len(got) > 100, f"21: the bench's graphed epoch differs from the eager epoch in {diff[:5]}")
    check(launches == per, f"21: the graphed epoch's launches {launches} (profiler, {traces} traces), not {per}")
    print(f"[21 bench epoch] the bench's timed program at its shapes ({n} samples, B={b}, {nb} batches, the "
          f"last with {int(mask[-1].sum())} real rows), its warm-up epoch from its seeded weights ({replays} "
          f"replays), equals train/step.py's eager epoch bit for bit: {nb} losses, {len(got)} parameter, "
          f"BatchNorm and AdamW tensors; launches counted by torch.profiler {launches}, of them the wrappers "
          f"launched {eager_launches} eagerly (the first step), on {card}; {time.perf_counter() - t0:.1f} s "
          f"({t_graphed:.1f} s the graphed epoch under the profiler, {traces} trace(s))")
    return launches


def phase_bench(card: str) -> dict:
    """Phase 21, this slice's main path: ``hippie-tpu-torch bench``, the root
    bench.py's stage-1 throughput measurement (scripts/bench.py), as a user
    runs it: a fresh process with its defaults ("pallas" blocks and loss)
    and one with the JAX bench's backends ("xla", "xla"), each checked by
    bench_cli; then the bench's program in this process against the eager
    epoch (bench_epoch). Returns both runs and the in-process launches."""
    t0 = time.perf_counter()
    runs = {"pallas": bench_cli(card), "xla": bench_cli(card, "xla")}
    launches = bench_epoch(card)
    print(f"  phase 21 {time.perf_counter() - t0:.1f} s on {card}")
    return {"runs": runs, "epochs_launches": launches}


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


def whole_run(tree: str, log_path=None, timeout: float = 1300.0) -> dict:
    """``python3 chip_smoke.py`` of ``tree`` in a fresh process: its exit
    code, its total seconds and each phase's seconds, read from the arrival
    times of its printed lines (a line starting ``[N`` opens phase N; each
    line's time since the line before it is its phase's). Its output goes
    to ``log_path``."""
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=tree, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    phases, last, phase, said = {}, t0, "start", []
    try:
        for line in proc.stdout:
            now = time.perf_counter()
            said.append(line)
            m = re.match(r"\[(\d+)", line)
            if m:
                phase = m.group(1)
            phases[phase] = phases.get(phase, 0.0) + now - last
            last = now
        rc = proc.wait()
    finally:
        timer.cancel()
    if log_path:
        pathlib.Path(log_path).write_text("".join(said))
    total = [float(x) for x in re.findall(r"^\[chip_smoke\] all phases ([0-9.]+) s", "".join(said), re.M)]
    return {"rc": rc, "wall": round(time.perf_counter() - t0, 1), "total": total[0] if total else None,
            "phases": {k: round(v, 1) for k, v in phases.items()}, "tail": "".join(said[-30:])}


def compare_whole(other: str, pairs: int, log_dir=None) -> int:
    """The whole script of ``other`` and of this tree, each in a fresh
    process, ``pairs`` times in turns (other first): each run's exit code,
    total and per-phase seconds (whole_run), side by side."""
    trees = {"other": str(pathlib.Path(other).resolve()), "this": str(REPO)}
    runs = {k: [] for k in trees}
    for i in range(pairs):
        for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
            log = f"{log_dir}/compare_{name}_{i}.log" if log_dir else None
            r = whole_run(trees[name], log)
            runs[name].append(r)
            print(f"[compare {i}] {name} ({trees[name]}): rc {r['rc']}, all phases {r['total']} s, wall "
                  f"{r['wall']} s; per phase (s) {json.dumps(r['phases'])}", flush=True)
            if r["rc"] != 0:
                print(r["tail"])
    names = sorted({p for rs in runs.values() for r in rs for p in r["phases"]},
                   key=lambda p: (not p.isdigit(), int(p) if p.isdigit() else 0))
    for p in names:
        print(f"[compare] phase {p}: " + "; ".join(
            f"{name} {[r['phases'].get(p) for r in rs]}" for name, rs in runs.items()))
    print("[compare] all phases (s): " + "; ".join(f"{name} {[r['total'] for r in rs]}" for name, rs in runs.items()))
    return 0 if all(r["rc"] == 0 for rs in runs.values() for r in rs) else 1


def main() -> int:
    if sys.argv[1:2] == ["--aot-load"]:
        return aot_load(sys.argv[2])
    if sys.argv[1:2] == ["--artifact-replies"]:
        artifact_replies(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--phases-of"]:
        phases_of(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--dp-walls"]:
        return dp_walls()
    if sys.argv[1:2] == ["--fsdp-nccl"]:
        return fsdp_nccl()
    if sys.argv[1:2] == ["--compare"]:
        args = sys.argv[3:]
        pairs = int(args[args.index("--pairs") + 1]) if "--pairs" in args else None
        if "--whole" in args:
            log_dir = args[args.index("--log-dir") + 1] if "--log-dir" in args else None
            return compare_whole(sys.argv[2], pairs or 1, log_dir)
        return compare(sys.argv[2], pairs or 5)
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

    t_start = time.perf_counter()
    try:
        kind = torch.cuda.get_device_name(0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True
                              ).stdout.strip().splitlines()[0]
        print(f"[1 device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s)")
        print(card)
        phase_build()
        phase_aot_cache(card)
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
            # phases 13-14: the four servers start at once, after phase 14's exports
            exported = export_artifacts(workdir, uni_ckpts, joint_ckpt)
            servers = start_servers(server_configs(uni_ckpts, joint_ckpt, exported["dir"]))
            try:
                ckpt_replies = phase_serving(card, uni_ckpts, joint_ckpt, servers)
                phase_artifacts(card, uni_ckpts, joint_ckpt, ckpt_replies, exported, servers)
            finally:
                stop_servers(servers)
            phase_ensemble(card, workdir, pool)
            # this slice's main path, the k-fold refit side by side: 16b's
            # replica-plan fits, counted by the profiler, go on the kernels
            # line after the later phases
            kfold_launches = phase_kfold(card, workdir, uni_ckpts, joint_ckpt, pool)
            # this slice's main path, the resumed joint pipeline: every kernel again, counted from 0
            resume_launches = phase_resume(card, workdir, pool)
            for record in kernels:
                record["launches"] = resume_launches[record["name"]]
            phase_cli_backends(card, workdir, pool, losses)
            # this slice's main path, the joint pipeline on two data-parallel
            # ranks: the segmented entries' launches, counted from 0 in it
            kernels += phase_data_parallel(card, workdir, idx, mask)
            # this slice's main path, the device fit loop: its joint CLI run
            # at 1 epoch per stage runs all seven kernels, counted from 0 by
            # the profiler (a graph's replays launch them without the wrappers)
            device_launches = phase_device_loop(card, workdir, pool)
            for record in kernels:
                if record["name"] in device_launches:
                    record["launches"] = device_launches[record["name"]]
            # the benchmark: its launches on earlier lines (counted by the
            # profiler), no record of its own
            phase_bench(card)
            for record in kernels:
                if record["name"] in kfold_launches:
                    record["launches"] = kfold_launches[record["name"]]
        torch.cuda.synchronize()
    except Exception as e:  # any failed phase fails the run, with its traceback
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    # the contract's limit is 1,200 s, the kernels' build included
    print(f"[chip_smoke] all phases {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
