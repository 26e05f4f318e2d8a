"""``hippie-tpu-torch bench``: stage-1 pretraining throughput (waveforms/s/chip).

    python -m hippie_tpu_torch.cli bench [--block-backend pallas] [--loss-backend pallas] \
        [--aot-dir DIR] [--device cuda]

Counterpart of the root bench.py, the JAX package's headline measurement,
with its workload unchanged (bench.py:39-56): the reference's stage-1
workload, the unimodal waveform cVAE (z_dim=10, 8,056,639 parameters) at
batch 512 over a reference-scale epoch of 19,539 samples (SURVEY.md §6: the
leave-cellexplorer-out pretraining pool), made from numpy's
``default_rng(0)`` (``normal`` [n, 50] float32, then sources 0-4: the JAX
data bit for bit), the port's seeded init (seed 0), AdamW (lr 1e-3, wd 0.01,
no clip), beta 1, no class labels. One shuffled plan (39 batches, the last
with 83 real rows under its mask) serves every epoch, as the JAX bench
reuses its plan; it is shuffled by a torch generator from
``loop.key_generator(42, 0)``, since jax.random's bits cannot be
reproduced, and each epoch's noise comes from a fresh generator
(``key_generator(42, 1, epoch)``, the counterpart of ``fold_in(key, e)``).

Baseline derivation (BASELINE.md): the reference publishes no numbers beyond
"~45 minutes for train+inference on a consumer-grade GPU" (README.md:80).
Attributing the entire 45 min to the six training passes over the pool
(2 models x 3 stages x 19,539 samples) gives the most charitable reference
throughput: 2*3*19539 / 2700 s = 43.4 waveforms/sec, a figure of the
reference's consumer GPU. ``vs_baseline`` is measured throughput / 43.4.

The timed program is the device fit loop's train epoch
(train/device_fit.py:run_graphed_epoch), the counterpart of the JAX bench's
epoch-as-scan: the plan's H2D copy, then per batch a noise draw and one
replay of the train step's CUDA graph. The warm-up epoch runs the first
step eagerly (it loads the kernels and makes the optimizer state), captures
the second and replays the rest; then 5 epochs are timed between two
``torch.cuda.synchronize()`` calls. The JAX script subtracts a calibrated
scalar fetch from its window because ``block_until_ready`` under-waits on a
remote TPU; ``synchronize`` waits for the card's work, so nothing is
subtracted here. After the window one loss is fetched and must be finite,
and one more epoch runs under torch.profiler (never inside the timed
window) for the device busy time per batch (its kernels and copies), each
kernel's launches (printed on stderr), and the idle share: 1 - busy time
over that epoch's span on the device's timeline (CUDA events). The span
is the profiled epoch's, not the timed ones': the profiler's tracing
stretches a device-bound step (4.257 ms busy per batch against 4.223 ms
per batch timed without it, on an NVIDIA H100 80GB HBM3 at 700 W), so only
the same window gives a share of it.

FLOPs per batch are counted from the layers' shapes (utils/flops.py:
3 x the forward's convolution and linear FLOPs), where the JAX bench reads
XLA's cost analysis, which the port has no counterpart of;
``mfu_vs_bf16_peak`` divides them by the H100's 989 TFLOP/s dense bf16
peak.

``--block-backend`` and ``--loss-backend`` are the training CLIs'; both
default to ``pallas``, so that the line times the hand-written kernels (the
JAX bench runs ``xla`` and ``xla``: pass ``--block-backend xla
--loss-backend xla`` for its backends). ``--aot-dir`` is the kernel-library
cache (ops/_build.py), the counterpart of the JAX bench's persistent
compilation cache. There are no size flags, as in the JAX bench. Without a
CUDA device and without ``--device cpu`` the script exits 1 with one line
on stderr; ``--device cpu`` runs the same epochs eagerly, with no graphs.
There is no retry: the JAX bench retries once for transient remote-TPU
errors, the port fails loudly.

Prints ONE JSON line, the last of stdout: bench.py's keys (``metric``,
``value``, ``unit``, ``vs_baseline``, ``ms_per_batch``,
``mfu_vs_bf16_peak``) and the port's (``flops_per_batch``,
``device_busy_ms_per_batch``, ``idle_share``, ``block_backend``,
``loss_backend``, ``device``: the card's name and power limit as
nvidia-smi gives them). Everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.ops import _build
from hippie_tpu_torch.train import device_fit, loop, optim, step
from hippie_tpu_torch.utils import kernel_profile
from hippie_tpu_torch.utils.flops import PEAK_BF16_FLOPS, step_flops

REFERENCE_EPOCH_SAMPLES = 19_539
BASELINE_WAVEFORMS_PER_SEC = 2 * 3 * REFERENCE_EPOCH_SAMPLES / 2700.0  # 43.42
BATCH_SIZE = 512
LENGTH = 50  # the waveform's samples
EPOCHS = 5  # timed, after one warm-up epoch
SEED = 0  # the data's and the weights'
KEY = 42  # the plan's and the noise's, as the JAX bench's PRNGKey(42)
LR, WD = 1e-3, 0.01


def bench_config(num_blocks=(2, 2, 2, 2)):
    """bench.py's model: z=10, 5 sources, 5 classes, class_hidden_dim 5."""
    return cvae.CVAEConfig(z_dim=10, output_size=LENGTH, class_hidden_dim=5, num_sources=5, num_classes=5,
                           num_blocks=num_blocks)


def make_data(n: int, device):
    """bench.py's data: ``default_rng(0)``'s ``normal`` [n, 50] float32, then
    ``integers(0, 5)`` as the sources; on ``device``."""
    rng = np.random.default_rng(SEED)
    data = rng.normal(size=(n, LENGTH)).astype(np.float32)
    source = rng.integers(0, 5, size=n)
    return torch.from_numpy(data).to(device), torch.from_numpy(source).long().to(device)


def make_plan(n: int, batch_size: int):
    """The one shuffled ``[nb, B]`` plan every epoch reuses."""
    return batch_plan(np.arange(n), batch_size, shuffle=True, generator=loop.key_generator(KEY, 0))


def noise_generator(epoch: int, device):
    """Epoch ``epoch``'s noise generator (0: the warm-up)."""
    return loop.key_generator(KEY, 1, epoch, device=device)


def make_state(cfg, device):
    """The seeded model and its AdamW, as a TrainState."""
    model = cvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(SEED), device=device)
    return step.TrainState(model, optim.make_optimizer(model.parameters(), LR, WD, clip_val=None))


def make_train_graph(ts, data, source, *, nb: int, batch_size: int, stream, pool, block_backend: str,
                     loss_backend: str):
    """The train step's StepGraph over ``data`` and ``source``, as the
    device fit loop builds it: call it inside ``device_fit.graph_stream``,
    which gives ``stream`` and ``pool``."""
    batch_step, _ = step.make_unimodal_steps(beta=1.0, loss_backend=loss_backend, block_backend=block_backend)

    def train_fn(idx, mask, eps):
        return batch_step(ts, data[idx], source[idx], None, mask, eps=eps)[1]

    z = ts.model.z_mean.out_features
    return device_fit.StepGraph([train_fn], nb=nb, batch=batch_size, noise_shape=(batch_size, z), dtype=data.dtype,
                                device=data.device, stream=stream, pool=pool,
                                before_capture=lambda: ts.optimizer.zero_grad(set_to_none=True))


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" off the card."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    return lines[device.index or 0]


def busy_profile(epoch, device, nb: int) -> tuple:
    """One ``epoch()`` of ``nb`` replays under torch.profiler: (the device's
    busy ms, its span in ms, each kernel wrapper's launches, the traces
    taken). On the card the busy time is the kernels' and copies' (the
    device's trace alone: kernel_profile.device_profile), the span is read
    from CUDA events on the device's timeline, and the launches are counted
    from the wrappers' marker kernels. Every replay runs the same kernels,
    and the epoch adds one plan copy and one reset of the row counter, so
    each kernel's count is 0 or 1 modulo ``nb``; a trace where it is not
    dropped some of a replay's events, and the epoch is traced again (up to
    5 traces). On the CPU the busy time is the host's time in operators,
    the span the host clock's, and no kernel launches."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def timed_epoch():
            start.record()
            epoch()
            end.record()

        for traces in range(1, 6):
            us, _, split = kernel_profile.device_profile(timed_epoch, n=1, warmup=False, host=False)
            if all(count % nb in (0, 1) for _, count in split.values()):
                break
        return us / 1e3, start.elapsed_time(end), kernel_profile.marker_launches(split), traces
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        epoch()
        span = (time.perf_counter() - t0) * 1e3
    return sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3, span, {}, 1


def run(cfg, n: int, batch_size: int, epochs: int, device, block_backend: str, loss_backend: str) -> dict:
    """The bench at ``cfg``, ``n`` samples, ``batch_size`` and ``epochs``
    timed epochs on ``device``: its JSON line as a dict."""
    t_setup = time.perf_counter()
    device = torch.device(device)
    data, source = make_data(n, device)
    ts = make_state(cfg, device)
    idx, mask = make_plan(n, batch_size)
    nb = idx.shape[0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with device_fit.graph_stream(device) as (stream, pool):
        train = make_train_graph(ts, data, source, nb=nb, batch_size=batch_size, stream=stream, pool=pool,
                                 block_backend=block_backend, loss_backend=loss_backend)

        def epoch(e):
            return device_fit.run_graphed_epoch(train, idx, mask, [noise_generator(e, device)])

        try:
            t0 = time.perf_counter()
            setup_s = t0 - t_setup
            epoch(0)  # the warm-up: the first step eager, the second captured, the rest replayed
            sync()
            warm_s = time.perf_counter() - t0
            # every epoch loads the same plan, so a pinned write that overtakes
            # the previous epoch's pending copy writes the bytes it reads
            t0 = time.perf_counter()
            for e in range(1, epochs + 1):
                metrics = epoch(e)
            sync()
            dt = time.perf_counter() - t0
            loss = metrics[0, 0, -1].item()
            if not math.isfinite(loss):
                raise FloatingPointError(f"bench: the last timed batch's loss is {loss}")
            t0 = time.perf_counter()
            busy_ms, span_ms, launches, traces = busy_profile(lambda: epoch(epochs + 1), device, nb)
            profile_s = time.perf_counter() - t0
        finally:
            train.graph = None
            ts.optimizer.zero_grad(set_to_none=True)

    ms_per_batch = dt / (epochs * nb) * 1e3
    flops = step_flops(cfg, batch_size, LENGTH)
    wps = epochs * n / dt
    busy = busy_ms / nb
    print(f"bench: set-up {setup_s:.3f} s; warm-up epoch {warm_s:.3f} s (capture {train.capture_s:.3f} s); "
          f"profiled epoch {profile_s:.3f} s with the reading of {traces} trace(s); "
          f"{time.perf_counter() - t_setup:.3f} s in all; {train.replays} replays in all; "
          f"{epochs} timed epochs of {nb} batches {dt:.4f} s; last loss {loss:.6f}; profiled epoch: busy "
          f"{busy:.4f} of {span_ms / nb:.4f} ms per batch; kernel launches in the profiled epoch (torch.profiler) "
          f"{json.dumps(launches)}", file=sys.stderr)
    return {
        "metric": "cvae_pretrain_waveforms_per_sec",
        "value": round(wps, 1),
        "unit": "waveforms/s/chip",
        "vs_baseline": round(wps / BASELINE_WAVEFORMS_PER_SEC, 2),
        "ms_per_batch": round(ms_per_batch, 4),
        "mfu_vs_bf16_peak": round(flops / (ms_per_batch * 1e-3) / PEAK_BF16_FLOPS, 4),
        "flops_per_batch": flops,
        "device_busy_ms_per_batch": round(busy, 4),
        "idle_share": round(1.0 - busy_ms / span_ms, 4),
        "block_backend": block_backend,
        "loss_backend": loss_backend,
        "device": card_name(device),
    }


def build_parser():
    p = argparse.ArgumentParser(prog="hippie-tpu-torch bench", description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="where the model and the data live (default cuda)")
    p.add_argument("--block-backend", choices=("xla", "fused", "bf16", "pallas"), default="pallas",
                   help="the backbones' BasicBlocks (the JAX bench's: xla)")
    p.add_argument("--loss-backend", choices=("xla", "pallas"), default="pallas",
                   help="the VAE loss (the JAX bench's: xla)")
    p.add_argument("--aot-dir", default=_build.CLI_DEFAULT_DIR,
                   help="kernel-library cache: the CUDA kernels load from DIR/torch_kernels, or are "
                        "built there once; '' keeps build/kernels beside the package")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("hippie-tpu-torch bench: no CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to run it on the CPU", file=sys.stderr)
        return 1
    _build.set_default_dir(args.aot_dir or None)
    line = run(bench_config(), REFERENCE_EPOCH_SAMPLES, BATCH_SIZE, EPOCHS, device, args.block_backend,
               args.loss_backend)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
