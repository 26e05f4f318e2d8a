"""Device time and kernel launches of a call, read from torch.profiler.

``device_profile`` gives the device kernels' and copies' time per call of
a function and each kernel's time and launches by name; ``MARKER_KERNELS``
names, for each kernel wrapper of ops/cuda_ops.py and ops/cuda_blocks.py,
the device kernels of which it launches exactly one per call, so that the
profiler's count of them is the wrapper's launches, those a CUDA graph's
replays make too (the wrappers count only the launches they make
themselves). Used by ``hippie-tpu-torch bench`` (scripts/bench.py) and by
chip_smoke.py and kernel_split.py.
"""

from __future__ import annotations

import re

# (enc_block.cu's bwd_conv1_kernel and dec_block.cu's bwd_conv2_kernel are
# the two files' only untemplated kernels of those names.)
MARKER_KERNELS = {
    "vae_sums_fwd": ("vae_sums_fwd_kernel",),
    "vae_sums_bwd": tuple(f"vae_sums_bwd_kernel<{a},{b}>" for a in (4, 2, 1) for b in (4, 2, 1)),
    "masked_sse_fwd": ("masked_sse_kernel",), "enc_block_fwd": ("fwd_conv_kernel<false,false>",),
    "enc_block_bwd": ("bwd_conv1_kernel",),
    "dec_block_fwd": ("dec_fwd_conv1_kernel<false>", "dec_fwd_conv1_kernel<true>"),
    "dec_block_bwd": ("bwd_conv2_kernel",),
}


def kernel_name(key: str) -> str:
    """A device kernel's profiler key without its return type, namespace and arguments."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return re.sub(r"^blocks::|^sm90::", "", name.removeprefix("void ").replace(", ", ","))


def device_events(prof) -> dict:
    """Each device kernel's and copy's (device us, count) by kernel_name in
    a finished torch.profiler trace, read from its raw events:
    ``key_averages()`` builds the whole event tree first, which takes
    seconds for a trace of tens of thousands of kernels (a replayed epoch)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_user_annotation", lambda: False)():
            continue
        name = kernel_name(e.name())
        us, count = out.get(name, (0.0, 0))
        out[name] = (us + e.duration_ns() / 1e3, count + 1)
    return out


def device_profile(fn, n: int = 10, warmup: bool = True, host: bool = True):
    """(device us, device kernels and copies, split) per call of ``fn``, from
    torch.profiler over ``n`` calls (after one unprofiled call with
    ``warmup``); ``split`` maps each kernel's name (kernel_name) to its
    (device us, launches) per call, the largest first. (0.0, 0.0, {}) if
    the profiler records no device time. ``host=False`` traces the device
    only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    for _ in range(5):  # the tracer sometimes drops whole calls' device events: take a full trace
        with profile(activities=activities) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = {k: v for k, v in device_events(prof).items() if v[0] > 0}
        if rows and all(count % n == 0 for _, count in rows.values()):
            break
    split = {k: (us / n, count / n) for k, (us, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])}
    return sum(v[0] for v in split.values()), sum(v[1] for v in split.values()), split


def marker_launches(split: dict) -> dict:
    """Each kernel wrapper's launches in a ``device_profile`` split: the
    count of its marker kernels."""
    return {k: sum(split.get(m, (0.0, 0))[1] for m in ms) for k, ms in MARKER_KERNELS.items()}
