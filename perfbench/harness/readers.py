"""Arithmetic the per-layer metrics' readers (``perfbench/metrics/``) share."""

from __future__ import annotations

import re
from typing import Optional

from perfbench.harness.common import ROOT
from perfbench.yardstick.peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS

# the files the fused block entry points (ops/cuda_blocks.py) are built from
BLOCK_SOURCES = ("hippie_tpu_torch/csrc/enc_block.cu", "hippie_tpu_torch/csrc/dec_block.cu",
                 "hippie_tpu_torch/csrc/sm90_gemm.cuh")


def idle_share(run: dict) -> Optional[float]:
    """% of the traced span in which no kernel or copy ran: the device's busy
    time inside the span (``busy_s``, the runner's) over the span."""
    prof = run.get("prof")
    if not prof or not prof["trace"].device or not prof.get("clipped"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["span_s"])


def train_mfu(run: dict) -> Optional[float]:
    """% of the bf16 peak: the frozen FLOPs of a step times the window's steps, over its seconds."""
    if not run.get("window_steps"):
        return None
    return 100.0 * run["step_flops"] * run["window_steps"] / run["window_s"] / PEAK_BF16_FLOPS


def embed_mfu(run: dict) -> Optional[float]:
    """% of the float32 peak: the encoder path's FLOPs of the rows answered in the window, over its seconds."""
    if not run.get("rows_done"):
        return None
    return 100.0 * run["embed_flops_per_row"] * run["rows_done"] / run["window_s"] / PEAK_F32_FLOPS


def global_names(paths=BLOCK_SOURCES) -> set:
    """The names of the ``__global__`` functions defined in ``paths``."""
    names = set()
    for p in paths:
        text = (ROOT / p).read_text()
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text))
    return names


def base_name(kernel: str) -> str:
    """A profiler kernel name without template arguments."""
    return kernel.split("<", 1)[0]
