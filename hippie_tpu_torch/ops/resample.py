"""Linear resampling as a precomputed interpolation-matrix matmul.

Counterpart of hippie_tpu/ops/resample.py (a copy of its numpy
``interp_matrix``). The reference resamples every sample with
``F.interpolate(x, size=(out,), mode="linear")`` (align_corners=False); here a
whole dataset is resampled as one ``X @ R`` with the same coefficients.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def interp_matrix(in_len: int, out_len: int) -> np.ndarray:
    """float32 R[in_len, out_len] s.t. x @ R == F.interpolate(x, out_len, mode='linear').

    align_corners=False source coordinate: src = (i + 0.5) * (in/out) - 0.5,
    clamped to [0, in-1]; output = (1-frac)*x[floor] + frac*x[floor+1].
    Source coordinates are computed in float32, as torch does on the CPU.
    The cached array is read-only.
    """
    scale = np.float32(in_len) / np.float32(out_len)
    i = np.arange(out_len, dtype=np.float32)
    src = (i + np.float32(0.5)) * scale - np.float32(0.5)
    src = np.clip(src, np.float32(0.0), np.float32(in_len - 1))
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_len - 1)
    frac = (src - lo).astype(np.float32)
    R = np.zeros((in_len, out_len), dtype=np.float32)
    cols = np.arange(out_len, dtype=np.int64)
    np.add.at(R, (lo, cols), np.float32(1.0) - frac)
    np.add.at(R, (hi, cols), frac)
    R.setflags(write=False)
    return R


def resample_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resample [..., L] -> [..., out_len] with torch-linear coefficients."""
    R = torch.from_numpy(interp_matrix(x.shape[-1], out_len).copy()).to(x.device, x.dtype)
    return x @ R
