"""Whole-dataset preprocessing on the device.

Counterpart of hippie_tpu/ops/preprocess.py (reference
hippie/dataloading.py:27-56, 74-101), one vectorized call per dataset:

  waveform:  [optional min-max to [-1, 1]]  ->  linear resample to 50
  isi:       log(x + 1)  ->  [optional z-score]  ->  linear resample to 100

Normalize before resample, and the unbiased std (torch ``.std()``), as the
reference does. The shipped pipelines use ``normalize=False``; both paths are
kept.
"""

from __future__ import annotations

import numpy as np
import torch

from hippie_tpu_torch.ops.resample import resample_linear

WAVE_LEN = 50
ISI_LEN = 100


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.float32)


def preprocess_waveforms(wf, *, normalize: bool = False, out_len: int = WAVE_LEN,
                         device="cuda") -> torch.Tensor:
    """[N, W_raw] -> [N, out_len] float32 on ``device`` (dataloading.py:75,81-93)."""
    wf = _as_f32(wf, device)
    if normalize:
        mn = wf.amin(dim=1, keepdim=True)
        mx = wf.amax(dim=1, keepdim=True)
        wf = (wf - mn) / (mx - mn)
        wf = wf * 2.0 - 1.0
    return resample_linear(wf, out_len)


def preprocess_isi(isi, *, normalize: bool = False, out_len: int = ISI_LEN,
                   device="cuda") -> torch.Tensor:
    """[N, W_raw] -> [N, out_len] float32 on ``device`` (dataloading.py:77-78,90,95-96)."""
    isi = torch.log(_as_f32(isi, device) + 1.0)
    if normalize:
        mean = isi.mean(dim=1, keepdim=True)
        var = (isi - mean).square().sum(dim=1, keepdim=True) / (isi.shape[1] - 1)
        isi = (isi - mean) / torch.sqrt(var)
    return resample_linear(isi, out_len)


def preprocess_pair(wf, isi, *, normalize: bool = False, device="cuda"):
    """Both modalities: (wave [N, 50], isi [N, 100])."""
    return (
        preprocess_waveforms(wf, normalize=normalize, device=device),
        preprocess_isi(isi, normalize=normalize, device=device),
    )
