"""The plain reference of the data preprocessing (HIPPIE ``dataloading.py``):
each waveform linearly resampled to 50 samples, each ISI histogram taken
as ``log(x + 1)`` and resampled to 100 bins, with
``F.interpolate(mode="linear", align_corners=False)`` as the published code
calls it per sample. ``normalize`` is off in every shipped pipeline and in
every cell, so its branch is not written here. Rows are the raw CSV rows
as loaded (the index column kept, as ``pd.read_csv`` keeps it).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WAVE_LEN = 50
ISI_LEN = 100


def _resample(x: torch.Tensor, n: int) -> torch.Tensor:
    return F.interpolate(x[:, None, :], size=(n,), mode="linear", align_corners=False)[:, 0, :]


def preprocess(wf: np.ndarray, isi: np.ndarray, device) -> tuple:
    """Raw ``[N, W]`` waveforms and ``[N, I]`` ISI rows (float32) -> ``([N, 50], [N, 100])`` float32."""
    w = torch.as_tensor(np.ascontiguousarray(wf, np.float32), device=device)
    i = torch.as_tensor(np.ascontiguousarray(isi, np.float32), device=device)
    return _resample(w, WAVE_LEN), _resample(torch.log(i + 1.0), ISI_LEN)
