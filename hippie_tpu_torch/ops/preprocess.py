"""Whole-dataset preprocessing on the device.

Counterpart of hippie_tpu/ops/preprocess.py (reference
hippie/dataloading.py:27-56, 74-101), one vectorized call per dataset:

  waveform:  [optional min-max to [-1, 1]]  ->  linear resample to 50
  isi:       log(x + 1)  ->  [optional z-score]  ->  linear resample to 100

Normalize before resample, and the unbiased std (torch ``.std()``), as the
reference does. The shipped pipelines use ``normalize=False``; both paths are
kept. ``preprocess_pair_padded`` is the serving counterpart for rows
zero-padded to fixed width caps, and ``preprocess_pair_exact`` the serving
path's preprocess_pair for wider rows; both take their coefficients as
device tensors, so that they run inside the server's CUDA graphs
(evaluate/eval_graph.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hippie_tpu_torch.ops.resample import padded_interp_matrix, resample_linear

WAVE_LEN = 50
ISI_LEN = 100


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=torch.float32)


def preprocess_waveforms(wf, *, normalize: bool = False, out_len: int = WAVE_LEN,
                         device="cuda") -> torch.Tensor:
    """[N, W_raw] -> [N, out_len] float32 on ``device`` (dataloading.py:75,81-93)."""
    return resample_linear(_waveforms(_as_f32(wf, device), normalize), out_len)


def preprocess_isi(isi, *, normalize: bool = False, out_len: int = ISI_LEN,
                   device="cuda") -> torch.Tensor:
    """[N, W_raw] -> [N, out_len] float32 on ``device`` (dataloading.py:77-78,90,95-96)."""
    return resample_linear(_isi(_as_f32(isi, device), normalize), out_len)


def _waveforms(wf: torch.Tensor, normalize: bool) -> torch.Tensor:
    """preprocess_waveforms before the resample."""
    if normalize:
        mn = wf.amin(dim=1, keepdim=True)
        mx = wf.amax(dim=1, keepdim=True)
        wf = (wf - mn) / (mx - mn)
        wf = wf * 2.0 - 1.0
    return wf


def _isi(isi: torch.Tensor, normalize: bool) -> torch.Tensor:
    """preprocess_isi before the resample."""
    isi = torch.log(isi + 1.0)
    if normalize:
        mean = isi.mean(dim=1, keepdim=True)
        var = (isi - mean).square().sum(dim=1, keepdim=True) / (isi.shape[1] - 1)
        isi = (isi - mean) / torch.sqrt(var)
    return isi


def preprocess_pair(wf, isi, *, normalize: bool = False, device="cuda"):
    """Both modalities: (wave [N, 50], isi [N, 100])."""
    return (
        preprocess_waveforms(wf, normalize=normalize, device=device),
        preprocess_isi(isi, normalize=normalize, device=device),
    )


def preprocess_pair_exact(wf: torch.Tensor, isi: torch.Tensor, R_wf: torch.Tensor, R_isi: torch.Tensor, *,
                          normalize: bool = False):
    """preprocess_pair of float32 rows on their device with the resample
    coefficients given (``interp_matrix`` of the rows' widths as tensors
    there), so that no coefficient is uploaded: the server's exact-width
    path inside a CUDA graph. Bit for bit preprocess_pair."""
    return _waveforms(wf, normalize) @ R_wf, _isi(isi, normalize) @ R_isi


@functools.lru_cache(maxsize=64)
def device_interp_matrix(in_len: int, out_len: int, cap: int, device: str) -> torch.Tensor:
    """``padded_interp_matrix`` as a float32 tensor on ``device``, kept there
    per geometry so a request does not upload it again."""
    return torch.from_numpy(padded_interp_matrix(in_len, out_len, cap).copy()).to(device)


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` rounded as a division by the Python float ``float(n)`` is:
    torch divides by a Python number on the CPU, and multiplies by its
    float32 reciprocal on CUDA, so a 0-d tensor ``n`` on CUDA takes the
    reciprocal too."""
    if isinstance(n, torch.Tensor) and x.is_cuda:
        return x * torch.reciprocal(n)
    return x / n


def preprocess_pair_padded(wf: torch.Tensor, isi: torch.Tensor, R_wf: torch.Tensor,
                           R_isi: torch.Tensor, wf_width, isi_width, *,
                           normalize: bool = False):
    """The width-agnostic preprocess_pair of the server: ``wf`` [N, W_cap]
    and ``isi`` [N, I_cap] are the raw rows zero-padded on the width axis,
    ``R_wf`` / ``R_isi`` the padded coefficient matrices
    (``device_interp_matrix``, zero rows past the true widths) and
    ``wf_width`` / ``isi_width`` the true widths: Python ints, or 0-d
    integer tensors on the rows' device, so that one CUDA graph per row
    bucket serves every width up to the caps (the JAX program's traced
    int32 scalars). Both give the same bits. The normalisation's
    min/max and mean/variance (unbiased) are masked to the true widths; the
    zero coefficient rows remove the padded columns from every output, which
    must be finite. Agrees with preprocess_pair on the unpadded rows to
    float32 rounding (the sums' order differs)."""
    wf = wf.to(torch.float32)
    isi = isi.to(torch.float32)
    if normalize:
        wmask = torch.arange(wf.shape[1], device=wf.device)[None, :] < wf_width
        mn = torch.where(wmask, wf, torch.inf).amin(dim=1, keepdim=True)
        mx = torch.where(wmask, wf, -torch.inf).amax(dim=1, keepdim=True)
        wf = ((wf - mn) / (mx - mn)) * 2.0 - 1.0
    wave = wf @ R_wf
    li = torch.log(isi + 1.0)
    if normalize:
        imask = torch.arange(li.shape[1], device=li.device)[None, :] < isi_width
        # widths are small integers, exact in float32
        n = isi_width.to(torch.float32) if isinstance(isi_width, torch.Tensor) else float(isi_width)
        mean = _div(torch.where(imask, li, 0.0).sum(dim=1, keepdim=True), n)
        var = _div(torch.where(imask, (li - mean).square(), 0.0).sum(dim=1, keepdim=True), n - 1.0)
        li = (li - mean) / torch.sqrt(var)
    return wave, li @ R_isi
