"""Functional NN primitives with hippie_tpu's numerics, in torch layout.

Counterpart of hippie_tpu/nn/functional.py. Activations are torch's
channels-first ``[B, C, L]`` (the JAX package keeps ``[B, L, C]``); conv
weights are ``[C_out, C_in, K]`` and dense weights ``[out, in]``, so the
parameters are those of plain ``nn.Conv1d`` / ``nn.Linear`` modules.

BatchNorm follows torch semantics (the reference uses nn.BatchNorm1d):
normalization uses the *biased* batch variance in training, while the
running-variance EMA uses the *unbiased* estimate with divisor
``max(n - 1, 1)``; momentum 0.1; eps 1e-5. A per-sample ``mask`` keeps the
padded rows of a statically-shaped tail batch out of the statistics.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch leaky_relu: slope 0.01 in the backbones, 0.2 in the fc heads.

    Same values as hippie_tpu's ``where(x >= 0, x, x * slope)``; the gradient
    differs only at exactly 0 (1 there, ``slope`` here).
    """
    return F.leaky_relu(x, negative_slope)


def _stat_dims(x: torch.Tensor):
    """(reduce dims, per-sample element count, broadcast shape) for [B, C(, L)]."""
    if x.ndim == 2:
        return (0,), 1, (1, -1)
    if x.ndim == 3:
        return (0, 2), x.shape[2], (1, -1, 1)
    raise ValueError(f"batch_norm expects 2D/3D input, got {tuple(x.shape)}")


def batch_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    num_batches_tracked: torch.Tensor,
    *,
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """BatchNorm1d over ``[B, C]`` or ``[B, C, L]`` (stats over all but C).

    In training the three running buffers are updated in place (no autograd),
    as ``nn.BatchNorm1d`` does; hippie_tpu returns them as a new state
    instead. ``mask`` is an optional ``[B]`` vector: rows with mask 0 are
    excluded from the batch statistics.
    """
    dims, per_sample, shape = _stat_dims(x)
    if not training:
        inv = torch.rsqrt(running_var + eps)
        return ((x - running_mean.view(shape)) * inv.view(shape) * weight.view(shape)
                + bias.view(shape))

    if mask is None:
        n = float(x.shape[0] * per_sample)
        mean = x.mean(dims)
        var = (x - mean.view(shape)).square().mean(dims)
        bessel = n / max(n - 1.0, 1.0)
    else:
        mb = mask.to(x.dtype).view((x.shape[0],) + (1,) * (x.ndim - 1))
        n = mb.sum() * per_sample
        mean = (x * mb).sum(dims) / n
        var = ((x - mean.view(shape)).square() * mb).sum(dims) / n
        bessel = n / torch.clamp(n - 1.0, min=1.0)

    inv = torch.rsqrt(var + eps)
    y = (x - mean.view(shape)) * inv.view(shape) * weight.view(shape) + bias.view(shape)

    with torch.no_grad():
        unbiased_var = var * bessel
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * unbiased_var)
        num_batches_tracked.add_(1)
    return y


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """F.interpolate(mode='nearest', scale_factor=scale) on ``[B, C, L]``:
    each element repeats ``scale`` times along L."""
    return torch.repeat_interleave(x, scale, dim=2)


def adaptive_avg_pool_to_1(x: torch.Tensor) -> torch.Tensor:
    """F.adaptive_avg_pool1d(x, 1) on ``[B, C, L]`` -> ``[B, C]``."""
    return x.mean(dim=2)


@contextlib.contextmanager
def full_fp32():
    """Run convolutions and matmuls in full float32 on the card.

    cuDNN convolutions default to TF32 (about three decimal digits); this is
    the counterpart of hippie_tpu's ``jax.default_matmul_precision("highest")``.
    Restores the previous settings on exit.
    """
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
