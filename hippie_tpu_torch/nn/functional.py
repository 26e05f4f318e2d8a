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
import functools
from typing import Optional

import torch

from hippie_tpu_torch.parallel import mesh as pmesh


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """LeakyReLU as hippie_tpu's ``where(x >= 0, x, x * slope)``: slope 0.01 in
    the backbones, 0.2 in the fc heads.

    The values are torch's; the gradient at exactly 0 is 1, as in the JAX
    package and the block kernels (torch's ``F.leaky_relu`` gives the slope
    there). It shows where a BatchNorm over one real row outputs its bias, 0.
    On a bf16 ``x`` (the "bf16" block backend) the slope is rounded to bf16
    first, as JAX rounds a Python scalar to the array's dtype: 0.01 becomes
    0.010009765625.
    """
    if x.dtype != torch.float32:
        negative_slope = _slope_in(negative_slope, x.dtype)
    return torch.where(x >= 0, x, x * negative_slope)


@functools.lru_cache(maxsize=None)
def _slope_in(slope: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(slope, dtype=dtype))


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
    excluded from the batch statistics. A bf16 (or fp16) ``x`` is
    normalized in float32 and the result rounded back.

    Under an active mesh (parallel/mesh.py) the statistics are the global
    batch's: the count is ``row_count``, and the masked sum and then the
    centred sum of squares are each summed over the ranks (``cross_sum``,
    whose backward sums the cotangents, so the backward reduces the sums of
    dy and dy * x_hat too). That is this function's single-process
    computation with two cross-rank sums inserted; at one rank it is the
    same bits. Every rank gets the same mean, variance and Bessel factor, so
    the running-statistic EMA stays bit-equal across ranks.
    """
    if x.dtype in (torch.bfloat16, torch.float16):
        # the "bf16" block backend: statistics and the running-stat EMA in
        # float32 (a bf16 sum over B*L elements loses about two digits), the
        # output back in the activation's dtype, as hippie_tpu's batch_norm
        return batch_norm(x.float(), weight, bias, running_mean, running_var, num_batches_tracked,
                          training=training, momentum=momentum, eps=eps, mask=mask).to(x.dtype)
    dims, per_sample, shape = _stat_dims(x)
    if not training:
        inv = torch.rsqrt(running_var + eps)
        return ((x - running_mean.view(shape)) * inv.view(shape) * weight.view(shape)
                + bias.view(shape))

    mesh = pmesh.active()
    if mesh is not None:
        if mask is None:
            mask = x.new_ones(x.shape[0])
        mb = mask.to(x.dtype).view((x.shape[0],) + (1,) * (x.ndim - 1))
        n = pmesh.row_count(mask).to(x.dtype) * per_sample
        mean = pmesh.cross_sum((x * mb).sum(dims)) / n
        var = pmesh.cross_sum(((x - mean.view(shape)).square() * mb).sum(dims)) / n
        bessel = n / torch.clamp(n - 1.0, min=1.0)
    elif mask is None:
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
