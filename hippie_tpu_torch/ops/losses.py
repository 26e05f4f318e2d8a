"""cVAE loss (reconstruction MSE + beta-weighted KL) in eager torch ops.

Counterpart of hippie_tpu/ops/losses.py, the ``loss_backend="xla"`` path.
Reference math (hippie/model.py:103-109):
  mse  = F.mse_loss(data, dec)                                 # mean over all elems
  kl   = -0.5 * sum(1 + logvar - mu^2 - exp(logvar), axis=1)   # per sample
  loss = mse + beta * kl.mean()

An optional per-sample ``mask`` makes a padded tail batch contribute exactly
the unpadded batch's loss.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], per_sample_elems: int):
    """Mean of x over all elements, counting only rows with mask=1."""
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    mb = m.view((x.shape[0],) + (1,) * (x.ndim - 1))
    return (x * mb).sum() / (m.sum() * per_sample_elems)


def _guard_rows(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero padded rows BEFORE any nonlinearity of the loss.

    Padded rows are outside the batch statistics, so their activations are
    unconstrained (in a 1-real-row tail every [B, C] BatchNorm has variance 0
    and can drive them to ~1e7); ``exp(logvar)`` would overflow and a
    mask-multiply would compute inf * 0 = NaN, in the value or in its
    gradient. ``where`` keeps both finite; real rows are untouched.
    """
    if mask is None:
        return x
    keep = (mask != 0).view((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(keep, x, x.new_zeros(()))


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(N(mu, sigma^2) || N(0, 1)), summed over the latent axis."""
    return -0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar), dim=1)


def vae_loss(
    data: torch.Tensor,
    dec: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    *,
    beta: float = 1.0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Unimodal loss. data/dec: [B, L]; mu/logvar: [B, z].

    Returns (total, (mse, kl_mean)).
    """
    mu = _guard_rows(mu, mask)
    logvar = _guard_rows(logvar, mask)
    mse = _masked_mean(_guard_rows(data - dec, mask).square(), mask, data.shape[1])
    kl = _masked_mean(kl_divergence(mu, logvar), mask, 1)
    return mse + beta * kl, (mse, kl)


def multimodal_vae_loss(
    data1: torch.Tensor,
    data2: torch.Tensor,
    dec1: torch.Tensor,
    dec2: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    *,
    beta: float = 1.0,
    mod1_weight: float = 1.0,
    mod2_weight: float = 1.0,
    mask: Optional[torch.Tensor] = None,
):
    """Joint loss (model.py:465-474). Returns (total, (mse1, mse2, kl_mean))."""
    mu = _guard_rows(mu, mask)
    logvar = _guard_rows(logvar, mask)
    mse1 = _masked_mean(_guard_rows(data1 - dec1, mask).square(), mask, data1.shape[1])
    mse2 = _masked_mean(_guard_rows(data2 - dec2, mask).square(), mask, data2.shape[1])
    kl = _masked_mean(kl_divergence(mu, logvar), mask, 1)
    total = mod1_weight * mse1 + mod2_weight * mse2 + beta * kl
    return total, (mse1, mse2, kl)
