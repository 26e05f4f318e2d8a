"""Modules that carry the per-sample mask through the network.

hippie_tpu threads ``mask`` through explicit apply functions; here it rides
as a second argument of ``forward``. ``MaskedBatchNorm1d`` registers the same
parameters and buffers as ``nn.BatchNorm1d`` (so ``state_dict`` keys match
torch's), and ``MaskedSequential`` hands the mask to the children that take
one, so ``nn.Sequential`` indices (``encoder_fc.1.weight``) keep their names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hippie_tpu_torch.nn import functional as F


class MaskedBatchNorm1d(nn.Module):
    """nn.BatchNorm1d with a per-sample mask (see functional.batch_norm)."""

    takes_mask = True

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))
        self.register_buffer("num_batches_tracked", torch.empty((), dtype=torch.long))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return F.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.num_batches_tracked, training=self.training,
            momentum=self.momentum, eps=self.eps, mask=mask,
        )


class MaskedSequential(nn.Sequential):
    """nn.Sequential whose ``forward(x, mask)`` passes the mask to the
    children that take one: those whose class sets ``takes_mask``."""

    takes_mask = True

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for module in self:
            x = module(x, mask) if getattr(module, "takes_mask", False) else module(x)
        return x
