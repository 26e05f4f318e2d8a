"""Torch-default parameter initializers drawn from an explicit generator.

Counterpart of hippie_tpu/nn/init.py. nn.Conv1d / nn.Linear reset_parameters
(kaiming_uniform_(a=sqrt(5))) reduce to U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
weights and biases; nn.Embedding is N(0, 1). Here every draw comes from the
``torch.Generator`` the caller passes, so a seed fixes the model without
touching torch's global generator. The bits differ from jax.random's; parity
tests carry weights across with train/checkpoint.py instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from hippie_tpu_torch.nn.modules import MaskedBatchNorm1d


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def conv1d_(conv: nn.Conv1d, generator: torch.Generator):
    """Weight [C_out, C_in, K] and bias with fan_in = C_in * K."""
    bound = 1.0 / math.sqrt(conv.in_channels * conv.kernel_size[0])
    _uniform_(conv.weight, bound, generator)
    if conv.bias is not None:
        _uniform_(conv.bias, bound, generator)


@torch.no_grad()
def dense_(linear: nn.Linear, generator: torch.Generator):
    """Weight [out, in] and bias with fan_in = in."""
    bound = 1.0 / math.sqrt(linear.in_features)
    _uniform_(linear.weight, bound, generator)
    if linear.bias is not None:
        _uniform_(linear.bias, bound, generator)


@torch.no_grad()
def embedding_(emb: nn.Embedding, generator: torch.Generator):
    emb.weight.normal_(0.0, 1.0, generator=generator)


def reset_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter and buffer of ``model`` in module order."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d):
            conv1d_(m, generator)
        elif isinstance(m, nn.Linear):
            dense_(m, generator)
        elif isinstance(m, nn.Embedding):
            embedding_(m, generator)
        elif isinstance(m, MaskedBatchNorm1d):
            m.reset_parameters()
    return model
