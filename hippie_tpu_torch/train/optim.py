"""AdamW with torch semantics, plus the optional global-norm clip.

Counterpart of the AdamW path of hippie_tpu/train/optim.py:make_optimizer.
The reference uses plain ``optim.AdamW(lr, weight_decay)`` (model.py:93,262)
with b1=0.9, b2=0.999, eps=1e-8 and decoupled weight decay, and Lightning's
global-norm gradient clipping on some trainers (quirk Q7). The clip here is
optax.clip_by_global_norm's: grads scale by clip/norm when norm > clip, with
no epsilon, computed on the device without a host sync.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float):
    """Scale ``grads`` in place so their joint L2 norm is at most ``max_norm``."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class AdamW(torch.optim.AdamW):
    """torch.optim.AdamW(b1=0.9, b2=0.999, eps=1e-8) with an optional clip of
    the gradients' global norm before each step."""

    def __init__(self, params: Iterable, lr: float, weight_decay: float = 0.01,
                 clip_val: Optional[float] = None):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.clip_val = clip_val

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_val is not None:
            grads = [p.grad for group in self.param_groups for p in group["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_val)
        return super().step(closure)


def make_optimizer(params: Iterable, learning_rate: float, weight_decay: float = 0.01,
                   clip_val: Optional[float] = None) -> AdamW:
    """AdamW (+ optional global-norm clipping) over ``params``."""
    return AdamW(params, lr=learning_rate, weight_decay=weight_decay, clip_val=clip_val)
