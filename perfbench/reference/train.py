"""The plain reference of the training step: forward, loss, backward, the
global-norm clip and AdamW, in float32 torch operations over a state dict.

AdamW is written out as torch.optim.AdamW computes it (decoupled weight
decay first, then the bias-corrected moments; b1 0.9, b2 0.999, eps 1e-8);
the clip is Lightning's ``gradient_clip_val`` by the global norm: every
gradient times ``clip / norm`` where the norm is at least ``clip``. A
trained leaf the loss does not reach (the class embedding, with no class
labels) has a zero gradient, so only the decay moves it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from perfbench.reference import cvae
from perfbench.reference.numerics import Numerics

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Hyper(NamedTuple):
    lr: float
    weight_decay: float
    clip: float
    beta: float
    modality_weights: tuple


class Steps(NamedTuple):
    """What the comparison reads from a few training steps: each step's
    loss and its two terms (the modalities' squared error, unweighted, and
    the KL divergence), the BatchNorm layers' running variances after the
    first step (the forward's statistics of every layer), the first step's
    gradients as the optimizer got them (after the clip), and the trained
    leaves after the last step."""

    losses: List[float]
    mses: List[float]
    kls: List[float]
    running_var1: Dict[str, torch.Tensor]
    grad1: Dict[str, torch.Tensor]
    params: Dict[str, torch.Tensor]


def clip_(grads: List[torch.Tensor], clip: float):
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    if norm >= clip:
        for g in grads:
            g.mul_(clip / norm)


def run_steps(P0: Dict[str, torch.Tensor], arch: cvae.Arch, batches, hp: Hyper, nx: Numerics) -> Steps:
    """``len(batches)`` training steps from the weights ``P0`` (left
    untouched). Each batch is ``(inputs, source, eps)``: the real rows'
    preprocessed modalities, their source ids and their noise."""
    keys = cvae.trained_keys(arch)
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    m = {k: torch.zeros_like(P[k]) for k in keys}
    v = {k: torch.zeros_like(P[k]) for k in keys}
    losses, mses, kls, grad1 = [], [], [], None
    for t, (inputs, source, eps) in enumerate(batches, start=1):
        for k in keys:
            P[k].requires_grad_(True)
        outs = cvae.forward(P, arch, inputs, source, eps, nx, training=True)
        total = cvae.loss(inputs, outs, hp.beta, hp.modality_weights)
        mses.append(float(cvae.loss(inputs, outs, 0.0, (1.0, 1.0)).detach()))
        kls.append(float(cvae.loss(inputs, outs, 1.0, (0.0, 0.0)).detach()))
        got = torch.autograd.grad(total, [P[k] for k in keys], allow_unused=True)
        grads = [torch.zeros_like(P[k]) if g is None else g for k, g in zip(keys, got)]
        losses.append(float(total.detach()))
        if t == 1:
            running_var1 = {k: P[k].clone() for k in P if k.endswith(".running_var")}
        with torch.no_grad():
            clip_(grads, hp.clip)
            if grad1 is None:
                grad1 = {k: g.clone() for k, g in zip(keys, grads)}
            bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            for k, g in zip(keys, grads):
                p = P[k].detach()
                p.mul_(1.0 - hp.lr * hp.weight_decay)
                m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                v[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-hp.lr / bc1)
                P[k] = p
    return Steps(losses, mses, kls, running_var1, grad1, {k: P[k].detach() for k in keys})
