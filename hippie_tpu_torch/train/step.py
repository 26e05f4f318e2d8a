"""Unimodal train/eval steps and the epoch over a ``[nb, B]`` index plan.

Counterpart of the unimodal parts of hippie_tpu/train/step.py. One train step
is forward, loss, backward and AdamW; the BatchNorm running statistics update
in place during the forward. The JAX package traces the epoch into one
program; here it is a Python loop of eager steps. The dataset is
device-resident and each epoch gathers all its batches at once.

``loss_backend`` keeps the JAX package's names, so ``--loss-backend
{xla,pallas}`` carries over: ``"xla"`` is ops/losses.py:vae_loss in eager torch
ops, ``"pallas"`` is the hand-written CUDA kernel of ops/cuda_ops.py (its
plain version on CPU tensors). Reparameterization noise comes from a
``torch.Generator`` on the data's device, or is injected as ``eps``.
Nothing in a step waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hippie_tpu_torch.models.cvae import UnimodalCVAE
from hippie_tpu_torch.ops import cuda_ops, losses


class TrainState(NamedTuple):
    """The model (parameters and BN buffers) and its optimizer; both are
    updated in place by a step."""

    model: UnimodalCVAE
    optimizer: torch.optim.Optimizer


class Metrics(NamedTuple):
    loss: torch.Tensor
    mse: torch.Tensor
    kl: torch.Tensor


def _select_vae_loss(loss_backend: str):
    if loss_backend == "pallas":
        return cuda_ops.vae_loss_pallas
    if loss_backend == "xla":
        return losses.vae_loss
    raise ValueError(f"loss_backend must be 'xla' or 'pallas', got {loss_backend!r}")


def make_unimodal_steps(*, beta: float = 1.0, loss_backend: str = "xla"):
    """Build the per-batch (batch_step, eval_step) pair for the unimodal cVAE.

    batch_step(ts, bd, bs, bc, bmask, *, eps=None, generator=None) -> (ts, Metrics)
    eval_step(model, bd, bs, bc, bmask, *, eps=None, generator=None) -> Metrics

    ``bc`` is the class-label batch, or None for no class conditioning.
    eval_step uses the running BN statistics and, like the reference's
    validation_step, still samples the reparameterization.
    """
    vae_loss = _select_vae_loss(loss_backend)

    def batch_step(ts: TrainState, bd, bs, bc, bmask, *, eps=None, generator=None):
        model, opt = ts
        model.train()
        opt.zero_grad(set_to_none=True)
        enc, mu, logvar, dec = model(bd, bs, bc, eps=eps, generator=generator, mask=bmask)
        total, (mse, kl) = vae_loss(bd, dec, mu, logvar, beta=beta, mask=bmask)
        total.backward()
        opt.step()
        return ts, Metrics(total.detach(), mse.detach(), kl.detach())

    @torch.no_grad()
    def eval_step(model, bd, bs, bc, bmask, *, eps=None, generator=None):
        model.eval()
        enc, mu, logvar, dec = model(bd, bs, bc, eps=eps, generator=generator, mask=bmask)
        total, (mse, kl) = vae_loss(bd, dec, mu, logvar, beta=beta, mask=bmask)
        return Metrics(total, mse, kl)

    return batch_step, eval_step


def _stack(ms) -> Metrics:
    return Metrics(*(torch.stack(x) for x in zip(*ms)))


def make_unimodal_epoch_fns(*, beta: float = 1.0, use_class_labels: bool = False,
                            loss_backend: str = "xla"):
    """Build (train_epoch, eval_epoch) for the unimodal cVAE.

    train_epoch(ts, data, source, class_, idx, mask, *, generator=None, eps=None)
        -> (ts, Metrics of [nb] tensors)
    eval_epoch(model, data, source, class_, idx, mask, *, generator=None, eps=None)
        -> Metrics of [nb] tensors

    ``data`` is the full [N, L] modality array on the device; ``idx``/``mask``
    the [nb, B] plan of data/device_data.py:batch_plan (numpy or tensors).
    ``eps`` ([nb, B, z]) injects each step's noise; otherwise it comes from
    ``generator``. Loss follows model.py:95-116: mse over elements + beta *
    mean KL.
    """
    batch_step, eval_step = make_unimodal_steps(beta=beta, loss_backend=loss_backend)

    def _batches(data, source, class_, idx, mask):
        idx = torch.as_tensor(idx, device=data.device).long()
        mask = torch.as_tensor(mask, device=data.device, dtype=data.dtype)
        # one whole-epoch gather; the loop then takes leading-axis slices
        bc_all = class_[idx] if use_class_labels else [None] * idx.shape[0]
        return data[idx], source[idx], bc_all, mask

    def _noise(eps, i):
        return None if eps is None else eps[i]

    def train_epoch(ts: TrainState, data, source, class_, idx, mask, *,
                    generator: Optional[torch.Generator] = None, eps=None):
        bd_all, bs_all, bc_all, mask = _batches(data, source, class_, idx, mask)
        ms = []
        for i in range(bd_all.shape[0]):
            ts, m = batch_step(ts, bd_all[i], bs_all[i], bc_all[i], mask[i],
                               eps=_noise(eps, i), generator=generator)
            ms.append(m)
        return ts, _stack(ms)

    def eval_epoch(model, data, source, class_, idx, mask, *,
                   generator: Optional[torch.Generator] = None, eps=None):
        bd_all, bs_all, bc_all, mask = _batches(data, source, class_, idx, mask)
        return _stack([
            eval_step(model, bd_all[i], bs_all[i], bc_all[i], mask[i],
                      eps=_noise(eps, i), generator=generator)
            for i in range(bd_all.shape[0])
        ])

    return train_epoch, eval_epoch
