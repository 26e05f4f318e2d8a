"""Train/eval steps and the epoch over a ``[nb, B]`` index plan, for the
unimodal and the joint (wave + ISI) cVAE.

Counterpart of hippie_tpu/train/step.py. One train step is forward, loss,
backward and AdamW; the BatchNorm running statistics update in place during
the forward. The JAX package traces the epoch into one program; here it is a
Python loop of eager steps. The dataset is device-resident and each epoch
gathers all its batches at once.

``loss_backend`` and ``block_backend`` keep the JAX package's names, so
``--loss-backend {xla,pallas}`` and ``--block-backend {xla,pallas}`` carry
over. Loss: ``"xla"`` is ops/losses.py in eager torch ops, ``"pallas"`` the
hand-written CUDA kernels of ops/cuda_ops.py. Blocks: ``"xla"``
runs the backbones' BasicBlocks as torch convolutions and masked BatchNorm,
``"pallas"`` through the fused block kernels of ops/cuda_blocks.py in training
steps (eval steps stay on ``"xla"``, as the JAX package's do). Either kernel
takes its plain version on CPU tensors. Reparameterization noise comes from a
``torch.Generator`` on the data's device, or is injected as ``eps``; every
train and eval step and epoch raises ``ValueError`` when given neither, as
the JAX steps take their key as a required argument (a step without noise
would decode ``mu`` and train a plain autoencoder). The models' forward keeps
its deterministic ``mu`` path for the embeddings. Nothing in a step waits for
the host.

A parameter the loss does not reach (the class embedding, trained without
class labels) gets a zero gradient before the optimizer step, so torch's
AdamW decays it by (1 - lr * wd) as optax's adamw does in the JAX step; its
Adam moments stay 0, so the decay is its only update.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from hippie_tpu_torch.models.backbones import check_backend
from hippie_tpu_torch.models.cvae import MultiModalCVAE, UnimodalCVAE
from hippie_tpu_torch.ops import cuda_ops, losses


class TrainState(NamedTuple):
    """The model (parameters and BN buffers) and its optimizer; both are
    updated in place by a step."""

    model: Union[UnimodalCVAE, MultiModalCVAE]
    optimizer: torch.optim.Optimizer


class Metrics(NamedTuple):
    loss: torch.Tensor
    mse: torch.Tensor
    kl: torch.Tensor


def _select_loss(loss_backend: str, xla, pallas):
    if loss_backend == "pallas":
        return pallas
    if loss_backend == "xla":
        return xla
    raise ValueError(f"loss_backend must be 'xla' or 'pallas', got {loss_backend!r}")


def _require_noise(eps, generator):
    if eps is None and generator is None:
        raise ValueError("the reparameterization needs noise: pass eps or a torch.Generator")


def _optimizer_step(opt: torch.optim.Optimizer):
    """opt.step() with a zero gradient for every parameter the backward pass
    left without one (see the module note); no host sync."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def make_unimodal_steps(*, beta: float = 1.0, loss_backend: str = "xla",
                        block_backend: str = "xla"):
    """Build the per-batch (batch_step, eval_step) pair for the unimodal cVAE.

    batch_step(ts, bd, bs, bc, bmask, *, eps=None, generator=None) -> (ts, Metrics)
    eval_step(model, bd, bs, bc, bmask, *, eps=None, generator=None) -> Metrics

    ``bc`` is the class-label batch, or None for no class conditioning. The
    noise is ``eps`` [B, z] or drawn from ``generator``; one is required.
    eval_step uses the running BN statistics and, like the reference's
    validation_step, still samples the reparameterization.
    """
    vae_loss = _select_loss(loss_backend, losses.vae_loss, cuda_ops.vae_loss_pallas)
    check_backend(block_backend)

    def batch_step(ts: TrainState, bd, bs, bc, bmask, *, eps=None, generator=None):
        _require_noise(eps, generator)
        model, opt = ts
        model.train()
        opt.zero_grad(set_to_none=True)
        enc, mu, logvar, dec = model(bd, bs, bc, eps=eps, generator=generator, mask=bmask,
                                     backend=block_backend)
        total, (mse, kl) = vae_loss(bd, dec, mu, logvar, beta=beta, mask=bmask)
        total.backward()
        _optimizer_step(opt)
        return ts, Metrics(total.detach(), mse.detach(), kl.detach())

    @torch.no_grad()
    def eval_step(model, bd, bs, bc, bmask, *, eps=None, generator=None):
        _require_noise(eps, generator)
        model.eval()
        enc, mu, logvar, dec = model(bd, bs, bc, eps=eps, generator=generator, mask=bmask)
        total, (mse, kl) = vae_loss(bd, dec, mu, logvar, beta=beta, mask=bmask)
        return Metrics(total, mse, kl)

    return batch_step, eval_step


def _stack(ms) -> Metrics:
    return Metrics(*(torch.stack(x) for x in zip(*ms)))


def _plan(idx, mask, device, dtype):
    """The [nb, B] plan as a long index tensor and a mask of the data's dtype."""
    return (torch.as_tensor(idx, device=device).long(),
            torch.as_tensor(mask, device=device, dtype=dtype))


def _noise(eps, i):
    return None if eps is None else eps[i]


def make_unimodal_epoch_fns(*, beta: float = 1.0, use_class_labels: bool = False,
                            loss_backend: str = "xla", block_backend: str = "xla"):
    """Build (train_epoch, eval_epoch) for the unimodal cVAE.

    train_epoch(ts, data, source, class_, idx, mask, *, generator=None, eps=None)
        -> (ts, Metrics of [nb] tensors)
    eval_epoch(model, data, source, class_, idx, mask, *, generator=None, eps=None)
        -> Metrics of [nb] tensors

    ``data`` is the full [N, L] modality array on the device; ``idx``/``mask``
    the [nb, B] plan of data/device_data.py:batch_plan (numpy or tensors).
    ``eps`` ([nb, B, z]) injects each step's noise; otherwise it comes from
    ``generator``; one of the two is required. Loss follows model.py:95-116: mse over elements + beta *
    mean KL.
    """
    batch_step, eval_step = make_unimodal_steps(beta=beta, loss_backend=loss_backend,
                                                block_backend=block_backend)

    def _batches(data, source, class_, idx, mask):
        idx, mask = _plan(idx, mask, data.device, data.dtype)
        # one whole-epoch gather; the loop then takes leading-axis slices
        bc_all = class_[idx] if use_class_labels else [None] * idx.shape[0]
        return data[idx], source[idx], bc_all, mask

    def train_epoch(ts: TrainState, data, source, class_, idx, mask, *,
                    generator: Optional[torch.Generator] = None, eps=None):
        _require_noise(eps, generator)
        bd_all, bs_all, bc_all, mask = _batches(data, source, class_, idx, mask)
        ms = []
        for i in range(bd_all.shape[0]):
            ts, m = batch_step(ts, bd_all[i], bs_all[i], bc_all[i], mask[i],
                               eps=_noise(eps, i), generator=generator)
            ms.append(m)
        return ts, _stack(ms)

    def eval_epoch(model, data, source, class_, idx, mask, *,
                   generator: Optional[torch.Generator] = None, eps=None):
        _require_noise(eps, generator)
        bd_all, bs_all, bc_all, mask = _batches(data, source, class_, idx, mask)
        return _stack([
            eval_step(model, bd_all[i], bs_all[i], bc_all[i], mask[i],
                      eps=_noise(eps, i), generator=generator)
            for i in range(bd_all.shape[0])
        ])

    return train_epoch, eval_epoch


def make_multimodal_steps(*, beta: float = 1.0, mod1_weight: float = 1.0,
                          mod2_weight: float = 1.0, loss_backend: str = "xla",
                          block_backend: str = "xla"):
    """Per-batch (batch_step, eval_step) for the joint MultiModalCVAE, the
    two-data-array counterpart of make_unimodal_steps.

    batch_step(ts, b1, b2, bs, bc, bmask, *, eps=None, generator=None) -> (ts, Metrics)
    eval_step(model, b1, b2, bs, bc, bmask, *, eps=None, generator=None) -> Metrics

    ``b1`` is the waveform batch [B, 50], ``b2`` the ISI batch [B, 100].
    ``Metrics.mse`` is mse1 + mse2 (unweighted), as in the JAX step.
    """
    loss_fn = _select_loss(loss_backend, losses.multimodal_vae_loss,
                           cuda_ops.multimodal_vae_loss_pallas)
    check_backend(block_backend)

    def loss(b1, b2, outs, bmask):
        _, mu, logvar, d1, d2 = outs
        total, (mse1, mse2, kl) = loss_fn(b1, b2, d1, d2, mu, logvar, beta=beta,
                                          mod1_weight=mod1_weight, mod2_weight=mod2_weight,
                                          mask=bmask)
        return total, mse1 + mse2, kl

    def batch_step(ts: TrainState, b1, b2, bs, bc, bmask, *, eps=None, generator=None):
        _require_noise(eps, generator)
        model, opt = ts
        model.train()
        opt.zero_grad(set_to_none=True)
        outs = model(b1, b2, bs, bc, eps=eps, generator=generator, mask=bmask,
                     backend=block_backend)
        total, mse, kl = loss(b1, b2, outs, bmask)
        total.backward()
        _optimizer_step(opt)
        return ts, Metrics(total.detach(), mse.detach(), kl.detach())

    @torch.no_grad()
    def eval_step(model, b1, b2, bs, bc, bmask, *, eps=None, generator=None):
        _require_noise(eps, generator)
        model.eval()
        outs = model(b1, b2, bs, bc, eps=eps, generator=generator, mask=bmask)
        return Metrics(*loss(b1, b2, outs, bmask))

    return batch_step, eval_step


def make_multimodal_epoch_fns(*, beta: float = 1.0, mod1_weight: float = 1.0,
                              mod2_weight: float = 1.0, use_class_labels: bool = False,
                              loss_backend: str = "xla", block_backend: str = "xla"):
    """Build (train_epoch, eval_epoch) for the joint MultiModalCVAE.

    train_epoch(ts, wave, isi, source, class_, idx, mask, *, generator=None, eps=None)
        -> (ts, Metrics of [nb] tensors)
    eval_epoch(model, wave, isi, source, class_, idx, mask, *, generator=None, eps=None)
        -> Metrics of [nb] tensors

    The unimodal epoch's contract with the (wave [N, 50], isi [N, 100]) pair;
    loss as model.py:454-482.
    """
    batch_step, eval_step = make_multimodal_steps(
        beta=beta, mod1_weight=mod1_weight, mod2_weight=mod2_weight,
        loss_backend=loss_backend, block_backend=block_backend)

    def _batches(wave, isi, source, class_, idx, mask):
        idx, mask = _plan(idx, mask, wave.device, wave.dtype)
        # one whole-epoch gather of both arrays; the loop then takes leading-axis slices
        bc_all = class_[idx] if use_class_labels else [None] * idx.shape[0]
        return wave[idx], isi[idx], source[idx], bc_all, mask

    def train_epoch(ts: TrainState, wave, isi, source, class_, idx, mask, *,
                    generator: Optional[torch.Generator] = None, eps=None):
        _require_noise(eps, generator)
        b1_all, b2_all, bs_all, bc_all, mask = _batches(wave, isi, source, class_, idx, mask)
        ms = []
        for i in range(b1_all.shape[0]):
            ts, m = batch_step(ts, b1_all[i], b2_all[i], bs_all[i], bc_all[i], mask[i],
                               eps=_noise(eps, i), generator=generator)
            ms.append(m)
        return ts, _stack(ms)

    def eval_epoch(model, wave, isi, source, class_, idx, mask, *,
                   generator: Optional[torch.Generator] = None, eps=None):
        _require_noise(eps, generator)
        b1_all, b2_all, bs_all, bc_all, mask = _batches(wave, isi, source, class_, idx, mask)
        return _stack([
            eval_step(model, b1_all[i], b2_all[i], bs_all[i], bc_all[i], mask[i],
                      eps=_noise(eps, i), generator=generator)
            for i in range(b1_all.shape[0])
        ])

    return train_epoch, eval_epoch
