"""Train/eval steps and the epoch over a ``[nb, B]`` index plan, for the
unimodal and the joint (wave + ISI) cVAE.

Counterpart of hippie_tpu/train/step.py. One train step is forward, loss,
backward and AdamW; the BatchNorm running statistics update in place during
the forward. The JAX package traces the epoch into one program; here it is a
Python loop of eager steps. The dataset is device-resident and each epoch
gathers all its batches at once.

``loss_backend`` and ``block_backend`` keep the JAX package's names, so
``--loss-backend {xla,pallas}`` and ``--block-backend {xla,bf16,fused,pallas}``
carry over. Loss: ``"xla"`` is ops/losses.py in eager torch ops, ``"pallas"``
the hand-written CUDA kernels of ops/cuda_ops.py. Blocks (models/
backbones.py): ``"xla"`` runs the backbones' BasicBlocks as torch
convolutions and masked BatchNorm, ``"bf16"`` the same on bf16 activations,
``"fused"`` the fused block math as eager torch ops, ``"pallas"`` through
the fused block kernels of ops/cuda_blocks.py, in training steps (eval
steps stay on ``"xla"``, as the JAX package's do). Either kernel takes its
plain version on CPU tensors. Reparameterization noise comes from a
``torch.Generator`` on the data's device, or is injected as ``eps``; every
train and eval step and epoch raises ``ValueError`` when given neither, as
the JAX steps take their key as a required argument (a step without noise
would decode ``mu`` and train a plain autoencoder). The models' forward keeps
its deterministic ``mu`` path for the embeddings. Nothing in a step waits for
the host, so the device fit loop (train/device_fit.py) captures a step in a
CUDA graph as it is: PyTorch's whole-network pattern, the gradients dropped
before the capture and allocated by the captured backward (the zero
gradients below too), so they keep their addresses across replays.

A parameter the loss does not reach (the class embedding, trained without
class labels) gets a zero gradient before the optimizer step, so torch's
AdamW decays it by (1 - lr * wd) as optax's adamw does in the JAX step; its
Adam moments stay 0, so the decay is its only update.

Under an active mesh (parallel/mesh.py) every step runs on this rank's
columns of the ``[nb, B]`` plan, the data-parallel step of the JAX package:
the global batch's noise ``[B, z]`` is drawn from the epoch's generator on
every rank, as the single process draws it, and sliced to this rank's rows;
the BatchNorm statistics and the loss's count are the global batch's; the
gradients are summed across ranks in one flat bucket before the optimizer
step (an FSDP optimizer, parallel/fsdp.py, reduce-scatters them itself);
and the epoch's metrics are summed across ranks, so every rank's fit loop
sees the same losses and decides the same. An injected ``eps`` is the
global batch's ``[nb, B, z]`` at the epoch and this rank's rows at a step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from hippie_tpu_torch.models.backbones import check_backend
from hippie_tpu_torch.models.cvae import MultiModalCVAE, UnimodalCVAE
from hippie_tpu_torch.ops import cuda_ops, losses
from hippie_tpu_torch.parallel import mesh as pmesh


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
    left without one (see the module note); no host sync. Under an active
    mesh the gradients are summed across ranks first (a sharded optimizer
    does its own reduction)."""
    if getattr(opt, "is_sharded", False):
        opt.step()
        return
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if pmesh.active() is not None:
        pmesh.sum_gradients(params)
    opt.step()


def _rank_noise(model, eps, generator, like: torch.Tensor):
    """Under an active mesh with a generator: this rank's rows of the global
    batch's noise, drawn as the single process draws it. Else ``eps``."""
    mesh = pmesh.active()
    if mesh is None or eps is not None:
        return eps
    full = torch.randn((like.shape[0] * mesh.size, model.z_mean.out_features), generator=generator,
                       dtype=like.dtype, device=like.device)
    return pmesh.batch_sharded(mesh, full, batch_axis=0)


def _rank_plan(idx, mask, eps):
    """This rank's columns of the plan and of an injected ``[nb, B, z]`` eps
    under an active mesh; the arguments as they are without one."""
    mesh = pmesh.active()
    if mesh is None:
        return idx, mask, eps
    idx, mask = pmesh.shard_epoch_inputs(mesh, idx, mask)
    return idx, mask, None if eps is None else pmesh.batch_sharded(mesh, eps, batch_axis=1)


def _global_metrics(ms: Metrics) -> Metrics:
    """The epoch's per-batch metrics summed across ranks (each rank's are its
    share of the global batch's) in one collective."""
    if pmesh.active() is None:
        return ms
    return Metrics(*pmesh.all_sum(torch.stack(list(ms))).unbind(0))


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
        with pmesh.step_scope():
            model.train()
            opt.zero_grad(set_to_none=True)
            eps = _rank_noise(model, eps, generator, bd)
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
        with pmesh.step_scope():
            eps = _rank_noise(model, eps, generator, bd)
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
        idx, mask, eps = _rank_plan(idx, mask, eps)
        bd_all, bs_all, bc_all, mask = _batches(data, source, class_, idx, mask)
        ms = []
        for i in range(bd_all.shape[0]):
            ts, m = batch_step(ts, bd_all[i], bs_all[i], bc_all[i], mask[i],
                               eps=_noise(eps, i), generator=generator)
            ms.append(m)
        return ts, _global_metrics(_stack(ms))

    def eval_epoch(model, data, source, class_, idx, mask, *,
                   generator: Optional[torch.Generator] = None, eps=None):
        _require_noise(eps, generator)
        idx, mask, eps = _rank_plan(idx, mask, eps)
        bd_all, bs_all, bc_all, mask = _batches(data, source, class_, idx, mask)
        return _global_metrics(_stack([
            eval_step(model, bd_all[i], bs_all[i], bc_all[i], mask[i],
                      eps=_noise(eps, i), generator=generator)
            for i in range(bd_all.shape[0])
        ]))

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
        with pmesh.step_scope():
            model.train()
            opt.zero_grad(set_to_none=True)
            eps = _rank_noise(model, eps, generator, b1)
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
        with pmesh.step_scope():
            eps = _rank_noise(model, eps, generator, b1)
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
        idx, mask, eps = _rank_plan(idx, mask, eps)
        b1_all, b2_all, bs_all, bc_all, mask = _batches(wave, isi, source, class_, idx, mask)
        ms = []
        for i in range(b1_all.shape[0]):
            ts, m = batch_step(ts, b1_all[i], b2_all[i], bs_all[i], bc_all[i], mask[i],
                               eps=_noise(eps, i), generator=generator)
            ms.append(m)
        return ts, _global_metrics(_stack(ms))

    def eval_epoch(model, wave, isi, source, class_, idx, mask, *,
                   generator: Optional[torch.Generator] = None, eps=None):
        _require_noise(eps, generator)
        idx, mask, eps = _rank_plan(idx, mask, eps)
        b1_all, b2_all, bs_all, bc_all, mask = _batches(wave, isi, source, class_, idx, mask)
        return _global_metrics(_stack([
            eval_step(model, b1_all[i], b2_all[i], bs_all[i], bc_all[i], mask[i],
                      eps=_noise(eps, i), generator=generator)
            for i in range(b1_all.shape[0])
        ]))

    return train_epoch, eval_epoch
