"""The fit loop: epochs, validation, early stopping, best-snapshot tracking.

Counterpart of hippie_tpu/train/loop.py (``limit_count``, ``limit_batches``,
``FitResult``, ``fit``), the pl.Trainer layer of the reference. Semantics
kept:
  - validation every epoch; the monitored value is the unweighted mean of the
    per-batch val losses (Lightning's epoch aggregation of ``self.log``);
  - ModelCheckpoint(monitor="val_loss", save_top_k=1, mode="min")
    (train_model.py:125-126): the best state is snapshotted whenever val_loss
    strictly improves;
  - EarlyStopping(patience, mode="min", min_delta=0) (train_model.py:127-128);
  - limit_train_batches / limit_val_batches as fractions or counts.

This is the ``--fit-loop host`` loop, whose trajectory is the JAX host
loop's. ``--fit-loop device`` (train/device_fit.py, the default, as in JAX)
replays each step as a CUDA graph and hands its graphed epochs to ``fit``
here, so both loops share this one and give the same trajectory bit for
bit. The JAX package's shape-bucketing helpers (``next_pow2``,
``pad_rows``, ``pad_plan``, ``epoch_shuffle_order``) exist to reuse compiled
XLA programs and have no counterpart here: a CUDA graph is captured per
stage, at that stage's batch and plan shapes.

Under an active mesh (parallel/mesh.py) every rank runs this loop on the
same all-reduced losses, so every rank decides the same; only rank 0 logs
and writes the resume files.

Random draws: each epoch's come from generators seeded from (seed, epoch)
alone (``epoch_key``, ``key_generator``), as the JAX loop folds (seed, epoch)
into its keys, so an epoch's draws do not depend on the epochs before it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from hippie_tpu_torch.parallel import mesh as pmesh


def limit_count(nb: int, limit) -> int:
    """Lightning-style batch limit (None | float fraction | int count) -> count."""
    if limit is None:
        return nb
    n = max(1, int(limit * nb)) if isinstance(limit, float) and limit <= 1.0 else int(limit)
    return min(nb, max(1, n))


def limit_batches(plan, limit):
    """Apply a Lightning-style limit to an (idx, mask) batch plan."""
    idx, mask = plan
    n = limit_count(idx.shape[0], limit)
    return idx[:n], mask[:n]


def epoch_key(seed: int, *path: int) -> int:
    """A 63-bit seed derived from ``seed`` and the integers of ``path`` alone
    (numpy's SeedSequence hash), the counterpart of folding integers into a
    jax.random key: ``epoch_key(seed, 2 * epoch, 1)`` is the train epoch's,
    ``epoch_key(key, 0)`` a draw split from ``key``."""
    state = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def key_generator(key: int, *path: int, device="cpu") -> torch.Generator:
    """A torch.Generator on ``device`` seeded with ``epoch_key(key, *path)``."""
    return torch.Generator(device=device).manual_seed(epoch_key(key, *path))


@dataclass
class FitResult:
    """What a fit returns. ``best_state_dict`` and ``best_opt_state`` are
    clones, on the model's device, of the model's state_dict (parameters and
    BatchNorm buffers) and the optimizer's state_dict at the best epoch."""

    state: Any  # the final TrainState (model and optimizer)
    best_state_dict: Any
    best_opt_state: Any
    best_val_loss: float
    best_epoch: int
    epochs_run: int
    train_losses: List[float] = field(default_factory=list)
    val_losses: List[float] = field(default_factory=list)
    # the device loop's graphs (train/device_fit.py): whether it captured,
    # the capture seconds and the replays of each step kind; empty otherwise
    graphs: dict = field(default_factory=dict)


def clone_tree(tree):
    """Deep copy of the tensors of nested dicts, lists and tuples (on their
    devices); other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return type(tree)((k, clone_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def snapshot(state):
    """(state_dict, optimizer state_dict) of a TrainState, cloned on the device."""
    return clone_tree(state.model.state_dict()), clone_tree(state.optimizer.state_dict())


_METRICS = ("loss", "mse", "kl")


def _fetch(tms, vms):
    """Every per-batch metric of the train and val epochs in ONE device-to-host
    copy: {(phase, name): float32 numpy array}."""
    parts = [((phase, name), getattr(ms, name, None)) for phase, ms in (("train", tms), ("val", vms))
             for name in _METRICS]
    parts = [(k, torch.as_tensor(v).reshape(-1).float()) for k, v in parts if v is not None]
    device = parts[0][1].device
    flat = torch.cat([v.to(device) for _, v in parts]).cpu().numpy()
    out, at = {}, 0
    for k, v in parts:
        out[k] = flat[at:at + v.numel()]
        at += v.numel()
    return out


def _stopped(wait: int, patience: Optional[int]) -> bool:
    """EarlyStopping's verdict after an epoch: ``wait`` epochs without an
    improvement reached the patience (an improving epoch never stops)."""
    return patience is not None and wait >= max(patience, 1)


def fit(
    state,
    *,
    run_train_epoch: Callable[[Any, int, int], tuple],
    run_val_epoch: Callable[[Any, int, int], Any],
    max_epochs: int,
    early_stopping_patience: Optional[int] = None,
    seed: int = 42,
    log_fn: Optional[Callable[[dict], None]] = None,
    verbose: bool = True,
    resume_dir: Optional[str] = None,
    lr: Optional[float] = None,
    progress_every: Optional[int] = 1,
    log_steps: bool = False,
) -> FitResult:
    """The fit loop over a TrainState (model, optimizer).

    run_train_epoch(state, key, epoch) -> (state, metrics)   # metrics.loss [nb]
    run_val_epoch(state, key, epoch)   -> metrics            # metrics.loss [nb]

    ``key`` is an integer seed of that epoch (``epoch_key(seed, 2 * epoch,
    1)`` for training, ``(..., 2)`` for validation); the callables seed their
    generators from it. Metrics go to the host once per epoch. A non-finite
    train loss raises FloatingPointError.

    ``resume_dir``: the full state (model, optimizer, loop counters, and the
    best snapshot when it improved) is saved there after every epoch
    (train/resume.py), before the patience break, and restored by the next
    call: the fit goes on from the epoch after the saved one, with the saved
    best, and a fit that had already stopped early returns without running
    an epoch. Each epoch draws from (seed, epoch) alone, so the resumed fit
    is the uninterrupted one's continuation. ``train_losses`` and
    ``val_losses`` hold the epochs this call ran; ``epochs_run`` counts from
    epoch 0.

    ``progress_every=k``: the epoch prints and ``log_fn`` records come out
    every k epochs (and at the stop); None or 0: after the stage, as the JAX
    device loop replays them. ``log_steps``: one ``{epoch, step,
    train_loss_step, train_mse_step, train_kl_step}`` record per executed
    train batch to ``log_fn``, after the stage's epoch records. A diverged
    epoch still emits the epochs before it, then raises.
    """
    best_val = math.inf
    best_epoch = -1
    best_sd = best_opt = None
    wait = 0
    train_losses, val_losses = [], []
    start_epoch = 0

    if resume_dir is not None:
        from hippie_tpu_torch.train import resume

        resumed = resume.resume_fit_state(resume_dir, state)
        if resumed is not None:
            last_epoch, state, extras, best = resumed
            start_epoch = last_epoch + 1
            best_val = float(extras.get("best_val", math.inf))
            best_epoch = int(extras.get("best_epoch", -1))
            wait = int(extras.get("wait", 0))
            # the persisted best snapshot; without one (no epoch improved),
            # the resume point's state as the JAX loop takes it
            best_sd, best_opt = best if best is not None else snapshot(state)
            if verbose:
                print(f"Resumed from {resume_dir} at epoch {start_epoch}")

    if start_epoch > 0 and _stopped(wait, early_stopping_patience):
        # the restored state had already stopped early: one more epoch would
        # leave the uninterrupted trajectory
        if verbose:
            print(f"Early stopping already triggered at epoch {start_epoch - 1}; nothing to resume")
        max_epochs = start_epoch

    writer = log_fn is not None and pmesh.is_writer()
    pending, step_rows = [], []  # what the next emit() prints and logs

    def emit():
        for epoch, host, train_loss, val_loss in pending:
            if verbose:
                # the reference's per-epoch prints (model.py:141-149)
                print(f"Average training loss is {train_loss:.2f}")
                print(f"Average validation loss is {val_loss:.2f}")
            if writer:
                rec = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss}
                for phase in ("train", "val"):
                    for name in ("mse", "kl"):
                        if (phase, name) in host:
                            rec[f"{phase}_{name}"] = float(np.mean(host[(phase, name)]))
                if lr is not None:
                    rec["lr"] = float(lr)
                log_fn(rec)
        pending.clear()
        if writer and log_steps:
            for epoch, rows in step_rows:
                for i in range(rows.shape[1]):
                    log_fn({"epoch": epoch, "step": epoch * rows.shape[1] + i,
                            "train_loss_step": float(rows[0, i]), "train_mse_step": float(rows[1, i]),
                            "train_kl_step": float(rows[2, i])})
        step_rows.clear()

    epochs_run = start_epoch
    for epoch in range(start_epoch, max_epochs):
        state, tms = run_train_epoch(state, epoch_key(seed, 2 * epoch, 1), epoch)
        vms = run_val_epoch(state, epoch_key(seed, 2 * epoch, 2), epoch)
        host = _fetch(tms, vms)
        train_loss = float(np.mean(host[("train", "loss")]))
        val_loss = float(np.mean(host[("val", "loss")]))
        if not math.isfinite(train_loss):
            emit()  # the epochs before it
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch}: {train_loss} "
                f"(val={val_loss}); lower the learning rate or enable clipping"
            )
        train_losses.append(train_loss)
        val_losses.append(val_loss)
        epochs_run = epoch + 1
        pending.append((epoch, host, train_loss, val_loss))
        if log_steps:
            step_rows.append((epoch, np.stack([host[("train", n)] for n in _METRICS])))

        if val_loss < best_val:
            best_val = val_loss
            best_epoch = epoch
            best_sd, best_opt = snapshot(state)
            wait = 0
        else:
            wait += 1
        stop = _stopped(wait, early_stopping_patience)
        if resume_dir is not None:
            # saved BEFORE the patience break, so a restart resumes from the
            # stopping epoch; the best snapshot rides along when it improved
            from hippie_tpu_torch.train import resume

            resume.save_fit_state(resume_dir, epoch, state,
                                  {"best_val": best_val, "best_epoch": best_epoch, "wait": wait},
                                  best=(best_sd, best_opt, best_epoch) if best_epoch == epoch else None)
        if progress_every and ((epoch + 1 - start_epoch) % progress_every == 0 or stop):
            emit()
        if stop:
            break
    emit()

    if best_epoch < 0:  # no validation ran (max_epochs=0)
        best_sd, best_opt = snapshot(state)

    return FitResult(
        state=state,
        best_state_dict=best_sd,
        best_opt_state=best_opt,
        best_val_loss=best_val,
        best_epoch=best_epoch,
        epochs_run=epochs_run,
        train_losses=train_losses,
        val_losses=val_losses,
    )
