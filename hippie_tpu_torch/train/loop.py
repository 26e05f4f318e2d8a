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

The JAX package also fits a whole stage in one device program
(train/device_fit.py); the port has this host loop only, whose trajectory is
the JAX host loop's (``--fit-loop host``). The JAX package's shape-bucketing
helpers (``next_pow2``, ``pad_rows``, ``pad_plan``, ``epoch_shuffle_order``)
exist to reuse compiled XLA programs and have no counterpart here.

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
) -> FitResult:
    """The fit loop over a TrainState (model, optimizer).

    run_train_epoch(state, key, epoch) -> (state, metrics)   # metrics.loss [nb]
    run_val_epoch(state, key, epoch)   -> metrics            # metrics.loss [nb]

    ``key`` is an integer seed of that epoch (``epoch_key(seed, 2 * epoch,
    1)`` for training, ``(..., 2)`` for validation); the callables seed their
    generators from it. Metrics go to the host once per epoch. A non-finite
    train loss raises FloatingPointError. Mid-run resume (``resume_dir``) is
    not ported yet and raises.
    """
    if resume_dir is not None:
        raise ValueError("resume_dir: mid-run resume is not ported yet (ROADMAP Queue 1 item 12)")
    best_val = math.inf
    best_epoch = -1
    best_sd = best_opt = None
    wait = 0
    train_losses, val_losses = [], []

    epochs_run = 0
    for epoch in range(max_epochs):
        state, tms = run_train_epoch(state, epoch_key(seed, 2 * epoch, 1), epoch)
        vms = run_val_epoch(state, epoch_key(seed, 2 * epoch, 2), epoch)
        host = _fetch(tms, vms)
        train_loss = float(np.mean(host[("train", "loss")]))
        val_loss = float(np.mean(host[("val", "loss")]))
        if not math.isfinite(train_loss):
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch}: {train_loss} "
                f"(val={val_loss}); lower the learning rate or enable clipping"
            )
        train_losses.append(train_loss)
        val_losses.append(val_loss)
        epochs_run = epoch + 1
        if verbose:
            # the reference's per-epoch prints (model.py:141-149)
            print(f"Average training loss is {train_loss:.2f}")
            print(f"Average validation loss is {val_loss:.2f}")
        if log_fn is not None:
            rec = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss}
            for phase in ("train", "val"):
                for name in ("mse", "kl"):
                    if (phase, name) in host:
                        rec[f"{phase}_{name}"] = float(np.mean(host[(phase, name)]))
            if lr is not None:
                rec["lr"] = float(lr)
            log_fn(rec)

        if val_loss < best_val:
            best_val = val_loss
            best_epoch = epoch
            best_sd, best_opt = snapshot(state)
            wait = 0
        else:
            wait += 1
            if early_stopping_patience is not None and wait >= early_stopping_patience:
                break

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
