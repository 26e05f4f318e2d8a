"""K-replica training: K same-shape models fitted side by side.

Counterpart of hippie_tpu/train/ensemble.py (seed ensembles, learning-rate
sweeps and the k-fold refit's replica-plan fits). The JAX package
``jax.vmap``s the train step over a leading replica axis, so K replicas run
as one program. The port holds K models, each with its own optimizer and
noise generator, and steps the replicas in turn over each batch:

  - the block kernels are ctypes launches with no batching rule, and the
    masked BatchNorm updates its EMA buffers in place, so a
    ``torch.func.vmap`` of the step would need both rebuilt; a loop keeps
    ``block_backend="pallas"`` and ``loss_backend="pallas"`` as they are;
  - replica k is bit-equal on the CPU to the port's single-model fit
    (train/loop.py:fit) driven with replica k's init, learning rate and
    generator path; the JAX package promises only "equivalent, not
    bit-equal" (its vmap reorders the backward's reductions).

The price: a step of K replicas is K steps, K times the host dispatch of one
model, and the step is host-bound (PERF.md section 5: idle share 0.87-0.89
on the card). A step that runs the K replicas in one launch per kernel is
ROADMAP Queue 2 work, for a benchmark cell.

Replicas share the data, the epoch plan and the batch masks (the lr sweep
and seed ensembles). Per-replica learning rates are each optimizer's
``param_groups[...]["lr"]`` (``set_ensemble_lr``).
Noise: in an epoch whose key is ``key`` (train/loop.py:epoch_key), replica
k trains with ``key_generator(key, 1, k)`` and validates with
``key_generator(key, k)``, the counterpart of the JAX ``_step_keys``
split of the epoch's key into K streams.

The JAX package's whole-fit device programs (``device_fit_ensemble``,
``device_fit_replica_plans``) have host-loop counterparts here,
``host_fit_ensemble`` and ``host_fit_replica_plans``: the port's one fit
loop is the host loop (ROADMAP Queue 1, item 3's note). Replicas that
follow their own plans gain nothing from being stepped side by side, so
``host_fit_replica_plans`` fits them one after another. ``shard_replicas``
belongs to ROADMAP Queue 1 item 12 (parallelism) and raises.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.train import loop, optim, step
from hippie_tpu_torch.train.step import Metrics, TrainState


def n_replicas(states: Sequence[TrainState]) -> int:
    return len(states)


def take_replica(tree, k: int):
    """Replica k of a stacked tree (nested dicts, lists and tuples of tensors
    with a leading replica axis): one view per leaf."""
    if isinstance(tree, dict):
        return type(tree)((key, take_replica(v, k)) for key, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(take_replica(v, k) for v in tree)
    return tree[k]


def stack_trees(trees):
    """Stack same-structure trees of tensors along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((key, stack_trees([t[key] for t in trees])) for key in first)
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees(list(xs)) for xs in zip(*trees))
    return torch.stack([torch.as_tensor(t) for t in trees])


def _init_ensemble(init, key: int, cfg, make_opt, n: int, device) -> List[TrainState]:
    states = []
    for k in range(n):
        model = init(cfg, loop.key_generator(key, k), device=device)
        states.append(TrainState(model, make_opt(model.parameters())))
    return states


def init_unimodal_ensemble(key: int, cfg: cvae.CVAEConfig, make_opt, n: int,
                           device="cuda") -> List[TrainState]:
    """K independently initialized replicas, each with its optimizer
    ``make_opt(parameters)``. Replica k equals ``unimodal_cvae_init`` with
    ``loop.key_generator(key, k)``."""
    return _init_ensemble(cvae.unimodal_cvae_init, key, cfg, make_opt, n, device)


def init_multimodal_ensemble(key: int, cfg: cvae.MultiModalConfig, make_opt, n: int,
                             device="cuda") -> List[TrainState]:
    """The joint model's ``init_unimodal_ensemble``: replica k equals
    ``multimodal_cvae_init`` with ``loop.key_generator(key, k)``."""
    return _init_ensemble(cvae.multimodal_cvae_init, key, cfg, make_opt, n, device)


def set_ensemble_lr(states: Sequence[TrainState], lrs) -> List[TrainState]:
    """Give replica k the learning rate ``lrs[k]`` (every param group of its
    optimizer); the lr sweep's K rates."""
    lrs = [float(x) for x in lrs]
    if len(lrs) != len(states):
        raise ValueError(f"{len(lrs)} learning rates for an ensemble of {len(states)} replicas")
    for ts, lr in zip(states, lrs):
        for group in ts.optimizer.param_groups:
            group["lr"] = lr
    return list(states)


def _ensemble_epoch_fns(batch_step, eval_step, n_arrays: int, use_class_labels: bool):
    """(train_epoch, eval_epoch) stepping each replica in turn over each
    batch of the shared ``[nb, B]`` plan."""

    def run(fn, items, args, eps, generators):
        arrays, source, class_, idx, mask = list(args[:n_arrays]), *args[n_arrays:]
        step._require_noise(eps, generators)
        idx, mask = step._plan(idx, mask, arrays[0].device, arrays[0].dtype)
        b_arrays, bs = [a[idx] for a in arrays], source[idx]
        bc = class_[idx] if use_class_labels else None
        rows = []
        for i in range(mask.shape[0]):
            rows.append([fn(item, *(g[i] for g in b_arrays), bs[i], None if bc is None else bc[i], mask[i],
                            eps=None if eps is None else eps[i][k],
                            generator=None if generators is None else generators[k])
                         for k, item in enumerate(items)])
        return Metrics(*(torch.stack([torch.stack([getattr(m, name) for m in row]) for row in rows])
                         for name in Metrics._fields))

    def train_epoch(states, *args, generators=None, eps=None):
        # a step updates its replica's model and optimizer in place
        return list(states), run(lambda ts, *a, **kw: batch_step(ts, *a, **kw)[1], states, args, eps,
                                 generators)

    def eval_epoch(models, *args, generators=None, eps=None):
        return run(eval_step, models, args, eps, generators)

    return train_epoch, eval_epoch


def make_unimodal_ensemble_epoch_fns(*, beta: float = 1.0, use_class_labels: bool = False,
                                     loss_backend: str = "xla", block_backend: str = "xla"):
    """(train_epoch, eval_epoch) over K unimodal replicas.

    train_epoch(states, data, source, class_, idx, mask, *, generators=None, eps=None)
        -> (states, Metrics of [nb, K])
    eval_epoch(models, data, source, class_, idx, mask, *, generators=None, eps=None)
        -> Metrics of [nb, K]

    The single-model epoch's contract (step.make_unimodal_epoch_fns), with
    the ``[nb, B]`` plan shared by the replicas and ``generators`` one per
    replica or ``eps`` ``[nb, K, B, z]``. Replica k's steps are the
    single-model steps on the shared batches."""
    batch_step, eval_step = step.make_unimodal_steps(beta=beta, loss_backend=loss_backend,
                                                     block_backend=block_backend)
    return _ensemble_epoch_fns(batch_step, eval_step, 1, use_class_labels)


def make_multimodal_ensemble_epoch_fns(*, beta: float = 1.0, mod1_weight: float = 1.0,
                                       mod2_weight: float = 1.0, use_class_labels: bool = False,
                                       loss_backend: str = "xla", block_backend: str = "xla"):
    """The joint model's ``make_unimodal_ensemble_epoch_fns``: the epochs
    take (wave, isi) where the unimodal ones take ``data``."""
    batch_step, eval_step = step.make_multimodal_steps(
        beta=beta, mod1_weight=mod1_weight, mod2_weight=mod2_weight, loss_backend=loss_backend,
        block_backend=block_backend)
    return _ensemble_epoch_fns(batch_step, eval_step, 2, use_class_labels)


@dataclass
class EnsembleFitResult:
    """What a K-replica fit returns. ``best_state_dict[k]`` is replica k's
    best snapshot, a state_dict in the model's key order."""

    state: List[TrainState]
    best_state_dict: List[dict]
    best_val_loss: np.ndarray         # [K]
    best_epoch: np.ndarray            # [K] int
    epochs_run: int
    train_losses: List[np.ndarray] = field(default_factory=list)  # per epoch [K]
    val_losses: List[np.ndarray] = field(default_factory=list)


def _eval_state_dict(ts: TrainState) -> dict:
    """The model's state_dict with its parameters at the x iterate when the
    optimizer is schedule-free (``optim.maybe_eval_params``), else as they
    are."""
    sd = dict(ts.model.state_dict())
    names, params = zip(*ts.model.named_parameters())
    sd.update(zip(names, optim.maybe_eval_params(ts.optimizer, [p.detach() for p in params])))
    return sd


def _epoch_means(ms) -> np.ndarray:
    """[nb, K] per-batch losses -> [K] epoch means, each reduced as
    train/loop.py:fit reduces a single model's (np.mean of its float32
    column), so a replica's improvements are the single-model fit's."""
    losses = ms.loss.detach().float().cpu().numpy()
    return np.asarray([np.mean(col) for col in np.ascontiguousarray(losses.T)], np.float64)


def fit_ensemble(
    states: Sequence[TrainState],
    *,
    run_train_epoch: Callable,
    run_val_epoch: Callable,
    max_epochs: int,
    early_stopping_patience: Optional[int] = None,
    seed: int = 42,
    verbose: bool = False,
) -> EnsembleFitResult:
    """Per-replica best tracking and joint early stopping over K replicas.

    run_train_epoch(states, key, epoch) -> (states, Metrics of [nb, K])
    run_val_epoch(states, key, epoch)   -> Metrics of [nb, K]

    The keys are train/loop.py:fit's (``epoch_key(seed, 2 * epoch, 1)`` and
    ``(..., 2)``). Each replica tracks its OWN best epoch: ``best_val`` moves
    with ``np.where(improved, ...)``, not ``minimum``, so a nan validation
    epoch (which is never an improvement) cannot poison it. Snapshots are
    device clones taken through ``optim.maybe_eval_params`` (the x iterate
    for schedule-free). Every replica trains until ALL have waited
    ``early_stopping_patience`` epochs (the joint stop of the JAX
    ``fit_ensemble``). A non-finite train loss raises."""
    k = n_replicas(states)
    states = list(states)
    best_val = np.full((k,), np.inf)
    best_epoch = np.full((k,), -1, np.int64)
    wait = np.zeros((k,), np.int64)
    best = None
    train_losses, val_losses = [], []
    epochs_run = 0
    for epoch in range(max_epochs):
        tkey, vkey = loop.epoch_key(seed, 2 * epoch, 1), loop.epoch_key(seed, 2 * epoch, 2)
        states, tms = run_train_epoch(states, tkey, epoch)
        vms = run_val_epoch(states, vkey, epoch)
        tl, vl = _epoch_means(tms), _epoch_means(vms)
        if not np.all(np.isfinite(tl)):
            raise FloatingPointError(f"non-finite ensemble training loss at epoch {epoch}: {tl}")
        train_losses.append(tl)
        val_losses.append(vl)
        improved = vl < best_val
        if best is None:  # the first epoch's states seed every replica's snapshot
            best = [loop.clone_tree(_eval_state_dict(ts)) for ts in states]
        else:
            for r in np.flatnonzero(improved):
                torch._foreach_copy_(list(best[r].values()), list(_eval_state_dict(states[r]).values()))
        best_epoch = np.where(improved, epoch, best_epoch)
        best_val = np.where(improved, vl, best_val)
        wait = np.where(improved, 0, wait + 1)
        epochs_run = epoch + 1
        if verbose:
            print(f"ensemble epoch {epoch}: val={np.array2string(vl, precision=4)}")
        if early_stopping_patience is not None and np.all(wait >= early_stopping_patience):
            break
    if best is None:  # no epoch ran
        best = [loop.clone_tree(_eval_state_dict(ts)) for ts in states]
    return EnsembleFitResult(state=states, best_state_dict=best, best_val_loss=best_val,
                             best_epoch=best_epoch, epochs_run=epochs_run,
                             train_losses=train_losses, val_losses=val_losses)


@contextlib.contextmanager
def _at_x(states):
    """Every replica's parameters at its x iterate (schedule-free)."""
    with contextlib.ExitStack() as stack:
        for ts in states:
            stack.enter_context(optim.evaluated_at_x(ts.optimizer))
        yield


def host_fit_ensemble(
    states: Sequence[TrainState],
    *,
    epoch_fns,
    arrays,
    source: torch.Tensor,
    class_: Optional[torch.Tensor],
    train_stream: np.ndarray,
    batch_size: int,
    val_idx: np.ndarray,
    val_mask: np.ndarray,
    max_epochs: int,
    early_stopping_patience: Optional[int] = None,
    seed: int = 42,
    shuffle: bool = True,
    verbose: bool = False,
) -> EnsembleFitResult:
    """The JAX ``device_fit_ensemble``'s fit on the host loop: K replicas over
    one shared plan per epoch (``batch_plan`` of ``train_stream``, shuffled
    from ``key_generator(key, 0)`` when ``shuffle``) and one fixed val plan,
    through ``fit_ensemble`` with the joint stop. ``epoch_fns`` is a
    (train_epoch, eval_epoch) pair of ``make_*_ensemble_epoch_fns``;
    ``arrays`` holds (data,) or (wave, isi)."""
    train_epoch, eval_epoch = epoch_fns
    device = arrays[0].device
    k = n_replicas(states)

    def run_train(sts, key, epoch):
        idx, mask = batch_plan(train_stream, batch_size, shuffle=shuffle,
                               generator=loop.key_generator(key, 0) if shuffle else None)
        return train_epoch(sts, *arrays, source, class_, idx, mask,
                           generators=[loop.key_generator(key, 1, r, device=device) for r in range(k)])

    def run_val(sts, key, epoch):
        with _at_x(sts):
            return eval_epoch([ts.model for ts in sts], *arrays, source, class_, val_idx, val_mask,
                              generators=[loop.key_generator(key, r, device=device) for r in range(k)])

    return fit_ensemble(states, run_train_epoch=run_train, run_val_epoch=run_val,
                        max_epochs=max_epochs, early_stopping_patience=early_stopping_patience,
                        seed=seed, verbose=verbose)


def host_fit_replica_plans(
    states: Sequence[TrainState],
    *,
    epoch_fns,
    arrays,
    source: torch.Tensor,
    class_: Optional[torch.Tensor],
    train_idx: np.ndarray,
    train_mask: np.ndarray,
    val_idx: np.ndarray,
    val_mask: np.ndarray,
    max_epochs: int,
    early_stopping_patience: Optional[int] = None,
    seeds: Sequence[int],
) -> EnsembleFitResult:
    """The JAX ``device_fit_replica_plans``'s fit on the host loop: replica k
    trains on its own FIXED plan ``train_idx[k]`` / ``train_mask[k]`` ([K, nb,
    B]; ``val_*`` likewise) and draws from ``seeds[k]`` as a single-model
    ``pipeline.fit_stage`` with ``cfg.seed + stage_seed == seeds[k]`` and
    ``shuffle_train=False`` does: its epochs' keys ``epoch_key(seeds[k], 2 *
    epoch, 1 | 2)``, its train noise ``key_generator(key, 1)``, its val
    noise ``key_generator(key)``. The replicas are fitted one after another,
    each stopping at its own patience, so ``state[k]`` is its state at its
    last epoch and its best is its own fit's: replica k is its sequential
    fit, step for step. ``epochs_run`` is the longest replica's."""
    k = n_replicas(states)
    if not (len(train_idx) == len(val_idx) == len(seeds) == k):
        raise ValueError(f"plans of {len(train_idx)}/{len(val_idx)} replicas and {len(seeds)} seeds "
                         f"for {k} replicas")
    train_epoch, eval_epoch = epoch_fns
    device = arrays[0].device
    fits = []
    for r in range(k):
        def run_train(sts, key, epoch, r=r):
            return train_epoch(sts, *arrays, source, class_, train_idx[r], train_mask[r],
                               generators=[loop.key_generator(key, 1, device=device)])

        def run_val(sts, key, epoch, r=r):
            with _at_x(sts):
                return eval_epoch([ts.model for ts in sts], *arrays, source, class_, val_idx[r], val_mask[r],
                                  generators=[loop.key_generator(key, device=device)])

        fits.append(fit_ensemble([states[r]], run_train_epoch=run_train, run_val_epoch=run_val,
                                 max_epochs=max_epochs, early_stopping_patience=early_stopping_patience,
                                 seed=seeds[r]))
    n = max((f.epochs_run for f in fits), default=0)

    def column(f, losses):  # replica r's [epochs_run] losses, nan after its stop
        return [x[0] for x in losses] + [np.nan] * (n - f.epochs_run)

    return EnsembleFitResult(
        state=[f.state[0] for f in fits], best_state_dict=[f.best_state_dict[0] for f in fits],
        best_val_loss=np.asarray([f.best_val_loss[0] for f in fits]),
        best_epoch=np.asarray([f.best_epoch[0] for f in fits], np.int64), epochs_run=n,
        train_losses=list(np.asarray([column(f, f.train_losses) for f in fits]).T),
        val_losses=list(np.asarray([column(f, f.val_losses) for f in fits]).T))


def shard_replicas(tree, mesh, axis_name: str = "data"):
    """The JAX package places the replica axis across a device mesh; the
    port's parallelism is ROADMAP Queue 1 item 12."""
    raise ValueError("shard_replicas: sharding replicas across devices is not ported yet "
                     "(ROADMAP Queue 1 item 12, parallelism)")
