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

The price: a step of K replicas is K steps' device work. Eagerly
(``host_fit_ensemble``) it is also K times one model's host dispatch; the
device fit (``device_fit_ensemble``) replays the K steps as one CUDA graph.
A step that runs the K replicas in one launch per kernel is work for a
benchmark cell (ROADMAP).

Replicas share the data, the epoch plan and the batch masks (the lr sweep
and seed ensembles). Per-replica learning rates are each optimizer's
``param_groups[...]["lr"]`` (``set_ensemble_lr``).
Noise: in an epoch whose key is ``key`` (train/loop.py:epoch_key), replica
k trains with ``key_generator(key, 1, k)`` and validates with
``key_generator(key, k)``, the counterpart of the JAX ``_step_keys``
split of the epoch's key into K streams.

The JAX package's whole-fit device programs have these counterparts:
``device_fit_ensemble`` (the JAX default of ``lr_sweep``) replays one CUDA
graph per step kind for all local replicas (train/device_fit.py:StepGraph:
each replica's first step eager on the capture stream, then one
``cudaGraphLaunch`` per step of the whole local ensemble) and
``host_fit_ensemble`` steps them eagerly; both hand their epochs to
``fit_ensemble``, so they give the same trajectory bit for bit. The JAX
``device_fit_replica_plans`` (the k-fold refit's replicas, each on its own
fixed plan and seed, each stopping at its own patience) is
``device_fit_replica_plans`` here, one CUDA graph per step kind for all
replicas as well; ``host_fit_replica_plans`` fits the same replicas one
after another, each its sequential stage fit, and the two agree bit for
bit. ``fit_ensemble`` takes the JAX ``device_fit_ensemble``'s ``resume_dir``
(all K replicas' states, their best snapshots and the ``[K]`` counters
saved after every epoch in one payload, train/resume.py) and
``progress_every``. ``shard_replicas`` splits the replicas over the ranks
of a mesh (parallel/mesh.py), K/N contiguous replicas per rank, and
``fit_ensemble(..., mesh=)`` (either fit with ``mesh=``) fits this rank's
replicas with their global replica indices, gathers every epoch's ``[K]``
losses on every rank (the joint stop decides the same everywhere) and
gathers the best snapshots at the end; each replica's fit is the
unsharded one's, so the per-replica results are the unsharded ensemble's.
With ``resume_dir`` as well, rank 0 writes the unsharded sweep's payload
(every replica, gathered) and each rank restores its own replicas from it,
so sharded and unsharded sweeps resume each other's files.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train import loop, optim, resume, step
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
    epoch_s: List[float] = field(default_factory=list)  # wall seconds of each epoch this call ran
    # device_fit_ensemble's graphs: whether it captured, the capture seconds
    # and the replays of each step kind; empty otherwise
    graphs: dict = field(default_factory=dict)


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
    resume_dir: Optional[str] = None,
    progress_every: Optional[int] = None,
    mesh: Optional[pmesh.Mesh] = None,
    own_stops: bool = False,
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
    ``fit_ensemble``). A non-finite train loss raises.

    ``resume_dir``: after every epoch, before the joint stop, every
    replica's model and optimizer state, its best snapshot and the ``[K]``
    counters are saved there in one payload; the next call restores them
    and goes on from the next epoch, so a resumed fit equals the
    uninterrupted one; a fit whose replicas had all stopped returns without
    running an epoch. ``train_losses`` and ``val_losses`` hold the epochs
    this call ran. ``progress_every=N`` prints one progress line every N
    epochs (the epoch, each replica's best validation loss, how many have
    waited out the patience, the seconds so far); the trajectory does not
    change.

    ``mesh``: ``states`` are this rank's K/N replicas (``shard_replicas``)
    and the epochs' metrics this rank's columns; the ``[K]`` losses are
    gathered every epoch and the best snapshots at the end, so the result's
    arrays and ``best_state_dict`` hold all K replicas on every rank, and
    ``state`` this rank's. With ``resume_dir`` the payload is gathered to
    rank 0, which writes the unsharded layout; each rank restores its own
    replicas from it.

    ``own_stops`` (the replica-plan fit, without ``mesh`` or
    ``resume_dir``): each replica stops at its own patience, as its
    sequential fit would. Its model's state_dict is frozen (device clones)
    at the epoch its patience fires and restored into the model at the
    end; it goes on stepping until every replica has stopped, but its
    losses after its stop are NaN, so it improves no more and its best is
    gated by its own stop; only the replicas still training count in the
    finite check. The optimizer states are the loop's last."""
    if own_stops and (mesh is not None or resume_dir is not None):
        raise ValueError("fit_ensemble(own_stops=True) takes neither mesh nor resume_dir")
    states = list(states)
    k = n_replicas(states) * (1 if mesh is None else mesh.size)
    mine = slice(0, k) if mesh is None else pmesh.local_slice(k, mesh, "replicas")
    best_val = np.full((k,), np.inf)
    best_epoch = np.full((k,), -1, np.int64)
    wait = np.zeros((k,), np.int64)
    best = None
    frozen = {}  # own_stops: replica -> its model's state_dict at its stop
    train_losses, val_losses, epoch_s = [], [], []
    start_epoch = 0
    if resume_dir is not None:
        resumed = resume.resume_ensemble_fit_state(resume_dir, states, mesh)
        if resumed is not None:
            last_epoch, states, extras, best = resumed
            start_epoch = last_epoch + 1
            best_val, best_epoch, wait = extras["best_val"], extras["best_epoch"], extras["wait"]
            if verbose:
                print(f"Resumed ensemble from {resume_dir} at epoch {start_epoch}")
    if (start_epoch > 0 and early_stopping_patience is not None
            and np.all(wait >= early_stopping_patience)):
        # the joint stop had fired: one more epoch would leave the uninterrupted trajectory
        if verbose:
            print(f"Ensemble early stopping already triggered at epoch {start_epoch - 1}; "
                  "nothing to resume")
        max_epochs = start_epoch
    epochs_run = start_epoch
    t0 = time.perf_counter()
    for epoch in range(start_epoch, max_epochs):
        t_epoch = time.perf_counter()
        tkey, vkey = loop.epoch_key(seed, 2 * epoch, 1), loop.epoch_key(seed, 2 * epoch, 2)
        states, tms = run_train_epoch(states, tkey, epoch)
        vms = run_val_epoch(states, vkey, epoch)
        tl, vl = _epoch_means(tms), _epoch_means(vms)
        if mesh is not None:  # every rank's replicas, in replica order (on the rank's device: NCCL)
            tl, vl = (pmesh.gather_rows(torch.from_numpy(x).to(mesh.device), mesh).reshape(-1).cpu().numpy()
                      for x in (tl, vl))
        done = np.isin(np.arange(k), list(frozen))  # replicas that had stopped before this epoch
        tl[done] = vl[done] = np.nan
        if not np.all(np.isfinite(tl[~done])):
            raise FloatingPointError(f"non-finite ensemble training loss at epoch {epoch}: {tl}")
        train_losses.append(tl)
        val_losses.append(vl)
        epoch_s.append(time.perf_counter() - t_epoch)
        improved = vl < best_val
        if best is None:  # the first epoch's states seed every replica's snapshot
            best = [loop.clone_tree(_eval_state_dict(ts)) for ts in states]
        else:
            for r in np.flatnonzero(improved[mine]):
                torch._foreach_copy_(list(best[r].values()), list(_eval_state_dict(states[r]).values()))
        best_epoch = np.where(improved, epoch, best_epoch)
        best_val = np.where(improved, vl, best_val)
        wait = np.where(improved, 0, wait + 1)
        if own_stops and early_stopping_patience is not None:
            for r in np.flatnonzero((wait >= early_stopping_patience) & ~done):
                frozen[r] = loop.clone_tree(states[r].model.state_dict())
        epochs_run = epoch + 1
        if verbose:
            print(f"ensemble epoch {epoch}: val={np.array2string(vl, precision=4)}")
        stop = early_stopping_patience is not None and np.all(wait >= early_stopping_patience)
        if progress_every and (epoch + 1) % progress_every == 0:
            waited = 0 if early_stopping_patience is None else int(np.sum(wait >= early_stopping_patience))
            print(f"ensemble progress: epoch {epoch + 1}/{max_epochs}, best val "
                  f"{np.array2string(best_val, precision=4)}, {waited}/{k} replicas out of patience, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        if resume_dir is not None:
            resume.save_ensemble_fit_state(resume_dir, epoch, states, {
                "best_val": best_val, "best_epoch": best_epoch, "wait": wait}, best, mesh)
        if stop:
            break
    if best is None:  # no epoch ran
        best = [loop.clone_tree(_eval_state_dict(ts)) for ts in states]
    for r, sd in frozen.items():
        states[r].model.load_state_dict(sd)
    if mesh is not None:
        best = _gather_replicas(best, mesh)
    return EnsembleFitResult(state=states, best_state_dict=best, best_val_loss=best_val,
                             best_epoch=best_epoch, epochs_run=epochs_run,
                             train_losses=train_losses, val_losses=val_losses, epoch_s=epoch_s)


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
    resume_dir: Optional[str] = None,
    progress_every: Optional[int] = None,
    mesh: Optional[pmesh.Mesh] = None,
) -> EnsembleFitResult:
    """The JAX ``device_fit_ensemble``'s fit on the host loop: K replicas over
    one shared plan per epoch (``batch_plan`` of ``train_stream``, shuffled
    from ``key_generator(key, 0)`` when ``shuffle``) and one fixed val plan,
    through ``fit_ensemble`` with the joint stop. ``epoch_fns`` is a
    (train_epoch, eval_epoch) pair of ``make_*_ensemble_epoch_fns``;
    ``arrays`` holds (data,) or (wave, isi); ``resume_dir`` and
    ``progress_every`` go to ``fit_ensemble``; with ``mesh``, ``states``
    are this rank's replicas (``shard_replicas``), each drawing from its
    global replica index's generators."""
    train_epoch, eval_epoch = epoch_fns
    device = arrays[0].device
    first = 0 if mesh is None else mesh.rank * n_replicas(states)
    replicas = range(first, first + n_replicas(states))

    def run_train(sts, key, epoch):
        idx, mask = batch_plan(train_stream, batch_size, shuffle=shuffle,
                               generator=loop.key_generator(key, 0) if shuffle else None)
        return train_epoch(sts, *arrays, source, class_, idx, mask,
                           generators=[loop.key_generator(key, 1, r, device=device) for r in replicas])

    def run_val(sts, key, epoch):
        with _at_x(sts):
            return eval_epoch([ts.model for ts in sts], *arrays, source, class_, val_idx, val_mask,
                              generators=[loop.key_generator(key, r, device=device) for r in replicas])

    return fit_ensemble(states, run_train_epoch=run_train, run_val_epoch=run_val,
                        max_epochs=max_epochs, early_stopping_patience=early_stopping_patience,
                        seed=seed, verbose=verbose, resume_dir=resume_dir,
                        progress_every=progress_every, mesh=mesh)


def device_fit_ensemble(
    states: Sequence[TrainState],
    *,
    batch_step: Callable,
    eval_step: Callable,
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
    use_class_labels: bool = False,
    shuffle: bool = True,
    verbose: bool = False,
    resume_dir: Optional[str] = None,
    progress_every: Optional[int] = None,
    mesh: Optional[pmesh.Mesh] = None,
    aot_dir: Optional[str] = None,
    aot_desc: str = "",
) -> EnsembleFitResult:
    """The JAX ``device_fit_ensemble`` (hippie_tpu/train/ensemble.py): the K
    local replicas' train steps as ONE CUDA graph replayed per batch of the
    shared plan, and their eval steps as another (train/device_fit.py:
    StepGraph), on the card; off it the same steps run eagerly over the
    same buffers.

    ``batch_step`` / ``eval_step`` are train/step.py's per-batch steps
    (``make_unimodal_steps`` / ``make_multimodal_steps``); the other
    arguments are ``host_fit_ensemble``'s, whose plans, noise (replica r
    trains with ``key_generator(key, 1, r)`` and validates at its x iterate
    with ``key_generator(key, r)``, r its global index) and epochs
    (``fit_ensemble``: the joint stop, the per-replica bests, ``resume_dir``,
    ``progress_every``, the ``mesh=`` gathers) it shares, so the two loops
    give the same result bit for bit and resume each other's files. Each
    replica's first train and eval steps run eagerly on the capture stream
    (a loss kernel's first call inside a capture raises; fused AdamW builds
    its state there), the second call captures, every later step is one
    ``cudaGraphLaunch`` for the whole local ensemble. ``aot_dir`` sets where
    the kernel libraries load from or are built (ops/_build.py); ``aot_desc``
    is ignored, as in ``device_fit``."""
    from hippie_tpu_torch.ops import _build
    from hippie_tpu_torch.train import device_fit as dfit

    if aot_dir is not None:
        _build.set_default_dir(aot_dir)
    states = list(states)
    device = arrays[0].device
    dfit.check_card(pmesh.active(), device)
    first = 0 if mesh is None else mesh.rank * n_replicas(states)
    replicas = range(first, first + n_replicas(states))
    stream_idx = np.asarray(train_stream)
    nb = max(1, -(-len(stream_idx) // batch_size))
    val_idx, val_mask = np.asarray(val_idx), np.asarray(val_mask)
    train_fns, eval_fns, zero_grads = _replica_step_fns(states, batch_step, eval_step, arrays, source, class_,
                                                        use_class_labels)
    z = states[0].model.z_mean.out_features
    with dfit.graph_stream(device) as (stream, pool):
        common = dict(dtype=arrays[0].dtype, device=device, stream=stream, pool=pool)
        train = dfit.StepGraph(train_fns, nb=nb, batch=batch_size, noise_shape=(batch_size, z),
                               before_capture=zero_grads, **common)
        val = dfit.StepGraph(eval_fns, nb=val_idx.shape[0], batch=val_idx.shape[1],
                             noise_shape=(val_idx.shape[1], z), **common)
        val.load_plan(val_idx, val_mask)

        def run_train(sts, key, epoch):
            idx, mask = batch_plan(stream_idx, batch_size, shuffle=shuffle,
                                   generator=loop.key_generator(key, 0) if shuffle else None)
            gens = [loop.key_generator(key, 1, r, device=device) for r in replicas]
            return sts, _replica_rows(dfit.run_graphed_epoch(train, idx, mask, gens))

        def run_val(sts, key, epoch):
            with _at_x(sts):
                val.row.zero_()
                gens = [loop.key_generator(key, r, device=device) for r in replicas]
                for _ in range(val.nb):
                    val(gens)
            return _replica_rows(val.metrics)

        try:
            result = fit_ensemble(states, run_train_epoch=run_train, run_val_epoch=run_val,
                                  max_epochs=max_epochs, early_stopping_patience=early_stopping_patience,
                                  seed=seed, verbose=verbose, resume_dir=resume_dir,
                                  progress_every=progress_every, mesh=mesh)
        finally:
            graphs = dfit.release(train, val, zero_grads)
    result.graphs = graphs
    return result


def _replica_step_fns(states, batch_step, eval_step, arrays, source, class_, use_class_labels: bool):
    """The StepGraph step functions of each replica, ``fn(idx, mask, eps)``,
    for training and for validation, and the train graph's ``before_capture``
    (every replica's gradients dropped)."""

    def gather(idx):
        bc = class_[idx] if use_class_labels else None
        return [a[idx] for a in arrays] + [source[idx], bc]

    def train_fn(ts):
        return lambda idx, mask, eps: batch_step(ts, *gather(idx), mask, eps=eps)[1]

    def eval_fn(ts):
        return lambda idx, mask, eps: eval_step(ts.model, *gather(idx), mask, eps=eps)

    def zero_grads():
        for ts in states:
            ts.optimizer.zero_grad(set_to_none=True)

    return [train_fn(ts) for ts in states], [eval_fn(ts) for ts in states], zero_grads


def _replica_rows(m: torch.Tensor) -> Metrics:
    """A StepGraph's ``[3, K, nb]`` metrics as ``fit_ensemble`` reads an
    epoch's: Metrics of ``[nb, K]``."""
    return Metrics(*(x.T for x in m))


def _check_replica_plans(k: int, train_idx, val_idx, seeds):
    if not (len(train_idx) == len(val_idx) == len(seeds) == k):
        raise ValueError(f"plans of {len(train_idx)}/{len(val_idx)} replicas and {len(seeds)} seeds "
                         f"for {k} replicas")


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
    _check_replica_plans(k, train_idx, val_idx, seeds)
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


def device_fit_replica_plans(
    states: Sequence[TrainState],
    *,
    batch_step: Callable,
    eval_step: Callable,
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
    use_class_labels: bool = False,
    aot_dir: Optional[str] = None,
    aot_desc: str = "",
) -> EnsembleFitResult:
    """The JAX ``device_fit_replica_plans`` (hippie_tpu/train/ensemble.py):
    K replicas, each on its own FIXED plan (``train_idx``/``train_mask``
    ``[K, nb, B]``, ``val_*`` likewise; every replica's plan has the same
    ``nb`` and ``B``), their train steps as ONE CUDA graph replayed per row
    of the plans and their eval steps as another (train/device_fit.py:
    StepGraph with ``per_model_plans``); off the card the same steps run
    eagerly over the same buffers.

    ``batch_step``/``eval_step``/``use_class_labels`` are
    ``device_fit_ensemble``'s; the plans, ``seeds`` and the patience are
    ``host_fit_replica_plans``'s, whose draws replica k makes: epoch keys
    ``epoch_key(seeds[k], 2 * epoch, 1 | 2)``, train noise
    ``key_generator(key, 1)``, val noise ``key_generator(key)`` at its x
    iterate. Each replica stops at its own patience (``fit_ensemble``'s
    ``own_stops``): its model's state is frozen on the card at its stop
    epoch and restored at the end, it steps on inside the graph until every
    replica has stopped, its best is gated by its own stop (ROADMAP Queue 3
    decision 1, which the JAX program lacks) and its losses after the stop
    are NaN. So the result's weights, BatchNorm buffers, bests, best epochs,
    losses and ``epochs_run`` are ``host_fit_replica_plans``'s bit for bit;
    ``state[k].optimizer`` holds the loop's final optimizer state, not the
    one at replica k's stop (as in JAX; no caller reads it). Each replica's
    first train and eval steps run eagerly on the capture stream, the second
    call captures, every later step is one ``cudaGraphLaunch`` for all K.
    A non-finite train loss of a replica still training raises
    FloatingPointError naming its epoch. ``aot_dir`` sets where the kernel
    libraries load from or are built (ops/_build.py); ``aot_desc`` is
    ignored, as in ``device_fit``."""
    from hippie_tpu_torch.ops import _build
    from hippie_tpu_torch.train import device_fit as dfit

    if aot_dir is not None:
        _build.set_default_dir(aot_dir)
    states = list(states)
    _check_replica_plans(n_replicas(states), train_idx, val_idx, seeds)
    device = arrays[0].device
    dfit.check_card(pmesh.active(), device)
    train_idx, val_idx = np.asarray(train_idx), np.asarray(val_idx)
    train_fns, eval_fns, zero_grads = _replica_step_fns(states, batch_step, eval_step, arrays, source, class_,
                                                        use_class_labels)
    z = states[0].model.z_mean.out_features

    def keys(epoch, phase):
        return [loop.epoch_key(s, 2 * epoch, phase) for s in seeds]

    with dfit.graph_stream(device) as (stream, pool):
        common = dict(dtype=arrays[0].dtype, device=device, stream=stream, pool=pool, per_model_plans=True)
        train = dfit.StepGraph(train_fns, nb=train_idx.shape[1], batch=train_idx.shape[2],
                               noise_shape=(train_idx.shape[2], z), before_capture=zero_grads, **common)
        val = dfit.StepGraph(eval_fns, nb=val_idx.shape[1], batch=val_idx.shape[2],
                             noise_shape=(val_idx.shape[2], z), **common)
        train.load_plan(train_idx, train_mask)  # the plans are fixed: one copy each
        val.load_plan(val_idx, val_mask)

        def run(graph, gens):
            graph.row.zero_()
            for _ in range(graph.nb):
                graph(gens)
            return _replica_rows(graph.metrics)

        def run_train(sts, _key, epoch):
            return sts, run(train, [loop.key_generator(key, 1, device=device) for key in keys(epoch, 1)])

        def run_val(sts, _key, epoch):
            with _at_x(sts):
                return run(val, [loop.key_generator(key, device=device) for key in keys(epoch, 2)])

        try:
            result = fit_ensemble(states, run_train_epoch=run_train, run_val_epoch=run_val,
                                  max_epochs=max_epochs, early_stopping_patience=early_stopping_patience,
                                  own_stops=True)
        finally:
            graphs = dfit.release(train, val, zero_grads)
    result.graphs = graphs
    return result


def shard_replicas(tree, mesh: pmesh.Mesh, axis_name: str = "data"):
    """This rank's replicas of ``tree``: K/N contiguous replicas of a list (of
    TrainStates, state_dicts, ...) or of the leading axis of a stacked tree
    (``stack_trees``). K must divide over the mesh's ranks, GSPMD's tiling
    rule; otherwise ValueError."""
    if axis_name != pmesh.AXIS:
        raise ValueError(f"the port's mesh has one axis, {pmesh.AXIS!r}, not {axis_name!r}")
    k = len(tree) if isinstance(tree, (list, tuple)) else _leading(tree)
    if k % mesh.size:
        raise ValueError(f"shard_replicas: {k} replicas do not divide over the {mesh.size} ranks of the "
                         "mesh (the replica axis must split evenly)")
    sl = pmesh.local_slice(k, mesh, "replicas")
    if isinstance(tree, (list, tuple)):
        return list(tree[sl])
    return _slice_tree(tree, sl)


def _leading(tree) -> int:
    if isinstance(tree, dict):
        return _leading(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _leading(tree[0])
    return tree.shape[0]


def _slice_tree(tree, sl: slice):
    if isinstance(tree, dict):
        return type(tree)((key, _slice_tree(v, sl)) for key, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_tree(v, sl) for v in tree)
    return tree[sl]


def _gather_replicas(local: List[dict], mesh: pmesh.Mesh) -> List[dict]:
    """Every rank's replicas' state_dicts (this rank's ``local``), in replica
    order, on every rank: one gather per key."""
    gathered = {key: pmesh.gather_rows(torch.stack([sd[key] for sd in local]), mesh).flatten(0, 1)
                for key in local[0]}
    return [type(local[0])((key, v[r]) for key, v in gathered.items())
            for r in range(mesh.size * len(local))]
