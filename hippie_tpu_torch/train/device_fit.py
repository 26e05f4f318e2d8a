"""The device fit loop: a stage fit whose steps are CUDA graphs replayed on
the card.

Counterpart of hippie_tpu/train/device_fit.py (``device_fit``), the JAX
default (``--fit-loop device``), which runs a whole stage fit as one XLA
``lax.while_loop``. Eager torch has no compiled program per fit; its
counterpart on the card is a CUDA graph: per stage, one train step and one
eval step are each captured once and replayed for every later step, so a
step costs the host a noise draw and one ``cudaGraphLaunch`` where the eager
step makes 1,200-2,600 launches from Python.

Each step of a graph reads static device buffers: the epoch's plan
``[nb, 2B]`` (the batch's indices, then its mask as 0/1), a row counter the
step advances, and the step's noise ``[B, z]``; the gathers from the
device-resident arrays run inside the graph, and each step writes its
(loss, mse, kl) into column ``row`` of a ``[3, 1, nb]`` metric buffer. The
same ``StepGraph`` runs the K replicas of a sweep or seed ensemble
(train/ensemble.py:device_fit_ensemble): one graph per step kind steps the
local replicas in turn over each row, with one noise slot and one metric
row per replica; with one plan per replica (``[R, nb, 2B]``) it runs the
k-fold refit's replicas (train/ensemble.py:device_fit_replica_plans). Per
epoch the host builds the plan with ``batch_plan`` exactly as the host loop
does (train/pipeline.py:fit_stage) and copies it in with one H2D copy from
pinned memory; the noise is drawn with the generator calls the host loop's
steps make, in the same order, into the static buffer before each replay,
so the draws are the host loop's bit for bit. A stage's first train and
eval steps run eagerly on the fit's stream (the warm-up: it builds kernels,
the optimizer state, the loss kernels' workspaces and the library handles,
and it is a real step of the trajectory); the second call captures and
replays. Train and eval graphs share one memory pool. Gradients follow
PyTorch's whole-network capture pattern: set to None before the capture,
allocated by the captured backward from the graph's pool, so they keep
their addresses across replays.

The epochs are the host loop's own: ``device_fit`` hands graphed train and
val epochs to ``loop.fit``, so the metric buffers come to the host in ONE
fetch per epoch, the epoch losses are the same ``np.mean`` of the same
float32 values, and the best snapshot, patience, the finite check, the
resume files, the prints and the records are that loop's. So for the same
seed, config and data the two loops give the same trajectory bit for bit:
losses, best epoch, parameters, BatchNorm buffers, optimizer state,
``.ckpt`` files; AdamW is ``fused`` on the card in both loops
(train/optim.py), so they run the same kernels.

The JAX semantics kept (hippie_tpu/train/device_fit.py:24-35): snapshot on
a strict improvement, stop once ``wait >= patience``, a non-finite train
loss raises FloatingPointError with its epoch, the epoch metric is the
unweighted mean over the executed batches; ``log_steps`` records per
executed train batch, the zero-epoch return, the "already early-stopped"
resume no-op. Progress: with ``progress_every=k`` the epoch prints and
``log_fn`` records come out every k epochs, without it after the stage (the
JAX loop's replay); the trajectory is the same either way.

Off the card there are no graphs: the same step functions over the same
buffers run eagerly (the CPU tests). On the card the loop captures or
raises; it never falls back to eager steps. Under an active mesh
(parallel/mesh.py) the NCCL collectives of a step are stream operations and
are captured with it, the FSDP step's too (parallel/fsdp.py keeps every
parameter in one fixed storage, gathered into in place); gloo carries CUDA
tensors through the host, which a graph cannot capture, so on the card it
raises ValueError (``--fit-loop host`` runs it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.ops import _build
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train import loop
from hippie_tpu_torch.train.loop import FitResult


class StepGraph:
    """One step kind (train or eval) of a stage over static device buffers,
    for R models stepped in turn over each row of one shared plan (or of
    one plan per model), and on the card its CUDA graph.

    ``fns[r](idx, mask, eps) -> Metrics`` is model r's step on a batch's
    indices ``[B]``, mask ``[B]`` and noise (a single model: one step
    function; the K replicas of train/ensemble.py:device_fit_ensemble: one
    per local replica). ``load_plan(idx, mask)`` sets an epoch's ``[nb, B]``
    plan (``[R, nb, B]`` with ``per_model_plans``: model r gathers its
    batches from row r, the k-fold refit's replicas of
    train/ensemble.py:device_fit_replica_plans) and rewinds the row
    counter; each call draws every model's noise
    into its slot of ``eps`` ``[R, *noise_shape]`` from its generator and
    runs the next row, the models in order: eagerly on its first call (and
    always off the card), captured on its second, replayed after.
    ``metrics`` ``[3, R, nb]`` holds each row's (loss, mse, kl) per model.
    ``before_capture`` runs just before the capture (the train step drops
    its gradients there)."""

    def __init__(self, fns: Sequence[Callable], *, nb: int, batch: int, noise_shape: Sequence[int],
                 dtype: torch.dtype, device: torch.device, stream=None, pool=None,
                 noise_view: Callable = lambda eps: eps, before_capture: Callable = lambda: None,
                 per_model_plans: bool = False):
        self.fns, self.nb, self.batch, self.dtype = list(fns), nb, batch, dtype
        self.device, self.stream, self.pool = device, stream, pool
        self.before_capture = before_capture
        n = len(self.fns)
        self.per_model_plans = per_model_plans
        plan_shape = (n, nb, 2 * batch) if per_model_plans else (nb, 2 * batch)
        self.plan = torch.zeros(plan_shape, dtype=torch.long, device=device)
        self.row = torch.zeros((1,), dtype=torch.long, device=device)
        self.eps = torch.zeros((n, *noise_shape), dtype=dtype, device=device)
        self.eps_local = [noise_view(e) for e in self.eps]
        self.metrics = torch.zeros((3, n, nb), dtype=torch.float32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = self.replays = 0
        self.capture_s = 0.0
        self._pinned = (torch.empty(plan_shape, dtype=torch.long, pin_memory=True)
                        if device.type == "cuda" else None)

    def load_plan(self, idx: np.ndarray, mask: np.ndarray):
        """The epoch's plan in one H2D copy (from pinned memory on the card:
        no sync; the epoch's fetch orders the next write after it)."""
        host = np.concatenate([np.asarray(idx, np.int64), np.asarray(mask).astype(np.int64)], axis=-1)
        if self._pinned is None:
            self.plan.copy_(torch.from_numpy(host))
        else:
            self._pinned.numpy()[...] = host
            self.plan.copy_(self._pinned, non_blocking=True)
        self.row.zero_()

    def _body(self):
        if self.per_model_plans:  # [R, 2B]: model r's row
            r = self.plan.index_select(1, self.row)[:, 0]
            idx, mask = r[:, :self.batch], r[:, self.batch:].to(self.dtype)
        else:  # [2B], every model's row
            r = self.plan.index_select(0, self.row)[0]
            idx, mask = r[:self.batch], r[self.batch:].to(self.dtype)
            idx, mask = [idx] * len(self.fns), [mask] * len(self.fns)
        ms = [fn(i, m, eps) for fn, i, m, eps in zip(self.fns, idx, mask, self.eps_local)]
        rows = torch.stack([m.loss for m in ms] + [m.mse for m in ms] + [m.kl for m in ms])
        self.metrics.index_copy_(2, self.row, rows.float().reshape(3, len(ms), 1))
        self.row.add_(1)

    def __call__(self, generators: Sequence[torch.Generator]):
        # torch.randn(shape, generator=...) is normal_ on a fresh tensor: the
        # same draw as the host loop's step makes
        for e, gen in zip(self.eps, generators):
            e.normal_(0.0, 1.0, generator=gen)
        self.calls += 1
        if self.graph is None and (self.device.type != "cuda" or self.calls == 1):
            self._body()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1

    def _capture(self):
        t0 = time.perf_counter()
        self.before_capture()
        g = torch.cuda.CUDAGraph()
        # thread_local: a checkpoint write in flight in another thread
        # (pipeline.BestTracker.flush_async) may use the card meanwhile
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
            self._body()
        self.graph = g
        self.capture_s = time.perf_counter() - t0


def run_graphed_epoch(train: StepGraph, idx: np.ndarray, mask: np.ndarray,
                      generators: Sequence[torch.Generator]) -> torch.Tensor:
    """One train epoch of ``train``: the ``[nb, B]`` plan loaded in one H2D
    copy, then ``nb`` calls, each drawing its noise from ``generators`` (one
    per model) before its row runs (eager, captured or replayed: see
    StepGraph). Returns ``train.metrics`` ``[3, R, nb]``, on the device and
    not waited for. The device fit loop's train epoch, and the epoch
    ``hippie-tpu-torch bench`` times (scripts/bench.py)."""
    train.load_plan(idx, mask)
    for _ in range(train.nb):
        train(generators)
    return train.metrics


@contextlib.contextmanager
def graph_stream(device: torch.device):
    """Where a fit's step graphs run: on the card a side stream, current
    inside and started after the caller's stream's work (the caller's stream
    waits for it on leaving), and one graph memory pool for both step kinds;
    off the card (None, None)."""
    if device.type != "cuda":
        yield None, None
        return
    outer, stream = torch.cuda.current_stream(device), torch.cuda.Stream(device)
    stream.wait_stream(outer)
    try:
        with torch.cuda.stream(stream):
            yield stream, torch.cuda.graph_pool_handle()
    finally:
        outer.wait_stream(stream)


def release(train: StepGraph, val: StepGraph, zero_grads: Callable) -> dict:
    """Drop a fit's two graphs, and with ``zero_grads`` the gradients the
    train graph's pool holds; returns the result's ``graphs`` record."""
    graphs = {"captured": train.graph is not None, "capture_s": train.capture_s + val.capture_s,
              "train_replays": train.replays, "eval_replays": val.replays}
    if train.graph is not None:
        zero_grads()
    train.graph = val.graph = None
    return graphs


def check_card(mesh, device: torch.device):
    """The device loop's refusal on the card: a gloo mesh."""
    if device.type == "cuda" and mesh is not None and mesh.backend != "nccl":
        raise ValueError(
            f"--fit-loop device on CUDA needs NCCL ranks: {mesh.backend} moves CUDA tensors through "
            "the host, which a CUDA graph cannot capture; run --fit-loop host")


def device_fit(
    ts,
    *,
    batch_step: Callable,
    eval_step: Callable,
    arrays: Sequence[torch.Tensor],
    source: torch.Tensor,
    class_: torch.Tensor,
    train_stream: np.ndarray,
    batch_size: int,
    val_idx: np.ndarray,
    val_mask: np.ndarray,
    max_epochs: int,
    early_stopping_patience: Optional[int],
    seed: int,
    use_class_labels: bool,
    shuffle: bool,
    limit_train_batches=None,
    eval_params_fn: Optional[Callable] = None,
    aot_dir: Optional[str] = None,
    aot_desc: str = "",
    log_fn: Optional[Callable[[dict], None]] = None,
    verbose: bool = True,
    lr: Optional[float] = None,
    progress_every: Optional[int] = None,
    log_steps: bool = False,
    resume_dir: Optional[str] = None,
) -> FitResult:
    """Fit a stage with graphed steps; returns the host loop's FitResult.

    ``batch_step(ts, *batch, bs, bc, bmask, eps=...) -> (ts, Metrics)`` and
    ``eval_step(model, *batch, bs, bc, bmask, eps=...) -> Metrics`` are
    train/step.py's per-batch steps, ``*batch`` the rows of each of
    ``arrays``. Each train epoch's plan is ``batch_plan`` over
    ``train_stream`` (shuffled when ``shuffle``) cut by
    ``limit_train_batches``; ``val_idx``/``val_mask`` is the fixed val plan.
    ``eval_params_fn(ts)`` is a context manager inside which the model holds
    the parameters to validate (schedule-free's x; None: the parameters).
    ``progress_every`` (None or 0: after the stage; every epoch with
    ``resume_dir``), ``log_steps`` and ``resume_dir`` are ``loop.fit``'s,
    which runs the epochs, so each loop resumes the other's stage.
    ``aot_dir``, the JAX program cache, sets where the kernel libraries load
    from or are built (ops/_build.py:set_default_dir); ``aot_desc`` (JAX's
    part of a program's key) is ignored: a library's key is its sources'."""
    if aot_dir is not None:
        _build.set_default_dir(aot_dir)
    device = arrays[0].device
    mesh = pmesh.active()
    check_card(mesh, device)
    stream_idx = np.asarray(train_stream)
    nb = loop.limit_count(max(1, -(-len(stream_idx) // batch_size)), limit_train_batches)
    val_idx, val_mask = np.asarray(val_idx), np.asarray(val_mask)
    if mesh is not None:
        val_idx, val_mask = pmesh.shard_epoch_inputs(mesh, val_idx, val_mask)
    z = ts.model.z_mean.out_features
    eval_ctx = eval_params_fn or (lambda _ts: contextlib.nullcontext())
    if resume_dir is not None and not progress_every:
        progress_every = 1  # per-epoch prints with per-epoch saves, as the JAX loop

    def gather(idx):
        bc = class_[idx] if use_class_labels else None
        return [a[idx] for a in arrays] + [source[idx], bc]

    def train_fn(idx, mask, eps):
        return batch_step(ts, *gather(idx), mask, eps=eps)[1]

    def eval_fn(idx, mask, eps):
        return eval_step(ts.model, *gather(idx), mask, eps=eps)

    with graph_stream(device) as (stream, pool):
        common = dict(batch=val_idx.shape[1], noise_shape=(batch_size, z), dtype=arrays[0].dtype, device=device,
                      stream=stream, pool=pool,
                      noise_view=((lambda eps: pmesh.batch_sharded(mesh, eps, batch_axis=0))
                                  if mesh is not None else (lambda eps: eps)))
        zero_grads = lambda: ts.optimizer.zero_grad(set_to_none=True)  # noqa: E731
        train = StepGraph([train_fn], nb=nb, before_capture=zero_grads, **common)
        val = StepGraph([eval_fn], nb=val_idx.shape[0], **common)
        val.load_plan(val_idx, val_mask)

        def run_train(state, key, epoch):
            idx, mask = loop.limit_batches(batch_plan(stream_idx, batch_size, shuffle=shuffle,
                                                      generator=loop.key_generator(key, 0)),
                                           limit_train_batches)
            if mesh is not None:
                idx, mask = pmesh.shard_epoch_inputs(mesh, idx, mask)
            metrics = run_graphed_epoch(train, idx, mask, [loop.key_generator(key, 1, device=device)])
            return state, _metrics(metrics[:, 0], mesh)

        def run_val(state, key, epoch):
            with eval_ctx(state):
                val.row.zero_()
                gens = [loop.key_generator(key, device=device)]
                for _ in range(val.nb):
                    val(gens)
            return _metrics(val.metrics[:, 0], mesh)

        try:
            result = loop.fit(ts, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=max_epochs,
                              early_stopping_patience=early_stopping_patience, seed=seed, log_fn=log_fn,
                              verbose=verbose, resume_dir=resume_dir, lr=lr,
                              progress_every=progress_every, log_steps=log_steps)
        finally:
            graphs = release(train, val, zero_grads)
    return dataclasses.replace(result, graphs=graphs)


class _Rows(NamedTuple):
    """A ``[3, nb]`` metric buffer's rows, as the host loop's Metrics."""

    loss: torch.Tensor
    mse: torch.Tensor
    kl: torch.Tensor


def _metrics(m: torch.Tensor, mesh) -> _Rows:
    """A StepGraph's ``[3, nb]`` metrics, summed over the ranks under a mesh
    (the host loop's ``_global_metrics``), as ``loop._fetch`` reads them."""
    if mesh is not None:
        m = pmesh.all_sum(m, mesh)
    return _Rows(*m)
