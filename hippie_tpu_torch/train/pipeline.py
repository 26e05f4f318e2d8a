"""The 3-stage HIPPIE pipelines: pretrain -> unsupervised fine-tune -> supervised.

Counterpart of hippie_tpu/train/pipeline.py (``PipelineConfig``,
``load_dataset``, ``load_pretrain_pool``, ``BestTracker``, ``_graft``,
``_seed_from_best``, the shared stage fit, ``_finetune_split_indices``, the
CSV exports, ``run_unimodal_pipeline``, ``run_multimodal_pipeline`` and
``run_pipeline``), the library side of scripts/train_model.py and
scripts/train_model_with_multimodal.py. Output filenames, CSV bytes and
checkpoint contents follow the JAX package; the quirks kept are its, first
for the unimodal pipeline:

  - leave-target-out pool assembly with the Q2 default (registry.pretrain_pool);
  - beta stays 1 in every stage (Q6); no gradient clip on the waveform model
    in stages 1-2, clip on the ISI model, both clipped in stage 3 (Q7);
  - the best model is reloaded after stage 1 (train_model.py:160-163);
  - stage-2 best tracking carries across stages 1-2 (one tracker per model,
    ``<ds>_<model>_model.ckpt``), so stage 3 may start from a stage-1 best;
  - stage-2 embeddings come from the last-epoch model on the fine-tune train
    split (train_model.py:235-237);
  - the fine-tune data drops NaN columns, the supervised data does not (Q13);
  - one balanced oversampled stream serves both stage-3 models; stage 3
    rebuilds each model with the training split's class count and loads the
    cross-stage best minus the class embedding, which stays fresh (Q10);
  - stage-3 embeddings are class-conditioned unless ``honest_eval``;
  - ``stage1_wave_ckpt`` and ``stage1_time_ckpt`` seed a model from a
    Lightning checkpoint and skip its stage-1 fit (with both, the pool is
    never loaded); the loaded weights are the tracker's best until stage 2
    improves on them.

and then for the joint (wave + ISI) pipeline, which trains one model:

  - beta is ``cfg.beta`` and the gradients are clipped in every stage;
  - stage 1 has 5 classes; stage 2 reloads the best model (the tracker
    carries across stages 1-2) and embeds the fine-tune *val* split, or
    every target row without ``finetune_without_labels``;
  - stage 3 as the unimodal one (class count of the training split, the
    cross-stage best minus the class embedding, the balanced stream, lr/10),
    then the KNN sweep on the joint embeddings only;
  - ``stage1_joint_ckpt`` is its stage-1 seam.

Every stage fit goes through ``fit_stage``, which runs the device fit loop
(train/device_fit.py: the steps as CUDA graphs replayed on the card;
``fit_loop="device"``, the JAX default) or the host loop (train/loop.py,
``"host"``), on the same trajectory bit for bit. Random draws: splits, shuffles and model inits come
from CPU ``torch.Generator``s and the reparameterization noise from a
generator on the data's device, each seeded from ``seed`` and a fixed path
(train/loop.py:epoch_key), where the JAX package folds the same integers into
jax.random keys; the bits differ between the packages, the structure does
not. The AdamW optimizer is fresh in every stage (with ``opt_state_dtype=
"bfloat16"`` its moments are stored in bf16). With ``optimizer=
"schedule-free"`` validation runs at the x iterate, every consumer of a fit
(checkpoints, embeddings, handoffs) gets x, and the averaging state (k,
weight_sum, lr_max, z, exp_avg_sq) carries over into the next stage's
optimizer, the stage-3 class embedding's entries fresh (Q10), training
resuming at y = train_params(x). The best checkpoints are written by a
background thread that overlaps the later stages (``BestTracker.
flush_async``), at the JAX pipeline's points. With ``resume`` every stage
fit saves its full state after each epoch under ``checkpoint_dir/resume/
<dataset>/<stage>`` (train/resume.py) and a re-run continues each fit where
it stopped, so an interrupted pipeline re-run with ``resume`` writes what an
uninterrupted one writes. ``discover_datasets`` registers the unknown
dataset directories of ``data_root`` first (data/registry.py), and
``profile_dir`` records the run with torch.profiler (utils/profiling.py:
trace). ``aot_dir`` is the JAX pipeline's AOT cache: the CUDA kernel
libraries load from, or are built into, its ``torch_kernels/``
(ops/_build.py), set before the first kernel loads in every rank.

Data parallelism (``dp_devices``, ``fsdp``): run inside each rank of a
``parallel.mesh.launch`` (the CLI's ``--dp-devices N`` does), the pipeline
takes the process group's mesh (``_dp_shardings``) and runs with it active:
the data are whole on every rank, every train and val epoch runs on this
rank's columns of its plan (train/step.py), the model starts from rank 0's
bits (``_place_train_state``), with ``fsdp`` the optimizer (AdamW or
schedule-free) shards its state per leaf (parallel/fsdp.py; either fit
loop), and every embedding
and KNN call shards its rows over the ranks (``mesh=_eval_mesh(cfg)`` at the
JAX sites). Every rank computes everything; rank 0 alone writes the files
(CSVs, ``.ckpt`` files and sidecars, resume files, logs, the trace), and its
results are every rank's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hippie_tpu_torch import export
from hippie_tpu_torch.data import registry, sampling
from hippie_tpu_torch.data.registry import write_csv
from hippie_tpu_torch.data.device_data import ArrayDataset, batch_plan, train_val_split
from hippie_tpu_torch.evaluate import embeddings as emb
from hippie_tpu_torch.evaluate import knn_eval, metrics
from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.ops import _build, preprocess
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train import checkpoint as ckpt_mod
from hippie_tpu_torch.train import loop, optim, step
from hippie_tpu_torch.utils.profiling import StageTimer, trace


@dataclass
class PipelineConfig:
    """The fields of hippie_tpu's PipelineConfig that the two pipelines read,
    with its defaults, plus the device the arrays and models live on."""

    z_dim: int = 5
    weight_decay: float = 0.01
    learning_rate: float = 0.001
    beta: float = 1.0  # the joint model's; the unimodal pipeline keeps 1 (Q6)
    dataset: str = "cellexplorer-celltype"
    finetune_without_labels: bool = True
    pretrain_max_epochs: int = 1
    finetune_max_epochs: int = 1
    supervised_max_epochs: int = 1
    batch_size: int = 512
    supervised_batch_size: int = 64
    early_stopping_patience: int = 30
    gradient_clip_val: float = 1.0
    train_val_split: float = 0.8
    finetune_split: float = 0.1
    limit_train_batches: Optional[float] = None
    limit_val_batches: Optional[float] = None
    model_type: str = "unimodal"  # or "multimodal"
    mod1_weight: float = 1.0
    mod2_weight: float = 1.0
    data_root: str = "datasets"
    output_dir: str = "."
    checkpoint_dir: str = "checkpoints"
    seed: int = 42
    class_hidden_dim: int = 5
    num_blocks: tuple = (2, 2, 2, 2)  # backbone depth; (2, 2, 2, 2) = ResNet18
    strict_leakage_guard: bool = False
    # register dataset directories under data_root that the registry lacks
    # (waveforms.csv + isi_dist.csv; registry.discover_datasets)
    discover_datasets: bool = False
    profile_dir: Optional[str] = None  # a torch.profiler trace of the run (utils/profiling.trace)
    resume: bool = False  # mid-run resume of every stage fit (train/resume.py)
    verbose: bool = True
    log_fn: Any = None  # optional callable(dict), one record per epoch
    # "device": each stage fit's steps as CUDA graphs replayed on the card
    # (train/device_fit.py; eager steps off the card); "host": the per-epoch
    # loop of eager steps (train/loop.py). The same trajectory bit for bit.
    fit_loop: str = "device"
    # device fit loop: print and log every N epochs (None: auto, chunks on
    # watched stages of more than 10 epochs; 0: after the stage)
    progress_every: Optional[int] = None
    # device fit loop: one {train_loss_step, ...} record per executed train
    # batch to log_fn (the reference's per-step self.log)
    log_every_step: bool = False
    drop_index_column: bool = False  # drop the CSV index feature (quirk Q4)
    honest_eval: bool = False  # stage-3 embeddings without class conditioning
    # data parallelism over this many ranks of a parallel.mesh.launch (None or
    # 1: one process); fsdp shards the parameters and the optimizer state
    dp_devices: Optional[int] = None
    fsdp: bool = False
    opt_state_dtype: Optional[str] = None  # "bfloat16": the AdamW moments stored in bf16
    optimizer: str = "adamw"  # or "schedule-free" (train/schedule_free.py)
    loss_backend: str = "xla"  # "pallas": the loss kernels of ops/cuda_ops.py
    block_backend: str = "xla"  # "pallas": the block kernels of ops/cuda_blocks.py
    device: str = "cuda"
    # Lightning stage-1 checkpoints that seed a model and skip its stage-1
    # fit; the geometry must be this pipeline's stage-1 config.
    # stage1_{wave,time}_ckpt: the unimodal pipeline; stage1_joint_ckpt: the
    # multimodal one.
    stage1_wave_ckpt: Optional[str] = None
    stage1_time_ckpt: Optional[str] = None
    stage1_joint_ckpt: Optional[str] = None
    # the kernel-library cache (hippie_tpu's AOT program cache): the CUDA
    # libraries load from, or are built into, aot_dir/torch_kernels
    # (ops/_build.py); None: build/kernels beside the package. The CLIs
    # default it to ~/.cache/hippie_tpu_aot, as JAX.
    aot_dir: Optional[str] = None


# ---------------------------------------------------------------------------
# Data assembly
# ---------------------------------------------------------------------------


def load_dataset(cfg: PipelineConfig, name: str, *, dropna: bool = False) -> ArrayDataset:
    """Load and preprocess one dataset into arrays on ``cfg.device``."""
    wf, isi = registry.load_raw(
        cfg.data_root, name, dropna=dropna, drop_index_column=cfg.drop_index_column
    )
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=cfg.device)
    src = torch.full((wf.shape[0],), registry.DATASET_SOURCE_IDS.get(name, 0),
                     dtype=torch.long, device=cfg.device)
    return ArrayDataset(wave=wave, isi=isi_p, source=src)


def load_pretrain_pool(cfg: PipelineConfig) -> ArrayDataset:
    """Leave-target-out pool (train_model.py:64-100); datasets whose files
    are missing are skipped, as the reference skips them."""
    names = registry.pretrain_pool(cfg.dataset, strict_leakage_guard=cfg.strict_leakage_guard)
    parts = []
    for name in names:
        try:
            part = load_dataset(cfg, name)
        except FileNotFoundError:
            if cfg.verbose:
                print(f"Folder {name} missing data files; skipping")
            continue
        if cfg.verbose:
            print(f"Folder {name} has shapes {tuple(part.wave.shape)} and {tuple(part.isi.shape)}")
        parts.append(part)
    if not parts:
        raise RuntimeError("no pretraining datasets available")
    ds = ArrayDataset.concat(parts)
    if cfg.verbose:
        print(f"Total waveforms {len(ds)} and total isi {len(ds)}")
    return ds


# ---------------------------------------------------------------------------
# Best checkpoints across stages
# ---------------------------------------------------------------------------


class BestTracker:
    """ModelCheckpoint(save_top_k=1, mode='min') semantics, shareable across
    stages like the reference's reused callback object.

    ``update_from_fit`` keeps the fit's best snapshot (device clones of the
    state_dict and the optimizer state) when it improves on the tracked
    best; a write puts it in ``path`` once, so a stage handoff reads the
    snapshot on the device (``seed_from_best``), never the file. As the JAX
    tracker does, the write runs in a background thread started by
    ``flush_async``, so it overlaps the later stages; the snapshots are
    clones no later fit touches. The thread fetches the snapshot in one copy
    (``checkpoint.host_tree``), converts it and saves it. ``wait()`` and
    ``flush()`` join the thread and re-raise its error. ``writes`` records
    each write's seconds: the fetch (``d2h_s``, of which ``pin_s``,
    ``copy_s`` and ``split_s``, see ``checkpoint.bulk_host_fetch``), the
    conversion (``convert_s``) and the save (``save_s``); ``wait_s`` the
    foreground's seconds spent joining.
    """

    def __init__(self, path: str):
        self.path = path
        self.best_val = math.inf
        self.best_state_dict = None
        self.best_opt = None  # survives the write: stage handoffs continue from it
        self._pending = None  # (state_dict, optimizer state, parameter keys, lr, wd) to write
        self._thread = None
        self._thread_err = None
        self.writes: List[dict] = []
        self.wait_s = 0.0

    def update_from_fit(self, result: loop.FitResult, param_keys, opt_meta) -> bool:
        if result.best_epoch >= 0 and result.best_val_loss < self.best_val:
            self.best_val = result.best_val_loss
            self.best_state_dict = result.best_state_dict
            self.best_opt = result.best_opt_state
            self._pending = (self.best_state_dict, self.best_opt, list(param_keys), *opt_meta)
            return True
        return False

    def _write(self, job, ready=None):
        """Write ``job``'s snapshot to ``path``: the .ckpt with the AdamW state
        in the ``optimizer_states[0]`` layout, or for schedule-free an empty
        ``optimizer_states`` and the sidecar."""
        sd, opt, keys, lr, wd = job
        split = {}
        t0 = time.perf_counter()
        sd, opt = ckpt_mod.host_tree((sd, opt), ready, split)
        t1 = time.perf_counter()
        if optim.find_schedule_free_state(opt) is None:
            sidecar = None
            opt_torch = ckpt_mod.adamw_state_to_torch(opt, sd, keys, lr=lr, weight_decay=wd)
        else:
            sidecar, opt_torch = optim.schedule_free_payload(opt, keys), None
        t2 = time.perf_counter()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if sidecar is not None:
            optim.write_sidecar(self.path, sidecar)
        ckpt_mod.save_lightning_ckpt(self.path, sd, optimizer_state=opt_torch)
        self.writes.append({"d2h_s": t1 - t0, **split, "convert_s": t2 - t1,
                            "save_s": time.perf_counter() - t2})
        if self._pending is job:
            self._pending = None

    def flush(self):
        """Write the best checkpoint if a new best is pending, after joining
        any write in flight. Under a mesh only rank 0 writes."""
        self.wait()
        if not pmesh.is_writer():
            self._pending = None
        if self._pending is not None:
            t0 = time.perf_counter()
            self._write(self._pending)
            self.wait_s += time.perf_counter() - t0

    def flush_async(self):
        """Start the pending write in a background thread (joining an
        earlier one first). The host fetch waits on an event recorded here,
        on the stream that made the snapshot."""
        self.wait()
        if not pmesh.is_writer():
            self._pending = None
        if self._pending is None:
            return
        job = self._pending
        ready = None
        device = next(iter(job[0].values())).device
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))

        def run():
            try:
                self._write(job, ready)
            except BaseException as e:  # re-raised on wait()
                self._thread_err = e

        # Non-daemon: if the pipeline dies mid-stage, interpreter shutdown
        # waits for the write in flight instead of killing it half done (the
        # write itself is atomic too, checkpoint.save_lightning_ckpt).
        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def wait(self):
        """Join the write in flight, if any, and re-raise its error."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self.wait_s += time.perf_counter() - t0
            self._thread = None
        if self._thread_err is not None:
            err, self._thread_err = self._thread_err, None
            raise err


def _graft(template: Dict[str, torch.Tensor], source: Dict[str, torch.Tensor], drop=()):
    """The template state_dict with ``source``'s tensors grafted in, except
    keys under a top-level module named in ``drop``, which keep the
    template's values; in the template's key order."""
    return {k: v if k.split(".")[0] in drop or k not in source else source[k]
            for k, v in template.items()}


def seed_from_best(model: torch.nn.Module, best_state_dict: Dict[str, torch.Tensor],
                   drop=("class_embedding",)):
    """Load a tracker's best snapshot into a freshly built ``model``, minus
    the modules in ``drop`` (the class embedding, quirk Q10), which keep the
    model's fresh values: the reference's reload-best-ckpt detour
    (train_model.py:333-347) without the file. Copies, so the snapshot stays
    valid for the tracker's write."""
    model.load_state_dict(_graft(model.state_dict(), best_state_dict, drop), strict=True)
    return model


# ---------------------------------------------------------------------------
# Stage fit
# ---------------------------------------------------------------------------


def _progress_chunk(cfg: PipelineConfig, max_epochs: int) -> Optional[int]:
    """Epoch chunk size for the device fit's live progress (the JAX
    ``_progress_chunk``): ``progress_every`` when given (0: none); in auto
    mode only multi-epoch stages someone is watching (verbose prints or a
    log_fn), in chunks of the patience clamped to 10-50."""
    if cfg.progress_every is not None:
        return cfg.progress_every if cfg.progress_every > 0 else None
    if not cfg.verbose and cfg.log_fn is None:
        return None
    if max_epochs <= 10:
        return None
    patience = cfg.early_stopping_patience or 10
    return max(10, min(patience, 50))


def fit_stage(
    *,
    cfg: PipelineConfig,
    ts: step.TrainState,
    arrays: Tuple[torch.Tensor, ...],
    source: torch.Tensor,
    class_: torch.Tensor,
    train_indices: np.ndarray,
    val_indices: np.ndarray,
    batch_size: int,
    max_epochs: int,
    shuffle_train: bool,
    use_class_labels: bool,
    make_steps,
    make_epoch_fns,
    fixed_train_stream: Optional[np.ndarray] = None,
    stage_seed: int = 0,
    lr: Optional[float] = None,
    resume_dir: Optional[str] = None,
) -> loop.FitResult:
    """One Trainer.fit, shared by both model families (the JAX ``_fit_stage``).

    ``arrays`` holds the per-sample gather sources ((data,) unimodal, (wave,
    isi) joint); the family enters through ``make_steps``, which builds its
    per-batch (batch_step, eval_step) for the device loop, and
    ``make_epoch_fns``, its (train_epoch, eval_epoch) for the host loop
    (``cfg.fit_loop``). Each train
    epoch's plan is ``batch_plan`` over the stream (shuffled when
    ``shuffle_train``), cut by ``limit_train_batches``;
    the val plan is fixed and cut by ``limit_val_batches``. The shuffle draws
    from a CPU generator split from the epoch's key, the noise from a
    generator on the data's device (``torch.randperm`` takes a CPU generator
    here, the model's ``torch.randn`` one on its device). ``resume_dir`` goes
    to the loop; either loop resumes the other's files.
    """
    val_idx, val_mask = loop.limit_batches(batch_plan(val_indices, batch_size, shuffle=False),
                                           cfg.limit_val_batches)
    stream = np.asarray(fixed_train_stream if fixed_train_stream is not None else train_indices)
    device = arrays[0].device
    fit_loop = cfg.fit_loop
    if fit_loop == "device":
        from hippie_tpu_torch.train import device_fit

        batch_step, eval_step = make_steps()
        return _finalize_fit(cfg, device_fit.device_fit(
            ts, batch_step=batch_step, eval_step=eval_step, arrays=arrays, source=source,
            class_=class_, train_stream=stream, batch_size=batch_size, val_idx=val_idx,
            val_mask=val_mask, max_epochs=max_epochs,
            early_stopping_patience=cfg.early_stopping_patience, seed=cfg.seed + stage_seed,
            use_class_labels=use_class_labels, shuffle=shuffle_train,
            limit_train_batches=cfg.limit_train_batches,
            eval_params_fn=lambda state: optim.evaluated_at_x(state.optimizer),  # schedule-free's x
            log_fn=cfg.log_fn, verbose=cfg.verbose, lr=lr,
            progress_every=_progress_chunk(cfg, max_epochs), log_steps=cfg.log_every_step,
            resume_dir=resume_dir))
    if fit_loop != "host":
        raise ValueError(f"fit_loop must be 'device' or 'host', got {fit_loop!r}")

    train_epoch, eval_epoch = make_epoch_fns()

    def run_train(state, key, epoch):
        idx, mask = loop.limit_batches(
            batch_plan(stream, batch_size, shuffle=shuffle_train, generator=loop.key_generator(key, 0)),
            cfg.limit_train_batches)
        return train_epoch(state, *arrays, source, class_, idx, mask,
                           generator=loop.key_generator(key, 1, device=device))

    def run_val(state, key, epoch):
        with optim.evaluated_at_x(state.optimizer):  # schedule-free validates x
            return eval_epoch(state.model, *arrays, source, class_, val_idx, val_mask,
                              generator=loop.key_generator(key, device=device))

    return _finalize_fit(cfg, loop.fit(
        ts, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=max_epochs,
        early_stopping_patience=cfg.early_stopping_patience, seed=cfg.seed + stage_seed,
        verbose=cfg.verbose, log_fn=cfg.log_fn, lr=lr, resume_dir=resume_dir,
    ))


@torch.no_grad()
def _finalize_fit(cfg: PipelineConfig, result: loop.FitResult) -> loop.FitResult:
    """With schedule-free, everything downstream of a fit (checkpoints,
    embeddings, stage handoffs) consumes the averaged x iterate, the
    reference's .eval() mode switch (optimizers.py:82-92): the best snapshot's
    parameters and the model's become x, computed from their own optimizer
    states. The identity for AdamW."""
    if cfg.optimizer != "schedule-free":
        return result
    model = result.state.model
    keys = ckpt_mod.parameter_key_order(model)
    best = result.best_state_dict
    if result.best_opt_state is not None:
        best = type(best)(best)
        best.update(zip(keys, optim.maybe_eval_params(result.best_opt_state, [best[k] for k in keys])))
    ps = list(model.parameters())
    torch._foreach_copy_(ps, optim.maybe_eval_params(result.state.optimizer, ps))
    return dataclasses.replace(result, best_state_dict=best)


def _optimizer(cfg: PipelineConfig, model: torch.nn.Module, lr: float, clip) -> torch.optim.Optimizer:
    """A fresh optimizer of ``cfg.optimizer`` over ``model``'s parameters;
    with ``fsdp``, sharded over the active mesh (parallel/fsdp.py)."""
    if not cfg.fsdp:
        return optim.make_optimizer(model.parameters(), lr, cfg.weight_decay, clip,
                                    state_dtype=cfg.opt_state_dtype, algorithm=cfg.optimizer)
    from hippie_tpu_torch.parallel.fsdp import ShardedOptimizer

    return ShardedOptimizer(model, _dp_shardings(cfg), lambda ps: optim.make_optimizer(
        ps, lr, cfg.weight_decay, None, state_dtype=cfg.opt_state_dtype, algorithm=cfg.optimizer), clip)


@torch.no_grad()
def _sf_fork_state(cfg: PipelineConfig, model: torch.nn.Module, lr: float, clip, prev_opt,
                   drop=()) -> step.TrainState:
    """A stage warm start that CONTINUES schedule-free averaging.

    A fresh optimizer would restart the run-weighted average (k=0, fresh z)
    at every stage boundary; instead the previous stage's (k, weight_sum,
    lr_max, z, exp_avg_sq) are carried into the fresh one, except for the
    parameters under a top-level module in ``drop`` (the stage-3 class
    embedding, quirk Q10), which keep their fresh z (their own value) and
    zero exp_avg_sq; training resumes at y = train_params(x). ``model`` must
    hold the x iterate, which is what ``_finalize_fit`` hands every
    consumer of a schedule-free fit. Under FSDP the fork runs over this
    rank's shards (the previous state's whole leaves cut to them), and the
    model's parameters are gathered from them after."""
    opt = _optimizer(cfg, model, lr, clip)
    prev = optim.find_schedule_free_state(prev_opt)
    if prev is None:  # an AdamW or unfitted predecessor: a plain fork
        return step.TrainState(model, opt)
    from hippie_tpu_torch.train.schedule_free import train_params

    group = opt.param_groups[0]
    ps = group["params"]
    local = getattr(opt, "local", lambda leaves: leaves)  # this rank's parts of whole leaves
    keys = ckpt_mod.parameter_key_order(model)
    if len(prev.z) != len(ps):
        raise ValueError(f"schedule-free state of {len(prev.z)} parameters for {len(ps)}")
    for name in ("k", "weight_sum", "lr_max"):
        group[name].copy_(getattr(prev, name))
    keep = [i for i, k in enumerate(keys) if k.split(".")[0] not in drop]
    for name, src in (("z", local(prev.z)), ("exp_avg_sq", local(prev.exp_avg_sq))):
        torch._foreach_copy_([opt.state[ps[i]][name] for i in keep], [src[i] for i in keep])
    torch._foreach_copy_(ps, train_params(ps, [opt.state[p]["z"] for p in ps], prev.b1))
    if getattr(opt, "is_sharded", False):
        opt.gather()
    return step.TrainState(model, opt)


def _stage_fork(cfg: PipelineConfig, model: torch.nn.Module, lr: float, clip, prev_opt,
                drop=()) -> step.TrainState:
    """The next stage's TrainState on ``model``: schedule-free continues the
    averaging from ``prev_opt`` (a tracker's or a fit's optimizer state);
    AdamW gets the reference's fresh per-fit optimizer (configure_optimizers
    per Trainer.fit)."""
    if cfg.optimizer == "schedule-free" and prev_opt is not None:
        return _sf_fork_state(cfg, model, lr, clip, prev_opt, drop)
    return step.TrainState(model, _optimizer(cfg, model, lr, clip))


def _unimodal_loss(cfg: PipelineConfig, beta: float) -> dict:
    return dict(beta=beta, loss_backend=cfg.loss_backend, block_backend=cfg.block_backend)


def _multimodal_loss(cfg: PipelineConfig) -> dict:
    return dict(beta=cfg.beta, mod1_weight=cfg.mod1_weight, mod2_weight=cfg.mod2_weight,
                loss_backend=cfg.loss_backend, block_backend=cfg.block_backend)


def stage_steps(cfg: PipelineConfig, joint: bool, beta: float = 1.0):
    """The per-batch (batch_step, eval_step) a stage fit of either model
    family runs on the device loop (``fit_unimodal_stage`` with ``beta``,
    ``fit_multimodal_stage`` with ``cfg.beta``)."""
    if joint:
        return step.make_multimodal_steps(**_multimodal_loss(cfg))
    return step.make_unimodal_steps(**_unimodal_loss(cfg, beta))


def fit_unimodal_stage(*, cfg: PipelineConfig, data: torch.Tensor, beta: float,
                       use_class_labels: bool, **kw) -> loop.FitResult:
    """One Trainer.fit of a unimodal model on ``data`` [N, L] (fit_stage's
    other keywords: ``ts``, ``source``, ``class_``, the indices, ...)."""
    return fit_stage(
        cfg=cfg, arrays=(data,), use_class_labels=use_class_labels,
        make_steps=lambda: stage_steps(cfg, False, beta),
        make_epoch_fns=lambda: step.make_unimodal_epoch_fns(
            use_class_labels=use_class_labels, **_unimodal_loss(cfg, beta)), **kw)


def fit_multimodal_stage(*, cfg: PipelineConfig, wave: torch.Tensor, isi: torch.Tensor,
                         use_class_labels: bool, **kw) -> loop.FitResult:
    """One Trainer.fit of the joint model on (wave [N, 50], isi [N, 100]),
    with ``cfg.beta`` and the modality weights."""
    return fit_stage(
        cfg=cfg, arrays=(wave, isi), use_class_labels=use_class_labels,
        make_steps=lambda: stage_steps(cfg, True),
        make_epoch_fns=lambda: step.make_multimodal_epoch_fns(use_class_labels=use_class_labels,
                                                              **_multimodal_loss(cfg)),
        **kw)


def _dp_shardings(cfg: PipelineConfig) -> Optional[pmesh.Mesh]:
    """The mesh of ``cfg.dp_devices`` ranks (the process group's), or None
    for one process; ``fsdp`` without a mesh raises, as the JAX pipeline."""
    if not cfg.dp_devices or cfg.dp_devices <= 1:
        if cfg.fsdp:
            raise ValueError("--fsdp requires --dp-devices > 1 (a device mesh)")
        return None
    return pmesh.make_mesh(cfg.dp_devices)


def _eval_mesh(cfg: PipelineConfig) -> Optional[pmesh.Mesh]:
    """The mesh the embeddings and the KNN sweep shard their rows over (None
    for one process)."""
    return _dp_shardings(cfg)


def _place_train_state(cfg: PipelineConfig, ts: step.TrainState) -> step.TrainState:
    """Under a mesh every rank starts a stage from rank 0's parameters and
    buffers (a broadcast); the optimizer is fresh, or sharded with ``fsdp``
    over those parameters, so it is built after."""
    if _dp_shardings(cfg) is not None:
        pmesh.replicated(ts.model)
        if getattr(ts.optimizer, "is_sharded", False):
            ts.optimizer.refresh_shards()
    return ts


def _stage_resume_dir(cfg: PipelineConfig, stage: str) -> Optional[str]:
    """``checkpoint_dir/resume/<dataset>/<stage>`` with ``cfg.resume``, else
    None. Keyed by dataset: every target's stage fits have the same shapes,
    so a path without it would resume target B from target A's state (one
    process over many targets, scripts/sweep_targets.py)."""
    if not cfg.resume:
        return None
    return os.path.join(cfg.checkpoint_dir, "resume", cfg.dataset, stage)


def _prepare(cfg: PipelineConfig):
    """The steps of both pipelines before stage 1: dataset discovery and the
    output directories."""
    if cfg.discover_datasets:
        if not pmesh.is_writer():
            pmesh.barrier()  # rank 0 persists the new IDs first; the rest read them
        new = registry.discover_datasets(cfg.data_root)
        if pmesh.is_writer():
            pmesh.barrier()
        if new and cfg.verbose:
            print(f"discovered datasets: {', '.join(new)}")
    if pmesh.is_writer():
        os.makedirs(cfg.output_dir, exist_ok=True)
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)


def finetune_split_indices(cfg: PipelineConfig, n: int, generator: torch.Generator
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """10%/90% fine-tune split, or the chip earliest-timestamps rule
    (train_model.py:179-190)."""
    meta = registry.load_metadata(cfg.data_root, cfg.dataset)
    if meta is not None and "chip" in cfg.dataset:
        return registry.chip_finetune_split(meta)
    return train_val_split(n, cfg.finetune_split, generator)


# ---------------------------------------------------------------------------
# CSV exports (the reference's file contracts; the bytes pandas writes)
# ---------------------------------------------------------------------------


def export_pretraining_embeddings(cfg: PipelineConfig, tagged: Dict[str, np.ndarray]) -> dict:
    """pretraining_<ds>_<kind>_embeddings.csv: an index column and one
    'embeddings' column whose cells are numpy's print of each row
    (train_model.py:249-264)."""
    paths = {}
    for kind, arr in tagged.items():
        path = os.path.join(cfg.output_dir, f"pretraining_{cfg.dataset}_{kind}_embeddings.csv")
        if pmesh.is_writer():
            write_csv(path, ["", "embeddings"], ([i, np.asarray(r)] for i, r in enumerate(arr)))
        paths[kind] = path
    return paths


def export_knn_csv(cfg: PipelineConfig, kind: str, pred, true, le) -> str:
    path = os.path.join(cfg.output_dir, f"{cfg.dataset}_{kind}_knn.csv")
    if pmesh.is_writer():
        rows = zip(range(len(pred)), le.inverse_transform(pred), le.inverse_transform(true))
        write_csv(path, ["", "pred", "true"], rows)
    return path


def export_embeddings_csv(cfg: PipelineConfig, kind: str, embeddings, labels, le) -> str:
    arr = np.asarray(embeddings)
    path = os.path.join(cfg.output_dir, f"{cfg.dataset}_{kind}_embeddings.csv")
    header = [""] + [str(j) for j in range(arr.shape[1])] + ["label"]
    if pmesh.is_writer():
        write_csv(path, header, ([i, *arr[i], lab] for i, lab in enumerate(le.inverse_transform(labels))))
    return path


# ---------------------------------------------------------------------------
# Unimodal pipeline (scripts/train_model.py)
# ---------------------------------------------------------------------------

MODALITIES = ("wave", "time")


def model_config(cfg: PipelineConfig, modality: str, num_classes: int) -> cvae.CVAEConfig:
    return cvae.CVAEConfig(
        z_dim=cfg.z_dim, output_size=50 if modality == "wave" else 100,
        class_hidden_dim=cfg.class_hidden_dim, num_sources=registry.NUM_SOURCES,
        num_classes=num_classes, num_blocks=tuple(cfg.num_blocks),
    )


def _init_state(cfg: PipelineConfig, cfg_m, init_key: int, lr: float, clip) -> step.TrainState:
    model = cvae.unimodal_cvae_init(cfg_m, loop.key_generator(cfg.seed, init_key), device=cfg.device)
    return _place_train_state(cfg, step.TrainState(model, _optimizer(cfg, model, lr, clip)))


def _seed_stage1(cfg: PipelineConfig, tracker: BestTracker, path: str, cfg_m, name: str
                 ) -> step.TrainState:
    """A stage-1 seam (``stage1_<name>_ckpt``): the model of the Lightning
    checkpoint at ``path`` in place of a stage-1 fit, its weights the
    tracker's best (``best_val`` stays inf, so the first stage-2 improvement
    takes over the file). Its geometry must be ``cfg_m``, the pipeline's
    stage-1 config."""
    model, lcfg = export.load_model_from_ckpt(path, multimodal=name == "joint",
                                              fallback_config=cfg_m, device=cfg.device)
    if tuple(lcfg) != tuple(cfg_m):
        raise ValueError(f"--stage1-{name}-ckpt geometry {lcfg} does not match this pipeline's "
                         f"stage-1 config {cfg_m}; re-run the sweep with matching --z-dim/--num-blocks")
    tracker.best_state_dict = loop.clone_tree(model.state_dict())
    if cfg.verbose:
        print(f"[stage 1] {name} model seeded from {path} (fit skipped)")
    return step.TrainState(model, None)


@contextlib.contextmanager
def _dp_context(cfg: PipelineConfig):
    """The config a rank runs (verbose, the trace and the log on rank 0
    only), with the mesh of ``cfg.dp_devices`` active; ``cfg`` as it is for
    one process."""
    mesh = _dp_shardings(cfg)
    if mesh is None:
        yield cfg
        return
    if mesh.rank != 0:
        cfg = dataclasses.replace(cfg, verbose=False, profile_dir=None, log_fn=None)
    with pmesh.data_parallel(mesh):
        yield cfg


def run_unimodal_pipeline(cfg: PipelineConfig,
                          trackers: Optional[Dict[str, BestTracker]] = None) -> Dict[str, Any]:
    """The three stages for the waveform and the ISI model, then the KNN
    evaluation and the exports. Returns the JAX pipeline's ``results`` keys.

    ``trackers``, when given, is filled with each checkpoint's BestTracker
    ("wave", "time", "wave_supervised", "time_supervised"), so a caller can
    hold the written files to the snapshots they came from.
    """
    _build.set_default_dir(cfg.aot_dir)  # before the first kernel loads, in every rank
    with _dp_context(cfg) as cfg:
        with trace(cfg.profile_dir, cfg.device):
            return _run_unimodal_pipeline(cfg, trackers)


def _run_unimodal_pipeline(cfg: PipelineConfig, trackers: Optional[Dict[str, BestTracker]]
                           ) -> Dict[str, Any]:
    timer = StageTimer()
    _prepare(cfg)
    seed = cfg.seed
    trackers = {} if trackers is None else trackers

    # ---------------- Stage 1: leave-target-out pretraining ----------------
    if not (cfg.stage1_wave_ckpt and cfg.stage1_time_ckpt):  # with both, no pool is needed
        with timer.stage("load_pool"):
            pool = load_pretrain_pool(cfg)
        tr_idx, va_idx = train_val_split(len(pool), cfg.train_val_split, loop.key_generator(seed, 0))

    states: Dict[str, step.TrainState] = {}
    prev_opts: Dict[str, Any] = {}  # schedule-free continuation, per model
    for mi, modality in enumerate(MODALITIES):
        clip = None if modality == "wave" else cfg.gradient_clip_val  # quirk Q7
        cfg_m = model_config(cfg, modality, num_classes=5)
        tracker = BestTracker(os.path.join(cfg.checkpoint_dir, f"{cfg.dataset}_{modality}_model.ckpt"))
        trackers[modality] = tracker
        stage1_ckpt = cfg.stage1_wave_ckpt if modality == "wave" else cfg.stage1_time_ckpt
        if stage1_ckpt:
            with timer.stage(f"load_stage1_{modality}"):
                states[modality] = _seed_stage1(cfg, tracker, stage1_ckpt, cfg_m, modality)
            prev_opts[modality] = None
            continue
        with timer.stage("setup"):
            ts = _init_state(cfg, cfg_m, 100 + mi, cfg.learning_rate, clip)
        if cfg.verbose:
            print(f"[stage 1] pretraining {modality} model ({cvae.param_count(ts.model):,} params)")
        with timer.stage(f"pretrain_{modality}"):
            result = fit_unimodal_stage(
                cfg=cfg, ts=ts, data=pool.wave if modality == "wave" else pool.isi,
                source=pool.source, class_=pool.source, train_indices=tr_idx, val_indices=va_idx,
                batch_size=cfg.batch_size, max_epochs=cfg.pretrain_max_epochs, beta=1.0,  # Q6
                use_class_labels=False, shuffle_train=True, stage_seed=10 + mi,
                lr=cfg.learning_rate, resume_dir=_stage_resume_dir(cfg, f"pretrain_{modality}"),
            )
        with timer.stage("ckpt_save"):
            tracker.update_from_fit(result, ckpt_mod.parameter_key_order(ts.model),
                                    (cfg.learning_rate, cfg.weight_decay))
        # the reference reloads the best ckpt after stage 1 (train_model.py:160-163)
        if tracker.best_state_dict is not None:
            ts.model.load_state_dict(tracker.best_state_dict)
        states[modality] = ts
        prev_opts[modality] = (tracker.best_opt if tracker.best_state_dict is not None
                               else result.best_opt_state)

    # ---------------- Stage 2: unsupervised fine-tune on the target --------
    with timer.stage("load_target"):
        target = load_dataset(cfg, cfg.dataset, dropna=True)  # quirk Q13
    target_source_id = registry.DATASET_SOURCE_IDS.get(cfg.dataset, 0)

    ft_lr = cfg.learning_rate / 10.0
    if cfg.finetune_without_labels:
        ft_tr, ft_va = finetune_split_indices(cfg, len(target), loop.key_generator(seed, 1))
        for mi, modality in enumerate(MODALITIES):
            clip = None if modality == "wave" else cfg.gradient_clip_val
            model = states[modality].model
            # a fresh AdamW per fit, as the reference's configure_optimizers;
            # schedule-free carries its averaging over
            ts = _stage_fork(cfg, model, ft_lr, clip, prev_opts[modality])
            if cfg.verbose:
                print(f"[stage 2] fine-tuning {modality} model on {cfg.dataset} (lr={ft_lr})")
            with timer.stage(f"finetune_{modality}"):
                result = fit_unimodal_stage(
                    cfg=cfg, ts=ts, data=target.wave if modality == "wave" else target.isi,
                    source=target.source, class_=target.source, train_indices=ft_tr, val_indices=ft_va,
                    batch_size=cfg.batch_size, max_epochs=cfg.finetune_max_epochs, beta=1.0,
                    use_class_labels=False,
                    shuffle_train=False,  # the reference's shuffle=False here (train_model.py:198-199)
                    stage_seed=20 + mi, lr=ft_lr,
                    resume_dir=_stage_resume_dir(cfg, f"finetune_{modality}"),
                )
            with timer.stage("ckpt_save"):
                trackers[modality].update_from_fit(result, ckpt_mod.parameter_key_order(model),
                                                   (ft_lr, cfg.weight_decay))
            # stage-2 embeddings use the LAST-epoch model (train_model.py:235)
            states[modality] = result.state
        emb_idx = torch.as_tensor(ft_tr, device=cfg.device).long()
    else:
        emb_idx = torch.arange(len(target), device=cfg.device)

    with timer.stage("embeddings"):
        ft_wave_emb, ft_isi_emb, ft_joint_emb = emb.get_embeddings(
            states["wave"].model, states["time"].model,
            target.wave[emb_idx], target.isi[emb_idx], target.source[emb_idx], mesh=_eval_mesh(cfg))
    pretrain_paths = export_pretraining_embeddings(
        cfg, {"waveform": ft_wave_emb, "isi": ft_isi_emb, "joint": ft_joint_emb})

    # ---------------- Stage 3: supervised with class conditioning ----------
    with timer.stage("load_target"):
        sup_wf, sup_isi = registry.load_raw(cfg.data_root, cfg.dataset,
                                            drop_index_column=cfg.drop_index_column)  # no dropna (Q13)
        sup_wave, sup_isi_p = preprocess.preprocess_pair(sup_wf, sup_isi, device=cfg.device)
        sup_labels, le = registry.load_supervised_labels(cfg.data_root, cfg.dataset)

    n = len(sup_wf)
    s_tr, s_va = train_val_split(n, cfg.train_val_split, loop.key_generator(seed, 2))
    label_train = sup_labels[s_tr]
    label_val = sup_labels[s_va]
    num_class_labels = int(len(np.unique(label_train)))

    labels_dev = torch.as_tensor(sup_labels, device=cfg.device).long()
    source_dev = torch.full((n,), target_source_id, dtype=torch.long, device=cfg.device)

    sup_models: Dict[str, torch.nn.Module] = {}
    sup_trackers: Dict[str, BestTracker] = {}
    # one balanced stream serves both modalities (fixed seed, same labels)
    train_stream = np.asarray(s_tr)[sampling.balanced_indices(label_train, seed=cfg.seed)]
    for mi, modality in enumerate(MODALITIES):
        cfg_m = model_config(cfg, modality, num_classes=num_class_labels)
        with timer.stage("setup"):
            model = cvae.unimodal_cvae_init(cfg_m, loop.key_generator(cfg.seed, 200 + mi),
                                            device=cfg.device)
            tk = trackers[modality]
            best = tk.best_state_dict if tk.best_state_dict is not None else \
                states[modality].model.state_dict()
            seed_from_best(model, best)  # minus the class embedding (quirk Q10)
            ts = _stage_fork(cfg, model, ft_lr, cfg.gradient_clip_val, tk.best_opt,
                             drop=("class_embedding",))
        with timer.stage("ckpt_save"):
            # stages 1-2 are final for this model: the write overlaps the supervised fits
            trackers[modality].flush_async()
        tracker = BestTracker(
            os.path.join(cfg.checkpoint_dir, f"{cfg.dataset}_{modality}_model_supervised.ckpt"))
        if cfg.verbose:
            print(f"[stage 3] supervised {modality} training ({num_class_labels} classes)")
        with timer.stage(f"supervised_{modality}"):
            result = fit_unimodal_stage(
                cfg=cfg, ts=ts, data=sup_wave if modality == "wave" else sup_isi_p,
                source=source_dev, class_=labels_dev, train_indices=np.asarray(s_tr),
                val_indices=np.asarray(s_va), batch_size=cfg.supervised_batch_size,
                max_epochs=cfg.supervised_max_epochs, beta=1.0, use_class_labels=True,
                shuffle_train=False, fixed_train_stream=train_stream, stage_seed=30 + mi, lr=ft_lr,
                resume_dir=_stage_resume_dir(cfg, f"supervised_{modality}"),
            )
        with timer.stage("ckpt_save"):
            tracker.update_from_fit(result, ckpt_mod.parameter_key_order(ts.model),
                                    (ft_lr, cfg.weight_decay))
            tracker.flush_async()  # overlaps the evaluation and exports below
        if tracker.best_state_dict is not None:
            ts.model.load_state_dict(tracker.best_state_dict)
        sup_models[modality] = ts.model
        sup_trackers[modality] = tracker
        trackers[f"{modality}_supervised"] = tracker

    # ---------------- Evaluation: embeddings + KNN sweep --------------------
    tr_dev = torch.as_tensor(s_tr, device=cfg.device).long()
    va_dev = torch.as_tensor(s_va, device=cfg.device).long()
    # The reference extracts stage-3 embeddings WITH class conditioning
    # (train_model.py:407-413), a label leak; honest_eval opts out.
    with timer.stage("embeddings"):
        wave_tr, isi_tr, joint_tr = emb.get_embeddings(
            sup_models["wave"], sup_models["time"], sup_wave[tr_dev], sup_isi_p[tr_dev],
            source_dev[tr_dev], None if cfg.honest_eval else labels_dev[tr_dev], mesh=_eval_mesh(cfg))
        wave_va, isi_va, joint_va = emb.get_embeddings(
            sup_models["wave"], sup_models["time"], sup_wave[va_dev], sup_isi_p[va_dev],
            source_dev[va_dev], None if cfg.honest_eval else labels_dev[va_dev], mesh=_eval_mesh(cfg))

    neighbor_options = list(range(5, 20))  # train_model.py:419
    accs: Dict[str, List[float]] = {}
    preds_by_kind: Dict[str, Dict[int, np.ndarray]] = {}
    with timer.stage("knn_eval"):
        for kind, e_tr, e_va in (("joint", joint_tr, joint_va), ("waveform", wave_tr, wave_va),
                                 ("isi", isi_tr, isi_va)):
            preds = knn_eval.knn_predict_sweep(e_tr, label_train, e_va, neighbor_options,
                                               device=cfg.device, mesh=_eval_mesh(cfg))
            preds_by_kind[kind] = preds
            accs[kind] = [metrics.balanced_accuracy_score(label_val, preds[k]) for k in neighbor_options]

    results: Dict[str, Any] = {
        "label_encoder": le,
        "neighbor_options": neighbor_options,
        "balanced_accuracy": accs,
        "best": {},
        "paths": {"pretraining_embeddings": pretrain_paths},
        "num_class_labels": num_class_labels,
        "checkpoints": {m: trackers[m].path for m in MODALITIES},
        "supervised_checkpoints": {m: t.path for m, t in sup_trackers.items()},
    }
    for kind in ("waveform", "isi", "joint"):
        best_k = neighbor_options[int(np.argmax(accs[kind]))]
        pred = preds_by_kind[kind][best_k]
        cm = metrics.confusion_matrix(label_val, pred, labels=np.arange(len(le.classes_)))
        results["best"][kind] = {"k": best_k, "balanced_accuracy": float(np.max(accs[kind])),
                                 "confusion_matrix": cm, "pred": pred}
        results["paths"][f"{kind}_knn"] = export_knn_csv(cfg, kind, pred, label_val, le)

    # full-dataset embeddings export (train_model.py:480-507)
    with timer.stage("embeddings"):
        wave_all, isi_all, joint_all = emb.get_embeddings(
            sup_models["wave"], sup_models["time"], sup_wave, sup_isi_p, source_dev,
            None if cfg.honest_eval else labels_dev, mesh=_eval_mesh(cfg))
    for kind, arr in (("waveform", wave_all), ("isi", isi_all), ("joint", joint_all)):
        results["paths"][f"{kind}_embeddings"] = export_embeddings_csv(cfg, kind, arr, sup_labels, le)

    with timer.stage("ckpt_save"):
        for t in [trackers[m] for m in MODALITIES] + list(sup_trackers.values()):
            t.flush()
    results["label_val"] = label_val
    results["label_train"] = label_train
    results["timings"] = dict(timer.timings)
    if cfg.verbose and timer.timings:
        print("stage timings:", timer.summary())
    return results



# ---------------------------------------------------------------------------
# Multimodal pipeline (scripts/train_model_with_multimodal.py)
# ---------------------------------------------------------------------------


def joint_model_config(cfg: PipelineConfig, num_classes: int) -> cvae.MultiModalConfig:
    return cvae.MultiModalConfig(
        z_dim=cfg.z_dim, class_hidden_dim=cfg.class_hidden_dim, num_sources=registry.NUM_SOURCES,
        num_classes=num_classes, num_blocks=tuple(cfg.num_blocks),
    )


def _init_joint(cfg: PipelineConfig, mm_cfg, init_key: int, lr: float) -> step.TrainState:
    model = cvae.multimodal_cvae_init(mm_cfg, loop.key_generator(cfg.seed, init_key), device=cfg.device)
    return _place_train_state(cfg, step.TrainState(model, _optimizer(cfg, model, lr, cfg.gradient_clip_val)))


def run_multimodal_pipeline(cfg: PipelineConfig,
                            trackers: Optional[Dict[str, BestTracker]] = None) -> Dict[str, Any]:
    """The three stages for the joint wave + ISI model, then the KNN sweep on
    its embeddings and the exports. Returns the JAX pipeline's ``results``
    keys; ``trackers``, when given, is filled with "joint" and
    "joint_supervised"."""
    _build.set_default_dir(cfg.aot_dir)  # before the first kernel loads, in every rank
    with _dp_context(cfg) as cfg:
        with trace(cfg.profile_dir, cfg.device):
            return _run_multimodal_pipeline(cfg, trackers)


def _run_multimodal_pipeline(cfg: PipelineConfig, trackers: Optional[Dict[str, BestTracker]]
                             ) -> Dict[str, Any]:
    timer = StageTimer()
    _prepare(cfg)
    seed = cfg.seed
    trackers = {} if trackers is None else trackers

    # ---------------- Stage 1: leave-target-out pretraining ----------------
    mm_cfg = joint_model_config(cfg, num_classes=5)
    tracker = trackers["joint"] = BestTracker(
        os.path.join(cfg.checkpoint_dir, f"{cfg.dataset}_joint_model.ckpt"))
    if cfg.stage1_joint_ckpt:  # no pool and no fit
        with timer.stage("load_stage1_joint"):
            model = _seed_stage1(cfg, tracker, cfg.stage1_joint_ckpt, mm_cfg, "joint").model
        prev_opt = None
    else:
        with timer.stage("load_pool"):
            pool = load_pretrain_pool(cfg)
        tr_idx, va_idx = train_val_split(len(pool), cfg.train_val_split, loop.key_generator(seed, 0))
        ts = _init_joint(cfg, mm_cfg, 100, cfg.learning_rate)
        if cfg.verbose:
            print(f"[stage 1] pretraining joint model ({cvae.param_count(ts.model):,} params)")
        with timer.stage("pretrain_joint"):
            result = fit_multimodal_stage(
                cfg=cfg, ts=ts, wave=pool.wave, isi=pool.isi, source=pool.source, class_=pool.source,
                train_indices=tr_idx, val_indices=va_idx, batch_size=cfg.batch_size,
                max_epochs=cfg.pretrain_max_epochs, use_class_labels=False, shuffle_train=True,
                stage_seed=10, lr=cfg.learning_rate, resume_dir=_stage_resume_dir(cfg, "pretrain_joint"),
            )
        tracker.update_from_fit(result, ckpt_mod.parameter_key_order(ts.model),
                                (cfg.learning_rate, cfg.weight_decay))
        model = ts.model
        if tracker.best_state_dict is not None:  # else the last state (max_epochs=0)
            model.load_state_dict(tracker.best_state_dict)
        prev_opt = tracker.best_opt if tracker.best_state_dict is not None else result.best_opt_state

    # ---------------- Stage 2: unsupervised fine-tune on the target --------
    target = load_dataset(cfg, cfg.dataset, dropna=True)  # quirk Q13
    ft_lr = cfg.learning_rate / 10.0
    if cfg.finetune_without_labels:
        ft_tr, ft_va = finetune_split_indices(cfg, len(target), loop.key_generator(seed, 1))
        ts = _stage_fork(cfg, model, ft_lr, cfg.gradient_clip_val, prev_opt)
        if cfg.verbose:
            print(f"[stage 2] fine-tuning joint model on {cfg.dataset} (lr={ft_lr})")
        with timer.stage("finetune_joint"):
            result = fit_multimodal_stage(
                cfg=cfg, ts=ts, wave=target.wave, isi=target.isi, source=target.source,
                class_=target.source, train_indices=ft_tr, val_indices=ft_va,
                batch_size=cfg.batch_size, max_epochs=cfg.finetune_max_epochs,
                use_class_labels=False, shuffle_train=False, stage_seed=20, lr=ft_lr,
                resume_dir=_stage_resume_dir(cfg, "finetune_joint"),
            )
        tracker.update_from_fit(result, ckpt_mod.parameter_key_order(model), (ft_lr, cfg.weight_decay))
        # the joint stage 2 reloads the best model and embeds the fine-tune
        # VAL split (train_model_with_multimodal.py:772-777)
        if tracker.best_state_dict is not None:
            model.load_state_dict(tracker.best_state_dict)
        emb_idx = torch.as_tensor(ft_va, device=cfg.device).long()
    else:
        emb_idx = torch.arange(len(target), device=cfg.device)
    ft_joint = emb.embed_multimodal(model, target.wave[emb_idx], target.isi[emb_idx],
                                    target.source[emb_idx], mesh=_eval_mesh(cfg)).cpu().numpy()
    pretrain_paths = export_pretraining_embeddings(cfg, {"joint": ft_joint})

    # ---------------- Stage 3: supervised with class conditioning ----------
    sup_wf, sup_isi = registry.load_raw(cfg.data_root, cfg.dataset,
                                        drop_index_column=cfg.drop_index_column)  # no dropna (Q13)
    sup_wave, sup_isi_p = preprocess.preprocess_pair(sup_wf, sup_isi, device=cfg.device)
    sup_labels, le = registry.load_supervised_labels(cfg.data_root, cfg.dataset)
    n = len(sup_wf)
    s_tr, s_va = train_val_split(n, cfg.train_val_split, loop.key_generator(seed, 2))
    label_train = sup_labels[s_tr]
    label_val = sup_labels[s_va]
    num_class_labels = int(len(np.unique(label_train)))

    sup_model = cvae.multimodal_cvae_init(joint_model_config(cfg, num_class_labels),
                                          loop.key_generator(cfg.seed, 200), device=cfg.device)
    # the cross-stage best minus the class embedding, which stays fresh (Q10)
    seed_from_best(sup_model, tracker.best_state_dict if tracker.best_state_dict is not None
                   else model.state_dict())
    with timer.stage("ckpt_save"):
        tracker.flush_async()  # stages 1-2 are final: the write overlaps the supervised fit
    ts = _stage_fork(cfg, sup_model, ft_lr, cfg.gradient_clip_val, tracker.best_opt,
                     drop=("class_embedding",))
    train_stream = np.asarray(s_tr)[sampling.balanced_indices(label_train, seed=cfg.seed)]
    labels_dev = torch.as_tensor(sup_labels, device=cfg.device).long()
    source_dev = torch.full((n,), registry.DATASET_SOURCE_IDS.get(cfg.dataset, 0), dtype=torch.long,
                            device=cfg.device)
    sup_tracker = trackers["joint_supervised"] = BestTracker(
        os.path.join(cfg.checkpoint_dir, f"{cfg.dataset}_joint_model_supervised.ckpt"))
    if cfg.verbose:
        print(f"[stage 3] supervised joint training ({num_class_labels} classes)")
    with timer.stage("supervised_joint"):
        result = fit_multimodal_stage(
            cfg=cfg, ts=ts, wave=sup_wave, isi=sup_isi_p, source=source_dev, class_=labels_dev,
            train_indices=np.asarray(s_tr), val_indices=np.asarray(s_va),
            batch_size=cfg.supervised_batch_size, max_epochs=cfg.supervised_max_epochs,
            use_class_labels=True, shuffle_train=False, fixed_train_stream=train_stream,
            stage_seed=30, lr=ft_lr, resume_dir=_stage_resume_dir(cfg, "supervised_joint"),
        )
    with timer.stage("ckpt_save"):
        sup_tracker.update_from_fit(result, ckpt_mod.parameter_key_order(ts.model),
                                    (ft_lr, cfg.weight_decay))
        sup_tracker.flush_async()  # overlaps the evaluation and exports below
    if sup_tracker.best_state_dict is not None:
        sup_model.load_state_dict(sup_tracker.best_state_dict)

    # ---------------- Evaluation: joint embeddings + KNN sweep --------------
    # class-conditioned like the reference (the label leak) unless honest_eval
    def embed(rows=None):
        sel = slice(None) if rows is None else torch.as_tensor(rows, device=cfg.device).long()
        cls = None if cfg.honest_eval else labels_dev[sel]
        return emb.embed_multimodal(sup_model, sup_wave[sel], sup_isi_p[sel], source_dev[sel],
                                    cls, mesh=_eval_mesh(cfg)).cpu().numpy()

    neighbor_options = list(range(5, 20))
    preds = knn_eval.knn_predict_sweep(embed(s_tr), label_train, embed(s_va), neighbor_options,
                                       device=cfg.device, mesh=_eval_mesh(cfg))
    accs = [metrics.balanced_accuracy_score(label_val, preds[k]) for k in neighbor_options]
    best_k = neighbor_options[int(np.argmax(accs))]
    pred = preds[best_k]
    cm = metrics.confusion_matrix(label_val, pred, labels=np.arange(len(le.classes_)))
    results: Dict[str, Any] = {
        "label_encoder": le,
        "neighbor_options": neighbor_options,
        "balanced_accuracy": {"joint": accs},
        "best": {"joint": {"k": best_k, "balanced_accuracy": float(np.max(accs)),
                           "confusion_matrix": cm, "pred": pred}},
        "paths": {"pretraining_embeddings": pretrain_paths},
        "num_class_labels": num_class_labels,
        "checkpoints": {"joint": tracker.path},
        "supervised_checkpoints": {"joint": sup_tracker.path},
        "label_val": label_val,
        "label_train": label_train,
    }
    results["paths"]["joint_knn"] = export_knn_csv(cfg, "joint", pred, label_val, le)
    results["paths"]["joint_embeddings"] = export_embeddings_csv(cfg, "joint", embed(), sup_labels, le)
    with timer.stage("ckpt_save"):
        tracker.flush()
        sup_tracker.flush()
    results["timings"] = dict(timer.timings)
    if cfg.verbose and timer.timings:
        print("stage timings:", timer.summary())
    return results


def run_pipeline(cfg: PipelineConfig, trackers: Optional[Dict[str, BestTracker]] = None
                 ) -> Dict[str, Any]:
    """The pipeline of ``cfg.model_type``; a stage-1 checkpoint given to the
    other pipeline raises."""
    if cfg.model_type == "multimodal":
        if cfg.stage1_wave_ckpt or cfg.stage1_time_ckpt:
            raise ValueError(
                "--stage1-{wave,time}-ckpt seed the UNIMODAL pipeline's "
                "stage 1; the multimodal pipeline takes --stage1-joint-ckpt")
        return run_multimodal_pipeline(cfg, trackers)
    if cfg.stage1_joint_ckpt:
        raise ValueError(
            "--stage1-joint-ckpt seeds the MULTIMODAL pipeline's stage 1; "
            "the unimodal pipeline takes --stage1-{wave,time}-ckpt")
    return run_unimodal_pipeline(cfg, trackers)
