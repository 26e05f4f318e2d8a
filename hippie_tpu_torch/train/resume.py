"""Mid-run resume: a fit's full state on disk after every epoch.

Counterpart of hippie_tpu/train/orbax_io.py (``save_fit_state``,
``latest_fit_state``, ``resume_fit_state``, ``save_ensemble_fit_state``,
``resume_ensemble_fit_state``, ``_complete_entries``). The reference has no
mid-run resume: its stages restart from the best Lightning checkpoint. Here
a fit can persist, after every epoch, everything its next epoch reads: the
model's state_dict (parameters and BatchNorm buffers), the optimizer's
state_dict (float32 or bf16 AdamW moments, or the schedule-free state) and
the loop counters (``best_val``, ``best_epoch``, ``wait``). The fit loop
draws each epoch from (seed, epoch) alone (train/loop.py:epoch_key), so a
resumed fit continues the uninterrupted trajectory.

The port keeps its own on-disk format, since it reads no orbax:

  - ``epoch_%06d.pt``: one ``torch.save`` file per epoch; ``best_%06d.pt``
    the best snapshot (state_dict and optimizer state), written only on the
    epochs that improved it;
  - every file is written under a temporary name and renamed into place, so
    a killed save leaves a ``*.tmp.<pid>`` file, which is never a resume
    source and is reaped by the next completed save;
  - only the latest two entries of each kind are kept;
  - a ``best_`` file is trusted only when it is the one the restored counters
    name (``best_epoch``): a crash between the best write and the epoch write
    leaves a newer best that the resumed fit re-creates exactly;
  - files load with ``weights_only=True``: tensors saved on the card load on
    the live model's device, tensors saved on the host stay there (the
    AdamW ``step`` counters, which torch keeps on the host).

Under an active mesh (parallel/mesh.py) every rank builds the payload and
rank 0 alone writes it; every rank reads it back on resume. A K-replica fit
sharded over a mesh gathers its replicas' parts to one payload in the
unsharded layout, which rank 0 writes; each rank restores its own replicas.

A directory of hippie_tpu's orbax entries (``epoch_NNNNNN`` directories)
raises ValueError: neither package reads the other's resume state. The
Lightning ``.ckpt`` files stay the contract the two share.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.serialization import default_restore_location

from hippie_tpu_torch.parallel import mesh as pmesh

SUFFIX = ".pt"
_TMP = ".tmp."


def _complete_entries(directory: str, prefix: str) -> list:
    """The COMPLETE entries under ``directory`` named ``<prefix><6
    digits>.pt``, sorted. A save killed midway leaves
    ``<name>.pt.tmp.<pid>``, which this never lists."""
    pat = re.compile(re.escape(prefix) + r"\d{6}" + re.escape(SUFFIX))
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(n for n in names if pat.fullmatch(n))


def _refuse_orbax(directory: str):
    """Raise on a directory holding hippie_tpu's orbax entries."""
    for name in sorted(os.listdir(directory)):
        if re.fullmatch(r"(epoch|best)_\d{6}", name) and os.path.isdir(os.path.join(directory, name)):
            raise ValueError(
                f"{directory} holds hippie_tpu's orbax resume state ({name}/): the PyTorch port cannot "
                "read orbax state; resume it with hippie_tpu, or give the port an empty directory")


def _atomic_save(payload: dict, path: str):
    tmp = f"{path}{_TMP}{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _keep_latest_two(directory: str, prefix: str):
    for stale in _complete_entries(directory, prefix)[:-2]:
        os.unlink(os.path.join(directory, stale))


def _reap_tmp(directory: str):
    """Remove the temporary files of killed saves; this directory has one
    writer, whose own saves have all completed when this runs."""
    for name in os.listdir(directory):
        if _TMP in name:
            os.unlink(os.path.join(directory, name))


def _load(path: str, device) -> dict:
    target = str(torch.device(device))

    def place(storage, location):
        return storage if location == "cpu" else default_restore_location(storage, target)

    return torch.load(path, map_location=place, weights_only=True)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def save_fit_state(directory: str, epoch: int, state, extras: dict, best=None):
    """Persist a TrainState (model, optimizer) and the loop counters
    ``extras`` ({best_val, best_epoch, wait}) as ``epoch_<epoch>.pt``.

    ``best``: ``(state_dict, optimizer state_dict, best_epoch)``, passed only
    on the epochs that improved it, written first as ``best_<best_epoch>.pt``.
    Without it a restart whose remaining epochs never beat the restored
    ``best_val`` would return the resume point's weights under the earlier
    best's metrics (the pipeline's Lightning best checkpoint is written
    lazily, so it may not be on disk either)."""
    payload = {"epoch": int(epoch), "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),  # every rank: an FSDP state gathers
               "extras": {k: float(v) if k == "best_val" else int(v) for k, v in extras.items()}}
    if pmesh.is_writer():
        os.makedirs(directory, exist_ok=True)
        _refuse_orbax(directory)
        if best is not None:
            sd, opt, b_epoch = best
            _atomic_save({"model": sd, "optimizer": opt},
                         os.path.join(directory, f"best_{int(b_epoch):06d}{SUFFIX}"))
            _keep_latest_two(directory, "best_")
        _atomic_save(payload, os.path.join(directory, f"epoch_{int(epoch):06d}{SUFFIX}"))
        _keep_latest_two(directory, "epoch_")
        _reap_tmp(directory)
    pmesh.barrier()  # no rank reads the directory before the write is whole


def latest_fit_state(directory: str) -> Optional[str]:
    """The path of the latest complete epoch entry, or None (no directory,
    or none saved yet). Raises on a directory of orbax entries."""
    if not os.path.isdir(directory):
        return None
    _refuse_orbax(directory)
    entries = _complete_entries(directory, "epoch_")
    return os.path.join(directory, entries[-1]) if entries else None


def resume_fit_state(directory: str, state) -> Optional[Tuple[int, Any, dict, Any]]:
    """Restore the latest saved epoch into ``state``'s model and optimizer (in
    place, on the model's device); returns ``(epoch, state, extras, best)``,
    or None when nothing is saved. ``best`` is ``(state_dict, optimizer
    state_dict)`` of the ``best_`` entry the counters name, on the model's
    device, or None when there is none."""
    path = latest_fit_state(directory)
    if path is None:
        return None
    device = _device(state.model)
    payload = _load(path, device)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    extras = payload["extras"]
    best = None
    best_epoch = int(extras.get("best_epoch", -1))
    bpath = os.path.join(directory, f"best_{best_epoch:06d}{SUFFIX}")
    if best_epoch >= 0 and os.path.isfile(bpath):
        b = _load(bpath, device)
        best = (b["model"], b["optimizer"])
    return int(payload["epoch"]), state, extras, best


def _on_host(tree):
    """``tree`` with every tensor leaf copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, _on_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_host(v) for v in tree)
    return tree


def save_ensemble_fit_state(directory: str, epoch: int, states: Sequence, extras: dict,
                            best: Sequence[dict], mesh: Optional[pmesh.Mesh] = None):
    """The K-replica twin of ``save_fit_state``: every replica's model and
    optimizer state, the ``[K]`` counters of ``extras`` and every replica's
    best snapshot ``best[k]`` (a state_dict), in ONE atomic payload. Per-
    replica bests advance on most epochs, so a separate best file would save
    nothing, and one payload can never hold a best its counters do not
    match.

    ``mesh``: ``states`` and ``best`` are this rank's replicas
    (ensemble.shard_replicas); every rank calls this, the parts are
    gathered in replica order (on the host) and rank 0 writes the unsharded
    payload."""
    parts = {"models": [ts.model.state_dict() for ts in states],
             "optimizers": [ts.optimizer.state_dict() for ts in states], "best": list(best)}
    if mesh is not None:
        gathered = [None] * mesh.size
        dist.all_gather_object(gathered, _on_host(parts), group=mesh.group)
        parts = {k: [x for part in gathered for x in part[k]] for k in parts}
    if mesh is None or mesh.rank == 0:
        os.makedirs(directory, exist_ok=True)
        _refuse_orbax(directory)
        _atomic_save({"epoch": int(epoch), **parts,
                      "extras": {k: np.asarray(v).tolist() for k, v in extras.items()}},
                     os.path.join(directory, f"epoch_{int(epoch):06d}{SUFFIX}"))
        _keep_latest_two(directory, "epoch_")
        _reap_tmp(directory)
    if mesh is not None:
        dist.barrier(group=mesh.group)  # no rank reads the directory before the write is whole


def resume_ensemble_fit_state(directory: str, states: Sequence, mesh: Optional[pmesh.Mesh] = None
                              ) -> Optional[Tuple[int, List, dict, List[dict]]]:
    """Restore an interrupted K-replica fit into ``states`` (in place); returns
    ``(epoch, states, extras, best)`` with ``extras``' counters as numpy
    arrays (``best_val`` float64, ``best_epoch`` and ``wait`` int64) and
    ``best`` the replicas' best snapshots on their models' device, or None
    when nothing is saved. ``mesh``: ``states`` are this rank's replicas,
    restored from their slice of the payload (``best`` likewise)."""
    path = latest_fit_state(directory)
    if path is None:
        return None
    device = _device(states[0].model)
    payload = _load(path, device)
    k = len(payload["models"])
    want = len(states) * (1 if mesh is None else mesh.size)
    if k != want:
        raise ValueError(f"{path} holds {k} replicas, the fit has {want}")
    mine = slice(0, k) if mesh is None else pmesh.local_slice(k, mesh, "replicas")
    for ts, sd, opt in zip(states, payload["models"][mine], payload["optimizers"][mine]):
        ts.model.load_state_dict(sd)
        ts.optimizer.load_state_dict(opt)
    extras = {k: np.asarray(v, np.float64 if k == "best_val" else np.int64)
              for k, v in payload["extras"].items()}
    best = [type(b)((name, v.to(device)) for name, v in b.items()) for b in payload["best"][mine]]
    return int(payload["epoch"]), list(states), extras, best
