"""Data parallelism across processes: one rank per device, the GSPMD
contract of the JAX package built by hand.

Counterpart of hippie_tpu/parallel/mesh.py (``make_mesh``, ``replicated``,
``batch_sharded``, ``fsdp_sharding_for``, ``shard_params_fsdp``,
``place_eval_inputs``, ``shard_epoch_inputs``). JAX runs one process over N
devices and GSPMD inserts the collectives; PyTorch runs one process per
device, so here each rank runs the same program on its share of every batch
and the collectives are explicit. The data-parallel step is the
single-process step on the global batch, up to float32 reduction order:

  - every masked BatchNorm takes its statistics over the global batch
    (nn/functional.py:batch_norm, the block kernels' seam in
    ops/cuda_blocks.py); ``row_count`` is the global count of real rows;
  - each rank's loss is its own rows' share, its local sum over the global
    count, so the summed gradients are the global batch's; differentiating a
    replicated global loss on every rank would make them N times too large;
  - the gradients are summed across ranks in one flat bucket
    (``sum_gradients``) and every rank applies the same update, so the ranks'
    parameters stay bit-equal. Gradients a kernel seam already reduced (the
    block kernels' BatchNorm gamma and beta) are marked with
    ``mark_reduced`` and left out of the bucket.

``launch`` spawns the ranks (NCCL on ``cuda:r``, gloo on the CPU, or gloo
ranks sharing one card through ``devices=`` and ``backend=``); inside a rank
``data_parallel(mesh)`` makes the mesh the active one, which the steps,
BatchNorm and the block kernels read through ``active()``. Without an active
mesh nothing here runs and the single-process path is unchanged.

Collectives take CUDA tensors on NCCL and CPU or CUDA tensors on gloo.
On gloo an all-gather is a sum of zeroed ``[world, ...]`` buffers in which
each rank fills its own row (the block kernels' seam gathers its moments
so on every backend) and a reduce-scatter an all-reduce plus a slice; a
sum with zeros is exact, so every rank gets the same bits.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The ranks of one process group along the ``data`` axis, seen from one
    rank: its index, the world size, its device and the backend."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Any = None  # the process group; None is the default group


_rank_device: Optional[torch.device] = None  # set by launch in each rank


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the current process group (``launch`` makes one). Unlike
    the JAX ``make_mesh``, which takes the first n devices, ``n_devices``
    must be the world size: a run never goes on with fewer ranks."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: run the ranks with parallel.mesh.launch")
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"a mesh of {n_devices} devices in a process group of {size} ranks")
    backend = dist.get_backend()
    device = _rank_device
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    return Mesh(dist.get_rank(), size, device, backend)


# ---------------------------------------------------------------------------
# Launching the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn, n: int, devices, backend: str, workdir: str, args):
    global _rank_device
    device = torch.device(devices[rank])
    _rank_device = device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores; more threads than cores spin against each other
        torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // n)))
    dist.init_process_group(backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                            world_size=n, rank=rank, timeout=datetime.timedelta(minutes=30))
    try:
        out = fn(Mesh(rank, n, device, backend), *args)
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException as e:
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps((time.time_ns(), rank, e, tb))
        except Exception:  # an exception that does not pickle travels as its text
            payload = pickle.dumps((time.time_ns(), rank, RuntimeError(f"rank {rank}: {e!r}"), tb))
        with open(os.path.join(workdir, f"err_{rank}.pkl"), "wb") as f:
            f.write(payload)
        raise
    finally:
        dist.destroy_process_group()


def check_devices(n: int, device: str):
    """Raise ValueError when ``n`` ranks on ``device`` cuda would need more
    GPUs than are visible (a run never goes on with fewer ranks)."""
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > visible:
            raise ValueError(f"{n} data-parallel ranks on cuda, but {visible} GPUs are visible")


def launch(fn: Callable, n: int, *args, device: str = "cuda", devices: Optional[Sequence] = None,
           backend: Optional[str] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` ranks and return their
    results in rank order.

    The ranks are processes started with the spawn method (``fn`` and its
    arguments must pickle); they meet at a ``file://`` rendezvous in a fresh
    temporary directory, so concurrent launches never collide on a port.
    ``device="cuda"``: rank r on ``cuda:r`` over NCCL, and more ranks than
    visible GPUs raise ValueError; ``device="cpu"``: gloo. ``devices`` (one
    per rank) and ``backend`` override both, e.g. two gloo ranks sharing
    ``cuda:0``. A rank that raises fails the launch: the other ranks are
    stopped and the first exception raised (by time) is re-raised here, its
    rank's traceback attached as a note.
    """
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    if devices is None:
        check_devices(n, device)
        devices = [f"cuda:{r}" for r in range(n)] if torch.device(device).type == "cuda" else ["cpu"] * n
    devices = [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    if backend is None:
        backend = "nccl" if all(torch.device(d).type == "cuda" for d in devices) else "gloo"
    import torch.multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="hippie_mesh_")
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, n, devices, backend, workdir, args),
                                 nprocs=n, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except Exception as failure:
            errs = []
            for r in range(n):
                path = os.path.join(workdir, f"err_{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        errs.append(pickle.load(f))
            if not errs:
                raise
            _, rank, err, tb = min(errs, key=lambda e: (e[0], e[1]))
            err.add_note(f"raised in data-parallel rank {rank} of {n}:\n{tb}")
            raise err from failure
        outs = []
        for r in range(n):
            with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# The active mesh and the step's scope
# ---------------------------------------------------------------------------

_active: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    """The mesh of ``data_parallel``, or None (the single-process path)."""
    return _active


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Inside, ``mesh`` is the active mesh (None: single-process)."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


class _Scope:
    def __init__(self):
        self.counts: Dict[int, tuple] = {}  # id(mask) -> (mask, global count)
        self.reduced: set = set()           # ids of parameters whose gradients are global


_scope: Optional[_Scope] = None


@contextlib.contextmanager
def step_scope():
    """One train or eval step's scope: the cache of global row counts and the
    set of ``mark_reduced`` parameters."""
    global _scope
    prev, _scope = _scope, _Scope()
    try:
        yield
    finally:
        _scope = prev


def is_writer() -> bool:
    """True in the rank that writes files: rank 0, or the single process."""
    return _active is None or _active.rank == 0


def barrier():
    if _active is not None:
        dist.barrier(group=_active.group)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_sum(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``t`` over the ranks, in a new tensor (no autograd)."""
    mesh = mesh or _active
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out


class _AllSum(torch.autograd.Function):
    """Cross-rank sum; its adjoint is the cross-rank sum of the cotangents."""

    @staticmethod
    def forward(ctx, t):
        return all_sum(t)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g)


def cross_sum(t: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``t`` over the active mesh's ranks."""
    return _AllSum.apply(t)


def gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` in rank order, on every rank
    (all_gather_into_tensor on NCCL, a zeroed buffer summed on gloo)."""
    mesh = mesh or _active
    t = t.detach().contiguous()
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=mesh.group)
        return out
    buf = torch.zeros((mesh.size, *t.shape), dtype=t.dtype, device=t.device)
    buf[mesh.rank] = t
    dist.all_reduce(buf, group=mesh.group)
    return buf


def reduce_scatter_rows(buf: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Row ``rank`` of the cross-rank sum of ``buf`` ``[world, S]``
    (reduce_scatter_tensor on NCCL, all_reduce plus a slice on gloo)."""
    mesh = mesh or _active
    buf = buf.contiguous()
    if mesh.backend == "nccl":
        out = torch.empty(buf.shape[1:], dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf, group=mesh.group)
        return out
    dist.all_reduce(buf, group=mesh.group)
    return buf[mesh.rank]


def row_count(mask: Optional[torch.Tensor], batch: int = 0, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The global count of real rows: the sum of ``mask`` over every rank
    (``batch`` rows per rank without a mask), once per mask and step scope."""
    mesh = mesh or _active
    if mask is None:
        return torch.tensor(float(batch * mesh.size))
    scope = _scope
    hit = scope.counts.get(id(mask)) if scope is not None else None
    if hit is not None and hit[0] is mask:
        return hit[1]
    n = all_sum(mask.sum(), mesh)
    if scope is not None:
        scope.counts[id(mask)] = (mask, n)
    return n


def mark_reduced(*params):
    """The gradients of ``params`` come out of a kernel seam already summed
    over the ranks: ``sum_gradients`` leaves them out."""
    if _scope is not None:
        _scope.reduced.update(id(p) for p in params if p is not None)


def is_reduced(p) -> bool:
    return _scope is not None and id(p) in _scope.reduced


@torch.no_grad()
def sum_gradients(params: Sequence[torch.Tensor], mesh: Optional[Mesh] = None):
    """Sum the parameters' gradients over the ranks in ONE flat bucket per
    dtype, in place; gradients ``mark_reduced`` are left as they are."""
    mesh = mesh or _active
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None and not is_reduced(p):
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(torch.split(flat, [g.numel() for g in grads]), grads)])


def replicated(tensors, mesh: Optional[Mesh] = None):
    """Broadcast ``tensors`` (a module's state_dict values, or a list) from
    rank 0 in place, so every rank starts from rank 0's bits."""
    mesh = mesh or _active
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.state_dict().values())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0, group=mesh.group)
    return tensors


# ---------------------------------------------------------------------------
# Statistics: Chan's merge of (count, sum, M2)
# ---------------------------------------------------------------------------


def merge_moments(rows: torch.Tensor) -> torch.Tensor:
    """``[world, 3 NS, C]`` per-rank moments (count, sum, M2 about the rank's
    own mean) of NS statistics -> their merge ``[3 NS, C]``, rank by rank in
    order with Chan's formula; a set with count 0 merges as nothing (the
    kernels' ``merge_moments``, csrc/sm90_gemm.cuh)."""
    out = rows[0].clone()
    for r in range(1, rows.shape[0]):
        a, b = out.view(-1, 3, out.shape[-1]), rows[r].view(-1, 3, out.shape[-1])
        a0, a1, a2 = a.unbind(1)
        b0, b1, b2 = b.unbind(1)
        n = a0 + b0
        d = b1 / torch.where(b0 == 0, 1.0, b0) - a1 / torch.where(a0 == 0, 1.0, a0)
        merged = torch.stack([n, a1 + b1, a2 + b2 + d * d * (a0 * b0 / torch.where(n == 0, 1.0, n))], 1)
        pick = torch.where((b0 == 0)[:, None], a, torch.where((a0 == 0)[:, None], b, merged))
        out = pick.reshape(out.shape)
    return out


def stats_of_moments(mom: torch.Tensor) -> torch.Tensor:
    """``[3 NS, C]`` merged moments -> ``[3 NS, C]`` (mean, var, inv) per
    statistic, the kernels' ``write_stats``."""
    out = []
    for n, s, m2 in mom.view(-1, 3, mom.shape[-1]).unbind(0):
        var = m2 / n
        out.append(torch.stack([s / n, var, torch.rsqrt(var + 1e-5)]))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Placement (the JAX helpers' counterparts)
# ---------------------------------------------------------------------------


def local_slice(size: int, mesh: Mesh, what: str) -> slice:
    if size % mesh.size:
        raise ValueError(f"{what} of {size} does not divide over {mesh.size} data-parallel ranks")
    k = size // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def batch_sharded(mesh: Mesh, a, *, batch_axis: int = 1):
    """This rank's contiguous block of ``a`` along ``batch_axis`` (default:
    the columns of an ``[nb, B]`` plan), the block JAX's ``P(None, "data")``
    gives device ``rank``."""
    sl = [slice(None)] * a.ndim
    sl[batch_axis] = local_slice(a.shape[batch_axis], mesh, "a batch axis")
    return a[tuple(sl)]


def _jax_axes(key: str, ndim: int) -> List[int]:
    """The torch dim of each axis of a leaf in the JAX layout
    (train/checkpoint.py:_to_torch_layout): conv ``[K, I, O]`` is torch
    ``[O, I, K]``, dense ``[in, out]`` is ``[out, in]``, the rest the same."""
    if ndim == 3:
        return [2, 1, 0]
    if ndim == 2 and "embedding" not in key:
        return [1, 0]
    return list(range(ndim))


def fsdp_sharding_for(mesh, key: str, shape) -> Optional[int]:
    """The torch dim to shard the port's leaf ``key`` of torch ``shape``
    along, or None for a replicated leaf: the dim of the LOGICAL axis the
    JAX ``fsdp_sharding_for`` picks on the same leaf in its own layout, the
    largest axis whose size divides the mesh, ties to the higher JAX index.
    ``mesh`` is a Mesh or a rank count."""
    n = mesh.size if isinstance(mesh, Mesh) else int(mesh)
    shape = tuple(shape)
    if not shape:
        return None
    axes = _jax_axes(key, len(shape))
    jshape = [shape[axes[a]] for a in range(len(shape))]
    candidates = [(size, i) for i, size in enumerate(jshape) if size % n == 0 and size >= n]
    if not candidates:
        return None
    return axes[max(candidates)[1]]


def shard_params_fsdp(mesh: Mesh, named) -> Dict[str, tuple]:
    """``{key: (dim, this rank's shard)}`` of ``named`` ((key, tensor) pairs);
    dim None and the whole tensor for a replicated leaf."""
    out = {}
    for key, t in named:
        d = fsdp_sharding_for(mesh, key, t.shape)
        out[key] = (d, t if d is None else t.detach().chunk(mesh.size, d)[mesh.rank])
    return out


def place_eval_inputs(mesh: Optional[Mesh], row_arrays: Sequence[torch.Tensor]):
    """(rows, this rank's blocks of ``row_arrays``): each padded with zero
    rows to a multiple of the world size, then cut into contiguous blocks.
    Without a mesh (or with one rank) the arrays as they are."""
    n = int(row_arrays[0].shape[0])
    if mesh is None or mesh.size <= 1:
        return n, tuple(row_arrays)
    padded = n + (-n) % mesh.size
    out = []
    for a in row_arrays:
        if padded != n:
            a = torch.cat([a, a.new_zeros((padded - n,) + tuple(a.shape[1:]))])
        out.append(batch_sharded(mesh, a, batch_axis=0))
    return n, tuple(out)


def gather_eval_rows(mesh: Optional[Mesh], local: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``place_eval_inputs`` for a result: every rank's block
    gathered in rank order, the padding rows cut off."""
    if mesh is None or mesh.size <= 1:
        return local
    return gather_rows(local, mesh).reshape((-1,) + tuple(local.shape[1:]))[:n]


def shard_epoch_inputs(mesh: Mesh, idx, mask):
    """This rank's columns of an epoch's ``[nb, B]`` plan ``(idx, mask)``; the
    data arrays stay whole on every rank (replicated)."""
    return batch_sharded(mesh, idx), batch_sharded(mesh, mask)

