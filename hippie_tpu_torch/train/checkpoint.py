"""Weights carried over from the JAX package's pytrees, and Lightning ``.ckpt`` I/O.

Counterpart of hippie_tpu/train/checkpoint.py (``flatten_interleaved``,
``_to_torch_layout``, ``_from_torch_layout``, ``bulk_host_fetch``,
``parameter_key_order``, ``save_lightning_ckpt``, ``load_lightning_ckpt``)
and of the AdamW-state layout of hippie_tpu/train/optim.py
(``adamw_state_to_torch``), copied rather than imported.
The JAX package keeps its parameters and BatchNorm state as nested dicts in
torch registration order; flattening them interleaved (a BatchNorm emits
weight, bias, running_mean, running_var, num_batches_tracked) gives the keys
of the port's ``state_dict`` in the same order.

Layouts: conv  [K, C_in, C_out] -> [C_out, C_in, K]; dense [in, out] -> [out, in];
embeddings, biases and BN vectors unchanged; num_batches_tracked int64.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

_BN_PARAM_KEYS = ("weight", "bias")
_BN_STATE_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _is_bn_params(node: Any) -> bool:
    return (
        isinstance(node, dict)
        and set(node.keys()) == {"weight", "bias"}
        and getattr(node["weight"], "ndim", None) == 1
    )


def flatten_interleaved(params: dict, state: Optional[dict]) -> Dict[str, Any]:
    """Flatten params + BN state into torch state_dict key order."""
    out: Dict[str, Any] = {}

    def walk(p: Any, s: Any, prefix: str):
        if _is_bn_params(p) and isinstance(s, dict) and "running_mean" in s:
            for k in _BN_PARAM_KEYS:
                out[prefix + k] = p[k]
            for k in _BN_STATE_KEYS:
                out[prefix + k] = s[k]
            return
        if isinstance(p, dict):
            for k, v in p.items():
                walk(v, s.get(k, {}) if isinstance(s, dict) else {}, prefix + k + ".")
        else:
            out[prefix[:-1]] = p

    walk(params, state or {}, "")
    return out


def _to_torch_layout(key: str, x: np.ndarray) -> np.ndarray:
    if x.ndim == 3:  # conv kernel [K, I, O] -> [O, I, K]
        return np.transpose(x, (2, 1, 0))
    if x.ndim == 2 and "embedding" not in key:  # dense [in, out] -> [out, in]
        return np.transpose(x, (1, 0))
    return x


def _from_torch_layout(key: str, x: np.ndarray) -> np.ndarray:
    if x.ndim == 3:  # conv kernel [O, I, K] -> [K, I, O]
        return np.transpose(x, (2, 1, 0))
    if x.ndim == 2 and "embedding" not in key:
        return np.transpose(x, (1, 0))
    return x


# ---------------------------------------------------------------------------
# Device -> host in one copy
# ---------------------------------------------------------------------------


_pinned = None  # the host buffer of bulk_host_fetch, kept pinned and reused
_pinned_lock = threading.Lock()


def _pinned_buffer(n: int) -> torch.Tensor:
    """``n`` float32 of the process's pinned host buffer, grown as needed
    (the caller holds ``_pinned_lock``)."""
    global _pinned
    if _pinned is None or _pinned.numel() < n:
        _pinned = None
        _pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)
    return _pinned[:n]


def bulk_host_fetch(flat: Dict[Any, Any], ready: Optional["torch.cuda.Event"] = None,
                    times: Optional[dict] = None) -> Dict[Any, Any]:
    """``flat`` with every tensor value as a numpy array, the CUDA ones
    fetched in ONE device-to-host copy; other values pass through.

    The CUDA tensors are concatenated into one float32 buffer on a side
    stream, copied into pinned host memory and split on the host, so a
    checkpoint of several hundred tensors costs one copy and one wait instead
    of one synchronising ``.cpu()`` each, and the copy does not queue behind
    the default stream's later kernels. The side stream first waits for
    ``ready``, an event recorded on the stream that produced the tensors
    (default: recorded on the current stream now). The tensors stay
    referenced until the copy has completed. The pinned buffer is one per
    process, reused by every fetch (one at a time) and grown to the largest.
    Values come back in their own dtype (bfloat16 as float32), each an array
    of its own; integers survive the float32 round trip exactly below 2**24
    (BatchNorm step counters). ``times``, when given, gets the seconds spent
    getting the pinned buffer (``pin_s``), from the copy's launch to its end
    (``copy_s``), and splitting on the host (``split_s``).
    """
    out = dict(flat)
    on_card = [k for k, v in flat.items() if isinstance(v, torch.Tensor) and v.is_cuda]
    for k, v in flat.items():
        if isinstance(v, torch.Tensor) and not v.is_cuda:
            v = v.detach()
            out[k] = np.array((v.float() if v.dtype == torch.bfloat16 else v).numpy())
    if not on_card:
        return out
    tensors = [flat[k].detach() for k in on_card]
    device = tensors[0].device
    if ready is None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
    side = torch.cuda.Stream(device)
    total = sum(t.numel() for t in tensors)
    with _pinned_lock:
        t0 = time.perf_counter()
        host = _pinned_buffer(total)
        t1 = time.perf_counter()
        with torch.cuda.stream(side):
            side.wait_event(ready)
            packed = torch.cat([t.reshape(-1) for t in tensors], out=torch.empty(
                total, dtype=torch.float32, device=device))
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        done.synchronize()  # the sources and ``packed`` stay referenced until here
        t2 = time.perf_counter()
        flat_host = host.numpy()
        at = 0
        for k, t in zip(on_card, tensors):
            n = t.numel()
            dtype = np.float32 if t.dtype == torch.bfloat16 else torch.empty(0, dtype=t.dtype).numpy().dtype
            out[k] = flat_host[at:at + n].astype(dtype).reshape(tuple(t.shape))  # a copy
            at += n
        t3 = time.perf_counter()
    if times is not None:
        times.update(pin_s=t1 - t0, copy_s=t2 - t1, split_s=t3 - t2)
    return out


def host_tree(tree, ready: Optional["torch.cuda.Event"] = None, times: Optional[dict] = None):
    """A nested dict / list / tuple with its tensor leaves as numpy arrays,
    all fetched by one ``bulk_host_fetch`` (``ready`` and ``times`` as
    there); other leaves are kept."""
    flat = {}

    def collect(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                collect(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                collect(v, path + (i,))
        elif isinstance(node, torch.Tensor):
            flat[path] = node

    collect(tree, ())
    if not flat:
        return tree
    host = bulk_host_fetch(flat, ready, times)

    def rebuild(node, path):
        if isinstance(node, dict):
            return type(node)((k, rebuild(v, path + (k,))) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, path + (i,)) for i, v in enumerate(node))
        return host.get(path, node)

    return rebuild(tree, ())


def state_dict_from_jax(params: dict, state: Optional[dict]) -> "OrderedDict[str, torch.Tensor]":
    """JAX (params, bn_state) nested dicts of arrays -> the port's state_dict.

    Leaves may be numpy arrays or anything ``np.asarray`` reads. The result
    loads with ``model.load_state_dict(sd, strict=True)``.
    """
    sd = OrderedDict()
    for k, v in flatten_interleaved(params, state).items():
        arr = np.asarray(v)
        if k.endswith("num_batches_tracked"):
            arr = arr.astype(np.int64)
        sd[k] = torch.from_numpy(np.array(_to_torch_layout(k, arr), order="C"))
    return sd


# ---------------------------------------------------------------------------
# Lightning .ckpt files
# ---------------------------------------------------------------------------
#
# The reference's checkpoint contract (SURVEY.md §5): a torch-pickled dict with
# ``state_dict`` (keys prefixed ``model.``), ``optimizer_states`` (a list with
# one torch AdamW state dict), ``epoch``, ``global_step``,
# ``pytorch-lightning_version`` and ``hyper_parameters``. The files this
# module writes hold what the JAX package's ``save_lightning_ckpt`` writes, in
# the same layout, so either package reads the other's.


def parameter_key_order(model: torch.nn.Module) -> list:
    """Names of the model's parameters (not its buffers) in
    ``model.parameters()`` order: the index order of the optimizer state. For
    the port's models this is the JAX package's ``parameter_key_order``."""
    return [k for k, _ in model.named_parameters()]


def adamw_state_to_torch(opt_state: dict, state_dict: Dict[str, Any],
                         param_keys: Sequence[str], *, lr: float, weight_decay: float) -> dict:
    """A torch AdamW ``state_dict()`` over ``param_keys`` -> the layout of
    hippie_tpu/train/optim.py:adamw_state_to_torch for ``optimizer_states[0]``:
    per parameter index ``step`` (a numpy float32 scalar), ``exp_avg`` and
    ``exp_avg_sq`` (float32 numpy arrays in torch layout, whatever dtype the
    moments are stored in), and one param group with the JAX package's keys.
    A parameter without state yet (no step taken) gets zero moments and step
    0, as optax's fresh state. Tensors on the card come over in one
    ``host_tree`` fetch; numpy input is used as it is."""
    state = host_tree(opt_state.get("state", {}))
    out = {}
    for i, k in enumerate(param_keys):
        entry = state.get(i)
        if entry is None:
            zeros = np.zeros(tuple(state_dict[k].shape), np.float32)
            out[i] = {"step": np.asarray(0, dtype=np.float32), "exp_avg": zeros,
                      "exp_avg_sq": zeros.copy()}
            continue
        out[i] = {
            "step": np.asarray(entry["step"], dtype=np.float32),
            "exp_avg": np.asarray(entry["exp_avg"], dtype=np.float32),
            "exp_avg_sq": np.asarray(entry["exp_avg_sq"], dtype=np.float32),
        }
    return {
        "state": out,
        "param_groups": [{
            "lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": weight_decay,
            "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
            "differentiable": False, "fused": None, "params": list(range(len(param_keys))),
        }],
    }


def load_optimizer_state(optimizer: torch.optim.Optimizer, torch_opt_sd: dict):
    """Load ``optimizer_states[0]`` (the layout above, from either package)
    into a torch AdamW over the same parameters in the same order: each
    index's moments onto the optimizer's parameter of that index, ``step`` as
    a float32 tensor. The optimizer keeps its own hyperparameters, as the JAX
    package's ``adamw_state_from_torch`` keeps its transform's."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    per_param = torch_opt_sd.get("state", {})
    sd = optimizer.state_dict()
    sd["state"] = {}
    for i, p in enumerate(params):
        entry = per_param.get(i, per_param.get(str(i)))
        if entry is None:
            continue
        moments = {}
        for name in ("exp_avg", "exp_avg_sq"):
            t = torch.as_tensor(entry[name])
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state {i} {name} has shape {tuple(t.shape)}, "
                                 f"parameter {tuple(p.shape)}")
            moments[name] = t.to(dtype=p.dtype)
        st = entry.get("step", 0)
        sd["state"][i] = {"step": torch.tensor(float(st), dtype=torch.float32), **moments}
    optimizer.load_state_dict(sd)


def save_lightning_ckpt(
    path: str,
    state_dict: Dict[str, Any],
    *,
    optimizer_state: Optional[dict] = None,
    epoch: int = 0,
    global_step: int = 0,
    hyper_parameters: Optional[dict] = None,
):
    """Write a Lightning-compatible .ckpt of a port model's ``state_dict``
    (keys without prefix; tensors on any device, fetched in one
    ``host_tree`` copy, or numpy arrays from one) and an ``optimizer_state``
    in the layout of ``adamw_state_to_torch``.

    Atomic: written to ``<path>.tmp.<pid>`` and renamed; on failure the
    temporary file is removed and nothing is left at ``path``.
    """
    host = host_tree(dict(state_dict))
    payload = {
        "state_dict": OrderedDict(("model." + k, torch.from_numpy(host[k]).contiguous())
                                  for k in state_dict),
        "optimizer_states": [optimizer_state] if optimizer_state is not None else [],
        "epoch": epoch,
        "global_step": global_step,
        "pytorch-lightning_version": "2.0.0",
        "hyper_parameters": hyper_parameters or {},
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_lightning_ckpt(path: str) -> dict:
    """Read a .ckpt written by either package or by the torch reference, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=False)


def model_state_from_ckpt(ckpt: dict) -> "OrderedDict[str, torch.Tensor]":
    """The ckpt's ``state_dict`` without its ``model.`` prefix, as tensors."""
    return OrderedDict((k[len("model."):], torch.as_tensor(v)) for k, v in ckpt["state_dict"].items()
                       if k.startswith("model."))


def load_model_state(model: torch.nn.Module, state: Dict[str, torch.Tensor],
                     drop: Iterable[str] = ()) -> list:
    """Load a state_dict (keys without prefix) into ``model`` and return the
    keys the model kept its own values for.

    Keys under a top-level module named in ``drop`` are skipped, and so is
    ``class_embedding.weight`` when its class count differs from the model's:
    the reference pops it and loads with ``strict=False`` (quirk Q10), so the
    model's fresh class embedding survives. Any other missing, unexpected or
    misshapen key raises.
    """
    drop = set(drop)
    own = model.state_dict()
    ce = "class_embedding.weight"
    if ce in state and ce in own and state[ce].shape != own[ce].shape:
        drop.add("class_embedding")
    kept = {k: v for k, v in state.items() if k.split(".")[0] not in drop}
    missing, unexpected = model.load_state_dict(kept, strict=False)
    bad = [k for k in missing if k.split(".")[0] not in drop] + list(unexpected)
    if bad:
        raise KeyError(f"state_dict does not match the model: {bad}")
    return list(missing)
