"""AdamW with torch semantics, the optional global-norm clip, bf16 Adam
moments, schedule-free AdamW and its ``.sfstate`` sidecar.

Counterpart of hippie_tpu/train/optim.py (``make_optimizer``,
``cast_state_dtype``, ``find_schedule_free_state``, ``maybe_eval_params``,
``save_schedule_free_sidecar``, ``load_schedule_free_sidecar``). The
reference uses plain ``optim.AdamW(lr, weight_decay)`` (model.py:93,262)
with b1=0.9, b2=0.999, eps=1e-8 and decoupled weight decay, and Lightning's
global-norm gradient clipping on some trainers (quirk Q7). The clip here is
optax.clip_by_global_norm's: grads scale by clip/norm when norm > clip, with
no epsilon, computed on the device without a host sync.

``state_dtype="bfloat16"`` stores the Adam moments in bf16: each step
upcasts them to float32, runs torch's AdamW update in float32 (the new
moments and the parameter update from the unrounded moments) and stores the
moments back rounded to nearest even, as ``cast_state_dtype`` wraps optax's
adamw; it does so in buckets of ``UPCAST_BUCKET`` elements, so the float32
copies never span the whole model. ``algorithm="schedule-free"`` is train/schedule_free.py; the pipeline
then evaluates and checkpoints the x iterate (``maybe_eval_params``), and a
checkpoint's averaging state goes to a sidecar beside the ``.ckpt``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.optim.adamw import adamw

from hippie_tpu_torch.train import checkpoint as ckpt_mod


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float):
    """Scale ``grads`` in place so their joint L2 norm is at most ``max_norm``."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


_MOMENTS = ("exp_avg", "exp_avg_sq")


class AdamW(torch.optim.AdamW):
    """torch.optim.AdamW(b1=0.9, b2=0.999, eps=1e-8) with an optional clip of
    the gradients' global norm before each step, and the moments stored in
    ``state_dtype`` (None: float32) with the update computed in float32."""

    def __init__(self, params: Iterable, lr: float, weight_decay: float = 0.01,
                 clip_val: Optional[float] = None, state_dtype: Optional[torch.dtype] = None):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.clip_val = clip_val
        self.state_dtype = state_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_val is not None:
            grads = [p.grad for group in self.param_groups for p in group["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.clip_val)
        if self.state_dtype is None:
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            for p in ps:
                if not self.state[p]:  # optax's fresh state: zero moments, step 0
                    self.state[p].update(step=torch.tensor(0.0, dtype=torch.float32), **{
                        m: torch.zeros_like(p, dtype=self.state_dtype) for m in _MOMENTS})
            for bucket in _buckets(ps, UPCAST_BUCKET):
                self._step_upcast(group, bucket)
        return loss

    def _step_upcast(self, group: dict, ps: List[torch.Tensor]):
        """torch's AdamW update of ``ps`` on float32 copies of their stored
        moments, the new moments stored back rounded to nearest even. The
        copies are freed on return, so one bucket's exist at a time."""
        st = [self.state[p] for p in ps]
        stored = {m: [s[m] for s in st] for m in _MOMENTS}
        wide = {m: _float32_like(stored[m]) for m in _MOMENTS}
        for m in _MOMENTS:
            torch._foreach_copy_(wide[m], stored[m])
        beta1, beta2 = group["betas"]
        adamw(
            ps, [p.grad for p in ps], wide["exp_avg"], wide["exp_avg_sq"], [], [s["step"] for s in st],
            foreach=group["foreach"], capturable=group["capturable"],
            differentiable=group["differentiable"], fused=group["fused"], amsgrad=False, beta1=beta1,
            beta2=beta2, lr=group["lr"], weight_decay=group["weight_decay"], eps=group["eps"],
            maximize=group["maximize"])
        for m in _MOMENTS:
            torch._foreach_copy_(stored[m], wide[m])  # round to nearest even

    def load_state_dict(self, state_dict):
        """torch's load (moments cast to the parameters' dtype), then the
        moments rounded to ``state_dtype``."""
        super().load_state_dict(state_dict)
        if self.state_dtype is not None:
            for st in self.state.values():
                for m in _MOMENTS:
                    if m in st:
                        st[m] = st[m].to(self.state_dtype)


# Parameters' elements per float32 upcast of bf16 moments (16 MiB a moment):
# the update's float32 copies and temporaries stay this small however large the
# model, so bf16 moments lower the optimizer's peak memory, not only its state.
UPCAST_BUCKET = 1 << 22


def _buckets(ps: List[torch.Tensor], limit: int) -> List[List[torch.Tensor]]:
    """``ps`` in order, cut into runs of at most ``limit`` elements (a larger
    tensor alone)."""
    out, n = [], limit
    for p in ps:
        if n + p.numel() > limit:
            out.append([])
            n = 0
        out[-1].append(p)
        n += p.numel()
    return out


def _float32_like(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """float32 tensors of ``ts``' shapes, views of one buffer per device."""
    if not ts:
        return []
    buf = torch.empty(sum(t.numel() for t in ts), dtype=torch.float32, device=ts[0].device)
    return [v.view(t.shape) for v, t in zip(torch.split(buf, [t.numel() for t in ts]), ts)]


def check_optimizer(algorithm: str, state_dtype: Optional[str]):
    """The JAX make_optimizer's refusals: an unknown algorithm or state
    dtype, and a state dtype with schedule-free."""
    if algorithm not in ("adamw", "schedule-free"):
        raise ValueError(f"optimizer must be 'adamw' or 'schedule-free', got {algorithm!r}")
    if algorithm == "schedule-free" and state_dtype is not None:
        # the z iterate is a parameter-scale accumulator; bf16 storage would corrupt it
        raise ValueError(
            "--opt-state-dtype is not supported with --optimizer schedule-free "
            "(the schedule-free z iterate must stay fp32)"
        )
    if state_dtype not in (None, "bfloat16"):
        raise ValueError(f"state_dtype must be None or 'bfloat16', got {state_dtype!r}")


def make_optimizer(params: Iterable, learning_rate: float, weight_decay: float = 0.01,
                   clip_val: Optional[float] = None, state_dtype: Optional[str] = None,
                   algorithm: str = "adamw") -> torch.optim.Optimizer:
    """AdamW (+ optional global-norm clipping, + bf16 moments with
    ``state_dtype="bfloat16"``) over ``params``, or schedule-free AdamW with
    ``algorithm="schedule-free"`` (b1=0.9, b2=0.999, eps=1e-8, warmup 0)."""
    check_optimizer(algorithm, state_dtype)
    if algorithm == "schedule-free":
        from hippie_tpu_torch.train.schedule_free import ScheduleFreeAdamW

        return ScheduleFreeAdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, clip_val=clip_val)
    return AdamW(params, lr=learning_rate, weight_decay=weight_decay, clip_val=clip_val,
                 state_dtype=None if state_dtype is None else getattr(torch, state_dtype))


# ---------------------------------------------------------------------------
# Schedule-free state
# ---------------------------------------------------------------------------


class ScheduleFreeState(NamedTuple):
    """The averaging state of a schedule-free optimizer (or of its
    ``state_dict()``): the group's 0-d tensors and the per-parameter lists
    in parameter order."""

    k: torch.Tensor
    weight_sum: torch.Tensor
    lr_max: torch.Tensor
    z: list
    exp_avg_sq: list
    b1: float


def find_schedule_free_state(opt_state) -> Optional[ScheduleFreeState]:
    """The schedule-free state of an optimizer or of its ``state_dict()``
    (one param group), else None."""
    if opt_state is None:
        return None
    sd = opt_state.state_dict() if isinstance(opt_state, torch.optim.Optimizer) else opt_state
    groups = sd.get("param_groups", [])
    if len(groups) != 1 or "weight_sum" not in groups[0]:
        return None
    g = groups[0]
    st = [sd["state"][i] for i in g["params"]]
    return ScheduleFreeState(g["k"], g["weight_sum"], g["lr_max"], [e["z"] for e in st],
                             [e["exp_avg_sq"] for e in st], g["betas"][0])


def maybe_eval_params(opt_state, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """The parameters to evaluate and checkpoint at: the x iterate when the
    optimizer is schedule-free (the reference's .eval() mode switch,
    optimizers.py:82-92), otherwise ``params``."""
    sf = find_schedule_free_state(opt_state)
    if sf is None:
        return params
    from hippie_tpu_torch.train.schedule_free import eval_params

    return eval_params(params, sf.z, sf.b1)


@contextlib.contextmanager
def evaluated_at_x(optimizer: torch.optim.Optimizer):
    """Inside, the optimizer's parameters hold the x iterate when it is
    schedule-free (once per validation epoch, the role of the JAX
    ``eval_params_jit``); on leaving, the training iterate y again, bit for
    bit. A no-op for AdamW."""
    if find_schedule_free_state(optimizer) is None:
        yield
        return
    ps = [p for g in optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        y = torch._foreach_mul(ps, 1.0)
        torch._foreach_copy_(ps, maybe_eval_params(optimizer, ps))
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_(ps, y)


# ---------------------------------------------------------------------------
# Schedule-free sidecar persistence
# ---------------------------------------------------------------------------
#
# The Lightning ckpt's ``optimizer_states[0]`` is a torch AdamW layout, which
# schedule-free state has none of, so a schedule-free .ckpt has empty
# ``optimizer_states`` and the averaging state (k, weight_sum, lr_max, z,
# exp_avg_sq) goes to ``<ckpt>.sfstate``, the JAX package's pickle: ``k`` an
# int, ``weight_sum`` and ``lr_max`` floats, ``z`` and ``exp_avg_sq`` flat
# dicts under the parameter names (the JAX ``flatten_interleaved(params,
# None)`` keys) of float32 numpy arrays in the JAX layout. Either package
# reads the other's.

SF_SIDECAR_SUFFIX = ".sfstate"


def schedule_free_payload(opt_state, param_keys: Sequence[str]) -> dict:
    """The sidecar's payload of a schedule-free optimizer or state_dict
    whose parameters are named ``param_keys``; tensors on the card come over
    in one fetch."""
    sf = find_schedule_free_state(ckpt_mod.host_tree(
        opt_state.state_dict() if isinstance(opt_state, torch.optim.Optimizer) else opt_state))
    if sf is None:
        raise ValueError("the optimizer state is not schedule-free")
    if len(sf.z) != len(param_keys):
        raise ValueError(f"{len(sf.z)} schedule-free states for {len(param_keys)} parameter names")

    def jax_layout(arrays):
        return {k: np.ascontiguousarray(ckpt_mod._from_torch_layout(k, np.asarray(a, np.float32)))
                for k, a in zip(param_keys, arrays)}

    return {"k": int(sf.k), "weight_sum": float(sf.weight_sum), "lr_max": float(sf.lr_max),
            "z": jax_layout(sf.z), "exp_avg_sq": jax_layout(sf.exp_avg_sq)}


def write_sidecar(ckpt_path: str, payload: dict) -> str:
    """Pickle ``payload`` to ``<ckpt_path>.sfstate`` atomically (a temporary
    file renamed into place); returns the path."""
    path = ckpt_path + SF_SIDECAR_SUFFIX
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def save_schedule_free_sidecar(ckpt_path: str, opt_state, param_keys: Sequence[str]) -> Optional[str]:
    """Write the schedule-free state beside ``ckpt_path``; returns the
    sidecar's path, or None when the optimizer is not schedule-free."""
    if find_schedule_free_state(opt_state) is None:
        return None
    return write_sidecar(ckpt_path, schedule_free_payload(opt_state, param_keys))


@torch.no_grad()
def load_schedule_free_sidecar(ckpt_path: str, optimizer: torch.optim.Optimizer,
                               param_keys: Sequence[str], drop_keys=()) -> torch.optim.Optimizer:
    """Restore a sidecar (written by either package) into a freshly built
    schedule-free optimizer whose parameters are named ``param_keys``.
    Parameters whose name starts with a ``drop_keys`` prefix keep their fresh
    state (the class-embedding surgery, quirk Q10); every other name must be
    in the sidecar with its parameter's shape."""
    sf = find_schedule_free_state(optimizer)
    if sf is None:
        raise ValueError("optimizer has no schedule-free component")
    with open(ckpt_path + SF_SIDECAR_SUFFIX, "rb") as f:
        payload = pickle.load(f)
    group = optimizer.param_groups[0]
    for i, (p, k) in enumerate(zip(group["params"], param_keys)):
        if any(k.startswith(d) for d in drop_keys):
            continue
        for name in ("z", "exp_avg_sq"):
            t = torch.from_numpy(np.ascontiguousarray(
                ckpt_mod._to_torch_layout(k, np.asarray(payload[name][k], np.float32))))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"sidecar {name} of {k} has shape {tuple(t.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            optimizer.state[p][name].copy_(t)
    group["k"].fill_(int(payload["k"]))
    group["weight_sum"].fill_(float(payload["weight_sum"]))
    group["lr_max"].fill_(float(payload["lr_max"]))
    return optimizer
