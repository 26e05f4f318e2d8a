"""Schedule-Free AdamW as a torch optimizer.

Counterpart of hippie_tpu/train/schedule_free.py (``adamw_schedule_free``,
``eval_params``, ``train_params``), the working form of the schedule-free
AdamW the reference vendors but never instantiates (quirk Q9):

  y      -- the iterate the model trains on (the parameters)
  z      -- the SGD-style iterate, z_{k+1} = z_k - lr_k * g_hat
  x      -- the weighted average that is evaluated, implied by y and z
  g_hat  -- the Adam-normalised gradient, plus decoupled weight decay at y
  lr_k   -- lr * warmup_sched * sqrt(1 - beta2^(k+1))
  ckp1   -- the averaging weight, ((k+1)^r * lr_max^p) / running sum

  y_{k+1} = y_k + ckp1 * (z_k - y_k) + lr_k * (beta1 * (1 - ckp1) - 1) * g_hat
  z_{k+1} = z_k - lr_k * g_hat

``k``, ``weight_sum`` and ``lr_max`` are 0-d tensors on the parameters'
device in each param group, and the step makes no host sync: every branch of
the JAX update is a ``torch.where``, every parameter update a ``torch._foreach_*``
op. ``eval_params`` and ``train_params`` are the reference's .eval() and
.train() mode switches (lerps toward z by 1 - 1/beta1 and 1 - beta1).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from hippie_tpu_torch.train.optim import clip_by_global_norm_


def eval_params(y: List[torch.Tensor], z: List[torch.Tensor], b1: float = 0.9) -> List[torch.Tensor]:
    """The x iterate to evaluate and checkpoint: y + (1 - 1/b1) * (z - y)."""
    d = torch._foreach_sub(z, y)
    torch._foreach_mul_(d, 1.0 - 1.0 / b1)
    return torch._foreach_add(y, d)


def train_params(x: List[torch.Tensor], z: List[torch.Tensor], b1: float = 0.9) -> List[torch.Tensor]:
    """The y iterate to resume training from x: x + (1 - b1) * (z - x)."""
    d = torch._foreach_sub(z, x)
    torch._foreach_mul_(d, 1.0 - b1)
    return torch._foreach_add(x, d)


class ScheduleFreeAdamW(torch.optim.Optimizer):
    """Schedule-free AdamW with the JAX transform's defaults, and the
    global-norm clip of the gradients before each step (the optax chain's
    ``clip_by_global_norm`` ahead of the update). The per-parameter state is
    ``z`` (a copy of the parameter when the optimizer is built) and
    ``exp_avg_sq``; each param group holds ``k`` (int32), ``weight_sum`` and
    ``lr_max`` (float32, -1 at the start)."""

    def __init__(self, params: Iterable, lr: float = 0.0025, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, warmup_steps: int = 0, r: float = 0.0,
                 weight_lr_power: float = 2.0, clip_val: Optional[float] = None):
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        warmup_steps=warmup_steps, r=r, weight_lr_power=weight_lr_power)
        super().__init__(params, defaults)
        self.clip_val = clip_val
        for group in self.param_groups:
            dev = group["params"][0].device
            group["k"] = torch.zeros((), dtype=torch.int32, device=dev)
            group["weight_sum"] = torch.zeros((), dtype=torch.float32, device=dev)
            group["lr_max"] = torch.full((), -1.0, dtype=torch.float32, device=dev)
            for p in group["params"]:
                self.state[p] = {"z": p.detach().clone(), "exp_avg_sq": torch.zeros_like(p)}

    def load_state_dict(self, state_dict):
        """torch's load, then the group's k, weight_sum and lr_max as 0-d
        tensors on the parameters' device (a state_dict from another device
        brings its own)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            dev = group["params"][0].device
            for name, dtype in (("k", torch.int32), ("weight_sum", torch.float32),
                                ("lr_max", torch.float32)):
                group[name] = torch.as_tensor(group[name], dtype=dtype).to(dev)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.clip_val is not None:
            clip_by_global_norm_([p.grad for g in self.param_groups for p in g["params"]
                                  if p.grad is not None], self.clip_val)
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            zs = [self.state[p]["z"] for p in ps]
            vs = [self.state[p]["exp_avg_sq"] for p in ps]
            b1, b2 = group["betas"]
            k, warmup = group["k"], group["warmup_steps"]
            kp1 = (k + 1).to(torch.float32)
            sched = torch.where(k < warmup, kp1 / max(warmup, 1), torch.ones_like(kp1))
            bc2 = 1.0 - torch.pow(b2, kp1)
            lr_t = group["lr"] * sched * torch.sqrt(bc2)
            lr_max = torch.maximum(lr_t, group["lr_max"])
            weight = torch.pow(kp1, group["r"]) * torch.pow(lr_max, group["weight_lr_power"])
            weight_sum = group["weight_sum"] + weight
            ckp1 = torch.where(weight_sum > 0, weight / weight_sum, torch.zeros_like(weight))

            # v <- b2 * v + (1 - b2) * g^2
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, sq)
            # g_hat = g / (sqrt(v) + eps) + wd * y
            den = torch._foreach_sqrt(vs)
            torch._foreach_add_(den, group["eps"])
            gn = torch._foreach_div(grads, den)
            if group["weight_decay"] != 0.0:
                torch._foreach_add_(gn, ps, alpha=group["weight_decay"])
            # y += ckp1 * (z - y) + lr_t * (b1 * (1 - ckp1) - 1) * g_hat
            upd = torch._foreach_sub(zs, ps)
            torch._foreach_mul_(upd, ckp1)
            step_g = torch._foreach_mul(gn, lr_t * (b1 * (1.0 - ckp1) - 1.0))
            torch._foreach_add_(upd, step_g)
            torch._foreach_add_(ps, upd)
            # z -= lr_t * g_hat
            torch._foreach_mul_(gn, lr_t)
            torch._foreach_sub_(zs, gn)

            k.add_(1)
            group["weight_sum"].copy_(weight_sum)
            group["lr_max"].copy_(lr_max)
        return loss
