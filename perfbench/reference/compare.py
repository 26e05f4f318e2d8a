"""The numbers that decide ``correct``, each a gap between what the program
produced and what the plain reference produces from the same inputs.

Training (``train_gaps``), per step and by leaf. The leaves counted are
those whose reference gradient is at least a thousandth of the median
leaf's: a leaf whose gradient is nought to rounding (a conv bias before
BatchNorm, an unused embedding) moves under Adam by round-off alone.
- ``loss_gap``: the largest ``|loss_prog - loss_ref| / |loss_ref|`` over the steps;
- ``grad_gap``: the first step's gradient as the optimizer got it; for each
  leaf ``|norm_prog - norm_ref| / max(norm_ref, median leaf's norm_ref)``,
  the largest over the leaves; ``grad_gap_raw_median`` its median;
- ``grad_gap_median``: the same median with the program's norms first
  divided by ``grad_scale``, the median leaf's ``norm_prog / norm_ref``.
  The clip multiplies every leaf by one factor, clip over the global norm,
  and that norm is set by a few early block convolutions whose gradient
  rounding moves by a tenth: the factor is common to all leaves, and what
  is left is each leaf's own gap;
- ``change_gap``: the worst leaf's gap of its change over the steps
  (``params - params0``); ``change_gap_median`` the median leaf's.

Embedding (``embed_gap``): the largest absolute difference between a reply's
z-scored embedding and the reference's, over the sampled rows; each row is
z-scored, so its entries are of order 1.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

MOVE_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is left out


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys) -> tuple:
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def bn_var_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The root mean square, over every channel of every BatchNorm layer, of
    the relative gap of its running variance after the first step."""
    rel = torch.cat([((prog[k].double() - ref[k].double()) / ref[k].double()).reshape(-1) for k in ref])
    return float(rel.square().mean().sqrt())


def train_gaps(prog_metrics, ref_metrics, prog_grad1, ref_grad1, prog_delta, ref_delta, prog_var1, ref_var1) -> dict:
    """The training numbers (module note), with the leaf that sets each
    worst one. ``*_metrics`` are ``(losses, mses, kls)``, one entry per step;
    ``*_var1`` the running variances after the first step."""
    rel = lambda p, r: abs(p - r) / abs(r)  # noqa: E731
    (pl, pm, pk), (rl, rm, rk) = prog_metrics, ref_metrics
    g_ref, g_prog = _norms(ref_grad1), _norms(prog_grad1)
    med = float(np.median(list(g_ref.values())))
    moved = [k for k, n in g_ref.items() if n >= MOVE_FLOOR * med]
    grad_gap, grad_leaf = _worst(g_prog, g_ref, moved)
    scale = float(np.median([g_prog[k] / g_ref[k] for k in moved]))
    # no common factor: the gradient never reached the optimizer (a fault), which reads 1
    shaped = {k: g_prog[k] / scale for k in moved} if scale > 0 else {k: 0.0 for k in moved}
    d_ref, d_prog = _norms(ref_delta), _norms(prog_delta)
    change_gap, change_leaf = _worst(d_prog, d_ref, moved)
    return {"bn_var_gap": bn_var_gap(prog_var1, ref_var1),
            "loss_gap": max(rel(p, r) for p, r in zip(pl, rl)), "loss1_gap": rel(pl[0], rl[0]),
            "mse1_gap": rel(pm[0], rm[0]), "kl1_gap": rel(pk[0], rk[0]),
            "grad_gap": grad_gap, "grad_gap_raw_median": _median_gap(g_prog, g_ref, moved), "grad_scale": scale,
            "grad_gap_median": _median_gap(shaped, g_ref, moved),
            "change_gap": change_gap, "change_gap_median": _median_gap(d_prog, d_ref, moved),
            "grad_leaf": grad_leaf, "change_leaf": change_leaf, "left_out": len(g_ref) - len(moved)}


def _median_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]))


def embed_gap(replies, refs) -> float:
    """The largest absolute difference over pairs of ``[rows, z]`` arrays; a
    reply of another shape, or not finite, reads infinite."""
    worst = 0.0
    for got, want in zip(replies, refs):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape or not np.isfinite(got).all():
            return float("inf")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst
