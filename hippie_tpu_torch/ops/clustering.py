"""Clustering of latent embeddings on the device: k-means and Gaussian mixtures.

Counterpart of hippie_tpu/ops/clustering.py: k-means++ seeding, then Lloyd
iterations; a diagonal-covariance GMM fit by EM from a short k-means. The
JAX module is plain XLA ops (no Pallas kernel), so this is plain torch ops,
with every product in full float32 (no TF32).

Random draws come from a CPU ``torch.Generator`` seeded with ``seed``, so a
seed gives the same clusters on the card and on the host; jax.random's bits
cannot be reproduced, so the seeding differs from the JAX package's draw
for draw. Every uniform of the seeding is drawn before it starts and reaches
the device in one copy; each centre is then picked on the device
(``searchsorted`` on the cumulative k-means++ weights), so neither the
seeding nor the iterations wait for the card.
"""

from __future__ import annotations

import math

import torch

from hippie_tpu_torch.evaluate.knn_eval import pairwise_sq_dists
from hippie_tpu_torch.nn.functional import full_fp32


def _points(x, device) -> torch.Tensor:
    """float32 [n, d] on ``device`` (default: a tensor's own, else cuda)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _onehot(assign: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """[n, k] one-hot rows; F.one_hot would wait for the card to check the
    labels' range."""
    return (assign[:, None] == torch.arange(k, device=assign.device)).to(dtype)


def _kmeans(x: torch.Tensor, k: int, iters: int, generator: torch.Generator):
    n, d = x.shape
    first = int(torch.randint(n, (1,), generator=generator))
    u = torch.rand(max(k - 1, 0), generator=generator, dtype=torch.float64).to(x.device)
    centers = torch.zeros(k, d, dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    slots = torch.arange(k, device=x.device)
    # k-means++: each next centre drawn with probability proportional to its
    # squared distance from the nearest centre so far. Slots not yet filled
    # are masked out of the minimum (an inf in the product would give NaN).
    for i in range(1, k):
        dists = pairwise_sq_dists(x, centers)
        mind = torch.where(slots[None, :] < i, dists, math.inf).min(dim=1).values
        probs = mind / torch.clamp(mind.sum(), min=1e-12)
        cum = torch.cumsum(probs, 0)
        r = (cum[-1] * (1.0 - u[i - 1])).to(cum.dtype).reshape(1)
        idx = torch.clamp(torch.searchsorted(cum, r), max=n - 1)
        centers[i] = x.index_select(0, idx)[0]
    for _ in range(iters):  # Lloyd; an empty cluster keeps its centre
        assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
        onehot = _onehot(assign, k, x.dtype)
        counts = onehot.sum(dim=0)
        with full_fp32():
            sums = onehot.T @ x
        centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    dists = pairwise_sq_dists(x, centers)
    return torch.argmin(dists, dim=1), centers, dists.min(dim=1).values.sum()


def kmeans(x, k: int, *, iters: int = 50, seed: int = 0, device=None):
    """(assignments [n], centers [k, d], inertia) of ``x`` [n, d], on the
    points' device."""
    return _kmeans(_points(x, device), int(k), int(iters), torch.Generator().manual_seed(seed))


def _log_prob(x, means, var, weights):
    """[n, k]: log N(x | mean_k, diag var_k) + log w_k."""
    d = x.shape[1]
    diff2 = torch.square(x[:, None, :] - means[None, :, :]) / var[None, :, :]
    ll = -0.5 * (diff2.sum(dim=2) + torch.log(var).sum(dim=1)[None, :] + d * math.log(2 * math.pi))
    return ll + torch.log(weights)[None, :]


def gmm(x, k: int, *, iters: int = 100, seed: int = 0, device=None):
    """Diagonal-covariance GMM by EM, started from 10 k-means iterations of
    the same seed. Returns (assign, means, var, weights, log_likelihood)."""
    x = _points(x, device)
    n, d = x.shape
    k = int(k)
    assign, means, _ = _kmeans(x, k, 10, torch.Generator().manual_seed(seed))
    counts = torch.clamp(_onehot(assign, k, x.dtype).sum(dim=0), min=1.0)
    var = torch.ones(k, d, dtype=x.dtype, device=x.device)
    weights = counts / n
    for _ in range(int(iters)):
        resp = torch.softmax(_log_prob(x, means, var, weights), dim=1)
        nk = torch.clamp(resp.sum(dim=0), min=1e-8)
        with full_fp32():
            means = (resp.T @ x) / nk[:, None]
            diff2 = torch.square(x[:, None, :] - means[None, :, :])
            var = torch.einsum("nk,nkd->kd", resp, diff2) / nk[:, None] + 1e-6
        weights = nk / n
    lp = _log_prob(x, means, var, weights)
    return torch.argmax(lp, dim=1), means, var, weights, torch.logsumexp(lp, dim=1).sum()
