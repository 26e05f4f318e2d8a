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

The iterations are the counterparts of the JAX ``fori_loop``s, fixed counts
in one compiled program each. On the card one Lloyd iteration and one EM
iteration are each captured as a CUDA graph over buffers that the
iteration updates in place (the centres; the means, variances and
weights), and replayed ``iters`` times: a call makes a few dozen launches
where the loops made about 10 and 15 per iteration. The graphs and their
buffers are kept per (n, d, k) and device, so repeated calls of one shape
capture once (evaluate/eval_graph.py GraphSpace: one capture stream and
memory pool per shape, the first iteration of a shape run eagerly on it
before the capture); calls of one shape take turns. The k-means++ seeding
(k - 1 small steps) runs eagerly. Off the card the same iteration functions
run eagerly, the loops of the JAX programs.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading

import torch

from hippie_tpu_torch.evaluate.eval_graph import GraphSpace
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


def _seed(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++: [k, d] centres, each next one drawn with probability
    proportional to its squared distance from the nearest centre so far.
    Slots not yet filled are masked out of the minimum (an inf in the
    product would give NaN)."""
    n, d = x.shape
    first = int(torch.randint(n, (1,), generator=generator))
    u = torch.rand(max(k - 1, 0), generator=generator, dtype=torch.float64).to(x.device)
    centers = torch.zeros(k, d, dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    slots = torch.arange(k, device=x.device)
    for i in range(1, k):
        dists = pairwise_sq_dists(x, centers)
        mind = torch.where(slots[None, :] < i, dists, math.inf).min(dim=1).values
        probs = mind / torch.clamp(mind.sum(), min=1e-12)
        cum = torch.cumsum(probs, 0)
        r = (cum[-1] * (1.0 - u[i - 1])).to(cum.dtype).reshape(1)
        idx = torch.clamp(torch.searchsorted(cum, r), max=n - 1)
        centers[i] = x.index_select(0, idx)[0]
    return centers


def _lloyd(x: torch.Tensor, centers: torch.Tensor, k: int):
    """One Lloyd iteration, ``centers`` updated in place; an empty cluster
    keeps its centre."""
    assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
    onehot = _onehot(assign, k, x.dtype)
    counts = onehot.sum(dim=0)
    with full_fp32():
        sums = onehot.T @ x
    centers.copy_(torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), centers))


def _em(x: torch.Tensor, means: torch.Tensor, var: torch.Tensor, weights: torch.Tensor):
    """One EM iteration of the diagonal GMM, ``means``, ``var`` and
    ``weights`` updated in place (the variances from the new means)."""
    resp = torch.softmax(_log_prob(x, means, var, weights), dim=1)
    nk = torch.clamp(resp.sum(dim=0), min=1e-8)
    with full_fp32():
        means.copy_((resp.T @ x) / nk[:, None])
        diff2 = torch.square(x[:, None, :] - means[None, :, :])
        var.copy_(torch.einsum("nk,nkd->kd", resp, diff2) / nk[:, None] + 1e-6)
    weights.copy_(nk / x.shape[0])


class _Iterations:
    """The iterations' buffers for ``x`` [n, d] and k clusters: ``x``,
    ``centers`` [k, d], ``means``, ``var`` [k, d] and ``weights`` [k], and
    on the card the captured Lloyd and EM iterations over them (module
    note)."""

    def __init__(self, x: torch.Tensor, k: int):
        n, d = x.shape
        dev = x.device
        self.space = GraphSpace(dev)
        self.x = torch.empty_like(x) if self.space.on_card else x
        self.centers, self.means, self.var = (torch.zeros(k, d, dtype=x.dtype, device=dev) for _ in range(3))
        self.weights = torch.zeros(k, dtype=x.dtype, device=dev)
        self.graphs: dict = {}
        self.lock = threading.Lock()

    def repeat(self, name: str, step, iters: int):
        """``step()`` ``iters`` times. On the card, while ``name`` has no
        graph, the first runs eagerly on the capture stream (the warm-up,
        and a real iteration), the second is captured, and every later one
        a replay of it."""
        if not self.space.on_card:
            for _ in range(iters):
                step()
            return
        with self.space.on_stream():
            for i in range(iters):
                if name not in self.graphs:
                    if i == 0:
                        step()
                        continue
                    self.graphs[name], _ = self.space.capture(step)
                self.graphs[name].replay()
                self.space.replays += 1


_ITERATIONS: "collections.OrderedDict[tuple, _Iterations]" = collections.OrderedDict()
_ITERATIONS_KEPT = 8
_ITERATIONS_LOCK = threading.Lock()


@contextlib.contextmanager
def _iterations(x: torch.Tensor, k: int):
    """The ``_Iterations`` of ``x``'s shape and ``k``, its lock held: on
    the card the cached one of (n, d, k, device), ``x`` copied into its
    buffer (the last ``_ITERATIONS_KEPT`` shapes are kept, so repeated
    calls of a shape capture once); off the card a new one over ``x``."""
    if x.device.type != "cuda":
        yield _Iterations(x, k)
        return
    key = (*x.shape, k, str(x.device))
    with _ITERATIONS_LOCK:
        it = _ITERATIONS.pop(key, None) or _Iterations(x, k)
        _ITERATIONS[key] = it
        while len(_ITERATIONS) > _ITERATIONS_KEPT:
            _ITERATIONS.popitem(last=False)
    with it.lock:
        it.x.copy_(x)
        yield it


def _kmeans(x: torch.Tensor, k: int, iters: int, generator: torch.Generator):
    centers = _seed(x, k, generator)
    with _iterations(x, k) as it:
        it.centers.copy_(centers)
        it.repeat("lloyd", lambda: _lloyd(it.x, it.centers, k), iters)
        centers = it.centers.clone()
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
    n = x.shape[0]
    k = int(k)
    assign, means, _ = _kmeans(x, k, 10, torch.Generator().manual_seed(seed))
    counts = torch.clamp(_onehot(assign, k, x.dtype).sum(dim=0), min=1.0)
    with _iterations(x, k) as it:
        it.means.copy_(means)
        it.var.fill_(1.0)
        it.weights.copy_(counts / n)
        it.repeat("em", lambda: _em(it.x, it.means, it.var, it.weights), int(iters))
        means, var, weights = it.means.clone(), it.var.clone(), it.weights.clone()
    lp = _log_prob(x, means, var, weights)
    return torch.argmax(lp, dim=1), means, var, weights, torch.logsumexp(lp, dim=1).sum()
