"""The in-place Lloyd and EM iterations of hippie_tpu_torch/ops/clustering.py,
which the card captures once per shape and replays, on the CPU, where the
same iteration functions run eagerly.

Against the loops the module ran before the iterations were captured (kept
here as the reference): k-means and the GMM bit for bit. Against the JAX
package (hippie_tpu/ops/clustering.py) up to a permutation of labels, as in
tests/test_torch_clustering.py: assignments equal; centres, means,
variances and weights within 1e-5; inertia and log-likelihood rtol 1e-5.
The card's replay against the eager loop is in
tests/test_torch_cuda_kernels.py.
"""

import math

import numpy as np
import pytest
import torch

from hippie_tpu.ops import clustering as jclu
from hippie_tpu_torch.evaluate.knn_eval import pairwise_sq_dists
from hippie_tpu_torch.nn.functional import full_fp32
from hippie_tpu_torch.ops import clustering as tclu

torch.set_num_threads(1)


def _blobs(k: int, d: int, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    centres = 6.0 * r.normal(size=(k, d))
    return (centres[r.integers(0, k, size=n)] + 0.5 * r.normal(size=(n, d))).astype(np.float32)


def _loop_kmeans(x, k, iters, generator):
    """The module's k-means before its Lloyd iteration was captured."""
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
    for _ in range(iters):
        assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
        onehot = (assign[:, None] == torch.arange(k, device=x.device)).to(x.dtype)
        counts = onehot.sum(dim=0)
        with full_fp32():
            sums = onehot.T @ x
        centers = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), centers)
    dists = pairwise_sq_dists(x, centers)
    return torch.argmin(dists, dim=1), centers, dists.min(dim=1).values.sum()


def _loop_gmm(x, k, iters, seed):
    """The module's GMM before its EM iteration was captured."""
    n, d = x.shape
    assign, means, _ = _loop_kmeans(x, k, 10, torch.Generator().manual_seed(seed))
    counts = torch.clamp((assign[:, None] == torch.arange(k)).to(x.dtype).sum(dim=0), min=1.0)
    var = torch.ones(k, d, dtype=x.dtype)
    weights = counts / n
    for _ in range(iters):
        resp = torch.softmax(tclu._log_prob(x, means, var, weights), dim=1)
        nk = torch.clamp(resp.sum(dim=0), min=1e-8)
        with full_fp32():
            means = (resp.T @ x) / nk[:, None]
            diff2 = torch.square(x[:, None, :] - means[None, :, :])
            var = torch.einsum("nk,nkd->kd", resp, diff2) / nk[:, None] + 1e-6
        weights = nk / n
    lp = tclu._log_prob(x, means, var, weights)
    return torch.argmax(lp, dim=1), means, var, weights, torch.logsumexp(lp, dim=1).sum()


CASES = [(3, 2, 150, 0, 50), (4, 6, 300, 1, 7), (5, 20, 400, 2, 1), (4, 10, 392, 3, 0)]


@pytest.mark.parametrize("k,d,n,seed,iters", CASES)
def test_kmeans_equals_the_loop(k, d, n, seed, iters):
    x = torch.from_numpy(_blobs(k, d, n, seed))
    got = tclu.kmeans(x, k, iters=iters, seed=seed)
    want = _loop_kmeans(x, k, iters, torch.Generator().manual_seed(seed))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,d,n,seed,iters", CASES)
def test_gmm_equals_the_loop(k, d, n, seed, iters):
    x = torch.from_numpy(_blobs(k, d, n, seed))
    got = tclu.gmm(x, k, iters=iters, seed=seed)
    want = _loop_gmm(x, k, iters, seed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_iterations_update_their_buffers_in_place():
    """One Lloyd and one EM step write the buffers they were given; repeat
    runs a step its count of times (eagerly off the card)."""
    x = torch.from_numpy(_blobs(3, 4, 90, 5))
    with tclu._iterations(x, 3) as it:
        assert it.x is x
        it.centers.copy_(x[:3])
        ptr = it.centers.data_ptr()
        steps = []
        it.repeat("lloyd", lambda: (steps.append(1), tclu._lloyd(it.x, it.centers, 3)), 4)
        assert len(steps) == 4 and it.centers.data_ptr() == ptr
        want = x[:3].clone()
        for _ in range(4):
            assign = torch.argmin(pairwise_sq_dists(x, want), dim=1)
            sums = torch.stack([x[assign == c].sum(0) if (assign == c).any() else want[c] * 0 for c in range(3)])
            cnt = torch.stack([(assign == c).sum() for c in range(3)]).to(x.dtype)
            want = torch.where(cnt[:, None] > 0, sums / cnt.clamp(min=1.0)[:, None], want)
        torch.testing.assert_close(it.centers, want, rtol=1e-6, atol=1e-6)
        it.means.copy_(it.centers)
        it.var.fill_(1.0)
        it.weights.fill_(1.0 / 3)
        tclu._em(it.x, it.means, it.var, it.weights)
        assert torch.isclose(it.weights.sum(), torch.tensor(1.0)) and bool((it.var > 0).all())


def _permutation(ref_assign, assign, k):
    perm = np.array([np.bincount(ref_assign[assign == c], minlength=k).argmax() for c in range(k)])
    assert sorted(perm) == list(range(k))
    return perm


@pytest.mark.parametrize("method", ["kmeans", "gmm"])
def test_matches_jax_up_to_labels(method):
    k, x = 4, _blobs(4, 10, 392, 6)
    ref = [np.asarray(v) for v in getattr(jclu, method)(x, k, seed=6)]
    got = [v.numpy() for v in getattr(tclu, method)(x, k, seed=6, device="cpu")]
    perm = _permutation(ref[0], got[0], k)
    np.testing.assert_array_equal(perm[got[0]], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        np.testing.assert_allclose(a, b[perm], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got[-1]), float(ref[-1]), rtol=1e-5)
