"""k-means and the diagonal GMM (hippie_tpu_torch/ops/clustering.py) against
hippie_tpu/ops/clustering.py.

The two packages draw their k-means++ seeds from different generators, so
the clusters are compared up to a permutation of their labels, on blobs far
enough apart that both runs converge to the same partition: the
assignments equal; centres, means, variances and weights within 1e-5 (each
is a mean over the same rows, summed in another order); inertia and
log-likelihood rtol 1e-5 (sums of a few hundred float32 terms). A seed
repeats bit for bit, and draws from a CPU generator, so it does not depend
on the points' device.
"""

import numpy as np
import pytest
import torch

from hippie_tpu.ops import clustering as jclu
from hippie_tpu_torch.ops import clustering as tclu

torch.set_num_threads(1)


def _blobs(k: int, d: int, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    centres = 6.0 * r.normal(size=(k, d))
    return (centres[r.integers(0, k, size=n)] + 0.5 * r.normal(size=(n, d))).astype(np.float32)


def _permutation(ref_assign, assign, k):
    """perm[c]: the reference's label of the port's cluster c (each port
    cluster's majority); a bijection."""
    perm = np.array([np.bincount(ref_assign[assign == c], minlength=k).argmax() for c in range(k)])
    assert sorted(perm) == list(range(k))
    return perm


CASES = [(3, 2, 150, 0), (4, 6, 300, 1), (5, 20, 400, 2)]


@pytest.mark.parametrize("k,d,n,seed", CASES)
def test_kmeans_matches_jax(k, d, n, seed):
    x = _blobs(k, d, n, seed)
    ja, jc, ji = (np.asarray(v) for v in jclu.kmeans(x, k, seed=seed))
    ta, tc, ti = tclu.kmeans(x, k, seed=seed, device="cpu")
    ta, tc = ta.numpy(), tc.numpy()
    perm = _permutation(ja, ta, k)
    np.testing.assert_array_equal(perm[ta], ja)
    np.testing.assert_allclose(tc, jc[perm], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


@pytest.mark.parametrize("k,d,n,seed", CASES)
def test_gmm_matches_jax(k, d, n, seed):
    x = _blobs(k, d, n, seed)
    ref = [np.asarray(v) for v in jclu.gmm(x, k, seed=seed)]
    got = [v.numpy() for v in tclu.gmm(x, k, seed=seed, device="cpu")]
    perm = _permutation(ref[0], got[0], k)
    np.testing.assert_array_equal(perm[got[0]], ref[0])
    for name, a, b in zip(("means", "var", "weights"), got[1:4], ref[1:4]):
        np.testing.assert_allclose(a, b[perm], rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-5)


@pytest.mark.parametrize("method", ["kmeans", "gmm"])
def test_a_seed_repeats_bit_for_bit(method):
    x = _blobs(4, 6, 300, 3)
    fn = getattr(tclu, method)
    first, again = fn(x, 4, seed=7, device="cpu"), fn(torch.from_numpy(x), 4, seed=7)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    other = fn(x, 4, seed=8, device="cpu")
    assert other[0].shape == first[0].shape


def test_kmeans_keeps_an_empty_clusters_centre():
    """Two distinct points and k = 3: k-means++ puts a centre on a point
    already taken (every remaining weight is 0, the last slot is drawn), the
    cluster stays empty, and its centre is kept, as in the JAX function."""
    x = np.array([[0.0, 0.0]] * 5 + [[4.0, 0.0]] * 5, np.float32)
    ja, jc, ji = (np.asarray(v) for v in jclu.kmeans(x, 3, seed=0))
    ta, tc, ti = tclu.kmeans(x, 3, seed=0, device="cpu")
    assert float(ti) == float(ji) == 0.0
    assert len(np.unique(ta.numpy())) == len(np.unique(ja)) == 2
    assert torch.isfinite(tc).all() and np.isfinite(jc).all()
