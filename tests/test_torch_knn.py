"""KNN evaluation and metrics: hippie_tpu_torch.evaluate against
hippie_tpu.evaluate and scikit-learn.

The sweep's predictions for k = 5..19 must equal, element for element,
``hippie_tpu.evaluate.knn_eval._knn_sweep`` and sklearn's
``KNeighborsClassifier(n_neighbors=k, algorithm="brute")``, on two kinds of
data: normal draws whose sorted distances have no near-ties (checked: every
gap among each query's 20 nearest is above 1e-4, ten times the float32 rounding
of the distances), and integer points built with exact ties, where each query
has an equal-distance pair of train points of different labels at the k-th
place for every odd k (the lower train index wins) and vote ties for even k
(the lower class wins). Squared distances of integers this small are exact
in float32 in every implementation. The distance matrix itself: rtol 1e-5
against the JAX function (float32 a² − 2ab + b², summed in another order).
The metrics are exact.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import balanced_accuracy_score as sk_bas
from sklearn.metrics import confusion_matrix as sk_cm
from sklearn.neighbors import KNeighborsClassifier

import jax.numpy as jnp

from hippie_tpu.evaluate import knn_eval as jknn
from hippie_tpu.evaluate import metrics as jmetrics
from hippie_tpu_torch.evaluate import knn_eval as tknn
from hippie_tpu_torch.evaluate import metrics as tmetrics

torch.set_num_threads(1)

KS = list(range(5, 20))


def _normal():
    r = np.random.default_rng(0)
    train_x = r.normal(size=(240, 10)).astype(np.float32)
    test_x = r.normal(size=(60, 10)).astype(np.float32)
    d = ((test_x[:, None, :].astype(np.float64) - train_x[None]) ** 2).sum(-1)
    assert np.diff(np.sort(d, axis=1)[:, :21], axis=1).min() > 1e-4  # no near-ties
    return train_x, r.integers(0, 4, size=240), test_x


def _built_ties():
    """Queries 100 apart on axis 0; around each, 4 train points at distance 1,
    then pairs at distances 2..9 along axes 1-3, the two labels of a pair
    differing: one pair per distance, so the k-th place of every odd k is a
    tie. The points are listed nearest first around each query (240 of them,
    one chunk of sklearn's brute search), so sklearn's bounded heap, which
    keeps the first of equal distances it meets, also keeps the lower index."""
    r = np.random.default_rng(1)
    points, labels, queries = [], [], []
    for j in range(12):
        q = np.zeros(4)
        q[0] = 100 * j
        queries.append(q)
        for sign, axis in ((1, 1), (-1, 1), (1, 2), (-1, 2)):
            p = q.copy()
            p[axis] += sign
            points.append(p)
            labels.append(r.integers(0, 3))
        for radius in range(2, 10):
            axis = 1 + radius % 3
            pair = r.permutation(3)[:2]
            for sign, lab in zip((1, -1), pair):
                p = q.copy()
                p[axis] += sign * radius
                points.append(p)
                labels.append(lab)
    return np.asarray(points, np.float32), np.asarray(labels), np.asarray(queries, np.float32)


DATA = {"normal": _normal, "built_ties": _built_ties}


def test_pairwise_sq_dists_matches_jax():
    train_x, _, test_x = _normal()
    got = tknn.pairwise_sq_dists(torch.from_numpy(test_x), torch.from_numpy(train_x)).numpy()
    ref = np.asarray(jknn.pairwise_sq_dists(jnp.asarray(test_x), jnp.asarray(train_x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(DATA))
def test_knn_sweep_matches_jax_and_sklearn(kind):
    train_x, train_y, test_x = DATA[kind]()
    got = tknn.knn_predict_sweep(train_x, train_y, test_x, KS, device="cpu")
    ref = np.asarray(jknn._knn_sweep(jnp.asarray(train_x), jnp.asarray(train_y, jnp.int32),
                                     jnp.asarray(test_x), max_k=19, num_classes=int(train_y.max()) + 1))
    for k in KS:
        assert got[k].dtype == np.int64 and got[k].shape == (len(test_x),)
        np.testing.assert_array_equal(got[k], ref[:, k - 1], err_msg=f"k={k} vs _knn_sweep")
        sk = KNeighborsClassifier(n_neighbors=k, algorithm="brute").fit(train_x, train_y)
        np.testing.assert_array_equal(got[k], sk.predict(test_x), err_msg=f"k={k} vs sklearn")
    if kind == "built_ties":  # the ties decide: swapping each pair's labels changes predictions
        per_query = train_y.reshape(12, 20).copy()
        per_query[:, 4:] = per_query[:, 4:].reshape(12, 8, 2)[:, :, ::-1].reshape(12, 16)
        swapped = tknn.knn_predict_sweep(train_x, per_query.reshape(-1), test_x, KS, device="cpu")
        assert any((swapped[k] != got[k]).any() for k in KS[::2])


def test_vote_ties_go_to_the_lower_class():
    """k = 6 with three votes each for classes 2 and 1: class 1 wins."""
    train_x = np.arange(1, 9, dtype=np.float32)[:, None]
    train_y = np.array([2, 1, 2, 1, 2, 1, 0, 0])
    got = tknn.knn_predict_sweep(train_x, train_y, np.zeros((1, 1), np.float32), [5, 6], device="cpu")
    assert got[6].tolist() == [1] and got[5].tolist() == [2]


CASES = {
    "all_present": (np.array([0, 1, 2, 2, 1, 0, 2, 1]), np.array([0, 2, 2, 1, 1, 0, 2, 0])),
    "class_never_predicted": (np.array([0, 1, 2, 3, 3, 1]), np.array([0, 0, 2, 3, 3, 0])),
    "pred_outside_true": (np.array([1, 1, 2, 2]), np.array([0, 1, 2, 3])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_match_jax_and_sklearn(case):
    y_true, y_pred = CASES[case]
    got = tmetrics.balanced_accuracy_score(y_true, y_pred)
    assert got == jmetrics.balanced_accuracy_score(y_true, y_pred)
    np.testing.assert_allclose(got, sk_bas(y_true, y_pred), rtol=1e-12)
    for labels in (None, np.arange(5)):
        cm = tmetrics.confusion_matrix(y_true, y_pred, labels=labels)
        np.testing.assert_array_equal(cm, jmetrics.confusion_matrix(y_true, y_pred, labels=labels))
        np.testing.assert_array_equal(cm, sk_cm(y_true, y_pred, labels=labels))
