"""KNN classification of embeddings on the device, every k in one pass.

Counterpart of hippie_tpu/evaluate/knn_eval.py (``pairwise_sq_dists``,
``_knn_sweep``, ``knn_predict_sweep``), which replaces the reference's sklearn
KNeighborsClassifier loop over k = 5..19 (train_model.py:415-461): one
[n_test, n_train] squared-distance matrix, the max(k) nearest neighbours
taken once, and every k's majority vote from prefix vote counts.

Ties follow sklearn: equal distances go to the lower train index (a stable
sort of the distances), equal votes to the lower class index (argmax takes
the first maximum). The distance product is a plain ``torch.matmul``, as the
JAX package computes it outside any Pallas kernel; it runs in full float32
(no TF32) on the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hippie_tpu_torch.nn.functional import full_fp32


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[n, d] x [m, d] -> [n, m] squared euclidean distances, a² − 2ab + b²."""
    a2 = a.square().sum(dim=1, keepdim=True)
    b2 = b.square().sum(dim=1, keepdim=True)
    with full_fp32():
        ab = a @ b.T
    return a2 - 2.0 * ab + b2.T


def knn_sweep(train_x: torch.Tensor, train_y: torch.Tensor, test_x: torch.Tensor, *,
              max_k: int, num_classes: int) -> torch.Tensor:
    """[n_test, max_k] int64 predictions: column k-1 is the k-NN vote."""
    d = pairwise_sq_dists(test_x, train_x)
    nbr_idx = torch.sort(d, dim=1, stable=True).indices[:, :max_k]
    nbr_labels = train_y[nbr_idx]
    onehot = torch.nn.functional.one_hot(nbr_labels, num_classes)
    counts = torch.cumsum(onehot, dim=1)  # [n_test, max_k, C] votes of the first k
    return torch.argmax(counts, dim=2)


def knn_predict_sweep(train_x, train_y, test_x, ks: Sequence[int], device="cuda") -> dict:
    """Predictions for every k in ``ks`` in one pass on ``device``.

    ``train_x`` / ``test_x`` are [n, d] embeddings (numpy or tensors),
    ``train_y`` integer labels 0..C-1. Returns {k: np.ndarray[n_test]}; one
    copy to the host.
    """
    train_y = np.asarray(train_y, dtype=np.int64)
    max_k = int(max(ks))
    as_dev = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)  # noqa: E731
    preds = knn_sweep(as_dev(train_x), torch.from_numpy(train_y).to(device), as_dev(test_x),
                      max_k=max_k, num_classes=int(train_y.max()) + 1).cpu().numpy()
    return {k: preds[:, k - 1] for k in ks}
