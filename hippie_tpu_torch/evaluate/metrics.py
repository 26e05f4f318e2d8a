"""Classification metrics with sklearn's definitions.

Counterpart of hippie_tpu/evaluate/metrics.py: ``confusion_matrix`` and
``balanced_accuracy_score``, used by the reference's evaluation
(train_model.py:415-461). numpy on the host.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_true, y_pred, labels=None) -> np.ndarray:
    """sklearn-compatible confusion matrix over sorted unique labels."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if labels is None:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    labels = np.asarray(labels)
    index = {lab: i for i, lab in enumerate(labels.tolist())}
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        cm[index[t], index[p]] += 1
    return cm


def balanced_accuracy_score(y_true, y_pred) -> float:
    """Mean per-class recall over the classes present in y_true."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean([np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]))
