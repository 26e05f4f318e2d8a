"""Stratified k-fold generation (reference: hippie/utils.py:42-70
``generate_kfolds``, StratifiedKFold(10, shuffle, seed 42)).

Counterpart of hippie_tpu/evaluate/kfolds.py. ``stratified_kfold_indices``
deals each class's shuffled members to the folds in turn (numpy's
``default_rng(seed)``), so the folds equal the JAX package's. ``generate_kfolds``
reads the labels with the ``csv`` module (data/registry.py) where the JAX
one reads them with pandas.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from hippie_tpu_torch.data import registry


def stratified_kfold_indices(labels, n_splits: int = 10, *, shuffle: bool = True, seed: int = 42):
    """[(train_idx, val_idx)] per fold with per-class balance."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    folds: List[List[int]] = [[] for _ in range(n_splits)]
    for cls in np.unique(labels):
        members = np.flatnonzero(labels == cls)
        if shuffle:
            members = members[rng.permutation(len(members))]
        for i, idx in enumerate(members):
            folds[i % n_splits].append(int(idx))
    all_idx = np.arange(len(labels))
    out = []
    for f in folds:
        val = np.sort(np.asarray(f, dtype=np.int64))
        out.append((np.setdiff1d(all_idx, val), val))
    return out


def _celltypes(path: str) -> np.ndarray:
    """``pd.read_csv(path, index_col=0).to_numpy().reshape(-1)``: every
    column but the first, each typed as pandas types it, row by row."""
    _, rows = registry._read_table(path)
    width = max((len(r) for r in rows), default=1)
    cols = [registry.column_values([r[j] if j < len(r) else "" for r in rows]) for j in range(1, width)]
    return np.stack(cols, axis=1).reshape(-1)


def generate_kfolds(dataset_path: str, data_root: str = "datasets", n_splits: int = 10):
    """The reference's contract: [(wf_train, wf_val, isi_train, isi_val,
    label_train, label_val, label_encoder), ...]."""
    wf, isi = registry.load_raw(data_root, dataset_path)
    labels_path = os.path.join(data_root, dataset_path, "celltypes.csv")
    if os.path.exists(labels_path):
        raw = _celltypes(labels_path)
    else:
        raw, _ = registry.load_supervised_labels(data_root, dataset_path)
    le = registry.LabelEncoder.fit(raw)
    labels = le.transform(raw)
    return [(wf[tr], wf[va], isi[tr], isi[va], labels[tr], labels[va], le)
            for tr, va in stratified_kfold_indices(labels, n_splits)]
