"""Dataset registry and CSV ingestion (the reference's on-disk data contract).

Counterpart of hippie_tpu/data/registry.py (the parts the training slice
needs). Layout: ``<data_root>/<name>/{waveforms,isi_dist}.csv``. The reference
loads with bare ``pd.read_csv``, which keeps the CSV's index column as
feature 0 (quirk Q4); this module does the same with the ``csv`` module, so
it needs no pandas.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Tuple

import numpy as np

# Source-ID map (train_model.py:51-59). allenscope shares ID 3 with
# cellexplorer; ID 0 is reserved for the inference-time dummy source.
DATASET_SOURCE_IDS: Dict[str, int] = {
    "extracellular-mouse-a1": 1,
    "cellexplorer-celltype": 3,
    "cellexplorer-area": 3,
    "juxtacellular-mouse-s1-celltype": 4,
    "juxtacellular-mouse-s1-area": 4,
    "allenscope-neuropixel": 3,
    "neonatal-mouse-brain-slice": 2,
}

NUM_SOURCES = max(DATASET_SOURCE_IDS.values()) + 1  # train_model.py:62


def pretrain_pool(target_dataset: str, *, strict_leakage_guard: bool = False) -> list:
    """Names of the datasets that pretrain a given target (leave-target-out).

    Reference behavior (train_model.py:70-79): exact-match removal always; the
    cellexplorer guard removes both cellexplorer datasets; the juxtacellular
    guard is typo'd and never fires (quirk Q2). ``strict_leakage_guard=True``
    also removes the sister juxtacellular datasets.
    """
    pool = dict(DATASET_SOURCE_IDS)
    if "cellexplorer" in target_dataset:
        pool.pop("cellexplorer-celltype", None)
        pool.pop("cellexplorer-area", None)
    if strict_leakage_guard and "juxtacellular" in target_dataset:
        pool.pop("juxtacellular-mouse-s1-celltype", None)
        pool.pop("juxtacellular-mouse-s1-area", None)
    return [name for name in pool if name != target_dataset]


def read_numeric_csv(path: str) -> np.ndarray:
    """float32 [rows, cols] of a numeric CSV with a header line.

    pandas semantics for the dataset files: the header is skipped, the index
    column is kept, empty or unparsable fields are NaN, short rows are padded
    with NaN, and a row longer than the first data row is an error. Values
    parse as float64 and round once to float32. A missing file raises
    FileNotFoundError.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f)][1:]
    rows = [r for r in rows if r]
    if not rows:
        return np.zeros((0, 0), np.float32)
    cols = len(rows[0])
    out = np.full((len(rows), cols), np.nan, np.float64)
    for i, r in enumerate(rows):
        if len(r) > cols:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, expected {cols}")
        for j, field in enumerate(r):
            try:
                out[i, j] = float(field)
            except ValueError:
                pass  # empty or unparsable: NaN
    return out.astype(np.float32)


def load_raw(
    data_root: str,
    name: str,
    *,
    dropna: bool = False,
    drop_index_column: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(waveforms, isi) raw float32 arrays, as the reference loads them.

    Keeps the CSV index column as feature 0 (quirk Q4) unless
    ``drop_index_column``; ``dropna`` drops any-NaN columns, the fine-tune
    path's ``dropna(axis=1)`` (train_model.py:166-169, quirk Q13).
    """
    wf = read_numeric_csv(os.path.join(data_root, name, "waveforms.csv"))
    isi = read_numeric_csv(os.path.join(data_root, name, "isi_dist.csv"))
    if drop_index_column:
        wf, isi = wf[:, 1:], isi[:, 1:]
    if dropna:
        wf = wf[:, ~np.isnan(wf).any(axis=0)]
        isi = isi[:, ~np.isnan(isi).any(axis=0)]
    return np.ascontiguousarray(wf), np.ascontiguousarray(isi)
