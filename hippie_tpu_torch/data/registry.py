"""Dataset registry and CSV ingestion (the reference's on-disk data contract).

Counterpart of hippie_tpu/data/registry.py. Layout: ``<data_root>/<name>/{waveforms,isi_dist,
labels,metadata}.csv``. The reference loads with bare ``pd.read_csv``, which
keeps the CSV's index column as feature 0 (quirk Q4); this module does the
same with the ``csv`` module, so it needs no pandas.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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


def register_dataset(name: str, source_id: Optional[int] = None) -> int:
    """Register a custom dataset name: ``source_id`` defaults to the next
    free ID (sharing an existing one shares that source embedding).
    Re-registering a name is a no-op when the IDs agree and an error when
    they conflict. Updates ``NUM_SOURCES``, the source-embedding size of
    models built afterwards."""
    global NUM_SOURCES
    prior = DATASET_SOURCE_IDS.get(name)
    if prior is not None:
        if source_id is not None and int(source_id) != prior:
            raise ValueError(f"dataset {name!r} already registered with source_id {prior}; "
                             f"got conflicting source_id {source_id}")
        return prior
    sid = NUM_SOURCES if source_id is None else int(source_id)
    if sid < 0:
        raise ValueError(f"source_id must be >= 0, got {sid}")
    DATASET_SOURCE_IDS[name] = sid
    NUM_SOURCES = max(NUM_SOURCES, sid + 1)
    return sid


def discover_datasets(data_root: str) -> list:
    """Register the unknown dataset directories of ``data_root`` (those with
    ``waveforms.csv`` and ``isi_dist.csv``), as the JAX package does: the
    pins of ``<data_root>/registry.json`` ({name: source_id}) first, each
    reserving its ID; then new names get fresh sequential IDs in sorted
    order, persisted back to ``registry.json`` so that a later discovery
    cannot remap them. Idempotent. Returns the newly registered names
    (sorted)."""
    pinned = {}
    manifest = os.path.join(data_root, "registry.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            raw = json.load(f)
        if not isinstance(raw, dict):
            raise ValueError(f"{manifest} must be a JSON object of name -> source_id")
        pinned = {str(k): int(v) for k, v in raw.items()}
    new = []
    for name in sorted(pinned):
        if name not in DATASET_SOURCE_IDS:
            new.append(name)
        register_dataset(name, pinned[name])
    found = []
    if os.path.isdir(data_root):
        for entry in sorted(os.listdir(data_root)):
            d = os.path.join(data_root, entry)
            if (os.path.isdir(d) and os.path.exists(os.path.join(d, "waveforms.csv"))
                    and os.path.exists(os.path.join(d, "isi_dist.csv")) and entry not in DATASET_SOURCE_IDS):
                found.append(entry)
    for name in found:
        register_dataset(name, None)
        new.append(name)
    unpersisted = [n for n in found if n not in pinned]
    if unpersisted:
        merged = dict(pinned)
        merged.update({n: DATASET_SOURCE_IDS[n] for n in unpersisted})
        try:
            tmp = f"{manifest}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, manifest)
        except OSError as e:  # a read-only data root: the IDs live for this process only
            warnings.warn(f"could not persist dataset source IDs to {manifest} ({e}); "
                          f"pin them manually to keep checkpoints portable")
    return sorted(new)


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


def write_csv(path: str, header, rows):
    """Write ``header`` and ``rows`` as pandas' ``to_csv`` does: minimal
    quoting, ``\\n`` line ends, each numpy value as ``str`` prints it, NaN
    as an empty field."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for row in rows:
            w.writerow(["" if isinstance(v, np.floating) and np.isnan(v) else str(v) for v in row])


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


@dataclass
class LabelEncoder:
    """sklearn-compatible label encoder (sorted unique classes -> codes)."""

    classes_: np.ndarray

    @classmethod
    def fit(cls, labels) -> "LabelEncoder":
        return cls(classes_=np.unique(np.asarray(labels)))

    def transform(self, labels) -> np.ndarray:
        return np.searchsorted(self.classes_, np.asarray(labels)).astype(np.int64)

    def inverse_transform(self, codes) -> np.ndarray:
        return self.classes_[np.asarray(codes, dtype=np.int64)]


def _read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    """(column names, rows of fields) of a CSV, named as ``pd.read_csv`` names
    them: an empty header cell ``i`` becomes ``"Unnamed: i"``."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0] if rows else []
    return [h if h != "" else f"Unnamed: {i}" for i, h in enumerate(header)], rows[1:]


def column_values(fields: List[str]) -> np.ndarray:
    """One column's values with pandas' type inference for the label and
    metadata files: int64 when every field is an integer, float64 when every
    field is a number or empty (NaN), else the strings as an object array."""
    try:
        return np.asarray([int(v) for v in fields], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(v) if v != "" else np.nan for v in fields], dtype=np.float64)
    except ValueError:
        return np.asarray(fields, dtype=object)


def load_supervised_labels(data_root: str, name: str):
    """Labels for the supervised stage (train_model.py:275-283).

    The reference reads ``labels.csv["label"]`` and crashes on every shipped
    dataset because none has a ``label`` column (quirk Q5). As the JAX
    package, this takes ``label`` if it exists, else the last column that is
    not a pandas index column. A missing file gives all-zero labels, the
    reference's else-branch. Returns (encoded labels int64 [N], encoder).
    """
    path = os.path.join(data_root, name, "labels.csv")
    if not os.path.exists(path):
        wf, _ = load_raw(data_root, name)
        labels = np.zeros(len(wf))
        return labels.astype(np.int64), LabelEncoder.fit(labels)
    columns, rows = _read_table(path)
    if "label" in columns:
        col = columns.index("label")
    else:
        named = [i for i, c in enumerate(columns) if not c.startswith("Unnamed")]
        col = named[-1] if named else len(columns) - 1
    raw = column_values([r[col] if col < len(r) else "" for r in rows])
    le = LabelEncoder.fit(raw)
    return le.transform(raw), le


def load_metadata(data_root: str, name: str) -> Optional[List[Dict[str, str]]]:
    """Rows of ``<name>/metadata.csv`` as {column: field} dicts, or None when
    the file is missing."""
    path = os.path.join(data_root, name, "metadata.csv")
    if not os.path.exists(path):
        return None
    columns, rows = _read_table(path)
    return [dict(zip(columns, r)) for r in rows]


def chip_finetune_split(metadata: List[Dict[str, str]]) -> Tuple[np.ndarray, np.ndarray]:
    """Earliest-10-timestamps rule for chip datasets (train_model.py:182-188):
    the rows whose time of day (``pd.to_datetime(datetime).dt.time``) is one
    of the 10 earliest distinct times train, the rest test. Parses ISO dates
    with a time ("2024-01-01 00:00:05", as synth.make_dataset writes them)."""
    times = [datetime.datetime.fromisoformat(r["datetime"]).time() for r in metadata]
    first = set(sorted(set(times))[:10])
    train = np.asarray([i for i, t in enumerate(times) if t in first], dtype=np.int64)
    test = np.asarray([i for i, t in enumerate(times) if t not in first], dtype=np.int64)
    return train, test
