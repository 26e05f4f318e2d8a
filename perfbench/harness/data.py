"""The raw rows every cell draws from: the repository's ``datasets/``
(``<name>/waveforms.csv`` and ``<name>/isi_dist.csv``), read as the
published pipeline reads them with a bare ``pd.read_csv``: the header
skipped, the index column kept as feature 0, values parsed as float64 and
rounded once to float32. The same raw rows go to the program and to the
plain reference.
"""

from __future__ import annotations

import csv
from typing import Dict, NamedTuple

import numpy as np

from perfbench.harness.common import ROOT

DATA_ROOT = ROOT / "datasets"


def read_numeric_csv(path) -> np.ndarray:
    """float32 ``[rows, cols]`` of a numeric CSV with a header line; an empty
    or unparsable field is NaN, a short row is padded with NaN."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f)][1:]
    rows = [r for r in rows if r]
    cols = len(rows[0])
    out = np.full((len(rows), cols), np.nan, np.float64)
    for i, r in enumerate(rows):
        if len(r) > cols:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, expected {cols}")
        for j, field in enumerate(r):
            try:
                out[i, j] = float(field)
            except ValueError:
                pass
    return out.astype(np.float32)


class RawSet(NamedTuple):
    name: str
    wf: np.ndarray  # [N, W] raw waveforms
    isi: np.ndarray  # [N, I] raw ISI histograms
    source: int  # the dataset's source id


def load_sets(sources: Dict[str, int]) -> list:
    """Each named dataset's raw rows, with its source id, in the given order."""
    out = []
    for name, sid in sources.items():
        wf = read_numeric_csv(DATA_ROOT / name / "waveforms.csv")
        isi = read_numeric_csv(DATA_ROOT / name / "isi_dist.csv")
        if len(wf) != len(isi):
            raise ValueError(f"{name}: {len(wf)} waveforms but {len(isi)} ISI rows")
        out.append(RawSet(name, wf, isi, int(sid)))
    return out
