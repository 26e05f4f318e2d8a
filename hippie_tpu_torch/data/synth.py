"""Synthetic dataset in the reference's on-disk CSV contract.

Counterpart of hippie_tpu/data/synth.py:make_dataset, written with the
``csv`` module: the same seed gives the same bytes as the JAX package's
pandas writer (floats as numpy prints them, an index column, ``\\n`` line
ends), so both packages' loaders read the same arrays. Waveforms are
class-dependent damped oscillations plus noise; ISI histograms are
class-dependent log-normal counts.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from hippie_tpu_torch.data.registry import write_csv


def make_dataset(
    root: str,
    name: str,
    *,
    n: int = 256,
    wave_width: int = 46,
    isi_width: int = 100,
    num_classes: int = 3,
    seed: int = 0,
    label_column: str = "label",
    with_metadata: bool = False,
) -> str:
    """Write <root>/<name>/{waveforms,isi_dist,labels}.csv (and metadata.csv
    with a ``datetime`` column one second apart); returns the directory.

    The value files have an index column, which the loaders re-ingest as
    feature 0 (quirk Q4).
    """
    rng = np.random.default_rng(seed)
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)

    classes = rng.integers(0, num_classes, size=n)
    t = np.linspace(0, 1, wave_width)

    waves = np.empty((n, wave_width), np.float64)
    isis = np.empty((n, isi_width), np.float64)
    for i in range(n):
        c = classes[i]
        freq = 3.0 + 2.0 * c
        decay = 2.0 + 0.5 * c
        wave = -np.exp(-decay * t) * np.sin(2 * np.pi * freq * t)
        waves[i] = wave + 0.05 * rng.normal(size=wave_width)
        mu = 1.0 + 0.6 * c
        samples = rng.lognormal(mean=mu, sigma=0.6, size=400)
        hist, _ = np.histogram(samples, bins=isi_width, range=(0, 30))
        isis[i] = hist

    for fname, arr in (("waveforms.csv", waves), ("isi_dist.csv", isis)):
        write_csv(os.path.join(path, fname), [""] + [str(j) for j in range(arr.shape[1])],
                  ([i, *arr[i]] for i in range(n)))
    write_csv(os.path.join(path, "labels.csv"), ["", label_column],
              ([i, f"type{c}"] for i, c in enumerate(classes)))
    if with_metadata:
        t0 = datetime.datetime(2024, 1, 1)
        write_csv(os.path.join(path, "metadata.csv"), ["label", "datetime"],
                  ([c, t0 + datetime.timedelta(seconds=i)] for i, c in enumerate(classes)))
    return path
