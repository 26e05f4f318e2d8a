"""Class-balanced oversampling (reference: BalancedBatchSampler,
hippie/dataloading.py:107-151) as a deterministic index stream.

Counterpart of hippie_tpu/data/sampling.py, numpy only, so one seed gives the
same stream bit for bit in both packages. Reference semantics:
  - bucket indices per label, in order of first appearance in the dataset;
  - oversample every class to the majority count by sampling (with
    replacement) from the indices accumulated so far;
  - yield round-robin across classes: class_0[0], class_1[0], ..., class_0[1]...
  - stream length = balanced_max * num_classes, identical every epoch.

The reference draws from Python's global ``random``; this draws from an
explicit numpy Generator, so runs are reproducible.
"""

from __future__ import annotations

import numpy as np


def balanced_indices(labels: np.ndarray, seed: int = 42,
                     target_count: int | None = None) -> np.ndarray:
    """The full balanced round-robin index stream for one epoch.

    ``target_count`` oversamples every class to that count instead of the
    majority count; it must be >= the majority count.
    """
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)

    buckets: dict = {}
    for idx, lab in enumerate(labels):
        buckets.setdefault(lab.item() if hasattr(lab, "item") else lab, []).append(idx)
    balanced_max = max(len(b) for b in buckets.values())
    if target_count is not None:
        if target_count < balanced_max:
            raise ValueError(f"target_count {target_count} < local majority {balanced_max}")
        balanced_max = target_count

    # choice with replacement from the growing list (dataloading.py:123-125)
    for b in buckets.values():
        while len(b) < balanced_max:
            b.append(b[rng.integers(0, len(b))])

    keys = list(buckets.keys())
    stream = np.empty(balanced_max * len(keys), dtype=np.int64)
    for j in range(balanced_max):
        for c, k in enumerate(keys):
            stream[j * len(keys) + c] = buckets[k][j]
    return stream
