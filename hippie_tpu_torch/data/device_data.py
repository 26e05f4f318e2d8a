"""Device-resident datasets and statically-shaped batch plans.

Counterpart of hippie_tpu/data/device_data.py (``ArrayDataset``,
``train_val_split``, ``batch_plan``). The whole preprocessed dataset lives on
the device, and an epoch walks a ``[num_batches, B]`` index plan whose padded
tail rows carry mask 0. Shuffles draw from an explicit ``torch.Generator``;
its bits differ from jax.random's, so parity tests pass the plans built on the
JAX side. Both fit loops (train/loop.py, train/device_fit.py) shuffle with
``batch_plan``: the JAX ``epoch_shuffle_order`` and ``host_epoch_plan`` draw
jax.random bits the port cannot reproduce, and the JAX shape buckets
(``next_pow2``, ``pad_plan``, ``plan_pad_duplicate``) serve XLA's compiled
programs, where the device loop captures its CUDA graphs per stage at the
stage's own plan shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ArrayDataset:
    """Preprocessed arrays of one dataset (or a concatenation).

    wave: [N, 50] float32; isi: [N, 100] float32; source: [N] int64 source ids;
    label: [N] int64 class labels or None.
    """

    wave: torch.Tensor
    isi: torch.Tensor
    source: torch.Tensor
    label: Optional[torch.Tensor] = None

    def __len__(self):
        return self.wave.shape[0]

    @staticmethod
    def concat(datasets) -> "ArrayDataset":
        labels = [d.label for d in datasets]
        return ArrayDataset(
            wave=torch.cat([d.wave for d in datasets]),
            isi=torch.cat([d.isi for d in datasets]),
            source=torch.cat([d.source for d in datasets]),
            label=None if any(lb is None for lb in labels) else torch.cat(labels),
        )


def _permutation(n: int, generator: torch.Generator) -> np.ndarray:
    return torch.randperm(n, generator=generator).numpy()


def train_val_split(n: int, train_prop: float, generator: torch.Generator
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Random index split like torch random_split (train_model.py:106), from a
    CPU ``generator``."""
    n_train = int(train_prop * n)
    perm = _permutation(n, generator)
    return perm[:n_train], perm[n_train:]


def batch_plan(
    indices: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool,
    generator: Optional[torch.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A statically-shaped epoch plan from an index stream.

    Returns (idx [nb, B] int32, mask [nb, B] float32). The final batch is
    padded with its own LAST REAL index and mask 0 (drop_last=False). An
    in-batch duplicate normalizes exactly like the sample it copies, so even
    a 1-real-row tail keeps its padded rows bounded through every masked
    BatchNorm; statistics and losses exclude them either way.
    """
    indices = np.asarray(indices)
    if shuffle:
        if generator is None:
            raise ValueError("shuffle=True needs a generator")
        indices = indices[_permutation(len(indices), generator)]
    n = len(indices)
    nb = max(1, -(-n // batch_size))
    padded = np.zeros(nb * batch_size, dtype=np.int32)
    padded[:n] = indices
    if n:
        padded[n:] = indices[n - 1]
    mask = np.zeros(nb * batch_size, dtype=np.float32)
    mask[:n] = 1.0
    return padded.reshape(nb, batch_size), mask.reshape(nb, batch_size)
