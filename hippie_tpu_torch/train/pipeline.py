"""Dataset assembly of the unimodal pipeline.

Counterpart of ``load_dataset`` and ``load_pretrain_pool`` in
hippie_tpu/train/pipeline.py (train_model.py:64-100): load raw CSVs,
preprocess on the device, and concatenate the leave-target-out pretraining
pool. The stage runners, fit loop and CLI of that module are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hippie_tpu_torch.data import registry
from hippie_tpu_torch.data.device_data import ArrayDataset
from hippie_tpu_torch.ops import preprocess


@dataclass
class PipelineConfig:
    """The fields of hippie_tpu's PipelineConfig that dataset assembly reads,
    plus the device the arrays live on."""

    dataset: str = "cellexplorer-celltype"
    data_root: str = "datasets"
    strict_leakage_guard: bool = False
    drop_index_column: bool = False  # drop the CSV index feature (quirk Q4)
    verbose: bool = True
    device: str = "cuda"


def load_dataset(cfg: PipelineConfig, name: str, *, dropna: bool = False) -> ArrayDataset:
    """Load and preprocess one dataset into arrays on ``cfg.device``."""
    wf, isi = registry.load_raw(
        cfg.data_root, name, dropna=dropna, drop_index_column=cfg.drop_index_column
    )
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=cfg.device)
    src = torch.full((wf.shape[0],), registry.DATASET_SOURCE_IDS.get(name, 0),
                     dtype=torch.long, device=cfg.device)
    return ArrayDataset(wave=wave, isi=isi_p, source=src)


def load_pretrain_pool(cfg: PipelineConfig) -> ArrayDataset:
    """Leave-target-out pool (train_model.py:64-100); datasets whose files
    are missing are skipped, as the reference skips them."""
    names = registry.pretrain_pool(cfg.dataset, strict_leakage_guard=cfg.strict_leakage_guard)
    parts = []
    for name in names:
        try:
            part = load_dataset(cfg, name)
        except FileNotFoundError:
            if cfg.verbose:
                print(f"Folder {name} missing data files; skipping")
            continue
        if cfg.verbose:
            print(f"Folder {name} has shapes {tuple(part.wave.shape)} and {tuple(part.isi.shape)}")
        parts.append(part)
    if not parts:
        raise RuntimeError("no pretraining datasets available")
    ds = ArrayDataset.concat(parts)
    if cfg.verbose:
        print(f"Total waveforms {len(ds)} and total isi {len(ds)}")
    return ds
