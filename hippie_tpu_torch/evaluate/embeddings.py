"""Embedding extraction (reference scripts/utils.py:74-98 get_embeddings).

Counterpart of zscore_rows, embed_unimodal, embed_multimodal and
get_embeddings in hippie_tpu/evaluate/embeddings.py. The embedding is ``encoded``, the
deterministic z-dim encoder_fc output, z-scored per row with the unbiased std.
Extraction runs in eval mode (running BN statistics) in one whole-dataset
forward, so rows cannot influence each other and no padding is needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hippie_tpu_torch.nn.functional import full_fp32


def zscore_rows(e: torch.Tensor) -> torch.Tensor:
    """Per-sample standardization with the unbiased std (scripts/utils.py:84-85)."""
    mean = e.mean(dim=1, keepdim=True)
    var = (e - mean).square().sum(dim=1, keepdim=True) / (e.shape[1] - 1)
    return (e - mean) / torch.sqrt(var)


@torch.no_grad()
def embed_unimodal(model, data: torch.Tensor, source: torch.Tensor,
                   class_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, L] -> z-scored [N, z] embeddings on the model's device.

    Convolutions and matmuls run in full float32 (no TF32), the counterpart of
    the JAX package's "highest" matmul precision for this parity-critical
    product. Leaves the model in eval mode.
    """
    model.eval()
    with full_fp32():
        enc, _, _, _ = model(data, source, class_)
        return zscore_rows(enc)


@torch.no_grad()
def embed_multimodal(model, wave: torch.Tensor, isi: torch.Tensor, source: torch.Tensor,
                     class_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """([N, 50], [N, 100]) -> z-scored [N, z] joint embeddings on the model's
    device, as embed_unimodal (eval mode, full float32, leaves the model in
    eval mode)."""
    model.eval()
    with full_fp32():
        enc, *_ = model(wave, isi, source, class_)
        return zscore_rows(enc)


def get_embeddings(wave_model, time_model, wave: torch.Tensor, isi: torch.Tensor,
                   source: torch.Tensor, class_: Optional[torch.Tensor] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wave_emb, isi_emb, joint) as numpy, like scripts/utils.py:74-98: each
    unimodal model's embeddings of its modality and their hstack (2z
    columns). Both embeddings come to the host in one copy."""
    e_wave = embed_unimodal(wave_model, wave, source, class_)
    e_time = embed_unimodal(time_model, isi, source, class_)
    both = torch.cat([e_wave, e_time], dim=1).cpu().numpy()
    z = e_wave.shape[1]
    return both[:, :z].copy(), both[:, z:].copy(), both
