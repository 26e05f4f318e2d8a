"""Embedding extraction (reference scripts/utils.py:74-98 get_embeddings).

Counterpart of zscore_rows and embed_unimodal in
hippie_tpu/evaluate/embeddings.py. The embedding is ``encoded``, the
deterministic z-dim encoder_fc output, z-scored per row with the unbiased std.
Extraction runs in eval mode (running BN statistics) in one whole-dataset
forward, so rows cannot influence each other and no padding is needed.
"""

from __future__ import annotations

from typing import Optional

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
