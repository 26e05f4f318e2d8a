"""Embedding extraction (reference scripts/utils.py:74-98 get_embeddings).

Counterpart of zscore_rows, embed_unimodal, embed_multimodal and
get_embeddings in hippie_tpu/evaluate/embeddings.py. The embedding is ``encoded``, the
deterministic z-dim encoder_fc output, z-scored per row with the unbiased std.
Extraction runs in eval mode (running BN statistics) in one whole-dataset
forward, so rows cannot influence each other and no padding is needed.
With ``mesh`` (parallel/mesh.py) the rows are padded to a multiple of the
ranks and each rank embeds its contiguous block (``place_eval_inputs``);
the blocks are gathered in rank order on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hippie_tpu_torch.nn.functional import full_fp32
from hippie_tpu_torch.parallel import mesh as pmesh


def zscore_rows(e: torch.Tensor) -> torch.Tensor:
    """Per-sample standardization with the unbiased std (scripts/utils.py:84-85)."""
    mean = e.mean(dim=1, keepdim=True)
    var = (e - mean).square().sum(dim=1, keepdim=True) / (e.shape[1] - 1)
    return (e - mean) / torch.sqrt(var)


def _sharded(mesh, fn, *rows):
    """fn(*rows) on this rank's block of the rows, gathered (no mesh: fn(*rows))."""
    present = [r for r in rows if r is not None]
    n, local = pmesh.place_eval_inputs(mesh, present)
    it = iter(local)
    return pmesh.gather_eval_rows(mesh, fn(*(None if r is None else next(it) for r in rows)), n)


@torch.no_grad()
def embed_unimodal(model, data: torch.Tensor, source: torch.Tensor,
                   class_: Optional[torch.Tensor] = None, *, mesh=None) -> torch.Tensor:
    """[N, L] -> z-scored [N, z] embeddings on the model's device.

    Convolutions and matmuls run in full float32 (no TF32), the counterpart of
    the JAX package's "highest" matmul precision for this parity-critical
    product. Leaves the model in eval mode. ``mesh``: rows sharded over the
    ranks (module note).
    """
    model.eval()

    def embed(d, s, c):
        with full_fp32():
            enc, _, _, _ = model(d, s, c)
            return zscore_rows(enc)

    return _sharded(mesh, embed, data, source, class_)


@torch.no_grad()
def embed_multimodal(model, wave: torch.Tensor, isi: torch.Tensor, source: torch.Tensor,
                     class_: Optional[torch.Tensor] = None, *, mesh=None) -> torch.Tensor:
    """([N, 50], [N, 100]) -> z-scored [N, z] joint embeddings on the model's
    device, as embed_unimodal (eval mode, full float32, leaves the model in
    eval mode, ``mesh``)."""
    model.eval()

    def embed(w, i, s, c):
        with full_fp32():
            enc, *_ = model(w, i, s, c)
            return zscore_rows(enc)

    return _sharded(mesh, embed, wave, isi, source, class_)


def get_embeddings(wave_model, time_model, wave: torch.Tensor, isi: torch.Tensor,
                   source: torch.Tensor, class_: Optional[torch.Tensor] = None, *, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wave_emb, isi_emb, joint) as numpy, like scripts/utils.py:74-98: each
    unimodal model's embeddings of its modality and their hstack (2z
    columns). Both embeddings come to the host in one copy. ``mesh``: rows
    sharded over the ranks."""
    e_wave = embed_unimodal(wave_model, wave, source, class_, mesh=mesh)
    e_time = embed_unimodal(time_model, isi, source, class_, mesh=mesh)
    both = torch.cat([e_wave, e_time], dim=1).cpu().numpy()
    z = e_wave.shape[1]
    return both[:, :z].copy(), both[:, z:].copy(), both
