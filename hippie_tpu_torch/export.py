"""A model's geometry read from its checkpoint, and the model rebuilt from it.

Counterpart of the checkpoint half of hippie_tpu/export.py
(``infer_unimodal_config``, ``infer_multimodal_config``,
``load_model_from_ckpt``): one policy for every entry point that loads a
Lightning ``.ckpt`` (the inference CLI, the pipelines' stage-1 seams). The
geometry comes from the state_dict's own weight shapes, so it works for the
port's checkpoints, the JAX package's and the torch reference's alike. The
JAX module's StableHLO artifact (``export_embedder`` and its loaders) has no
port here.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.train import checkpoint as ckpt_mod
from hippie_tpu_torch.train import loop


def _block_counts(state_dict: dict, encoder: str) -> tuple:
    """Blocks per stage from the ``model.<encoder>.layer{i}.{j}.`` key indices."""
    return tuple(len({int(k.split(".")[3]) for k in state_dict
                      if k.startswith(f"model.{encoder}.layer{li}.")}) for li in (1, 2, 3, 4))


def _embeddings(state_dict: dict):
    """(z_dim, num_classes, class_hidden_dim, num_sources)."""
    num_classes, h = (int(x) for x in state_dict["model.class_embedding.weight"].shape)
    return (int(state_dict["model.z_mean.weight"].shape[0]), num_classes, h,
            int(state_dict["model.source_embedding.weight"].shape[0]))


def infer_unimodal_config(state_dict: dict) -> cvae.CVAEConfig:
    """The geometry of a unimodal cVAE from a Lightning state_dict's shapes:
    z_mean [z, z]; the class and source embeddings [n, h]; decoder.linear_out
    [output_size, 64]; the block counts from the encoder's key indices."""
    z_dim, num_classes, h, num_sources = _embeddings(state_dict)
    return cvae.CVAEConfig(
        z_dim=z_dim, output_size=int(state_dict["model.decoder.linear_out.weight"].shape[0]),
        class_hidden_dim=h, num_sources=num_sources, num_classes=num_classes,
        num_blocks=_block_counts(state_dict, "encoder"))


def infer_multimodal_config(state_dict: dict) -> cvae.MultiModalConfig:
    """The geometry of a joint MultiModalCVAE checkpoint (model.py:350-395)."""
    z_dim, num_classes, h, num_sources = _embeddings(state_dict)
    return cvae.MultiModalConfig(
        z_dim=z_dim,
        output_size_wave=int(state_dict["model.decoder_mod1.linear_out.weight"].shape[0]),
        output_size_isi=int(state_dict["model.decoder_mod2.linear_out.weight"].shape[0]),
        class_hidden_dim=h, num_sources=num_sources, num_classes=num_classes,
        num_blocks=_block_counts(state_dict, "encoder_mod1"))


def load_model_from_ckpt(path_or_payload: Union[str, dict], *, multimodal: Optional[bool] = None,
                         fallback_config=None, device="cuda") -> Tuple[torch.nn.Module, tuple]:
    """A ``.ckpt`` (a path or its loaded payload) as ``(model, config)``, the
    model on ``device`` in eval mode.

    The geometry is inferred from the state_dict's shapes; when the keys do
    not allow that, ``fallback_config`` is used, or a ValueError raised if
    none was given. ``multimodal=None`` detects a joint checkpoint from its
    ``model.encoder_mod1.`` keys. The weights load with
    ``checkpoint.load_model_state`` (a class embedding of another class
    count, or none, keeps the model's fresh one, quirk Q10; any other
    mismatch raises, where the JAX loader keeps its initial values).
    """
    payload = (path_or_payload if isinstance(path_or_payload, dict)
               else ckpt_mod.load_lightning_ckpt(path_or_payload))
    sd = payload["state_dict"]
    if multimodal is None:
        multimodal = any(k.startswith("model.encoder_mod1.") for k in sd)
    try:
        cfg = infer_multimodal_config(sd) if multimodal else infer_unimodal_config(sd)
    except (KeyError, ValueError, IndexError) as e:
        if fallback_config is None:
            raise ValueError(
                f"could not infer model geometry from the checkpoint's "
                f"state_dict keys ({e!r}); the checkpoint does not follow "
                f"the reference layout — pass explicit geometry"
            ) from e
        cfg = fallback_config
    init = cvae.multimodal_cvae_init if multimodal else cvae.unimodal_cvae_init
    model = init(cfg, loop.key_generator(0), device=device)
    state = ckpt_mod.model_state_from_ckpt(payload)
    # without its class embedding (the reference's inference heal removes
    # it) the model keeps its fresh one
    drop = () if "class_embedding.weight" in state else ("class_embedding",)
    ckpt_mod.load_model_state(model, state, drop=drop)
    return model.eval(), cfg
