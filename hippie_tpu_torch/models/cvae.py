"""The unimodal conditional VAE as a torch module.

Counterpart of the unimodal half of hippie_tpu/models/cvae.py (reference
hippie/model.py:12-72 ``hippieUnimodalCVAE``). The module tree mirrors the
reference, so its ``state_dict`` carries the reference's keys and layouts and
takes weights carried over from the JAX package
(train/checkpoint.py:state_dict_from_jax).

Forward contract: ``(encoded, mu, logvar, decoded)``, where ``encoded`` is the
deterministic z-dim encoder_fc output, the embedding used downstream.
``class_=None`` zeroes the class embedding (model.py:66).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from hippie_tpu_torch.models.backbones import ResNet18Dec, ResNet18Enc
from hippie_tpu_torch.nn import init as tinit
from hippie_tpu_torch.nn.modules import MaskedBatchNorm1d, MaskedSequential


class CVAEConfig(NamedTuple):
    """Hyperparameters of a unimodal cVAE (reference model.py:13).

    ``num_blocks`` selects the backbone depth per stage; (2, 2, 2, 2) is the
    reference's ResNet18.
    """

    z_dim: int = 10
    output_size: int = 50
    class_hidden_dim: int = 5
    num_sources: int = 5
    num_classes: int = 5
    num_blocks: tuple = (2, 2, 2, 2)


def reparameterize(mu, logvar, *, eps=None, generator=None):
    """z = mu + eps * exp(0.5 * logvar), eps ~ N(0, 1) (model.py:46-49).

    ``eps`` injects the noise (parity tests pass the noise the JAX side saw);
    otherwise it is drawn from ``generator``, which lives on mu's device.
    """
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + eps * torch.exp(0.5 * logvar)


class UnimodalCVAE(nn.Module):
    """hippieUnimodalCVAE (model.py:12-72)."""

    def __init__(self, cfg: CVAEConfig):
        super().__init__()
        z, h = cfg.z_dim, cfg.class_hidden_dim
        self.encoder = ResNet18Enc(z_dim=z, num_blocks=cfg.num_blocks)
        self.encoder_fc = MaskedSequential(
            nn.Linear(2 * z + 2 * h, 2 * z), MaskedBatchNorm1d(2 * z), nn.LeakyReLU(0.2),
            nn.Linear(2 * z, z), MaskedBatchNorm1d(z), nn.LeakyReLU(0.2),
        )
        self.source_embedding = nn.Embedding(cfg.num_sources, h)
        self.class_embedding = nn.Embedding(cfg.num_classes, h)
        self.z_mean = nn.Linear(z, z)
        self.z_log_var = nn.Linear(z, z)
        self.decoder_fc = MaskedSequential(
            nn.Linear(z + 2 * h, 2 * z), nn.LeakyReLU(0.2),
            nn.Linear(2 * z, 2 * z), MaskedBatchNorm1d(2 * z), nn.LeakyReLU(0.2),
        )
        self.decoder = ResNet18Dec(z_dim=z, output_size=cfg.output_size, num_blocks=cfg.num_blocks)

    def forward(
        self,
        data: torch.Tensor,
        source: torch.Tensor,
        class_: Optional[torch.Tensor] = None,
        *,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
    ):
        """data: [B, L]; returns (encoded, mu, logvar, decoded).

        With neither ``eps`` nor ``generator`` the reparameterization is
        skipped and the decoder sees ``mu`` (the deterministic eval path,
        SURVEY.md quirk Q8). Train or eval mode is the module's own
        (``model.train()`` / ``model.eval()``).
        """
        source_emb = self.source_embedding(source)
        if class_ is not None:
            class_emb = self.class_embedding(class_)
        else:
            class_emb = torch.zeros_like(source_emb)
        h = self.encoder(data[:, None, :], mask)
        encoded = self.encoder_fc(torch.cat([h, source_emb, class_emb], dim=1), mask)
        mu = self.z_mean(encoded)
        logvar = self.z_log_var(encoded)
        if eps is not None or generator is not None:
            z = reparameterize(mu, logvar, eps=eps, generator=generator)
        else:
            z = mu
        d = self.decoder_fc(torch.cat([z, source_emb, class_emb], dim=1), mask)
        return encoded, mu, logvar, self.decoder(d, mask)


def unimodal_cvae_init(
    cfg: CVAEConfig, generator: torch.Generator, device="cuda"
) -> UnimodalCVAE:
    """A UnimodalCVAE with torch-default inits drawn from ``generator`` (a CPU
    generator: the weights are drawn on the host, then moved to ``device``,
    so one seed gives the same model on every device)."""
    with torch.device("meta"):
        model = UnimodalCVAE(cfg)
    model = model.to_empty(device="cpu")
    tinit.reset_(model, generator)
    return model.to(device)


def param_count(model: nn.Module) -> int:
    """Number of trainable parameters (BatchNorm buffers excluded)."""
    return sum(p.numel() for p in model.parameters())
