"""The unimodal and the joint conditional VAE as torch modules.

Counterpart of hippie_tpu/models/cvae.py (reference hippie/model.py:12-72
``hippieUnimodalCVAE`` and model.py:350-432 ``MultiModalCVAE``). The module
trees mirror the reference, so their ``state_dict`` carries the reference's
keys and layouts and takes weights carried over from the JAX package
(train/checkpoint.py:state_dict_from_jax).

Forward contracts: unimodal ``(encoded, mu, logvar, decoded)``, joint
``(encoded, mu, logvar, decoded1, decoded2)``, where ``encoded`` is the
deterministic z-dim encoder_fc (fusion_encoder) output, the embedding used
downstream. ``class_=None`` zeroes the class embedding (model.py:66).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from hippie_tpu_torch.models.backbones import ResNet18Dec, ResNet18Enc
from hippie_tpu_torch.nn import init as tinit
from hippie_tpu_torch.nn.modules import LeakyReLU, MaskedBatchNorm1d, MaskedSequential


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
            nn.Linear(2 * z + 2 * h, 2 * z), MaskedBatchNorm1d(2 * z), LeakyReLU(0.2),
            nn.Linear(2 * z, z), MaskedBatchNorm1d(z), LeakyReLU(0.2),
        )
        self.source_embedding = nn.Embedding(cfg.num_sources, h)
        self.class_embedding = nn.Embedding(cfg.num_classes, h)
        self.z_mean = nn.Linear(z, z)
        self.z_log_var = nn.Linear(z, z)
        self.decoder_fc = _decoder_fc(z, h)
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
        backend: str = "xla",
    ):
        """data: [B, L]; returns (encoded, mu, logvar, decoded).

        With neither ``eps`` nor ``generator`` the reparameterization is
        skipped and the decoder sees ``mu`` (the deterministic eval path,
        SURVEY.md quirk Q8). Train or eval mode is the module's own
        (``model.train()`` / ``model.eval()``). ``backend`` goes to both
        backbones, as in hippie_tpu's ``unimodal_cvae_apply``: ``"pallas"``
        runs their BasicBlocks through the fused block kernels in training.
        """
        source_emb, class_emb = _embed_labels(self, source, class_)
        h = self.encoder(data[:, None, :], mask, backend=backend)
        encoded = self.encoder_fc(torch.cat([h, source_emb, class_emb], dim=1), mask)
        mu = self.z_mean(encoded)
        logvar = self.z_log_var(encoded)
        z = _sample(mu, logvar, eps, generator)
        d = self.decoder_fc(torch.cat([z, source_emb, class_emb], dim=1), mask)
        return encoded, mu, logvar, self.decoder(d, mask, backend=backend)


class MultiModalConfig(NamedTuple):
    """Hyperparameters of the joint model (reference model.py:352)."""

    z_dim: int = 10
    output_size_wave: int = 50
    output_size_isi: int = 100
    class_hidden_dim: int = 5
    num_sources: int = 5
    num_classes: int = 5
    num_blocks: tuple = (2, 2, 2, 2)


class MultiModalCVAE(nn.Module):
    """MultiModalCVAE (model.py:350-432): a ResNet18 encoder per modality, a
    fusion head, one latent, and a decoder_fc and ResNet18 decoder per
    modality. Modules register in the reference's order (both decoder_fc_*
    before both decoder_*), so ``state_dict`` keys follow the JAX tree's."""

    def __init__(self, cfg: MultiModalConfig):
        super().__init__()
        z, h = cfg.z_dim, cfg.class_hidden_dim
        self.encoder_mod1 = ResNet18Enc(z_dim=z, num_blocks=cfg.num_blocks)
        self.encoder_mod2 = ResNet18Enc(z_dim=z, num_blocks=cfg.num_blocks)
        # no BatchNorm or activation after the last Linear (cvae.py:212-217)
        self.fusion_encoder = MaskedSequential(
            nn.Linear(4 * z + 2 * h, 2 * z), MaskedBatchNorm1d(2 * z), LeakyReLU(0.2),
            nn.Linear(2 * z, z),
        )
        self.source_embedding = nn.Embedding(cfg.num_sources, h)
        self.class_embedding = nn.Embedding(cfg.num_classes, h)
        self.z_mean = nn.Linear(z, z)
        self.z_log_var = nn.Linear(z, z)
        self.decoder_fc_mod1 = _decoder_fc(z, h)
        self.decoder_fc_mod2 = _decoder_fc(z, h)
        self.decoder_mod1 = ResNet18Dec(z_dim=z, output_size=cfg.output_size_wave,
                                        num_blocks=cfg.num_blocks)
        self.decoder_mod2 = ResNet18Dec(z_dim=z, output_size=cfg.output_size_isi,
                                        num_blocks=cfg.num_blocks)

    def forward(
        self,
        data1: torch.Tensor,
        data2: torch.Tensor,
        source: torch.Tensor,
        class_: Optional[torch.Tensor] = None,
        *,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mask: Optional[torch.Tensor] = None,
        backend: str = "xla",
    ):
        """data1: [B, 50] waveforms, data2: [B, 100] ISI histograms; returns
        (encoded, mu, logvar, decoded1, decoded2). ``eps``, ``generator``,
        ``mask`` and ``backend`` as UnimodalCVAE.forward's; ``backend`` goes
        to all four backbones, as in hippie_tpu's ``multimodal_cvae_apply``."""
        source_emb, class_emb = _embed_labels(self, source, class_)
        h1 = self.encoder_mod1(data1[:, None, :], mask, backend=backend)
        h2 = self.encoder_mod2(data2[:, None, :], mask, backend=backend)
        encoded = self.fusion_encoder(torch.cat([h1, h2, source_emb, class_emb], dim=1), mask)
        mu = self.z_mean(encoded)
        logvar = self.z_log_var(encoded)
        zc = torch.cat([_sample(mu, logvar, eps, generator), source_emb, class_emb], dim=1)
        decoded = [
            dec(fc(zc, mask), mask, backend=backend)
            for fc, dec in ((self.decoder_fc_mod1, self.decoder_mod1),
                            (self.decoder_fc_mod2, self.decoder_mod2))
        ]
        return encoded, mu, logvar, decoded[0], decoded[1]


def _decoder_fc(z: int, h: int) -> MaskedSequential:
    """Linear(z+2h, 2z) LeakyReLU(0.2) Linear(2z, 2z) BN LeakyReLU(0.2) (model.py:36-42)."""
    return MaskedSequential(
        nn.Linear(z + 2 * h, 2 * z), LeakyReLU(0.2),
        nn.Linear(2 * z, 2 * z), MaskedBatchNorm1d(2 * z), LeakyReLU(0.2),
    )


def _embed_labels(model, source, class_):
    """(source embedding, class embedding); zeros for the class without labels."""
    source_emb = model.source_embedding(source)
    if class_ is None:
        return source_emb, torch.zeros_like(source_emb)
    return source_emb, model.class_embedding(class_)


def _sample(mu, logvar, eps, generator):
    """z: reparameterized with ``eps`` or ``generator``, else ``mu`` (eval path)."""
    if eps is not None or generator is not None:
        return reparameterize(mu, logvar, eps=eps, generator=generator)
    return mu


def unimodal_cvae_init(
    cfg: CVAEConfig, generator: torch.Generator, device="cuda"
) -> UnimodalCVAE:
    """A UnimodalCVAE with torch-default inits drawn from ``generator`` (a CPU
    generator: the weights are drawn on the host, then moved to ``device``,
    so one seed gives the same model on every device)."""
    return _seeded(UnimodalCVAE, cfg, generator, device)


def multimodal_cvae_init(
    cfg: MultiModalConfig, generator: torch.Generator, device="cuda"
) -> MultiModalCVAE:
    """A MultiModalCVAE with torch-default inits drawn from ``generator``, as
    unimodal_cvae_init."""
    return _seeded(MultiModalCVAE, cfg, generator, device)


def _seeded(cls, cfg, generator: torch.Generator, device):
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to_empty(device="cpu")
    tinit.reset_(model, generator)
    return model.to(device)


def param_count(model: nn.Module) -> int:
    """Number of trainable parameters (BatchNorm buffers excluded)."""
    return sum(p.numel() for p in model.parameters())
