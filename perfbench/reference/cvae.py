"""The plain reference of the HIPPIE cVAEs: the unimodal waveform model and
the joint (waveform + ISI) model, as functions of a state dict.

Written from the published model (aghatpande/HIPPIE, ``model.py``:
``hippieUnimodalCVAE`` and ``MultiModalCVAE``; ``backbones.py``:
``ResNet18Enc``, ``ResNet18Dec``, ``BasicBlockEnc``, ``BasicBlockDec``,
``ResizeConv1d``), in float32 torch operations, with no kernel, mask,
graph or batching of the program's. The state dict's keys and layouts are
the published model's (``encoder.layer1.0.conv1.weight``, ...), so one set
of weights made by the benchmark loads into the program and serves here.

Departures, each without effect on the compared numbers:
- a batch holds only real rows; the program's padded rows, which its masks
  keep out of every statistic and loss, are not computed here;
- LeakyReLU is ``torch.where(x >= 0, x, slope * x)``, whose gradient at
  exactly 0 is 1 (the reference's ``nn.LeakyReLU`` gives the slope there):
  a set of measure zero.

Shapes: the encoder maps ``[B, 1, L]`` to ``[B, 2z]`` (stem stride 2, then
four stages of 64/128/256/512 channels, stages 2-4 stride 2, a mean over
the length and a linear); the decoder maps ``[B, 2z]`` to ``[B, out]``
(a linear to 512, nearest upsampling x4, four stages from 512 down to 64
channels, each ending in a stride-2 ResizeConv block but the last, a
ResizeConv to one channel at length 64, and a linear to ``out``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import Numerics

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
ENC_PLANES = (64, 128, 256, 512)
ENC_STRIDES = (1, 2, 2, 2)
DEC_STAGES = ((4, 2), (3, 2), (2, 2), (1, 1))  # (stage, stride), in the decoder's order


class Arch(NamedTuple):
    """A configuration's sizes (``perfbench/configs/<name>.json``)."""

    multimodal: bool
    z_dim: int
    class_hidden_dim: int
    num_sources: int
    num_classes: int
    num_blocks: Tuple[int, ...]
    wave_len: int
    isi_len: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        m = cfg["model"]
        return cls(multimodal=m["kind"] == "multimodal", z_dim=m["z_dim"], class_hidden_dim=m["class_hidden_dim"],
                   num_sources=m["num_sources"], num_classes=m["num_classes"], num_blocks=tuple(m["num_blocks"]),
                   wave_len=m["wave_len"], isi_len=m.get("isi_len", 0))


class Leaf(NamedTuple):
    """One state-dict entry: its shape, how it is made (``uniform`` with its
    bound, ``normal``, ``ones``, ``zeros``, ``count``) and whether it is
    trained (BatchNorm's running statistics are not)."""

    shape: Tuple[int, ...]
    init: str
    bound: float
    trained: bool


def _conv(spec, key, c_in, c_out, k, bias):
    bound = (c_in * k) ** -0.5
    spec[key + ".weight"] = Leaf((c_out, c_in, k), "uniform", bound, True)
    if bias:
        spec[key + ".bias"] = Leaf((c_out,), "uniform", bound, True)


def _linear(spec, key, n_in, n_out):
    bound = n_in ** -0.5
    spec[key + ".weight"] = Leaf((n_out, n_in), "uniform", bound, True)
    spec[key + ".bias"] = Leaf((n_out,), "uniform", bound, True)


def _bn(spec, key, c):
    spec[key + ".weight"] = Leaf((c,), "ones", 0.0, True)
    spec[key + ".bias"] = Leaf((c,), "zeros", 0.0, True)
    spec[key + ".running_mean"] = Leaf((c,), "zeros", 0.0, False)
    spec[key + ".running_var"] = Leaf((c,), "ones", 0.0, False)
    spec[key + ".num_batches_tracked"] = Leaf((), "count", 0.0, False)


def _enc_spec(spec, pre, arch):
    _conv(spec, pre + "conv1", 1, 64, 3, False)
    _bn(spec, pre + "bn1", 64)
    c_in = 64
    for si, (planes, stride) in enumerate(zip(ENC_PLANES, ENC_STRIDES), start=1):
        for bi in range(arch.num_blocks[si - 1]):
            s = stride if bi == 0 else 1
            b = f"{pre}layer{si}.{bi}."
            _conv(spec, b + "conv1", c_in, planes, 3, False)
            _bn(spec, b + "bn1", planes)
            _conv(spec, b + "conv2", planes, planes, 3, False)
            _bn(spec, b + "bn2", planes)
            if s != 1:
                _conv(spec, b + "shortcut.0", c_in, planes, 1, False)
                _bn(spec, b + "shortcut.1", planes)
            c_in = planes
    _linear(spec, pre + "linear", 512, 2 * arch.z_dim)


def _dec_block_strides(arch, stage, stride):
    return list(reversed([stride] + [1] * (arch.num_blocks[stage - 1] - 1)))


def _dec_spec(spec, pre, arch, out_len):
    _linear(spec, pre + "linear", 2 * arch.z_dim, 512)
    c = 512
    for stage, stride in DEC_STAGES:
        for bi, s in enumerate(_dec_block_strides(arch, stage, stride)):
            b = f"{pre}layer{stage}.{bi}."
            planes = c // s
            _conv(spec, b + "conv2", c, c, 3, False)
            _bn(spec, b + "bn2", c)
            if s == 1:
                _conv(spec, b + "conv1", c, planes, 3, False)
            else:
                _conv(spec, b + "conv1.conv", c, planes, 3, True)
            _bn(spec, b + "bn1", planes)
            if s != 1:
                _conv(spec, b + "shortcut.0.conv", c, planes, 3, True)
                _bn(spec, b + "shortcut.1", planes)
            c = planes
    _conv(spec, pre + "conv1.conv", 64, 1, 3, True)
    _linear(spec, pre + "linear_out", 64, out_len)


def _decoder_fc_spec(spec, pre, z, h):
    _linear(spec, pre + ".0", z + 2 * h, 2 * z)
    _linear(spec, pre + ".2", 2 * z, 2 * z)
    _bn(spec, pre + ".3", 2 * z)


def param_spec(arch: Arch) -> Dict[str, Leaf]:
    """Every state-dict entry of the model, in the published module order."""
    z, h = arch.z_dim, arch.class_hidden_dim
    spec: Dict[str, Leaf] = {}
    emb = lambda key, n: spec.__setitem__(key + ".weight", Leaf((n, h), "normal", 0.0, True))  # noqa: E731
    if not arch.multimodal:
        _enc_spec(spec, "encoder.", arch)
        _linear(spec, "encoder_fc.0", 2 * z + 2 * h, 2 * z)
        _bn(spec, "encoder_fc.1", 2 * z)
        _linear(spec, "encoder_fc.3", 2 * z, z)
        _bn(spec, "encoder_fc.4", z)
        emb("source_embedding", arch.num_sources)
        emb("class_embedding", arch.num_classes)
        _linear(spec, "z_mean", z, z)
        _linear(spec, "z_log_var", z, z)
        _decoder_fc_spec(spec, "decoder_fc", z, h)
        _dec_spec(spec, "decoder.", arch, arch.wave_len)
        return spec
    _enc_spec(spec, "encoder_mod1.", arch)
    _enc_spec(spec, "encoder_mod2.", arch)
    _linear(spec, "fusion_encoder.0", 4 * z + 2 * h, 2 * z)
    _bn(spec, "fusion_encoder.1", 2 * z)
    _linear(spec, "fusion_encoder.3", 2 * z, z)
    emb("source_embedding", arch.num_sources)
    emb("class_embedding", arch.num_classes)
    _linear(spec, "z_mean", z, z)
    _linear(spec, "z_log_var", z, z)
    _decoder_fc_spec(spec, "decoder_fc_mod1", z, h)
    _decoder_fc_spec(spec, "decoder_fc_mod2", z, h)
    _dec_spec(spec, "decoder_mod1.", arch, arch.wave_len)
    _dec_spec(spec, "decoder_mod2.", arch, arch.isi_len)
    return spec


def trained_keys(arch: Arch) -> List[str]:
    return [k for k, leaf in param_spec(arch).items() if leaf.trained]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def leaky(x, slope):
    return torch.where(x >= 0, x, x * slope)


def bn(P, key, x, training: bool):
    """nn.BatchNorm1d: batch statistics (biased variance) in training, which
    also move the running statistics in ``P`` (momentum 0.1, the unbiased
    variance), and the running ones in eval."""
    if training:
        return F.batch_norm(x, P[key + ".running_mean"], P[key + ".running_var"], P[key + ".weight"],
                            P[key + ".bias"], True, BN_MOMENTUM, BN_EPS)
    return F.batch_norm(x, P[key + ".running_mean"], P[key + ".running_var"], P[key + ".weight"],
                        P[key + ".bias"], False, 0.0, BN_EPS)


def linear(P, key, x, nx: Numerics):
    return nx.linear(x, P[key + ".weight"], P[key + ".bias"])


def resize_conv(P, key, x, scale, nx: Numerics, block: bool):
    """ResizeConv1d: nearest upsampling by ``scale``, then a k3 p1 convolution with bias."""
    x = F.interpolate(x, scale_factor=scale, mode="nearest")
    return nx.conv(x, P[key + ".conv.weight"], P[key + ".conv.bias"], 1, 1, block=block)


def encoder(P, pre, x, arch: Arch, nx: Numerics, training: bool):
    """ResNet18Enc: ``[B, 1, L]`` -> ``[B, 2z]``."""
    out = leaky(bn(P, pre + "bn1", nx.conv(x, P[pre + "conv1.weight"], None, 2, 1), training), 0.01)
    for si, stride in enumerate(ENC_STRIDES, start=1):
        for bi in range(arch.num_blocks[si - 1]):
            s = stride if bi == 0 else 1
            b = f"{pre}layer{si}.{bi}."
            y = leaky(bn(P, b + "bn1", nx.conv(out, P[b + "conv1.weight"], None, s, 1, block=True), training), 0.01)
            y = bn(P, b + "bn2", nx.conv(y, P[b + "conv2.weight"], None, 1, 1, block=True), training)
            if s != 1:
                short = bn(P, b + "shortcut.1", nx.conv(out, P[b + "shortcut.0.weight"], None, s, 0, block=True),
                           training)
            else:
                short = out
            out = leaky(y + short, 0.01)
    return linear(P, pre + "linear", F.adaptive_avg_pool1d(out, 1)[:, :, 0], nx)


def decoder(P, pre, h, arch: Arch, nx: Numerics, training: bool):
    """ResNet18Dec: ``[B, 2z]`` -> ``[B, out]``."""
    out = F.interpolate(linear(P, pre + "linear", h, nx)[:, :, None], scale_factor=4, mode="nearest")
    for stage, stride in DEC_STAGES:
        for bi, s in enumerate(_dec_block_strides(arch, stage, stride)):
            b = f"{pre}layer{stage}.{bi}."
            y = leaky(bn(P, b + "bn2", nx.conv(out, P[b + "conv2.weight"], None, 1, 1, block=True), training), 0.01)
            if s == 1:
                y = nx.conv(y, P[b + "conv1.weight"], None, 1, 1, block=True)
                short = out
            else:
                y = resize_conv(P, b + "conv1", y, s, nx, block=True)
                short = bn(P, b + "shortcut.1", resize_conv(P, b + "shortcut.0", out, s, nx, block=True), training)
            out = leaky(bn(P, b + "bn1", y, training) + short, 0.01)
    out = resize_conv(P, pre + "conv1", out, 2, nx, block=False)  # [B, 1, 64]
    return linear(P, pre + "linear_out", out.reshape(out.shape[0], -1), nx)


def _labels(P, source):
    s = P["source_embedding.weight"][source]
    return s, torch.zeros_like(s)  # stage 1 trains without class labels: a zero class embedding


def _decoder_fc(P, pre, x, nx, training):
    x = leaky(linear(P, pre + ".0", x, nx), 0.2)
    return leaky(bn(P, pre + ".3", linear(P, pre + ".2", x, nx), training), 0.2)


def encode(P, arch: Arch, inputs, source, nx: Numerics, training: bool):
    """The encoder path: ``(encoded, mu, logvar)``; ``inputs`` is
    ``(wave,)`` or ``(wave, isi)``, each ``[B, L]``."""
    s, c = _labels(P, source)
    if not arch.multimodal:
        h = encoder(P, "encoder.", inputs[0][:, None, :], arch, nx, training)
        x = torch.cat([h, s, c], dim=1)
        x = leaky(bn(P, "encoder_fc.1", linear(P, "encoder_fc.0", x, nx), training), 0.2)
        enc = leaky(bn(P, "encoder_fc.4", linear(P, "encoder_fc.3", x, nx), training), 0.2)
    else:
        h1 = encoder(P, "encoder_mod1.", inputs[0][:, None, :], arch, nx, training)
        h2 = encoder(P, "encoder_mod2.", inputs[1][:, None, :], arch, nx, training)
        x = torch.cat([h1, h2, s, c], dim=1)
        x = leaky(bn(P, "fusion_encoder.1", linear(P, "fusion_encoder.0", x, nx), training), 0.2)
        enc = linear(P, "fusion_encoder.3", x, nx)
    return enc, linear(P, "z_mean", enc, nx), linear(P, "z_log_var", enc, nx)


def forward(P, arch: Arch, inputs, source, eps, nx: Numerics, training: bool = True):
    """The training forward: ``(encoded, mu, logvar, decoded...)`` with
    ``z = mu + eps * exp(logvar / 2)``."""
    enc, mu, logvar = encode(P, arch, inputs, source, nx, training)
    s, c = _labels(P, source)
    zc = torch.cat([mu + eps * torch.exp(0.5 * logvar), s, c], dim=1)
    if not arch.multimodal:
        return enc, mu, logvar, decoder(P, "decoder.", _decoder_fc(P, "decoder_fc", zc, nx, training), arch, nx,
                                        training)
    d1 = decoder(P, "decoder_mod1.", _decoder_fc(P, "decoder_fc_mod1", zc, nx, training), arch, nx, training)
    d2 = decoder(P, "decoder_mod2.", _decoder_fc(P, "decoder_fc_mod2", zc, nx, training), arch, nx, training)
    return enc, mu, logvar, d1, d2


def loss(inputs, outs, beta: float, weights=(1.0, 1.0)):
    """model.py's loss: the mean squared error of each modality (over every
    element), weighted, plus beta times the batch mean of the KL divergence."""
    _, mu, logvar, *decs = outs
    kl = (-0.5 * torch.sum(1.0 + logvar - mu.square() - torch.exp(logvar), dim=1)).mean()
    mse = sum(w * F.mse_loss(d, x) for w, d, x in zip(weights, decs, inputs))
    return mse + beta * kl


def zscore_rows(e):
    """Each row standardised with its unbiased standard deviation (scripts/utils.py)."""
    return (e - e.mean(dim=1, keepdim=True)) / e.std(dim=1, keepdim=True)


@torch.no_grad()
def embed(P, arch: Arch, inputs, source, nx: Numerics):
    """The embedding: the eval-mode encoder path's ``encoded``, z-scored per row."""
    return zscore_rows(encode(P, arch, inputs, source, nx, training=False)[0])
