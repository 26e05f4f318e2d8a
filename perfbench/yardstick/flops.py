"""Operations counted from the models' shapes: the yardstick of ``step_mfu``
and ``embed_mfu``.

A convolution costs ``2 * B * L_out * C_out * C_in * k`` FLOPs, a linear
layer ``2 * B * in * out``; BatchNorm, activations, upsampling, pooling,
the embeddings, the loss and the optimizer are not counted. A training step
is 3x its forward (the backward computes one product for the input's
gradient and one for the weight's, each as large as the forward's). The
embedding is the encoder path alone (the encoders, the fusion or fc head
and nothing of the decoders), since that is all an embedding needs.

The counts walk the published architecture (``perfbench/reference/cvae.py``'s
shapes); they read nothing of the program, so a later change to the
program cannot move them.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.reference.cvae import DEC_STAGES, ENC_PLANES, ENC_STRIDES, Arch, _dec_block_strides

Layer = Tuple[str, str, int]  # (module key, "conv" or "linear", FLOPs per row)


def _conv_out(length: int, k: int, stride: int, pad: int) -> int:
    return (length + 2 * pad - k) // stride + 1


def encoder_layers(pre: str, arch: Arch, length: int) -> List[Layer]:
    out = []
    length = _conv_out(length, 3, 2, 1)
    out.append((pre + "conv1", "conv", 2 * length * 64 * 1 * 3))
    c = 64
    for si, (planes, stride) in enumerate(zip(ENC_PLANES, ENC_STRIDES), start=1):
        for bi in range(arch.num_blocks[si - 1]):
            s = stride if bi == 0 else 1
            b = f"{pre}layer{si}.{bi}."
            lo = _conv_out(length, 3, s, 1)
            out.append((b + "conv1", "conv", 2 * lo * planes * c * 3))
            out.append((b + "conv2", "conv", 2 * lo * planes * planes * 3))
            if s != 1:
                out.append((b + "shortcut.0", "conv", 2 * lo * planes * c))
            c, length = planes, lo
    out.append((pre + "linear", "linear", 2 * 512 * 2 * arch.z_dim))
    return out


def decoder_layers(pre: str, arch: Arch, out_len: int) -> List[Layer]:
    out = [(pre + "linear", "linear", 2 * 2 * arch.z_dim * 512)]
    c, length = 512, 4
    for stage, stride in DEC_STAGES:
        for bi, s in enumerate(_dec_block_strides(arch, stage, stride)):
            b = f"{pre}layer{stage}.{bi}."
            planes = c // s
            out.append((b + "conv2", "conv", 2 * length * c * c * 3))
            out.append((b + "conv1", "conv", 2 * length * s * planes * c * 3))
            if s != 1:
                out.append((b + "shortcut.0", "conv", 2 * length * s * planes * c * 3))
            c, length = planes, length * s
    out.append((pre + "conv1", "conv", 2 * 2 * length * 1 * 64 * 3))
    out.append((pre + "linear_out", "linear", 2 * 64 * out_len))
    return out


def _lin(key: str, n_in: int, n_out: int) -> Layer:
    return (key, "linear", 2 * n_in * n_out)


def encode_layers(arch: Arch) -> List[Layer]:
    """The encoder path: what an embedding needs."""
    z, h = arch.z_dim, arch.class_hidden_dim
    if not arch.multimodal:
        return encoder_layers("encoder.", arch, arch.wave_len) + [
            _lin("encoder_fc.0", 2 * z + 2 * h, 2 * z), _lin("encoder_fc.3", 2 * z, z)]
    return (encoder_layers("encoder_mod1.", arch, arch.wave_len) + encoder_layers("encoder_mod2.", arch, arch.isi_len)
            + [_lin("fusion_encoder.0", 4 * z + 2 * h, 2 * z), _lin("fusion_encoder.3", 2 * z, z)])


def forward_layers(arch: Arch) -> List[Layer]:
    """The training forward: the encoder path, the latent heads and the decoder(s)."""
    z, h = arch.z_dim, arch.class_hidden_dim
    heads = [_lin("z_mean", z, z), _lin("z_log_var", z, z)]
    if not arch.multimodal:
        return (encode_layers(arch) + heads + [_lin("decoder_fc.0", z + 2 * h, 2 * z), _lin("decoder_fc.2", 2 * z, 2 * z)]
                + decoder_layers("decoder.", arch, arch.wave_len))
    fcs = []
    for m in ("mod1", "mod2"):
        fcs += [_lin(f"decoder_fc_{m}.0", z + 2 * h, 2 * z), _lin(f"decoder_fc_{m}.2", 2 * z, 2 * z)]
    return (encode_layers(arch) + heads + fcs + decoder_layers("decoder_mod1.", arch, arch.wave_len)
            + decoder_layers("decoder_mod2.", arch, arch.isi_len))


def forward_flops(arch: Arch, batch: int) -> int:
    return batch * sum(f for _, _, f in forward_layers(arch))


def step_flops(arch: Arch, batch: int) -> int:
    """One training step at ``batch`` rows: 3x the forward."""
    return 3 * forward_flops(arch, batch)


def embed_flops(arch: Arch, rows: int) -> int:
    """The embedding of ``rows`` rows: the encoder path's forward."""
    return rows * sum(f for _, _, f in encode_layers(arch))
