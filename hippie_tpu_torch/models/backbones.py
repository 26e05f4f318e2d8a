"""1-D ResNet18 encoder/decoder backbones as torch modules.

Counterpart of hippie_tpu/models/backbones.py (reference hippie/backbones.py).
Attribute names follow the reference's module tree, so ``state_dict`` keys
are ``encoder.layer1.0.conv1.weight`` and so on, in the JAX package's
flattening order.

Shapes (torch layout ``[B, C, L]``):
  encoder  [B, 1, L]     -> [B, 2*z_dim]   (L=50: 25->25->13->7->4->pool; C 64->512)
  decoder  [B, 2*z_dim]  -> [B, out_len]   (L 1->4->8->16->32->32->64->linear; C 512->64)

Every ``forward`` takes an optional per-sample ``mask`` for padded tail
batches; the BatchNorm running statistics update in place in training mode.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hippie_tpu_torch.nn.functional import adaptive_avg_pool_to_1, leaky_relu, upsample_nearest
from hippie_tpu_torch.nn.modules import MaskedBatchNorm1d, MaskedSequential


class ResizeConv1d(nn.Module):
    """Reference ResizeConv1d (backbones.py:6-16): nearest upsample, conv k3 p1."""

    def __init__(self, in_channels: int, out_channels: int, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv = nn.Conv1d(in_channels, out_channels, 3, stride=1, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x, self.scale_factor))


class BasicBlockEnc(nn.Module):
    """Reference BasicBlockEnc (backbones.py:19-41); planes = in_planes * stride."""

    takes_mask = True

    def __init__(self, in_planes: int, stride: int = 1):
        super().__init__()
        planes = in_planes * stride
        self.conv1 = nn.Conv1d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = MaskedBatchNorm1d(planes)
        self.conv2 = nn.Conv1d(planes, planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm1d(planes)
        if stride != 1:
            self.shortcut = MaskedSequential(
                nn.Conv1d(in_planes, planes, 1, stride=stride, bias=False),
                MaskedBatchNorm1d(planes),
            )

    @property
    def stride(self) -> int:
        """Read from the weight shapes, as hippie_tpu does: C_out // C_in."""
        return self.conv1.weight.shape[0] // self.conv1.weight.shape[1]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x), mask))
        out = self.bn2(self.conv2(out), mask)
        short = x if self.stride == 1 else self.shortcut(x, mask)
        return leaky_relu(out + short)


class BasicBlockDec(nn.Module):
    """Reference BasicBlockDec (backbones.py:44-70); planes = in_planes // stride.

    Registration order conv2, bn2, conv1, bn1, shortcut is the reference's.
    """

    takes_mask = True

    def __init__(self, in_planes: int, stride: int = 1):
        super().__init__()
        planes = in_planes // stride
        self.conv2 = nn.Conv1d(in_planes, in_planes, 3, stride=1, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm1d(in_planes)
        if stride == 1:
            self.conv1 = nn.Conv1d(in_planes, planes, 3, stride=1, padding=1, bias=False)
            self.bn1 = MaskedBatchNorm1d(planes)
        else:
            self.conv1 = ResizeConv1d(in_planes, planes, scale_factor=stride)
            self.bn1 = MaskedBatchNorm1d(planes)
            self.shortcut = MaskedSequential(
                ResizeConv1d(in_planes, planes, scale_factor=stride),
                MaskedBatchNorm1d(planes),
            )

    @property
    def stride(self) -> int:
        """A stride-2 block's conv1 is a ResizeConv1d: C_in // C_out; else 1."""
        if isinstance(self.conv1, ResizeConv1d):
            w = self.conv1.conv.weight
            return w.shape[1] // w.shape[0]
        return 1

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = leaky_relu(self.bn2(self.conv2(x), mask))
        out = self.bn1(self.conv1(out), mask)
        short = x if self.stride == 1 else self.shortcut(x, mask)
        return leaky_relu(out + short)


class ResNet18Enc(nn.Module):
    """Reference ResNet18Enc (backbones.py:73-103): [B, nc, L] -> [B, 2*z_dim]."""

    takes_mask = True

    def __init__(self, z_dim: int = 10, nc: int = 1, num_blocks=(2, 2, 2, 2)):
        super().__init__()
        self.conv1 = nn.Conv1d(nc, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = MaskedBatchNorm1d(64)
        in_planes = 64
        for li, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2)), start=1):
            strides = [stride] + [1] * (num_blocks[li - 1] - 1)
            blocks = []
            for st in strides:
                blocks.append(BasicBlockEnc(in_planes, st))
                in_planes = planes
            self.add_module(f"layer{li}", MaskedSequential(*blocks))
        self.linear = nn.Linear(512, 2 * z_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x), mask))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            out = layer(out, mask)
        return self.linear(adaptive_avg_pool_to_1(out))


class ResNet18Dec(nn.Module):
    """Reference ResNet18Dec (backbones.py:106-141): [B, 2*z_dim] -> [B, output_size].

    ``_make_layer`` walks the strides reversed (backbones.py:123): block 0 of
    each stage is stride 1 at the incoming width, the last block is the
    stride-2 upsampler that halves the channels.
    """

    takes_mask = True

    def __init__(self, z_dim: int = 10, output_size: int = 64, nc: int = 1, num_blocks=(2, 2, 2, 2)):
        super().__init__()
        self.linear = nn.Linear(2 * z_dim, 512)
        in_planes = 512
        for li, stride in ((4, 2), (3, 2), (2, 2), (1, 1)):
            strides = [stride] + [1] * (num_blocks[li - 1] - 1)
            blocks = []
            for st in reversed(strides):
                blocks.append(BasicBlockDec(in_planes, st))
                in_planes = in_planes // st
            self.add_module(f"layer{li}", MaskedSequential(*blocks))
        self.conv1 = ResizeConv1d(64, nc, scale_factor=2)
        self.linear_out = nn.Linear(64, output_size)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.linear(x)  # [B, 512]
        out = upsample_nearest(out[:, :, None], 4)  # [B, 512, 4]: F.interpolate(scale_factor=4)
        for layer in (self.layer4, self.layer3, self.layer2, self.layer1):
            out = layer(out, mask)
        out = self.conv1(out)  # [B, nc, 64]
        return self.linear_out(out.reshape(out.shape[0], -1))
