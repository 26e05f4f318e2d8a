"""The arithmetic of the plain reference's convolutions and linear layers.

``Numerics("float32")`` is the reference itself: float32 operands and
float32 accumulation, with TF32 off (``full_float32``). ``"tf32"`` and
``"fp8_blocks"`` are the controls, the reference computed one precision
below what a configuration states:

- ``"tf32"``: every convolution's and linear layer's operands rounded to
  TF32 (10 mantissa bits, round to nearest even), accumulated in float32:
  the control of a path that states full float32 (the embedding engine).
- ``"fp8_blocks"``: the operands of the BasicBlocks' convolutions rounded to
  float8 e4m3 with a per-tensor scale (amax to 448), and their backward's
  output gradient to float8 e5m2 with its own scale, as an fp8 training
  recipe does; everything else float32: the control of a path that states
  bf16 block operands (the training step's fused blocks).

``"bf16_blocks"`` is the training step's stated precision in the
reference's hands: the BasicBlocks' convolution operands, and their
backward's output gradient, rounded to bfloat16, accumulated in float32.
It is read beside the control, to show what that precision alone moves.

Plain torch only: nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("float32", "tf32", "fp8_blocks", "bf16_blocks")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """x through float8 with a per-tensor scale that maps its amax to the
    format's largest value, back in float32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 through bfloat16 (round to nearest even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _LowConv(torch.autograd.Function):
    """A convolution whose operands, and whose backward's output gradient,
    are rounded to a lower precision (``fp8``: e4m3 and e5m2 with per-tensor
    scales; else bfloat16); float32 accumulation."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, fp8):
        rnd = round_fp8 if fp8 else round_bf16
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, fp8)
        return F.conv1d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        stride, padding, fp8 = ctx.conf
        gq = round_fp8(gy, torch.float8_e5m2, E5M2_MAX) if fp8 else round_bf16(gy)
        gx = torch.nn.grad.conv1d_input(xq.shape, wq, gq, stride, padding)
        gw = torch.nn.grad.conv1d_weight(xq, wq.shape, gq, stride, padding)
        return gx, gw, None, None, None


class Numerics:
    """``conv`` and ``linear`` in one of ``MODES``."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}: one of {MODES}")
        self.mode = mode

    def conv(self, x, w, b, stride: int, padding: int, block: bool = False):
        if self.mode == "tf32":
            x, w = round_tf32(x), round_tf32(w)
        if self.mode in ("fp8_blocks", "bf16_blocks") and block:
            out = _LowConv.apply(x, w, stride, padding, self.mode == "fp8_blocks")
            return out if b is None else out + b.view(1, -1, 1)
        return F.conv1d(x, w, b, stride, padding)

    def linear(self, x, w, b):
        if self.mode == "tf32":
            x, w = round_tf32(x), round_tf32(w)
        return F.linear(x, w, b)
