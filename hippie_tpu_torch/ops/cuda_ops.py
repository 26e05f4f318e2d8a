"""Hand-written CUDA kernel for the cVAE loss: fused masked sums and gradients.

Counterpart of hippie_tpu/ops/pallas_ops.py (``fused_vae_sums``,
``vae_loss_pallas``); the kernel is csrc/vae_sums.cu, whose header note says
what bounds it and how it is laid out. The step factories keep the JAX
package's name for this path, ``loss_backend="pallas"``.

``FusedVaeSums`` launches the kernel for CUDA tensors and raises on anything
it does not take. For CPU tensors it runs the plain versions below,
``vae_sums_plain`` and ``vae_sums_bwd_plain``, which repeat the kernel's
arithmetic in eager torch ops: the CPU tests use them, and chip_smoke.py holds
the kernel against them on the card. A CUDA tensor never takes the plain
path.

``launches`` counts kernel launches per wrapper: ``vae_sums_fwd`` one per
forward call (two CUDA launches: partial sums, final sum), ``vae_sums_bwd`` one
per backward call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hippie_tpu_torch.ops import _build

launches = {"vae_sums_fwd": 0, "vae_sums_bwd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (eager torch ops, the kernel's arithmetic in the same order)
# ---------------------------------------------------------------------------


def vae_sums_plain(data, dec, mu, logvar, mask_col) -> torch.Tensor:
    """[sum(m * d^2), sum(m * kl)] with the where() guards before the square
    and the exp (hippie_tpu pallas_ops._fwd_kernel)."""
    keep = mask_col > 0
    d = torch.where(keep, dec - data, 0.0)
    u = torch.where(keep, mu, 0.0)
    lv = torch.where(keep, logvar, 0.0)
    kl = -0.5 * (1.0 + lv - u * u - torch.exp(lv))
    return torch.stack([(d * d * mask_col).sum(), (kl * mask_col).sum()])


def vae_sums_bwd_plain(data, dec, mu, logvar, mask_col, g):
    """(ddata, ddec, dmu, dlogvar) for g = [g_mse, g_kl]
    (hippie_tpu pallas_ops._bwd_kernel)."""
    g_mse, g_kl = g[0], g[1]
    keep = mask_col > 0
    d = torch.where(keep, dec - data, 0.0) * mask_col
    ddec = 2.0 * g_mse * d
    ddata = -2.0 * g_mse * d
    dmu = g_kl * torch.where(keep, mu, 0.0) * mask_col
    lv = torch.where(keep, logvar, 0.0)
    dlogvar = g_kl * -0.5 * (1.0 - torch.exp(lv)) * mask_col
    return ddata, ddec, dmu, dlogvar


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("vae_sums")
        lib.vae_sums_fwd_partials.argtypes = [_I]
        lib.vae_sums_fwd_partials.restype = _I
        lib.vae_sums_fwd.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 3
        lib.vae_sums_fwd.restype = _I
        lib.vae_sums_bwd.argtypes = [_P] * 6 + [_I] * 3 + [_P] * 5
        lib.vae_sums_bwd.restype = _I
        _lib = lib
    return _lib


def _check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _check_inputs(data, dec, mu, logvar, mask_col):
    B, L = data.shape
    Z = mu.shape[1]
    want = {"data": (B, L), "dec": (B, L), "mu": (B, Z), "logvar": (B, Z), "mask_col": (B, 1)}
    for (name, shape), t in zip(want.items(), (data, dec, mu, logvar, mask_col)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if B == 0:
        raise ValueError("empty batch")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {data.device}")


def vae_sums_fwd_cuda(data, dec, mu, logvar, mask_col) -> torch.Tensor:
    """Launch the forward kernel: returns [sse, kl] on the device."""
    lib = _kernels()
    B, L = data.shape
    Z = mu.shape[1]
    with torch.cuda.device(data.device):
        partial = torch.empty((lib.vae_sums_fwd_partials(B), 2), dtype=torch.float32,
                              device=data.device)
        out = torch.empty(2, dtype=torch.float32, device=data.device)
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.vae_sums_fwd(
            data.data_ptr(), dec.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            mask_col.data_ptr(), B, L, Z, partial.data_ptr(), out.data_ptr(), stream,
        )
    _check_launch(err, "vae_sums_fwd")
    launches["vae_sums_fwd"] += 1
    return out


def vae_sums_bwd_cuda(data, dec, mu, logvar, mask_col, g):
    """Launch the backward kernel; ``g`` = [g_mse, g_kl] stays on the device."""
    if g.shape != (2,) or g.dtype != torch.float32 or g.device != data.device:
        raise ValueError(f"g must be float32 [2] on {data.device}, got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}")
    lib = _kernels()
    B, L = data.shape
    Z = mu.shape[1]
    g = g.contiguous()
    grads = [torch.empty_like(t) for t in (data, dec, mu, logvar)]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.vae_sums_bwd(
            data.data_ptr(), dec.data_ptr(), mu.data_ptr(), logvar.data_ptr(),
            mask_col.data_ptr(), g.data_ptr(), B, L, Z, *(t.data_ptr() for t in grads), stream,
        )
    _check_launch(err, "vae_sums_bwd")
    launches["vae_sums_bwd"] += 1
    return tuple(grads)


class FusedVaeSums(torch.autograd.Function):
    """[sum(m * (dec - data)^2), sum(m * kl)] with a fused backward.

    CUDA tensors launch csrc/vae_sums.cu; CPU tensors take the plain versions.
    """

    @staticmethod
    def forward(ctx, data, dec, mu, logvar, mask_col):
        _check_inputs(data, dec, mu, logvar, mask_col)
        ctx.save_for_backward(data, dec, mu, logvar, mask_col)
        if data.device.type == "cpu":
            return vae_sums_plain(data, dec, mu, logvar, mask_col)
        return vae_sums_fwd_cuda(data, dec, mu, logvar, mask_col)

    @staticmethod
    def backward(ctx, g):
        data, dec, mu, logvar, mask_col = ctx.saved_tensors
        if data.device.type == "cpu":
            grads = vae_sums_bwd_plain(data, dec, mu, logvar, mask_col, g)
        else:
            grads = vae_sums_bwd_cuda(data, dec, mu, logvar, mask_col, g)
        return (*grads, None)


def fused_vae_sums(data, dec, mu, logvar, mask_col) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum(mask * (dec - data)^2), sum(mask * kl_elements)); mask_col: [B, 1]."""
    sse, kl = FusedVaeSums.apply(data, dec, mu, logvar, mask_col).unbind(0)
    return sse, kl


def vae_loss_pallas(
    data: torch.Tensor,
    dec: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    *,
    beta: float = 1.0,
    mask: Optional[torch.Tensor] = None,
):
    """Drop-in for losses.vae_loss on the fused kernel: (total, (mse, kl))."""
    B = data.shape[0]
    if mask is None:
        mask_col = torch.ones((B, 1), dtype=data.dtype, device=data.device)
        n = float(B)
    else:
        mask_col = mask.to(data.dtype).reshape(B, 1).contiguous()
        n = mask_col.sum()
    sse, kl_sum = fused_vae_sums(data.contiguous(), dec.contiguous(), mu.contiguous(),
                                 logvar.contiguous(), mask_col)
    mse = sse / (n * data.shape[1])
    kl = kl_sum / n
    return mse + beta * kl, (mse, kl)
