"""Hand-written CUDA kernels for the cVAE losses: fused masked sums and gradients.

Counterpart of hippie_tpu/ops/pallas_ops.py (``fused_vae_sums``,
``vae_loss_pallas``, ``fused_masked_sse``, ``multimodal_vae_loss_pallas``);
the kernels are csrc/vae_sums.cu, whose header note says what bounds them and
how they are laid out. The step factories keep the JAX package's name for
this path, ``loss_backend="pallas"``.

``FusedVaeSums`` and ``FusedMaskedSse`` launch the kernels for CUDA tensors
and raise on anything they do not take. For CPU tensors they run the plain
versions below (``vae_sums_plain``, ``vae_sums_bwd_plain``,
``masked_sse_plain``), which repeat the kernels' arithmetic in eager torch
ops: the CPU tests use them, and chip_smoke.py holds the kernels against them
on the card. A CUDA tensor never takes the plain path. The masked SSE's
backward is elementwise torch ops on either device (``masked_sse_bwd``), as
``_sse_bwd`` is plain JAX.

``launches`` counts kernel launches per wrapper, one per call, and each call
is one CUDA launch: ``vae_sums_fwd`` and ``masked_sse_fwd`` (whose last block
sums the partials; each keeps a workspace per stream) and ``vae_sums_bwd``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from hippie_tpu_torch.ops import _build

launches = {"vae_sums_fwd": 0, "vae_sums_bwd": 0, "masked_sse_fwd": 0}


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


def masked_sse_plain(data, dec, mask_col) -> torch.Tensor:
    """sum(m * d^2) with d = where(m > 0, dec - data, 0) (hippie_tpu
    pallas_ops._sse_kernel)."""
    d = torch.where(mask_col > 0, dec - data, 0.0)
    return (d * d * mask_col).sum()


def masked_sse_bwd(data, dec, mask_col, g):
    """(ddata, ddec) for the cotangent g of masked_sse (pallas_ops._sse_bwd):
    the where() keeps inf in a padded row from making (inf - data) * 0 = NaN."""
    d = torch.where(mask_col > 0, dec - data, 0.0) * mask_col
    return -2.0 * g * d, 2.0 * g * d


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
        for name in ("vae_sums_fwd", "masked_sse_fwd"):
            size = getattr(lib, f"{name}_workspace")
            size.argtypes, size.restype = [_I], _I
        lib.vae_sums_fwd.argtypes = [_P] * 5 + [_I] * 3 + [_P] * 3
        lib.vae_sums_fwd.restype = _I
        lib.vae_sums_bwd.argtypes = [_P] * 6 + [_I] * 3 + [_P] * 5
        lib.vae_sums_bwd.restype = _I
        lib.masked_sse_fwd.argtypes = [_P] * 3 + [_I] * 2 + [_P] * 3
        lib.masked_sse_fwd.restype = _I
        _lib = lib
    return _lib


def _check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def _check_inputs(data, dec, mu, logvar, mask_col):
    B, L = data.shape
    Z = mu.shape[1]
    _check_tensors({"data": (data, (B, L)), "dec": (dec, (B, L)), "mu": (mu, (B, Z)),
                    "logvar": (logvar, (B, Z)), "mask_col": (mask_col, (B, 1))})


def _check_sse_inputs(data, dec, mask_col):
    """Raise on what the masked-SSE kernel does not take: float32 data and
    dec [B, L] and mask_col [B, 1], contiguous, on one device, B > 0."""
    f32 = torch.float32
    if data.dtype != f32 or dec.dtype != f32 or mask_col.dtype != f32:
        raise TypeError(f"data, dec, mask_col: dtypes {data.dtype}, {dec.dtype}, {mask_col.dtype}; "
                        "the kernel takes float32")
    if data.ndim != 2 or dec.shape != data.shape or mask_col.shape != (data.shape[0], 1):
        raise ValueError(f"shapes {tuple(data.shape)}, {tuple(dec.shape)}, {tuple(mask_col.shape)}: "
                         "the kernel takes data and dec [B, L] and mask_col [B, 1]")
    if dec.device != data.device or mask_col.device != data.device:
        raise ValueError(f"data on {data.device}, dec on {dec.device}, mask_col on {mask_col.device}")
    if not (data.is_contiguous() and dec.is_contiguous() and mask_col.is_contiguous()):
        raise ValueError("data, dec and mask_col must be contiguous")
    if data.shape[0] == 0:
        raise ValueError("empty batch")


def _check_tensors(want):
    """Each tensor of ``want`` (name -> (tensor, shape)) float32 of that shape,
    contiguous, on the first one's device; a nonempty batch."""
    data = next(iter(want.values()))[0]
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if data.shape[0] == 0:
        raise ValueError("empty batch")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {data.device}")


def _device(device: torch.device):
    """``device`` made current for the call (no context switch when it is already)."""
    return contextlib.nullcontext() if device.index == torch.cuda.current_device() else torch.cuda.device(device)


_workspaces: dict = {}  # (kernel, device index, stream) -> (largest batch, float32 workspace)


def _workspace(lib, kernel: str, device: torch.device, stream: int, B: int) -> torch.Tensor:
    """``kernel``'s workspace on ``stream``: an integer ticket, zero when made,
    then the kernel's partials, ``<kernel>_workspace(B)`` floats in all. The
    kernel leaves the ticket zero, so one workspace serves every later call
    of that kernel on that stream with a batch no larger (and a CUDA graph).
    Each kernel has its own, so no two kernels ever share a ticket."""
    key = (kernel, device.index, stream)
    held = _workspaces.get(key)
    if held is None or held[0] < B:
        n = getattr(lib, f"{kernel}_workspace")(B)
        held = _workspaces[key] = (B, torch.zeros(n, dtype=torch.float32, device=device))
    return held[1]


def vae_sums_fwd_cuda(data, dec, mu, logvar, mask_col) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors: returns [sse, kl] on the
    device. One CUDA launch; the call allocates only its output."""
    device = data.device
    if device.type != "cuda":
        raise ValueError(f"vae_sums_fwd_cuda takes CUDA tensors, got {device}")
    lib = _kernels()
    B, L = data.shape
    Z = mu.shape[1]
    with _device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out = torch.empty(2, dtype=torch.float32, device=device)
        err = lib.vae_sums_fwd(
            data.data_ptr(), dec.data_ptr(), mu.data_ptr(), logvar.data_ptr(), mask_col.data_ptr(), B, L, Z,
            _workspace(lib, "vae_sums_fwd", device, stream, B).data_ptr(), out.data_ptr(), stream,
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


def masked_sse_fwd_cuda(data, dec, mask_col) -> torch.Tensor:
    """Launch the masked-SSE kernel on CUDA tensors: a 0-dim sum on the device.
    One CUDA launch; the call allocates only its output."""
    _check_sse_inputs(data, dec, mask_col)
    device = data.device
    if device.type != "cuda":
        raise ValueError(f"masked_sse_fwd_cuda takes CUDA tensors, got {device}")
    B, L = data.shape
    lib = _kernels()
    with _device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out = torch.empty((), dtype=torch.float32, device=device)
        err = lib.masked_sse_fwd(data.data_ptr(), dec.data_ptr(), mask_col.data_ptr(), B, L,
                                 _workspace(lib, "masked_sse_fwd", device, stream, B).data_ptr(), out.data_ptr(),
                                 stream)
    _check_launch(err, "masked_sse_fwd")
    launches["masked_sse_fwd"] += 1
    return out


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


class FusedMaskedSse(torch.autograd.Function):
    """sum(m * (dec - data)^2), where-guarded. CUDA tensors launch
    csrc/vae_sums.cu's masked_sse; CPU tensors take masked_sse_plain. The
    backward is masked_sse_bwd on the device's tensors (g stays there)."""

    @staticmethod
    def forward(ctx, data, dec, mask_col):
        ctx.save_for_backward(data, dec, mask_col)
        if data.device.type == "cpu":
            _check_sse_inputs(data, dec, mask_col)
            return masked_sse_plain(data, dec, mask_col)
        return masked_sse_fwd_cuda(data, dec, mask_col)

    @staticmethod
    def backward(ctx, g):
        data, dec, mask_col = ctx.saved_tensors
        return (*masked_sse_bwd(data, dec, mask_col, g), None)


def fused_masked_sse(data, dec, mask_col) -> torch.Tensor:
    """sum(mask * (dec - data)^2) for the second modality; mask_col: [B, 1]."""
    return FusedMaskedSse.apply(data, dec, mask_col)


def _mask_col_and_count(data, mask):
    B = data.shape[0]
    if mask is None:
        return torch.ones((B, 1), dtype=data.dtype, device=data.device), float(B)
    mask_col = mask.to(data.dtype).reshape(B, 1).contiguous()
    return mask_col, mask_col.sum()


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
    mask_col, n = _mask_col_and_count(data, mask)
    sse, kl_sum = fused_vae_sums(data.contiguous(), dec.contiguous(), mu.contiguous(),
                                 logvar.contiguous(), mask_col)
    mse = sse / (n * data.shape[1])
    kl = kl_sum / n
    return mse + beta * kl, (mse, kl)


def multimodal_vae_loss_pallas(
    data1: torch.Tensor,
    data2: torch.Tensor,
    dec1: torch.Tensor,
    dec2: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    *,
    beta: float = 1.0,
    mod1_weight: float = 1.0,
    mod2_weight: float = 1.0,
    mask: Optional[torch.Tensor] = None,
):
    """Drop-in for losses.multimodal_vae_loss on the fused kernels: one
    fused_vae_sums call for modality 1 and the KL, one fused_masked_sse call
    for modality 2. Returns (total, (mse1, mse2, kl))."""
    mask_col, n = _mask_col_and_count(data1, mask)
    mse1_sum, kl_sum = fused_vae_sums(data1.contiguous(), dec1.contiguous(), mu.contiguous(),
                                      logvar.contiguous(), mask_col)
    mse2_sum = fused_masked_sse(data2.contiguous(), dec2.contiguous(), mask_col)
    mse1 = mse1_sum / (n * data1.shape[1])
    mse2 = mse2_sum / (n * data2.shape[1])
    kl = kl_sum / n
    total = mod1_weight * mse1 + mod2_weight * mse2 + beta * kl
    return total, (mse1, mse2, kl)
