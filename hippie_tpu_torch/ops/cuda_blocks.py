"""Hand-written CUDA kernels for the backbones' BasicBlocks, encoder and
decoder, forward and backward.

Counterpart of hippie_tpu/ops/pallas_blocks.py (``_enc_block_prim``,
``_dec_block_prim``, ``basic_block_enc_fused``, ``basic_block_dec_fused``);
the kernels are csrc/enc_block.cu and csrc/dec_block.cu on the wgmma GEMM
core of csrc/sm90_gemm.cuh, whose header notes say what bounds them and how
they are laid out: each forward is 5 CUDA launches (the tickets' memset, two
convs with their statistics in the epilogue, two elementwise passes), each
backward 7.

Layout at every function here is the JAX package's: activations ``[L, B, C]``
(length leading) in bfloat16, conv weights ``[K, C_in, C_out]``, BatchNorm
vectors and conv biases float32 ``[C]``, the mask a float32 column ``[B, 1]``.

``enc_block_fwd_plain`` / ``enc_block_bwd_plain`` and ``dec_block_fwd_plain``
/ ``dec_block_bwd_plain`` repeat ``_enc_fwd_math`` / ``_enc_bwd_math`` and
``_dec_fwd_math`` / ``_dec_bwd_math`` step for step in eager torch ops, with
the bf16 roundings at the same places. A product of two bf16 operands is
exact in float32, so the plain versions multiply the operands upcast to
float32 (torch's ``bf16 @ bf16`` would round the result to bf16). The CPU
tests hold them against the JAX package; chip_smoke.py holds the kernels
against them on the card.

``EncBlockFn`` and ``DecBlockFn`` launch the kernels for CUDA tensors and
raise on anything they do not take; for CPU tensors they run the plain
versions. A CUDA tensor never takes the plain path. ``launches`` counts one
per call of each entry point (each entry point issues a fixed sequence of
CUDA launches).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from hippie_tpu_torch.ops import _build

EPS = 1e-5
SLOPE = 0.01  # the backbones' LeakyReLU slope

launches = {"enc_block_fwd": 0, "enc_block_bwd": 0, "dec_block_fwd": 0, "dec_block_bwd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain versions: helpers on [L, B, C] (pallas_blocks.py:73-252)
# ---------------------------------------------------------------------------


def _bf16_as_f32(t: torch.Tensor) -> torch.Tensor:
    """bf16-rounded operand as float32: products of two of them are exact."""
    return t.to(torch.bfloat16).float()


def _dot(a, b):
    """[M, K] @ [K, N] -> float32 with bf16 operands (``_dot2``)."""
    return _bf16_as_f32(a) @ _bf16_as_f32(b)


def _dot_t(a, b):
    """[K, M]^T @ [K, N] -> float32 with bf16 operands (``_dotT2``)."""
    return _bf16_as_f32(a).t() @ _bf16_as_f32(b)


def _out_len(L: int, stride: int) -> int:
    return L if stride == 1 else (L - 1) // 2 + 1


def _taps(x, stride: int, lo: int):
    """The three input slabs of a k3, pad-1 conv at output length ``lo``."""
    xp = F.pad(x, (0, 0, 0, 0, 1, 1))
    if stride == 1:
        return [xp[t:t + lo] for t in range(3)]
    return [xp[t:t + 2 * lo - 1:2] for t in range(3)]


def _conv3(x, w, stride: int):
    """k3 pad-1 conv: x [L,B,Ci], w [3,Ci,Co] -> float32 [Lo,B,Co]."""
    lo, B = _out_len(x.shape[0], stride), x.shape[1]
    taps = _taps(x, stride, lo)
    acc = _dot(taps[0].reshape(lo * B, -1), w[0])
    acc = acc + _dot(taps[1].reshape(lo * B, -1), w[1])
    acc = acc + _dot(taps[2].reshape(lo * B, -1), w[2])
    return acc.reshape(lo, B, -1)


def _conv1x1_s2(x, w):
    """k1 stride-2 conv (the encoder's shortcut): w [1,Ci,Co]."""
    lo, B = _out_len(x.shape[0], 2), x.shape[1]
    return _dot(x[0:2 * lo - 1:2].reshape(lo * B, -1), w[0]).reshape(lo, B, -1)


def _wT(w):
    """[3,Ci,Co] -> flipped and transposed [3,Co,Ci]."""
    return torch.stack([w[2].t(), w[1].t(), w[0].t()])


def _convT3(g, w, stride: int, lin: int):
    """Transpose of _conv3: g [Lo,B,Co], w [3,Ci,Co] -> float32 [Lin,B,Ci]."""
    if stride == 1:
        return _conv3(g, _wT(w), 1)
    lo, B, co = g.shape
    gf = g.reshape(lo * B, co)
    # u_t = g @ w[t]^T lands on padded position 2l + t; keep [1, 1 + Lin)
    out = torch.zeros((2 * lo + 2, B, w.shape[1]), dtype=torch.float32, device=g.device)
    for t in range(3):
        out[t:t + 2 * lo:2] += _dot(gf, w[t].t()).reshape(lo, B, -1)
    return out[1:1 + lin]


def _convT1x1_s2(g, w, lin: int):
    """Transpose of _conv1x1_s2: g [Lo,B,Co] -> float32 [Lin,B,Ci]."""
    lo, B, co = g.shape
    out = torch.zeros((lin, B, w.shape[1]), dtype=torch.float32, device=g.device)
    out[0::2] = _dot(g.reshape(lo * B, co), w[0].t()).reshape(lo, B, -1)
    return out


def _dw3(x, dc, stride: int):
    """Weight gradient of _conv3: x [L,B,Ci], dc [Lo,B,Co] -> float32 [3,Ci,Co]."""
    lo, B, co = dc.shape
    dcf = dc.reshape(lo * B, co)
    return torch.stack([_dot_t(t.reshape(lo * B, -1), dcf) for t in _taps(x, stride, lo)])


def _dw1x1_s2(x, dc):
    lo, B, co = dc.shape
    return _dot_t(x[0:2 * lo - 1:2].reshape(lo * B, -1), dc.reshape(lo * B, co))[None]


def _bn_stats(c, mb, n):
    """Masked batch statistics over (L, B): mean first, then centred variance."""
    mean = (c * mb).sum((0, 1)) / n
    var = ((c - mean).square() * mb).sum((0, 1)) / n
    return mean, var, torch.rsqrt(var + EPS)


def _bn_bwd(dy, xh, gamma, inv, mb, n):
    """Masked BatchNorm backward -> (dc, dgamma, dbeta). The sums run over
    every entry, padded rows included; only the m/n term is masked."""
    dy32, xh32 = dy.float(), xh.float()
    dgamma = (dy32 * xh32).sum((0, 1))
    dbeta = dy32.sum((0, 1))
    dc = (gamma * inv) * (dy32 - (mb / n) * (dbeta + xh32 * dgamma))
    return dc, dgamma, dbeta


def _lrelu(a):
    return torch.where(a >= 0, a, a * SLOPE)


def _dlrelu(a):
    """1 at exactly 0, as the JAX package's where(a >= 0, ...)."""
    return torch.where(a >= 0, 1.0, SLOPE)


# ---------------------------------------------------------------------------
# Plain versions: the block (pallas_blocks.py:261-338)
# ---------------------------------------------------------------------------


def _bf16(t):
    return t.to(torch.bfloat16)


def _shortcut_dummies(x, w2, ws, gs, bs):
    """The zero shortcut operands of a block without one (pallas_blocks.py:722-726)."""
    if ws is not None:
        return ws, gs, bs
    co = w2.shape[2]
    z = torch.zeros(co, dtype=torch.float32, device=x.device)
    return torch.zeros((1, x.shape[2], co), dtype=torch.float32, device=x.device), z, z


def enc_block_fwd_plain(stride, has_short, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m):
    """Training forward of BasicBlockEnc -> (out bf16 [Lo,B,Co], st1, st2, sts),
    each st a float32 [3, C] of (mean, var, inv). ``m`` is the [B, 1] mask."""
    ws, gs, bs = _shortcut_dummies(x, w2, ws, gs, bs)
    w1, w2, ws = _bf16(w1), _bf16(w2), _bf16(ws)
    mb = m[None]
    n = m.sum() * _out_len(x.shape[0], stride)

    c1 = _conv3(x, w1, stride)
    mu1, var1, inv1 = _bn_stats(c1, mb, n)
    r1 = _bf16(_lrelu(g1 * ((c1 - mu1) * inv1) + b1))
    st1 = torch.stack([mu1, var1, inv1])

    c2 = _conv3(r1, w2, 1)
    mu2, var2, inv2 = _bn_stats(c2, mb, n)
    a2 = g2 * ((c2 - mu2) * inv2) + b2
    st2 = torch.stack([mu2, var2, inv2])

    if has_short:
        cs = _conv1x1_s2(x, ws)
        mus, vars_, invs = _bn_stats(cs, mb, n)
        ash = gs * ((cs - mus) * invs) + bs
        sts = torch.stack([mus, vars_, invs])
    else:
        ash = x.float()
        sts = torch.zeros((3, w2.shape[2]), dtype=torch.float32, device=x.device)
    return _bf16(_lrelu(a2 + ash)), st1, st2, sts


def enc_block_bwd_plain(stride, has_short, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m,
                        st1, st2, sts, g):
    """Backward of enc_block_fwd_plain given the output cotangent ``g``
    -> (dx bf16, dw1, dg1, db1, dw2, dg2, db2, dws, dgs, dbs), float32 but dx.
    Recomputes the forward from x and the saved statistics."""
    ws, gs, bs = _shortcut_dummies(x, w2, ws, gs, bs)
    w1, w2, ws, g = _bf16(w1), _bf16(w2), _bf16(ws), _bf16(g)
    mb = m[None]
    lin = x.shape[0]
    n = m.sum() * g.shape[0]

    mu1, inv1 = st1[0], st1[2]
    xh1 = _bf16((_conv3(x, w1, stride) - mu1) * inv1)
    a1 = _bf16(g1 * xh1.float() + b1)
    r1 = _bf16(_lrelu(a1.float()))
    mu2, inv2 = st2[0], st2[2]
    xh2 = _bf16((_conv3(r1, w2, 1) - mu2) * inv2)
    a2 = g2 * xh2.float() + b2
    if has_short:
        mus, invs = sts[0], sts[2]
        xhs = _bf16((_conv1x1_s2(x, ws) - mus) * invs)
        ash = gs * xhs.float() + bs
    else:
        ash = x.float()

    g0 = _bf16(g.float() * _dlrelu(a2 + ash))

    dc2, dg2, db2 = _bn_bwd(g0, xh2, g2, inv2, mb, n)
    dc2 = _bf16(dc2)
    dw2 = _dw3(r1, dc2, 1)
    da1 = _bf16(_convT3(dc2, w2, 1, r1.shape[0]) * _dlrelu(a1.float()))
    dc1, dg1, db1 = _bn_bwd(da1, xh1, g1, inv1, mb, n)
    dc1 = _bf16(dc1)
    dw1 = _dw3(x, dc1, stride)
    dx = _convT3(dc1, w1, stride, lin)

    if has_short:
        dcs, dgs, dbs = _bn_bwd(g0, xhs, gs, invs, mb, n)
        dcs = _bf16(dcs)
        dws = _dw1x1_s2(x, dcs)
        dx = dx + _convT1x1_s2(dcs, ws, lin)
    else:
        dws = torch.zeros(ws.shape, dtype=torch.float32, device=x.device)
        dgs = torch.zeros(gs.shape, dtype=torch.float32, device=x.device)
        dbs = torch.zeros(bs.shape, dtype=torch.float32, device=x.device)
        dx = dx + g0.float()
    return _bf16(dx), dw1, dg1, db1, dw2, dg2, db2, dws, dgs, dbs


# ---------------------------------------------------------------------------
# Plain versions: the decoder block (pallas_blocks.py:244-252, 341-440)
# ---------------------------------------------------------------------------


def _upsample2(x):
    """Nearest x2 along L of [L, B, C] (``_upsample2``)."""
    return x.repeat_interleave(2, dim=0)


def _dupsample2(g):
    """Backward of _upsample2: the sum of adjacent pairs (``_dupsample2``)."""
    L2, B, C = g.shape
    return g.reshape(L2 // 2, 2, B, C).sum(1)


def _dec_dummies(x, w1, c1b, ws, csb, gs, bs):
    """The zero conv biases and shortcut operands of a stride-1 block
    (pallas_blocks.py:755-762); ws is [3, C_in, C_out] in the decoder."""
    if ws is not None:
        return c1b, ws, csb, gs, bs
    co = w1.shape[2]
    z = torch.zeros(co, dtype=torch.float32, device=x.device)
    return z, torch.zeros((3, x.shape[2], co), dtype=torch.float32, device=x.device), z, z, z


def dec_block_fwd_plain(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m):
    """Training forward of BasicBlockDec -> (out bf16 [Lo,B,Co], st2 [3,Ci],
    st1, sts [3,Co]), Lo = stride * Lin. BN2 normalises at the input length
    (n2 = sum(m) * Lin), BN1 and the shortcut's at the output length."""
    c1b, ws, csb, gs, bs = _dec_dummies(x, w1, c1b, ws, csb, gs, bs)
    w2, w1, ws = _bf16(w2), _bf16(w1), _bf16(ws)
    mb = m[None]
    lin = x.shape[0]
    n2, n1 = m.sum() * lin, m.sum() * lin * stride

    c2 = _conv3(x, w2, 1)
    mu2, var2, inv2 = _bn_stats(c2, mb, n2)
    r = _bf16(_lrelu(g2 * ((c2 - mu2) * inv2) + b2))
    st2 = torch.stack([mu2, var2, inv2])

    c1 = _conv3(_upsample2(r), w1, 1) + c1b if stride != 1 else _conv3(r, w1, 1)
    mu1, var1, inv1 = _bn_stats(c1, mb, n1)
    a1 = g1 * ((c1 - mu1) * inv1) + b1
    st1 = torch.stack([mu1, var1, inv1])

    if stride != 1:
        cs = _conv3(_upsample2(x), ws, 1) + csb
        mus, vars_, invs = _bn_stats(cs, mb, n1)
        ash = gs * ((cs - mus) * invs) + bs
        sts = torch.stack([mus, vars_, invs])
    else:
        ash = x.float()
        sts = torch.zeros((3, w1.shape[2]), dtype=torch.float32, device=x.device)
    return _bf16(_lrelu(a1 + ash)), st2, st1, sts


def dec_block_bwd_plain(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m,
                        st2, st1, sts, g):
    """Backward of dec_block_fwd_plain given the output cotangent ``g`` ->
    (dx bf16, dw2, dg2, db2, dw1, dc1b, dg1, db1, dws, dcsb, dgs, dbs), float32
    but dx. Recomputes the forward from x and the saved statistics."""
    short = stride != 1
    c1b, ws, csb, gs, bs = _dec_dummies(x, w1, c1b, ws, csb, gs, bs)
    w2, w1, ws, g = _bf16(w2), _bf16(w1), _bf16(ws), _bf16(g)
    mb = m[None]
    lin = x.shape[0]
    n2, n1 = m.sum() * lin, m.sum() * g.shape[0]
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=x.device)  # noqa: E731

    mu2, inv2 = st2[0], st2[2]
    xh2 = _bf16((_conv3(x, w2, 1) - mu2) * inv2)
    a2 = _bf16(g2 * xh2.float() + b2)
    r = _bf16(_lrelu(a2.float()))
    mu1, inv1 = st1[0], st1[2]
    if short:
        up_r = _upsample2(r)
        c1 = _conv3(up_r, w1, 1) + c1b
    else:
        c1 = _conv3(r, w1, 1)
    xh1 = _bf16((c1 - mu1) * inv1)
    a1 = g1 * xh1.float() + b1
    if short:
        mus, invs = sts[0], sts[2]
        up_x = _upsample2(x)
        xhs = _bf16((_conv3(up_x, ws, 1) + csb - mus) * invs)
        ash = gs * xhs.float() + bs
    else:
        ash = x.float()

    g0 = _bf16(g.float() * _dlrelu(a1 + ash))

    dc1, dg1, db1 = _bn_bwd(g0, xh1, g1, inv1, mb, n1)
    dc1 = _bf16(dc1)
    if short:
        dw1 = _dw3(up_r, dc1, 1)
        dc1b = dc1.float().sum((0, 1))
        dr = _dupsample2(_convT3(dc1, w1, 1, up_r.shape[0]))
    else:
        dw1 = _dw3(r, dc1, 1)
        dc1b = zeros(c1b)
        dr = _convT3(dc1, w1, 1, lin)

    da2 = _bf16(dr * _dlrelu(a2.float()))
    dc2, dg2, db2 = _bn_bwd(da2, xh2, g2, inv2, mb, n2)
    dc2 = _bf16(dc2)
    dw2 = _dw3(x, dc2, 1)
    dx = _convT3(dc2, w2, 1, lin)

    if short:
        dcs, dgs, dbs = _bn_bwd(g0, xhs, gs, invs, mb, n1)
        dcs = _bf16(dcs)
        dws = _dw3(up_x, dcs, 1)
        dcsb = dcs.float().sum((0, 1))
        dx = dx + _dupsample2(_convT3(dcs, ws, 1, up_x.shape[0]))
    else:
        dws, dcsb, dgs, dbs = zeros(ws), zeros(csb), zeros(gs), zeros(bs)
        dx = dx + g0.float()
    return _bf16(dx), dw2, dg2, db2, dw1, dc1b, dg1, db1, dws, dcsb, dgs, dbs


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_libs: dict = {}
# per block kind: the entry points' ints (shape, stride), and the forward's
# and the backward's (operand, output + scratch + stream) pointer counts
_SIGNATURES = {"enc": (6, (11, 6), (15, 12)), "dec": (5, (13, 6), (17, 14))}


def _kernels(kind: str) -> ctypes.CDLL:
    """csrc/<kind>_block.cu, built and loaded once, its entry points typed."""
    lib = _libs.get(kind)
    if lib is None:
        lib = _build.load(f"{kind}_block")
        ints, *directions = _SIGNATURES[kind]
        for d, (n_in, n_out) in zip(("fwd", "bwd"), directions):
            scratch = getattr(lib, f"{kind}_block_{d}_scratch")
            scratch.argtypes, scratch.restype = [_I] * ints, ctypes.c_longlong
            fn = getattr(lib, f"{kind}_block_{d}")
            fn.argtypes, fn.restype = [_P] * n_in + [_I] * ints + [_P] * n_out, _I
        _libs[kind] = lib
    return lib


def _check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_block_inputs(stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m, g=None):
    """Raise on what the kernels do not take. Weights must already be bf16."""
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: the kernels take 1 or 2")
    if x.ndim != 3:
        raise ValueError(f"x must be [L, B, C], got {tuple(x.shape)}")
    L, B, ci = x.shape
    co = w2.shape[-1]
    lo = _out_len(L, stride)
    has_short = stride != 1
    want = {"x": (x, torch.bfloat16, (L, B, ci)), "w1": (w1, torch.bfloat16, (3, ci, co)),
            "g1": (g1, torch.float32, (co,)), "b1": (b1, torch.float32, (co,)),
            "w2": (w2, torch.bfloat16, (3, co, co)), "g2": (g2, torch.float32, (co,)),
            "b2": (b2, torch.float32, (co,)), "mask": (m, torch.float32, (B, 1))}
    if has_short:
        want.update({"ws": (ws, torch.bfloat16, (1, ci, co)), "gs": (gs, torch.float32, (co,)),
                     "bs": (bs, torch.float32, (co,))})
    elif ws is not None or ci != co:
        raise ValueError("a stride-1 block has no shortcut and C_in == C_out")
    if g is not None:
        want["g"] = (g, torch.bfloat16, (lo, B, co))
    _check_operands(want, x, ci, co, L)


def _check_operands(want, x, ci, co, rows):
    """Each operand of ``want`` (name -> (tensor, dtype, shape)) as given, on
    x's device and contiguous; channels and sizes as the kernels take them.
    ``rows`` is the longest length of an intermediate [rows, B, max(ci, co)]."""
    L, B = x.shape[:2]
    for name, (t, dtype, shape) in want.items():
        if t is None:
            raise ValueError(f"{name} is missing")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if ci % 64 or co % 64:
        raise ValueError(f"channels {ci} -> {co}: the kernels take multiples of 64")
    if B == 0 or L == 0:
        raise ValueError("empty input")
    if rows * B * max(ci, co) >= 2**31:
        raise ValueError(f"{rows} x {B} x {max(ci, co)} elements: the kernels index with 32-bit ints")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


def _scratch(nbytes: int, device) -> torch.Tensor:
    return torch.empty(max(int(nbytes), 1), dtype=torch.uint8, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def enc_block_fwd_cuda(stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m):
    """Launch the forward: (out bf16 [Lo,B,Co], st1, st2, sts). Weights bf16;
    ws/gs/bs None for a block without shortcut (sts then zeros)."""
    check_block_inputs(stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m)
    lib = _kernels("enc")
    L, B, ci = x.shape
    co = w2.shape[-1]
    lo = _out_len(L, stride)
    short = int(stride != 1)
    with torch.cuda.device(x.device):
        out = torch.empty((lo, B, co), dtype=torch.bfloat16, device=x.device)
        st = [torch.empty((3, co), dtype=torch.float32, device=x.device) for _ in range(3)]
        scratch = _scratch(lib.enc_block_fwd_scratch(L, B, ci, co, stride, short), x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.enc_block_fwd(
            x.data_ptr(), w1.data_ptr(), g1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            g2.data_ptr(), b2.data_ptr(), _ptr(ws), _ptr(gs), _ptr(bs), m.data_ptr(),
            L, B, ci, co, stride, short,
            out.data_ptr(), *(s.data_ptr() for s in st), scratch.data_ptr(), stream,
        )
    _check_launch(err, "enc_block_fwd")
    launches["enc_block_fwd"] += 1
    return (out, *st)


def enc_block_bwd_cuda(stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m, st1, st2, sts, g):
    """Launch the backward: (dx bf16, dw1, dg1, db1, dw2, dg2, db2, dws, dgs,
    dbs), the last three None for a block without shortcut."""
    check_block_inputs(stride, x, w1, g1, b1, w2, g2, b2, ws, gs, bs, m, g)
    co = w2.shape[-1]
    for name, t in (("st1", st1), ("st2", st2), ("sts", sts)):
        if t.dtype != torch.float32 or tuple(t.shape) != (3, co) or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 [3, {co}] on {x.device}")
    lib = _kernels("enc")
    L, B, ci = x.shape
    short = stride != 1
    f32 = dict(dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dw1, dw2 = torch.empty(w1.shape, **f32), torch.empty(w2.shape, **f32)
        dvec = torch.empty((6 if short else 4, co), **f32)  # dg1 db1 dg2 db2 (dgs dbs)
        dws = torch.empty(ws.shape, **f32) if short else None
        scratch = _scratch(lib.enc_block_bwd_scratch(L, B, ci, co, stride, int(short)), x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.enc_block_bwd(
            x.data_ptr(), w1.data_ptr(), g1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            g2.data_ptr(), b2.data_ptr(), _ptr(ws), _ptr(gs), _ptr(bs), m.data_ptr(),
            st1.data_ptr(), st2.data_ptr(), sts.data_ptr(), g.data_ptr(),
            L, B, ci, co, stride, int(short),
            dx.data_ptr(), dw1.data_ptr(), dvec[0].data_ptr(), dvec[1].data_ptr(),
            dw2.data_ptr(), dvec[2].data_ptr(), dvec[3].data_ptr(), _ptr(dws),
            dvec[4].data_ptr() if short else None, dvec[5].data_ptr() if short else None,
            scratch.data_ptr(), stream,
        )
    _check_launch(err, "enc_block_bwd")
    launches["enc_block_bwd"] += 1
    dgs, dbs = (dvec[4], dvec[5]) if short else (None, None)
    return dx, dw1, dvec[0], dvec[1], dw2, dvec[2], dvec[3], dws, dgs, dbs


def check_dec_block_inputs(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m, g=None):
    """Raise on what the decoder kernels do not take. Weights must already be
    bf16; a stride-1 block has no conv bias and no shortcut (c1b, ws, csb, gs,
    bs None) and C_in == C_out."""
    if stride not in (1, 2):
        raise ValueError(f"stride {stride}: the kernels take 1 or 2")
    if x.ndim != 3:
        raise ValueError(f"x must be [L, B, C], got {tuple(x.shape)}")
    L, B, ci = x.shape
    co = w1.shape[-1]
    want = {"x": (x, torch.bfloat16, (L, B, ci)), "w2": (w2, torch.bfloat16, (3, ci, ci)),
            "g2": (g2, torch.float32, (ci,)), "b2": (b2, torch.float32, (ci,)),
            "w1": (w1, torch.bfloat16, (3, ci, co)), "g1": (g1, torch.float32, (co,)),
            "b1": (b1, torch.float32, (co,)), "mask": (m, torch.float32, (B, 1))}
    if stride != 1:
        want.update({"c1b": (c1b, torch.float32, (co,)), "ws": (ws, torch.bfloat16, (3, ci, co)),
                     "csb": (csb, torch.float32, (co,)), "gs": (gs, torch.float32, (co,)),
                     "bs": (bs, torch.float32, (co,))})
    elif any(t is not None for t in (c1b, ws, csb, gs, bs)) or ci != co:
        raise ValueError("a stride-1 block has no conv bias, no shortcut and C_in == C_out")
    if g is not None:
        want["g"] = (g, torch.bfloat16, (L * stride, B, co))
    _check_operands(want, x, ci, co, L * stride)


def dec_block_fwd_cuda(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m):
    """Launch the decoder forward: (out bf16 [Lo,B,Co], st2 [3,Ci], st1, sts
    [3,Co]). Weights bf16; c1b, ws, csb, gs, bs None at stride 1 (sts zeros)."""
    check_dec_block_inputs(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m)
    lib = _kernels("dec")
    L, B, ci = x.shape
    co = w1.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        out = torch.empty((L * stride, B, co), dtype=torch.bfloat16, device=x.device)
        st2, st1, sts = torch.empty((3, ci), **f32), torch.empty((3, co), **f32), torch.empty((3, co), **f32)
        scratch = _scratch(lib.dec_block_fwd_scratch(L, B, ci, co, stride), x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dec_block_fwd(
            *(_ptr(t) for t in (x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m)),
            L, B, ci, co, stride,
            out.data_ptr(), st2.data_ptr(), st1.data_ptr(), sts.data_ptr(), scratch.data_ptr(), stream,
        )
    _check_launch(err, "dec_block_fwd")
    launches["dec_block_fwd"] += 1
    return out, st2, st1, sts


def dec_block_bwd_cuda(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m, st2, st1, sts, g):
    """Launch the decoder backward: (dx bf16, dw2, dg2, db2, dw1, dc1b, dg1,
    db1, dws, dcsb, dgs, dbs); dc1b and the shortcut's four None at stride 1."""
    check_dec_block_inputs(stride, x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m, g)
    L, B, ci = x.shape
    co = w1.shape[-1]
    for name, t, c in (("st2", st2, ci), ("st1", st1, co), ("sts", sts, co)):
        if t.dtype != torch.float32 or tuple(t.shape) != (3, c) or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 [3, {c}] on {x.device}")
    lib = _kernels("dec")
    short = stride != 1
    f32 = dict(dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dw2, dw1 = torch.empty(w2.shape, **f32), torch.empty(w1.shape, **f32)
        dv2 = torch.empty((2, ci), **f32)                # dg2 db2
        dv1 = torch.empty((6 if short else 2, co), **f32)  # dg1 db1 (dc1b dcsb dgs dbs)
        dws = torch.empty(ws.shape, **f32) if short else None
        d1 = [dv1[i] if short else None for i in range(2, 6)]
        scratch = _scratch(lib.dec_block_bwd_scratch(L, B, ci, co, stride), x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dec_block_bwd(
            *(_ptr(t) for t in (x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m, st2, st1, sts, g)),
            L, B, ci, co, stride,
            *(_ptr(t) for t in (dx, dw2, dv2[0], dv2[1], dw1, d1[0], dv1[0], dv1[1], dws, d1[1],
                                d1[2], d1[3], scratch)),
            stream,
        )
    _check_launch(err, "dec_block_bwd")
    launches["dec_block_bwd"] += 1
    return dx, dw2, dv2[0], dv2[1], dw1, d1[0], dv1[0], dv1[1], dws, d1[1], d1[2], d1[3]


# ---------------------------------------------------------------------------
# Autograd and the block
# ---------------------------------------------------------------------------


def _weights_bf16(*ws):
    """Contiguous bf16 copies (one cast each) of float32 weight views."""
    return [None if w is None else
            w.detach().to(torch.bfloat16, memory_format=torch.contiguous_format) for w in ws]


class BlockOps(NamedTuple):
    """One block kind's operands and versions, each taking (stride, *operands)."""

    weights: tuple   # positions of the conv weights among the operands
    absent: tuple    # positions of the operands a stride-1 block has none of
    check: Callable
    fwd_plain: Callable
    fwd_cuda: Callable
    bwd_plain: Callable
    bwd_cuda: Callable


ENC_OPS = BlockOps((1, 4, 7), (7, 8, 9), check_block_inputs,
                   lambda s, *a: enc_block_fwd_plain(s, s != 1, *a), enc_block_fwd_cuda,
                   lambda s, *a: enc_block_bwd_plain(s, s != 1, *a), enc_block_bwd_cuda)
DEC_OPS = BlockOps((1, 4, 8), (5, 8, 9, 10, 11), check_dec_block_inputs,
                   dec_block_fwd_plain, dec_block_fwd_cuda, dec_block_bwd_plain, dec_block_bwd_cuda)


def _block_forward(ctx, plain, kind, args, stride):
    """args: the kind's operands, conv weights float32; stats are not differentiable."""
    args = list(args)
    for i in kind.weights:
        args[i], = _weights_bf16(args[i])
    if plain:
        kind.check(stride, *args)
        outs = kind.fwd_plain(stride, *args)
    else:
        outs = kind.fwd_cuda(stride, *args)
    ctx.stride, ctx.kind = stride, kind
    ctx.save_for_backward(*args, *outs[1:])
    ctx.mark_non_differentiable(*outs[1:])
    return outs


def _block_backward(ctx, plain, g):
    kind, saved = ctx.kind, ctx.saved_tensors
    g = g.to(torch.bfloat16).contiguous()
    if plain:
        grads = kind.bwd_plain(ctx.stride, *saved, g)
        if ctx.stride == 1:  # those operands did not come in
            grads = tuple(None if i in kind.absent else d for i, d in enumerate(grads))
    else:
        grads = kind.bwd_cuda(ctx.stride, *saved, g)
    return (*grads, None, None)


class EncBlockFn(torch.autograd.Function):
    """Fused BasicBlockEnc in training: (out, st1, st2, sts) with the fused
    backward. Weights come in float32 ``[K, C_in, C_out]`` and their
    gradients go back in float32; the kernels read them rounded to bf16.

    CUDA tensors launch csrc/enc_block.cu; CPU tensors take the plain versions.
    """

    @staticmethod
    def forward(ctx, x, *args):
        return _block_forward(ctx, x.device.type == "cpu", ENC_OPS, (x, *args[:-1]), args[-1])

    @staticmethod
    def backward(ctx, g, *_):
        return _block_backward(ctx, g.device.type == "cpu", g)


class PlainEncBlockFn(torch.autograd.Function):
    """EncBlockFn's signature on the plain versions, on any device: the
    reference chip_smoke.py holds the kernel path against on the card. The
    port's own path never takes it."""

    @staticmethod
    def forward(ctx, *args):
        return _block_forward(ctx, True, ENC_OPS, args[:-1], args[-1])

    @staticmethod
    def backward(ctx, g, *_):
        return _block_backward(ctx, True, g)


class DecBlockFn(torch.autograd.Function):
    """Fused BasicBlockDec in training: (x, w2, g2, b2, w1, c1b, g1, b1, ws,
    csb, gs, bs, mask, stride) -> (out, st2, st1, sts) with the fused
    backward; weights as EncBlockFn's, ws ``[3, C_in, C_out]``.

    CUDA tensors launch csrc/dec_block.cu; CPU tensors take the plain versions.
    """

    @staticmethod
    def forward(ctx, x, *args):
        return _block_forward(ctx, x.device.type == "cpu", DEC_OPS, (x, *args[:-1]), args[-1])

    @staticmethod
    def backward(ctx, g, *_):
        return _block_backward(ctx, g.device.type == "cpu", g)


class PlainDecBlockFn(torch.autograd.Function):
    """DecBlockFn's signature on the plain versions, on any device: the
    reference chip_smoke.py holds the kernel path against on the card. The
    port's own path never takes it."""

    @staticmethod
    def forward(ctx, *args):
        return _block_forward(ctx, True, DEC_OPS, args[:-1], args[-1])

    @staticmethod
    def backward(ctx, g, *_):
        return _block_backward(ctx, True, g)


def mask_column(mask: Optional[torch.Tensor], batch: int, device) -> torch.Tensor:
    """The [B, 1] float32 mask column the kernels take (ones without a mask)."""
    if mask is None:
        return torch.ones((batch, 1), dtype=torch.float32, device=device)
    return mask.to(torch.float32).reshape(batch, 1).contiguous()


@torch.no_grad()
def _ema(bn, st, n):
    """torch's running-stat update: the unbiased variance with divisor
    max(n - 1, 1) goes into the average (pallas_blocks.py:697-705)."""
    m = bn.momentum
    bn.running_mean.copy_((1 - m) * bn.running_mean + m * st[0])
    bn.running_var.copy_((1 - m) * bn.running_var + m * (st[1] * (n / torch.clamp(n - 1.0, min=1.0))))
    bn.num_batches_tracked.add_(1)


def enc_block_apply(fn, block, x, mask_col):
    """Run ``fn`` (an autograd Function with EncBlockFn's signature) as the
    training forward of the port's ``BasicBlockEnc`` on x bf16 [L,B,C], and
    update the block's BatchNorm buffers in place. Returns the block output."""
    stride = block.stride
    w = [None if c is None else c.weight.permute(2, 1, 0)  # [Co,Ci,K] -> [K,Ci,Co]
         for c in (block.conv1, block.conv2, block.shortcut[0] if stride != 1 else None)]
    bns = (block.shortcut[1],) if stride != 1 else ()
    gs, bs = (bns[0].weight, bns[0].bias) if bns else (None, None)
    out, st1, st2, sts = fn.apply(
        x, w[0], block.bn1.weight, block.bn1.bias, w[1], block.bn2.weight, block.bn2.bias,
        w[2], gs, bs, mask_col, stride,
    )
    n = mask_col.sum() * out.shape[0]
    _ema(block.bn1, st1, n)
    _ema(block.bn2, st2, n)
    if bns:
        _ema(bns[0], sts, n)
    return out


def basic_block_enc_fused(block, x, mask=None):
    """Training-mode fused BasicBlockEnc (pallas_blocks.basic_block_enc_fused):
    x bf16 [L,B,C] -> bf16 [Lo,B,Co]; the BN buffers update in place."""
    return enc_block_apply(EncBlockFn, block, x, mask_column(mask, x.shape[1], x.device))


def dec_block_apply(fn, block, x, mask_col):
    """Run ``fn`` (an autograd Function with DecBlockFn's signature) as the
    training forward of the port's ``BasicBlockDec`` on x bf16 [Lin,B,C], and
    update the block's BatchNorm buffers in place: bn2 with the count at the
    input length, bn1 and the shortcut's at the output length
    (pallas_blocks.py:768-777). Returns the block output."""
    stride = block.stride
    perm = lambda w: w.permute(2, 1, 0)  # noqa: E731  [Co,Ci,K] -> [K,Ci,Co]
    if stride != 1:
        conv1, short, bns = block.conv1.conv, block.shortcut[0].conv, block.shortcut[1]
        w1, c1b, ws, csb = perm(conv1.weight), conv1.bias, perm(short.weight), short.bias
        gs, bs = bns.weight, bns.bias
    else:
        w1, c1b, ws, csb, gs, bs = perm(block.conv1.weight), None, None, None, None, None
    out, st2, st1, sts = fn.apply(
        x, perm(block.conv2.weight), block.bn2.weight, block.bn2.bias, w1, c1b,
        block.bn1.weight, block.bn1.bias, ws, csb, gs, bs, mask_col, stride,
    )
    count = mask_col.sum()
    n1 = count * out.shape[0]
    _ema(block.bn2, st2, count * x.shape[0])
    _ema(block.bn1, st1, n1)
    if stride != 1:
        _ema(bns, sts, n1)
    return out


def basic_block_dec_fused(block, x, mask=None):
    """Training-mode fused BasicBlockDec (pallas_blocks.basic_block_dec_fused):
    x bf16 [Lin,B,C] -> bf16 [stride*Lin,B,C/stride]; the BN buffers update in
    place."""
    return dec_block_apply(DecBlockFn, block, x, mask_column(mask, x.shape[1], x.device))
