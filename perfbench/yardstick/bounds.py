"""The least time of the step's hand-written kernels on the H100: the
yardstick of ``block_roofline.train``.

Each bound is the larger of the kernel's operations over the peak rate and
its bytes over the memory bandwidth, with each input read once and each
output written once (the fused blocks' GEMMs at the bf16 tensor-core peak,
the loss's arithmetic at the float32 peak). A block's backward recomputes
the forward and then forms the input's and the weights' gradients: 3x the
forward's products. These are frozen copies of the arithmetic the port's
kernel checks use; ``block_calls`` reads the shapes from the published
architecture, never from the program.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench.reference.cvae import DEC_STAGES, ENC_PLANES, ENC_STRIDES, Arch, _dec_block_strides
from perfbench.yardstick.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, PEAK_F32_FLOPS


def _bound(nbytes: float, ops: float, peak: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def enc_block_bounds(stride, L, ci, co, b):
    """Least ms of one encoder block's forward and backward on ``[L, b, ci]``."""
    lo = L if stride == 1 else (L - 1) // 2 + 1
    short = stride != 1
    wts = 3 * ci * co + 3 * co * co + (ci * co if short else 0)
    nvec = 4 + (2 if short else 0)  # gammas and betas
    fwd_ops = 2 * lo * b * wts
    x_b, y_b = 2 * L * b * ci, 2 * lo * b * co
    common = x_b + 2 * wts + 4 * nvec * co + 4 * b
    fwd_bytes = common + y_b + 4 * 9 * co
    bwd_bytes = common + 4 * 9 * co + y_b + x_b + 4 * wts + 4 * nvec * co
    return {"enc_block_fwd": _bound(fwd_bytes, fwd_ops, PEAK_BF16_FLOPS),
            "enc_block_bwd": _bound(bwd_bytes, 3 * fwd_ops, PEAK_BF16_FLOPS)}


def dec_block_bounds(stride, L, ci, co, b):
    """As enc_block_bounds for a decoder block, each conv counted at its own
    length: conv2 at L_in, conv1 and the shortcut's conv at L_out = stride *
    L_in (on the upsampled input)."""
    lo = L * stride
    short = stride != 1
    fwd_ops = 2 * b * (L * 3 * ci * ci + lo * 3 * ci * co * (2 if short else 1))
    wts = 3 * ci * ci + 3 * ci * co * (2 if short else 1)
    vecs = 2 * ci + (6 if short else 2) * co  # gammas, betas and conv biases
    x_b, y_b = 2 * L * b * ci, 2 * lo * b * co
    stats = 4 * 3 * (ci + 2 * co)
    common = x_b + 2 * wts + 4 * vecs + 4 * b
    fwd_bytes = common + y_b + stats
    bwd_bytes = common + stats + y_b + x_b + 4 * wts + 4 * vecs
    return {"dec_block_fwd": _bound(fwd_bytes, fwd_ops, PEAK_BF16_FLOPS),
            "dec_block_bwd": _bound(bwd_bytes, 3 * fwd_ops, PEAK_BF16_FLOPS)}


STEP_GRADS = (False, True, True, True)  # the train step's loss backward: ddec, dmu, dlogvar (no ddata)


def vae_sums_bounds(b: int, l: int, z: int, want=STEP_GRADS):
    """Least ms of the loss forward and of the backward that writes the
    gradients ``want`` flags (ddata, ddec, dmu, dlogvar)."""
    f4 = 4
    in_bytes = f4 * (2 * b * l + 2 * b * z + b)
    fwd_bytes = in_bytes + f4 * 2
    bwd_bytes = in_bytes + f4 * 2 + f4 * sum(n for n, w in zip((b * l, b * l, b * z, b * z), want) if w)
    fwd_ops = 4 * b * l + 9 * b * z  # sub, square, mask, add; the KL's 8 ops and an exp
    bwd_ops = (3 * b * l if want[0] or want[1] else 0) + b * l * (want[0] + want[1]) \
        + 3 * b * z * want[2] + 5 * b * z * want[3]  # d = (dec - data) * m, one product per output
    return {"vae_sums_fwd": _bound(fwd_bytes, fwd_ops, PEAK_F32_FLOPS),
            "vae_sums_bwd": _bound(bwd_bytes, bwd_ops, PEAK_F32_FLOPS)}


def masked_sse_bound(b: int, l: int):
    """Least ms of the masked-SSE forward: data and dec ``[b, l]`` and the
    mask read once, one float written, against 4 float32 operations per element."""
    return _bound(4 * (2 * b * l + b + 1), 4 * b * l, PEAK_F32_FLOPS)


Block = Tuple[str, int, int, int, int]  # (kind, stride, L_in, C_in, C_out)


def encoder_blocks(arch: Arch, length: int) -> List[Block]:
    out, L, c = [], (length - 1) // 2 + 1, 64
    for si, (planes, stride) in enumerate(zip(ENC_PLANES, ENC_STRIDES), start=1):
        for bi in range(arch.num_blocks[si - 1]):
            s = stride if bi == 0 else 1
            out.append(("enc", s, L, c, planes))
            c, L = planes, (L - 1) // s + 1
    return out


def decoder_blocks(arch: Arch) -> List[Block]:
    out, L, c = [], 4, 512
    for stage, stride in DEC_STAGES:
        for s in _dec_block_strides(arch, stage, stride):
            out.append(("dec", s, L, c, c // s))
            c, L = c // s, L * s
    return out


def block_calls(arch: Arch) -> List[Block]:
    """Every fused block a training step runs (forward and backward each)."""
    if not arch.multimodal:
        return encoder_blocks(arch, arch.wave_len) + decoder_blocks(arch)
    return (encoder_blocks(arch, arch.wave_len) + encoder_blocks(arch, arch.isi_len)
            + decoder_blocks(arch) + decoder_blocks(arch))


def block_step_ms(arch: Arch, batch: int) -> float:
    """The least ms of one step's block kernels: the sum over its block
    calls of each forward's and backward's bound."""
    total = 0.0
    for kind, s, L, ci, co in block_calls(arch):
        fn = enc_block_bounds if kind == "enc" else dec_block_bounds
        total += sum(ms for ms, _ in fn(s, L, ci, co, batch).values())
    return total
