"""The frozen yardstick (perfbench/yardstick/) on the CPU.

(a) The train step's FLOP count against ``torch.utils.flop_counter.
FlopCounterMode`` over the plain reference's forward and backward at the
published widths: autograd runs every product the count holds but the
stem convolutions' input gradients (their input needs none), so the
counter reads the count less one stem forward per encoder, exactly.
(b) The copied kernel bounds equal the port's kernel checks' (chip_smoke.py)
at the bench's shapes; chip_smoke is imported here only, never by the
harness. (c) The counts at the published widths, as PERF.md quotes them.
"""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.harness import weights
from perfbench.reference import cvae
from perfbench.reference.numerics import Numerics
from perfbench.yardstick import bounds, flops

WAVE = cvae.Arch(False, 10, 5, 5, 5, (2, 2, 2, 2), 50, 100)
JOINT = cvae.Arch(True, 10, 5, 5, 5, (2, 2, 2, 2), 50, 100)


def _stem(arch, length):
    return 2 * ((length - 1) // 2 + 1) * 64 * 3


@pytest.mark.parametrize("arch", [WAVE, JOINT], ids=["wave", "joint"])
def test_step_count_against_flop_counter(arch):
    b = 4
    sd = weights.make_state_dict(arch, 1, "cpu")
    trained = set(cvae.trained_keys(arch))
    P = {k: (v.clone().requires_grad_(True) if k in trained else v.clone()) for k, v in sd.items()}
    g = torch.Generator().manual_seed(0)
    inputs = (torch.randn(b, 50, generator=g),) + ((torch.randn(b, 100, generator=g),) if arch.multimodal else ())
    src, eps = torch.randint(0, 5, (b,), generator=g), torch.randn(b, 10, generator=g)
    with FlopCounterMode(display=False) as counter:
        loss = cvae.loss(inputs, cvae.forward(P, arch, inputs, src, eps, Numerics()), 1.0)
        loss.backward()
    stems = _stem(arch, arch.wave_len) + (_stem(arch, arch.isi_len) if arch.multimodal else 0)
    assert counter.get_total_flops() == flops.step_flops(arch, b) - b * stems


def test_published_counts():
    assert flops.step_flops(WAVE, 512) == 151_427_702_784  # the port's utils/flops.py at bench.py's shapes
    assert flops.step_flops(JOINT, 512) == 353_159_454_720
    assert flops.embed_flops(JOINT, 1) == 113_416_672


def test_bounds_equal_the_kernel_checks():
    cs = pytest.importorskip("chip_smoke")
    for stride, L, ci, co in cs.ENC_BLOCKS + tuple(b[1:] for b in bounds.encoder_blocks(JOINT, 100)):
        assert bounds.enc_block_bounds(stride, L, ci, co, 512) == cs.enc_block_bounds(stride, L, ci, co)
    for stride, L, ci, co in cs.DEC_BLOCKS:
        assert bounds.dec_block_bounds(stride, L, ci, co, 512) == cs.dec_block_bounds(stride, L, ci, co)
    for length in (50, 100):
        assert bounds.vae_sums_bounds(512, length, 10) == cs.vae_sums_bounds(512, length, 10)
        assert bounds.masked_sse_bound(512, length) == cs.masked_sse_bound(512, length)
    assert [b[1:] for b in bounds.encoder_blocks(WAVE, 50)] == list(cs.ENC_BLOCKS)
    assert [b[1:] for b in bounds.decoder_blocks(WAVE)] == list(cs.DEC_BLOCKS)
    assert len(bounds.block_calls(JOINT)) == 2 * len(bounds.block_calls(WAVE))
