"""The port's CUDA kernels on the card: the fused VAE-loss and masked-SSE
kernels (hippie_tpu_torch/csrc/vae_sums.cu) and the encoder and decoder block
kernels (hippie_tpu_torch/csrc/enc_block.cu, dec_block.cu).

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither jax nor hippie_tpu, so it also runs where only the port is
installed; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

The block kernels, all on the wgmma core, are also held at batches that are
not multiples of 64 (B = 100 and B = 1), where a 64-row tile spans several
positions, repeat bit for bit on one stream and across two, and issue at
most 5 (enc_block_fwd, dec_block_fwd) or 8 (enc_block_bwd, dec_block_bwd)
CUDA launches per call; the loss kernels' forwards are one CUDA launch each
and repeat bit for bit across two streams. A stage fit cut and resumed on
the card equals the uninterrupted one, and one step of each of the "fused"
and "bf16" block backends runs on the card without a block kernel, and the
replica-plan device fit of the full-width cVAE equals the host fit. The
server's, the artifact's and the clustering iterations' CUDA graphs replay
equal to the same programs run eagerly on the card, bit for bit, and a
capture that fails raises.
Tolerances of the VAE-loss and
masked-SSE kernels: values rtol 4e-6 (two
summation orders of up to 51,200 nonnegative float32 terms, each within about
1e-6 of the exact sum); gradients rtol 1e-5 / atol 1e-7 (elementwise, as
tests/test_pallas.py). The loss backward writes only the gradients it is
asked for: each of the 15 patterns is held to the plain version at B = 512,
a 415-row tail with +-1e4 and +-inf pads, B = 100, B = 1 and arrays 4
bytes off a 16-byte boundary, and replays from a CUDA graph behind the
kernel that writes its g.
"""

import itertools
import shutil

import numpy as np
import pytest
import torch

from hippie_tpu_torch.ops import cuda_ops

torch.set_num_threads(1)

B, L, Z = 512, 50, 10
CASES = {"full": (B, None), "tail": (415, None), "one_row": (1, 1e7), "one_row_inf": (1, np.inf)}


@pytest.fixture(autouse=True)
def _free_tmp_path(tmp_path):
    """Remove what the test wrote: its checkpoints are tens of MB each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 3 runs these checks on the card")
    return torch.device("cuda")


def _device_launches(fn) -> int:
    """CUDA kernels and memsets of one call of ``fn`` (after a warm-up call).
    The tracer sometimes drops a whole call's device events: a trace with
    none is taken again, up to 5 times (chip_smoke.device_profile does the
    same)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return 0


def _inputs(device, n_real=B, pad=None, seed=0):
    r = np.random.default_rng(seed)
    data = r.normal(size=(B, L)).astype(np.float32)
    dec = r.normal(size=(B, L)).astype(np.float32)
    mu = r.normal(size=(B, Z)).astype(np.float32)
    logvar = (r.normal(size=(B, Z)) * 0.3).astype(np.float32)
    mask = (np.arange(B) < n_real).astype(np.float32).reshape(B, 1)
    if pad is not None:  # padded rows blown up: exp(logvar) overflows
        dec[n_real:] = pad
        mu[n_real:] = -pad
        logvar[n_real:] = pad
    return tuple(torch.from_numpy(x).to(device) for x in (data, dec, mu, logvar, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda_device, case):
    x = _inputs(cuda_device, *CASES[case])
    got = cuda_ops.vae_sums_fwd_cuda(*x)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, cuda_ops.vae_sums_plain(*x), rtol=4e-6, atol=0)
    g = torch.tensor([0.37, -1.3], device=cuda_device)
    for a, b in zip(cuda_ops.vae_sums_bwd_cuda(*x, g), cuda_ops.vae_sums_bwd_plain(*x, g)):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    torch.cuda.synchronize()


BWD_CASES = {"B512": (512, 512, None), "tail415_pad1e4": (512, 415, 1e4), "tail415_padinf": (512, 415, np.inf),
             "B100": (100, 100, None), "B1": (1, 1, None), "offset": (100, 77, np.inf)}
WANTS = [w for w in itertools.product((False, True), repeat=4) if any(w)]


def _bwd_inputs(device, case):
    """(data, dec, mu, logvar, mask, g) of a backward case; "offset" puts
    every array 4 bytes past a 16-byte boundary (the single-float path)."""
    b, n_real, pad = BWD_CASES[case]
    r = np.random.default_rng(b + n_real)
    arrays = [r.normal(size=(b, c)).astype(np.float32) for c in (L, L, Z, Z)]
    arrays[3] *= 0.3
    if pad is not None:
        sign = np.where(r.random((b - n_real, 1)) < 0.5, 1.0, -1.0).astype(np.float32)
        for a in arrays[1:]:
            a[n_real:] = pad * sign
    x = [torch.from_numpy(a).to(device) for a in arrays]
    if case == "offset":
        x = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape) for t in x]
    mask = torch.from_numpy((np.arange(b) < n_real).astype(np.float32).reshape(b, 1)).to(device)
    g = torch.tensor([1.0 / (n_real * L), 0.7 / n_real], device=device)
    return (*x, mask, g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernel_matches_plain_for_every_flag_pattern(cuda_device, case):
    """vae_sums_bwd writes the gradients asked for, each within the
    gradients' tolerance of the plain version and the same bits on a
    repeat, in one launch, and returns None for the others."""
    x = _bwd_inputs(cuda_device, case)
    for want in WANTS:
        cuda_ops.reset_launches()
        got = cuda_ops.vae_sums_bwd_cuda(*x, want=want)
        again = cuda_ops.vae_sums_bwd_cuda(*x, want=want)
        assert cuda_ops.launches["vae_sums_bwd"] == 2
        ref = cuda_ops.vae_sums_bwd_plain(*x, want=want)
        for a, b, c, w in zip(got, ref, again, want):
            assert (a is None) == (b is None) == (c is None) == (not w)
            if w:
                assert torch.isfinite(a).all()
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
                assert torch.equal(a, c)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("want", [(False, True, True, True), (True, True, True, True)], ids=["step", "all"])
def test_bwd_kernel_replays_bit_for_bit_behind_its_predecessor(cuda_device, want):
    """The backward captured behind the kernel that writes its g (as in a
    step's backward) and replayed: the same bits as the eager call, over 20
    replays."""
    x = _bwd_inputs(cuda_device, "tail415_padinf")
    g0 = x[-1]

    def fn():
        g = g0 * 1.0  # the predecessor, whose output the backward reads
        return [t for t in cuda_ops.vae_sums_bwd_cuda(*x[:-1], g, want=want) if t is not None]

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        eager = [t.clone() for t in fn()]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            out = fn()
        for _ in range(20):
            for t in out:
                t.fill_(float("nan"))
            graph.replay()
            s.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, eager))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(cuda_device):
    x = _inputs(cuda_device, n_real=415)
    runs = [cuda_ops.vae_sums_fwd_cuda(*x) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit_across_streams(cuda_device):
    x = _inputs(cuda_device, n_real=415, pad=np.inf)
    first = cuda_ops.vae_sums_fwd_cuda(*x)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for s in streams:  # each stream takes its own workspace
        with torch.cuda.stream(s):
            outs += [cuda_ops.vae_sums_fwd_cuda(*x) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    keys = [("vae_sums_fwd", cuda_device.index or 0, s.cuda_stream) for s in streams]
    assert all(k in cuda_ops._workspaces for k in keys)
    assert cuda_ops._workspaces[keys[0]][1].data_ptr() != cuda_ops._workspaces[keys[1]][1].data_ptr()


@pytest.mark.cuda
def test_forward_kernels_are_one_launch(cuda_device):
    x = _inputs(cuda_device, n_real=415)
    sse = _sse_inputs(cuda_device, n_real=415)
    assert _device_launches(lambda: cuda_ops.vae_sums_fwd_cuda(*x)) == 1
    assert _device_launches(lambda: cuda_ops.masked_sse_fwd_cuda(*sse)) == 1


@pytest.mark.cuda
def test_autograd_launches_both_kernels(cuda_device):
    data, dec, mu, logvar, mask = _inputs(cuda_device, n_real=300)
    leaves = [t.clone().requires_grad_(True) for t in (dec, mu, logvar)]
    cuda_ops.reset_launches()
    total, _ = cuda_ops.vae_loss_pallas(data, *leaves, beta=0.5, mask=mask[:, 0])
    total.backward()
    assert cuda_ops.launches == {"vae_sums_fwd": 1, "vae_sums_bwd": 1, "masked_sse_fwd": 0}
    ref = [t.clone().requires_grad_(True) for t in (dec, mu, logvar)]
    sse, kl = cuda_ops.vae_sums_plain(data, *ref, mask).unbind(0)
    (sse / (300 * L) + 0.5 * kl / 300).backward()
    torch.testing.assert_close(total, sse / (300 * L) + 0.5 * kl / 300, rtol=4e-6, atol=0)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    data, dec, mu, logvar, mask = _inputs(cuda_device)
    with pytest.raises(TypeError):
        cuda_ops.fused_vae_sums(data, dec.double(), mu, logvar, mask)
    with pytest.raises(ValueError):
        cuda_ops.fused_vae_sums(data, dec, mu.cpu(), logvar, mask)


# ---------------------------------------------------------------------------
# The masked-SSE kernel (csrc/vae_sums.cu masked_sse), the joint model's
# second modality: [B, 100].
# ---------------------------------------------------------------------------

SSE_L = 100


def _sse_inputs(device, n_real=B, pad=None, seed=0):
    r = np.random.default_rng(seed)
    data = r.normal(size=(B, SSE_L)).astype(np.float32)
    dec = r.normal(size=(B, SSE_L)).astype(np.float32)
    if pad is not None:
        dec[n_real:] = pad
    mask = (np.arange(B) < n_real).astype(np.float32).reshape(B, 1)
    return tuple(torch.from_numpy(x).to(device) for x in (data, dec, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full", "tail_inf"])
def test_masked_sse_kernel_matches_plain(cuda_device, case):
    x = _sse_inputs(cuda_device, *((B, None) if case == "full" else (415, np.inf)))
    got = cuda_ops.masked_sse_fwd_cuda(*x)
    assert got.shape == () and torch.isfinite(got)
    torch.testing.assert_close(got, cuda_ops.masked_sse_plain(*x), rtol=4e-6, atol=0)


@pytest.mark.cuda
def test_masked_sse_kernel_repeats_bit_for_bit(cuda_device):
    x = _sse_inputs(cuda_device, n_real=415, pad=1e4)
    runs = [cuda_ops.masked_sse_fwd_cuda(*x) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)


@pytest.mark.cuda
def test_masked_sse_kernel_repeats_bit_for_bit_across_streams(cuda_device):
    x = _sse_inputs(cuda_device, n_real=415, pad=np.inf)
    first = cuda_ops.masked_sse_fwd_cuda(*x)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for s in streams:  # each stream takes its own workspace
        with torch.cuda.stream(s):
            outs += [cuda_ops.masked_sse_fwd_cuda(*x) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    keys = [("masked_sse_fwd", cuda_device.index or 0, s.cuda_stream) for s in streams]
    assert all(k in cuda_ops._workspaces for k in keys)
    assert cuda_ops._workspaces[keys[0]][1].data_ptr() != cuda_ops._workspaces[keys[1]][1].data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "non_contiguous"])
def test_masked_sse_kernel_raises_on_what_it_does_not_take(cuda_device, bad):
    data, dec, mask = _sse_inputs(cuda_device)
    if bad == "float64":
        with pytest.raises(TypeError):
            cuda_ops.masked_sse_fwd_cuda(data, dec.double(), mask)
    else:
        with pytest.raises(ValueError):
            cuda_ops.masked_sse_fwd_cuda(data, dec.t().contiguous().t(), mask)


@pytest.mark.cuda
def test_masked_sse_autograd_launches_once(cuda_device):
    data, dec, mask = _sse_inputs(cuda_device, n_real=300, pad=np.inf)
    leaf = dec.clone().requires_grad_(True)
    cuda_ops.reset_launches()
    total = cuda_ops.fused_masked_sse(data, leaf, mask)
    (0.37 * total).backward()
    assert cuda_ops.launches == {"vae_sums_fwd": 0, "vae_sums_bwd": 0, "masked_sse_fwd": 1}
    ref = dec.clone().requires_grad_(True)
    (0.37 * cuda_ops.masked_sse_plain(data, ref, mask)).backward()
    assert torch.isfinite(leaf.grad).all()
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_masked_sse_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    data, dec, mask = _sse_inputs(cuda_device)
    with pytest.raises(TypeError):
        cuda_ops.fused_masked_sse(data, dec.double(), mask)
    with pytest.raises(ValueError):
        cuda_ops.fused_masked_sse(data, dec[:, :50], mask)
    with pytest.raises(ValueError):
        cuda_ops.fused_masked_sse(data, dec.t().contiguous().t(), mask)


# ---------------------------------------------------------------------------
# The encoder block kernels (hippie_tpu_torch/csrc/enc_block.cu).
# Limits as chip_smoke.py's phase 5b, with their reasons there: bf16 outputs
# and float32 gradients relative Frobenius 1e-2, statistics 1e-4 of their
# scale; the two versions differ only in the order of float32 sums.
# ---------------------------------------------------------------------------

ENC_SHAPES = [(1, 25, 64, 64), (2, 25, 64, 128), (1, 13, 128, 128), (2, 13, 128, 256),
              (1, 7, 256, 256), (2, 7, 256, 512), (1, 4, 512, 512)]  # (stride, L, C_in, C_out)
# the ISI encoder's (input length 100) shapes that the waveform encoder's lack
ISI_ENC_SHAPES = [(1, 50, 64, 64), (2, 50, 64, 128), (1, 7, 512, 512)]


def _block_inputs(device, stride, L, ci, co, n_real=B, seed=0, batch=B):
    r = np.random.default_rng(seed)
    lo = L if stride == 1 else (L - 1) // 2 + 1

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    x = r.normal(size=(L, batch, ci))
    x[:, n_real:] = 1e4
    bf = torch.bfloat16
    args = [t(x, bf), t(r.normal(size=(3, ci, co)) / np.sqrt(3 * ci), bf), t(r.uniform(0.5, 1.5, co)),
            t(0.1 * r.normal(size=co)), t(r.normal(size=(3, co, co)) / np.sqrt(3 * co), bf),
            t(r.uniform(0.5, 1.5, co)), t(0.1 * r.normal(size=co))]
    if stride != 1:
        args += [t(r.normal(size=(1, ci, co)) / np.sqrt(ci), bf), t(r.uniform(0.5, 1.5, co)),
                 t(0.1 * r.normal(size=co))]
    else:
        args += [None, None, None]
    args.append(t((np.arange(batch) < n_real).reshape(batch, 1)))
    return args, t(r.normal(size=(lo, batch, co)), bf)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ENC_SHAPES + ISI_ENC_SHAPES, ids=lambda s: "s{}-L{}-{}-{}".format(*s))
def test_enc_block_kernels_match_plain(cuda_device, shape):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    stride = shape[0]
    args, g = _block_inputs(cuda_device, *shape, n_real=415)
    got = cb.enc_block_fwd_cuda(stride, *args)
    ref = cb.enc_block_fwd_plain(stride, stride != 1, *args)
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0][:, :415], ref[0][:, :415]) < 1e-2
    for a, b in zip(got[1:], ref[1:]):
        scale = torch.stack([b[0].abs() + b[1].sqrt(), b[1].abs(), b[2].abs()])
        assert ((a - b).abs() <= 1e-4 * scale).all()
    dgot = cb.enc_block_bwd_cuda(stride, *args, *got[1:], g)
    dref = cb.enc_block_bwd_plain(stride, stride != 1, *args, *got[1:], g)
    for a, b in zip(dgot, dref):
        if a is not None:
            assert torch.isfinite(a).all()
            assert _rel(a, b) < 1e-2
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_enc_block_kernels_repeat_bit_for_bit(cuda_device):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _block_inputs(cuda_device, 2, 13, 128, 256, n_real=300, seed=1)
    fwd = [cb.enc_block_fwd_cuda(2, *args) for _ in range(3)]
    bwd = [cb.enc_block_bwd_cuda(2, *args, *fwd[0][1:], g) for _ in range(3)]
    for runs in (fwd, bwd):
        assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))


# batches that are not multiples of 64 (a tile's rows span several positions)
ODD_BATCHES = [(100, 70), (1, 1)]  # (B, real rows)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ODD_BATCHES, ids=lambda b: f"B{b[0]}")
@pytest.mark.parametrize("shape", [(1, 13, 128, 128), (2, 13, 128, 256)], ids=["s1", "s2"])
def test_enc_block_bwd_matches_plain_at_odd_batches(cuda_device, shape, batch):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    stride = shape[0]
    args, g = _block_inputs(cuda_device, *shape, n_real=batch[1], seed=2, batch=batch[0])
    st = cb.enc_block_fwd_cuda(stride, *args)[1:]
    dgot = cb.enc_block_bwd_cuda(stride, *args, *st, g)
    dref = cb.enc_block_bwd_plain(stride, stride != 1, *args, *st, g)
    for a, b in zip(dgot, dref):
        if a is None:
            assert stride == 1 and not b.any()
        else:
            assert torch.isfinite(a).all() and _rel(a, b) < 1e-2
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_enc_block_bwd_repeats_bit_for_bit_at_an_odd_batch(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _block_inputs(cuda_device, stride, 13, 128, 256 if stride == 2 else 128, n_real=70, seed=3,
                            batch=100)
    st = cb.enc_block_fwd_cuda(stride, *args)[1:]
    runs = [cb.enc_block_bwd_cuda(stride, *args, *st, g) for _ in range(3)]
    assert all(a is None or torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_enc_block_bwd_launches_at_most_8_kernels(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _block_inputs(cuda_device, stride, 7, 256, 256 * stride)
    st = cb.enc_block_fwd_cuda(stride, *args)[1:]
    assert 0 < _device_launches(lambda: cb.enc_block_bwd_cuda(stride, *args, *st, g)) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_enc_block_fwd_launches_at_most_5_kernels(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, _ = _block_inputs(cuda_device, stride, 7, 256, 256 * stride)
    assert 0 < _device_launches(lambda: cb.enc_block_fwd_cuda(stride, *args)) <= 5


def _stats_ok(a, b):
    scale = torch.stack([b[0].abs() + b[1].sqrt(), b[1].abs(), b[2].abs()])
    return bool(((a - b).abs() <= 1e-4 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ODD_BATCHES, ids=lambda b: f"B{b[0]}")
@pytest.mark.parametrize("shape", [(1, 13, 128, 128), (2, 13, 128, 256)], ids=["s1", "s2"])
def test_enc_block_fwd_matches_plain_at_odd_batches(cuda_device, shape, batch):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    stride, n_real = shape[0], batch[1]
    args, _ = _block_inputs(cuda_device, *shape, n_real=n_real, seed=2, batch=batch[0])
    got = cb.enc_block_fwd_cuda(stride, *args)
    ref = cb.enc_block_fwd_plain(stride, stride != 1, *args)
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0][:, :n_real], ref[0][:, :n_real]) < 1e-2
    assert all(_stats_ok(a, b) for a, b in zip(got[1:], ref[1:]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_enc_block_fwd_repeats_bit_for_bit_across_streams(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, _ = _block_inputs(cuda_device, stride, 13, 128, 128 * stride, n_real=70, seed=3, batch=100)
    first = cb.enc_block_fwd_cuda(stride, *args)
    runs = [cb.enc_block_fwd_cuda(stride, *args) for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            runs += [cb.enc_block_fwd_cuda(stride, *args) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for r in runs for a, b in zip(r, first))


@pytest.mark.cuda
def test_enc_block_autograd_launches_both_kernels(cuda_device):
    from hippie_tpu_torch.models.backbones import BasicBlockEnc
    from hippie_tpu_torch.ops import cuda_blocks as cb

    torch.manual_seed(0)
    block = BasicBlockEnc(64, 2).to(cuda_device).train()
    x = torch.randn(25, B, 64, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    cb.reset_launches()
    out = cb.basic_block_enc_fused(block, x)
    out.float().sum().backward()
    assert cb.launches == {"enc_block_fwd": 1, "enc_block_bwd": 1, "dec_block_fwd": 0, "dec_block_bwd": 0}
    assert out.shape == (13, B, 128) and x.grad.dtype == torch.bfloat16
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in block.parameters())
    assert int(block.bn1.num_batches_tracked) == 1


@pytest.mark.cuda
def test_enc_block_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _block_inputs(cuda_device, 2, 13, 128, 256)
    with pytest.raises(TypeError):  # float32 activations
        cb.enc_block_fwd_cuda(2, args[0].float(), *args[1:])
    with pytest.raises(ValueError):  # weights of the wrong shape
        cb.enc_block_fwd_cuda(2, args[0], args[1][:, :64], *args[2:])
    with pytest.raises(ValueError):  # [B, L, C] handed over as a strided view
        cb.enc_block_fwd_cuda(2, args[0].transpose(0, 1).contiguous().transpose(0, 1), *args[1:])
    with pytest.raises(ValueError):  # a stride-1 block with a shortcut
        cb.enc_block_fwd_cuda(1, *args)


# ---------------------------------------------------------------------------
# The decoder block kernels (hippie_tpu_torch/csrc/dec_block.cu). Limits as
# chip_smoke.py's phase 5d: bf16 outputs and float32 gradients relative
# Frobenius 1e-2, statistics 1e-4 of their scale, and the conv biases'
# gradients (rounding noise in exact arithmetic) by dec_bias_grad_tol.
# ---------------------------------------------------------------------------

DEC_SHAPES = [(1, 4, 512, 512), (2, 4, 512, 256), (1, 8, 256, 256), (2, 8, 256, 128),
              (1, 16, 128, 128), (2, 16, 128, 64), (1, 32, 64, 64)]  # (stride, L_in, C_in, C_out)
DEC_GRADS = ("dx", "dw2", "dg2", "db2", "dw1", "dc1b", "dg1", "db1", "dws", "dcsb", "dgs", "dbs")


def _dec_inputs(device, stride, L, ci, co, n_real=B, seed=0, batch=B):
    r = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)

    x = r.normal(size=(L, batch, ci))
    x[:, n_real:] = 1e4
    bf = torch.bfloat16
    vec = lambda c: [t(r.uniform(0.5, 1.5, c)), t(0.1 * r.normal(size=c))]  # noqa: E731
    args = [t(x, bf), t(r.normal(size=(3, ci, ci)) / np.sqrt(3 * ci), bf), *vec(ci),
            t(r.normal(size=(3, ci, co)) / np.sqrt(3 * ci), bf)]
    args += [t(0.1 * r.normal(size=co)) if stride != 1 else None, *vec(co)]
    if stride != 1:
        args += [t(r.normal(size=(3, ci, co)) / np.sqrt(3 * ci), bf), t(0.1 * r.normal(size=co)), *vec(co)]
    else:
        args += [None] * 4
    args.append(t((np.arange(batch) < n_real).reshape(batch, 1)))
    return args, t(r.normal(size=(L * stride, batch, co)), bf)


def dec_bias_grad_tol(g, gamma, st, dgamma):
    """A conv bias's gradient before BatchNorm is -gamma * inv * dgamma *
    sum(m * xh) / n in exact arithmetic (rounding noise of the bf16 xh's
    mean): 1e-2 * |g| plus 1e-3 of |gamma * inv * dgamma|."""
    return float(1e-2 * g.double().norm() + 1e-3 * (gamma * st[2] * dgamma).double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DEC_SHAPES, ids=lambda s: "s{}-L{}-{}-{}".format(*s))
def test_dec_block_kernels_match_plain(cuda_device, shape):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    stride = shape[0]
    args, g = _dec_inputs(cuda_device, *shape, n_real=415)
    got = cb.dec_block_fwd_cuda(stride, *args)
    ref = cb.dec_block_fwd_plain(stride, *args)
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0][:, :415], ref[0][:, :415]) < 1e-2
    for a, b in zip(got[1:], ref[1:]):
        scale = torch.stack([b[0].abs() + b[1].sqrt(), b[1].abs(), b[2].abs()])
        assert ((a - b).abs() <= 1e-4 * scale).all()
    dgot = cb.dec_block_bwd_cuda(stride, *args, *got[1:], g)
    dref = cb.dec_block_bwd_plain(stride, *args, *got[1:], g)
    tol = {"dc1b": (args[6], got[2], dref[6]), "dcsb": (args[10], got[3], dref[10])}
    for name, a, b in zip(DEC_GRADS, dgot, dref):
        if a is None:
            assert stride == 1 and not b.any(), name
        elif name in tol:
            assert float((a - b).double().norm()) <= dec_bias_grad_tol(g, *tol[name]), name
        else:
            assert torch.isfinite(a).all() and _rel(a, b) < 1e-2, name
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dec_block_kernels_repeat_bit_for_bit(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _dec_inputs(cuda_device, stride, 8, 256, 256 // stride, n_real=300, seed=1)
    fwd = [cb.dec_block_fwd_cuda(stride, *args) for _ in range(3)]
    bwd = [cb.dec_block_bwd_cuda(stride, *args, *fwd[0][1:], g) for _ in range(3)]
    for runs in (fwd, bwd):
        assert all(a is None or torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))


def _check_dec_grads(args, g, st, dgot, dref, stride, real=slice(None)):
    tol = {"dc1b": (args[6], st[1], dref[6]), "dcsb": (args[10], st[2], dref[10])}
    for name, a, b in zip(DEC_GRADS, dgot, dref):
        if a is None:
            assert stride == 1 and not b.any(), name
        elif name in tol:
            assert float((a - b).double().norm()) <= dec_bias_grad_tol(g, *tol[name]), name
        else:
            assert torch.isfinite(a).all() and _rel(a, b) < 1e-2, name
    assert _rel(dgot[0][:, real], dref[0][:, real]) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ODD_BATCHES, ids=lambda b: f"B{b[0]}")
@pytest.mark.parametrize("shape", [(1, 8, 256, 256), (2, 8, 256, 128)], ids=["s1", "s2"])
def test_dec_block_bwd_matches_plain_at_odd_batches(cuda_device, shape, batch):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    stride = shape[0]
    args, g = _dec_inputs(cuda_device, *shape, n_real=batch[1], seed=2, batch=batch[0])
    st = cb.dec_block_fwd_cuda(stride, *args)[1:]
    dgot = cb.dec_block_bwd_cuda(stride, *args, *st, g)
    dref = cb.dec_block_bwd_plain(stride, *args, *st, g)
    _check_dec_grads(args, g, st, dgot, dref, stride, slice(0, batch[1]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dec_block_bwd_repeats_bit_for_bit_across_streams(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _dec_inputs(cuda_device, stride, 8, 256, 256 // stride, n_real=70, seed=3, batch=100)
    st = cb.dec_block_fwd_cuda(stride, *args)[1:]
    first = cb.dec_block_bwd_cuda(stride, *args, *st, g)
    runs = [cb.dec_block_bwd_cuda(stride, *args, *st, g) for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            runs += [cb.dec_block_bwd_cuda(stride, *args, *st, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(a is None or torch.equal(a, b) for r in runs for a, b in zip(r, first))


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dec_block_bwd_launches_at_most_8_kernels(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _dec_inputs(cuda_device, stride, 8, 256, 256 // stride)
    st = cb.dec_block_fwd_cuda(stride, *args)[1:]
    assert 0 < _device_launches(lambda: cb.dec_block_bwd_cuda(stride, *args, *st, g)) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ODD_BATCHES, ids=lambda b: f"B{b[0]}")
@pytest.mark.parametrize("shape", [(1, 8, 256, 256), (2, 8, 256, 128)], ids=["s1", "s2"])
def test_dec_block_fwd_matches_plain_at_odd_batches(cuda_device, shape, batch):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    stride, n_real = shape[0], batch[1]
    args, _ = _dec_inputs(cuda_device, *shape, n_real=n_real, seed=2, batch=batch[0])
    got = cb.dec_block_fwd_cuda(stride, *args)
    ref = cb.dec_block_fwd_plain(stride, *args)
    assert torch.isfinite(got[0]).all()
    assert _rel(got[0][:, :n_real], ref[0][:, :n_real]) < 1e-2
    assert all(_stats_ok(a, b) for a, b in zip(got[1:], ref[1:]))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dec_block_fwd_launches_at_most_5_kernels(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, _ = _dec_inputs(cuda_device, stride, 8, 256, 256 // stride)
    assert 0 < _device_launches(lambda: cb.dec_block_fwd_cuda(stride, *args)) <= 5


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_dec_block_fwd_repeats_bit_for_bit_across_streams(cuda_device, stride):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, _ = _dec_inputs(cuda_device, stride, 8, 256, 256 // stride, n_real=70, seed=3, batch=100)
    first = cb.dec_block_fwd_cuda(stride, *args)
    runs = [cb.dec_block_fwd_cuda(stride, *args) for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            runs += [cb.dec_block_fwd_cuda(stride, *args) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for r in runs for a, b in zip(r, first))


@pytest.mark.cuda
def test_dec_block_autograd_launches_both_kernels(cuda_device):
    from hippie_tpu_torch.models.backbones import BasicBlockDec
    from hippie_tpu_torch.ops import cuda_blocks as cb

    torch.manual_seed(0)
    block = BasicBlockDec(128, 2).to(cuda_device).train()
    x = torch.randn(8, B, 128, device=cuda_device).to(torch.bfloat16).requires_grad_(True)
    cb.reset_launches()
    out = cb.basic_block_dec_fused(block, x)
    out.float().sum().backward()
    assert cb.launches == {"enc_block_fwd": 0, "enc_block_bwd": 0, "dec_block_fwd": 1, "dec_block_bwd": 1}
    assert out.shape == (16, B, 64) and x.grad.dtype == torch.bfloat16
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in block.parameters())
    assert int(block.bn2.num_batches_tracked) == 1 == int(block.shortcut[1].num_batches_tracked)


@pytest.mark.cuda
def test_dec_block_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    args, g = _dec_inputs(cuda_device, 2, 8, 256, 128)
    with pytest.raises(TypeError):  # float32 activations
        cb.dec_block_fwd_cuda(2, args[0].float(), *args[1:])
    with pytest.raises(ValueError):  # a conv weight of the wrong shape
        cb.dec_block_fwd_cuda(2, args[0], args[1], args[2], args[3], args[4][:, :64], *args[5:])
    with pytest.raises(ValueError):  # an operand on the host
        cb.dec_block_fwd_cuda(2, *args[:12], args[12].cpu())
    with pytest.raises(ValueError):  # channels the tiles do not take
        cb.dec_block_fwd_cuda(2, *_dec_inputs(cuda_device, 2, 8, 96, 48)[0])
    with pytest.raises(ValueError):  # a stride-1 block with a shortcut
        cb.dec_block_fwd_cuda(1, *args)


# ---------------------------------------------------------------------------
# The unimodal pipeline's layers on the card: the KNN sweep and a stage fit
# ---------------------------------------------------------------------------


def _knn_data(kind: str):
    """(train_x, train_y, test_x): small integers, whose squared distances are
    exact in float32 on any device and tie often, or normal draws."""
    r = np.random.default_rng(4)
    if kind == "integer_ties":
        return (r.integers(-2, 3, size=(300, 6)).astype(np.float32), r.integers(0, 4, size=300),
                r.integers(-2, 3, size=(80, 6)).astype(np.float32))
    return (r.normal(size=(300, 10)).astype(np.float32), r.integers(0, 4, size=300),
            r.normal(size=(80, 10)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer_ties", "normal"])
def test_knn_sweep_on_the_card_equals_the_cpu(cuda_device, kind):
    """Every k of 5..19 predicts on the card exactly what it predicts on the
    CPU, ties included (stable sort: lower train index; argmax: lower class)."""
    from hippie_tpu_torch.evaluate import knn_eval

    train_x, train_y, test_x = _knn_data(kind)
    ks = list(range(5, 20))
    got = knn_eval.knn_predict_sweep(train_x, train_y, test_x, ks, device=cuda_device)
    ref = knn_eval.knn_predict_sweep(train_x, train_y, test_x, ks, device="cpu")
    for k in ks:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"k={k}")


@pytest.mark.cuda
def test_stage_fit_on_the_card_runs_the_kernels_and_writes_a_ckpt(cuda_device, tmp_path):
    """One stage fit (2 epochs, the small model) with the loss and block
    kernels: every kernel of the path launches, once per train step per
    block; the tracker's .ckpt reloads into a fresh model and optimizer equal
    bit for bit to the best snapshot."""
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.ops import cuda_blocks
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import optim, pipeline, step

    cfg = pipeline.PipelineConfig(device="cuda", loss_backend="pallas", block_backend="pallas",
                                  verbose=False, batch_size=32, checkpoint_dir=str(tmp_path),
                                  fit_loop="host")  # the wrappers' counters count its every launch
    cfg_m = cvae.CVAEConfig(z_dim=4, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
    model = cvae.unimodal_cvae_init(cfg_m, torch.Generator().manual_seed(0), device="cuda")
    ts = step.TrainState(model, optim.make_optimizer(model.parameters(), 1e-3, 0.01))
    r = np.random.default_rng(0)
    data = torch.from_numpy(r.normal(size=(90, 50)).astype(np.float32)).cuda()
    source = torch.from_numpy(r.integers(0, 5, size=90)).cuda()
    cuda_ops.reset_launches()
    cuda_blocks.reset_launches()
    result = pipeline.fit_unimodal_stage(
        cfg=cfg, ts=ts, data=data, source=source, class_=source, train_indices=np.arange(70),
        val_indices=np.arange(70, 90), batch_size=32, max_epochs=2, beta=1.0,
        use_class_labels=False, shuffle_train=True)
    steps = 2 * 3  # 2 epochs of 70 rows at B = 32
    assert result.epochs_run == 2 and all(np.isfinite(result.train_losses))
    assert {**cuda_ops.launches, **cuda_blocks.launches} == {
        "vae_sums_fwd": steps + 2, "vae_sums_bwd": steps, "masked_sse_fwd": 0,
        "enc_block_fwd": 4 * steps, "enc_block_bwd": 4 * steps,
        "dec_block_fwd": 4 * steps, "dec_block_bwd": 4 * steps}
    tracker = pipeline.BestTracker(str(tmp_path / "stage.ckpt"))
    assert tracker.update_from_fit(result, ckpt_mod.parameter_key_order(model), (1e-3, 0.01))
    tracker.flush()
    ck = ckpt_mod.load_lightning_ckpt(tracker.path)
    fresh = cvae.unimodal_cvae_init(cfg_m, torch.Generator().manual_seed(1), device="cuda")
    assert not ckpt_mod.load_model_state(fresh, ckpt_mod.model_state_from_ckpt(ck))
    opt = optim.make_optimizer(fresh.parameters(), 1e-3, 0.01)
    ckpt_mod.load_optimizer_state(opt, ck["optimizer_states"][0])
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, tracker.best_state_dict[k]), k
    for i, e in tracker.best_opt["state"].items():
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state_dict()["state"][i][m].to(e[m].device), e[m]), (i, m)


def _blobs(k: int, d: int, n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    centres = 6.0 * r.normal(size=(k, d))
    return (centres[r.integers(0, k, size=n)] + 0.5 * r.normal(size=(n, d))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["kmeans", "gmm"])
def test_clustering_on_the_card_equals_the_cpu(cuda_device, method):
    """The same seed on the card and on the host: the same draws (a CPU
    generator), so the same assignments on separated blobs; every float
    within 1e-4 of the host's (means of up to 2,000 rows of magnitude 10 to
    20, summed in another order on each device), the inertia and the
    log-likelihood rtol 1e-5."""
    from hippie_tpu_torch.ops import clustering

    x = _blobs(5, 20, 2000, 6)
    fn = getattr(clustering, method)
    got = [v.cpu() for v in fn(torch.from_numpy(x).to(cuda_device), 5, seed=3)]
    ref = fn(x, 5, seed=3, device="cpu")
    assert got[0].device.type == "cpu" and torch.equal(got[0], ref[0])
    for a, b in zip(got[1:-1], ref[1:-1]):
        assert (a - b).abs().max() <= 1e-4
    np.testing.assert_allclose(float(got[-1]), float(ref[-1]), rtol=1e-5)


@pytest.mark.cuda
def test_joint_pipeline_on_the_card_runs_every_kernel(cuda_device, tmp_path):
    """run_pipeline(model_type="multimodal") at num_blocks=(1, 1, 1, 1), one
    batch per stage, with the loss and block kernels: per train step one
    launch of each loss kernel and 8 of each block kernel (two encoders or
    two decoders of 4 blocks), per val step one vae_sums_fwd and one
    masked_sse_fwd; both .ckpt files reload equal bit for bit to their
    trackers' snapshots; 15 finite balanced accuracies."""
    from hippie_tpu_torch.ops import cuda_blocks
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import pipeline

    cfg = pipeline.PipelineConfig(model_type="multimodal", num_blocks=(1, 1, 1, 1), batch_size=64,
                                  supervised_batch_size=32, limit_train_batches=1, limit_val_batches=1,
                                  loss_backend="pallas", block_backend="pallas", verbose=False,
                                  output_dir=str(tmp_path / "out"), checkpoint_dir=str(tmp_path / "ckpt"))
    cuda_ops.reset_launches()
    cuda_blocks.reset_launches()
    trackers = {}
    results = pipeline.run_pipeline(cfg, trackers=trackers)
    train = val = 3  # one batch per stage
    assert {**cuda_ops.launches, **cuda_blocks.launches} == {
        "vae_sums_fwd": train + val, "vae_sums_bwd": train, "masked_sse_fwd": train + val,
        **{k: 8 * train for k in ("enc_block_fwd", "enc_block_bwd", "dec_block_fwd", "dec_block_bwd")}}
    accs = results["balanced_accuracy"]["joint"]
    assert len(accs) == 15 and np.isfinite(accs).all()
    for tracker in trackers.values():
        sd = ckpt_mod.model_state_from_ckpt(ckpt_mod.load_lightning_ckpt(tracker.path))
        assert list(sd) == list(tracker.best_state_dict)
        for k, v in tracker.best_state_dict.items():
            assert torch.equal(sd[k], v.cpu()), k


@pytest.mark.cuda
def test_host_fetch_on_a_side_stream_equals_cpu(cuda_device):
    """checkpoint.bulk_host_fetch / host_tree: every CUDA tensor of a dict
    (float32, int64, bfloat16, 0-d) in one copy on a side stream, equal to
    its ``.cpu()``, with the tensors made by work still queued on the default
    stream when the fetch starts; a later fetch reuses the pinned buffer, and
    the arrays it returned earlier are copies of their own."""
    from hippie_tpu_torch.train import checkpoint as ckpt_mod

    g = torch.Generator(device="cuda").manual_seed(0)
    big = torch.randn(4096, 4096, device=cuda_device, generator=g)
    flat = {"w": (big @ big)[:7, :5], "conv": torch.randn(3, 4, 5, device=cuda_device, generator=g),
            "nbt": torch.tensor(123457, device=cuda_device), "m": torch.randn(
                33, device=cuda_device, generator=g).to(torch.bfloat16), "s": big.sum(),
            "host": torch.arange(3), "np": np.ones(2, np.float32)}
    times = {}
    got = ckpt_mod.bulk_host_fetch(flat, times=times)
    assert set(times) == {"pin_s", "copy_s", "split_s"}
    buf = ckpt_mod._pinned
    assert buf.is_pinned() and buf.numel() >= sum(v.numel() for v in flat.values()
                                                  if isinstance(v, torch.Tensor) and v.is_cuda)
    # reuses the pinned buffer, overwriting its start: ``got`` below is unchanged
    again = ckpt_mod.bulk_host_fetch({"conv": -flat["conv"]})
    assert ckpt_mod._pinned is buf
    np.testing.assert_array_equal(again["conv"], -flat["conv"].cpu().numpy())
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            want = v.float().cpu().numpy() if v.dtype == torch.bfloat16 else v.cpu().numpy()
            assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert got["np"] is flat["np"]
    tree = ckpt_mod.host_tree({"a": [flat["w"], {"b": flat["nbt"]}], "c": 3})
    np.testing.assert_array_equal(tree["a"][0], flat["w"].cpu().numpy())
    assert tree["a"][1]["b"] == 123457 and tree["c"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,state_dtype", [("schedule-free", None), ("adamw", "bfloat16")])
def test_optimizer_step_on_the_card_equals_the_cpu(cuda_device, algorithm, state_dtype):
    """Two steps of schedule-free AdamW and of bf16-moment AdamW (clip 1.0)
    on the card against the same steps on the CPU from the same gradients:
    parameters and states rtol 1e-5 / atol 1e-7 (tests/test_torch_schedule_free.py),
    bf16 moments within one bf16 ulp, schedule-free k exact."""
    from hippie_tpu_torch.train import optim

    r = np.random.default_rng(0)
    shapes = [(64, 32, 3), (64,), (10, 64)]
    init = [r.normal(size=s).astype(np.float32) for s in shapes]
    sides = {}
    for dev in ("cpu", "cuda"):
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy()).to(dev)) for v in init]
        sides[dev] = (ps, optim.make_optimizer(ps, 1e-3, 0.01, 1.0, state_dtype=state_dtype,
                                               algorithm=algorithm))
    for _ in range(2):
        grads = [r.normal(size=s).astype(np.float32) for s in shapes]
        for ps, opt in sides.values():
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g.copy()).to(p.device)  # the clip scales in place
            opt.step()
    (cp, co), (gp, go) = sides["cpu"], sides["cuda"]
    for a, b in zip(gp, cp):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7)
    if algorithm == "schedule-free":
        gs, cs = optim.find_schedule_free_state(go), optim.find_schedule_free_state(co)
        assert int(gs.k) == int(cs.k) == 2
        for a, b in zip(gs.z + gs.exp_avg_sq, cs.z + cs.exp_avg_sq):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
    else:
        for a, b in zip(gp, cp):
            for m in ("exp_avg", "exp_avg_sq"):
                x, y = go.state[a][m], co.state[b][m]
                assert x.dtype == y.dtype == torch.bfloat16
                x, y = x.float().cpu().numpy(), y.float().numpy()
                ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(y), 1e-30))) - 7)
                assert (np.abs(x - y) <= ulp).all(), m


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["adamw", "schedule-free"])
def test_flush_async_on_the_card_writes_the_bytes_of_flush(cuda_device, tmp_path, algorithm):
    """A snapshot on the card written by the background writer (one fetch
    on a side stream) and by a synchronous flush: the same bytes, .ckpt and
    sidecar."""
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import loop, optim, pipeline

    model = cvae.unimodal_cvae_init(cvae.CVAEConfig(z_dim=4, num_blocks=(1, 1, 1, 1)),
                                    torch.Generator().manual_seed(0), device="cuda")
    opt = optim.make_optimizer(model.parameters(), 1e-3, 0.01, algorithm=algorithm)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    sd, osd = loop.snapshot(type("TS", (), {"model": model, "optimizer": opt})())
    result = loop.FitResult(state=None, best_state_dict=sd, best_opt_state=osd, best_val_loss=1.0,
                            best_epoch=0, epochs_run=1)
    for how in ("sync", "async"):
        t = pipeline.BestTracker(str(tmp_path / how / "m.ckpt"))
        t.update_from_fit(result, ckpt_mod.parameter_key_order(model), (1e-3, 0.01))
        t.flush() if how == "sync" else (t.flush_async(), t.wait())
    names = sorted(p.name for p in (tmp_path / "sync").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "async").iterdir())
    assert len(names) == (1 if algorithm == "adamw" else 2)
    for n in names:
        assert (tmp_path / "sync" / n).read_bytes() == (tmp_path / "async" / n).read_bytes(), n


@pytest.mark.cuda
@pytest.mark.parametrize("traced_on", ["cpu", "cuda"])
def test_artifact_on_the_card_equals_the_model(cuda_device, tmp_path, traced_on):
    """An artifact traced on the host or on the card (the weights stored on
    the CPU either way) runs on the card, at 1, 3 and 415 rows, within 1e-5
    of embed_unimodal on the card (both at "highest", full float32), and on
    the CPU within 1e-5 of the CPU model."""
    from hippie_tpu_torch import export
    from hippie_tpu_torch.evaluate import embeddings as emb
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import checkpoint as ckpt_mod

    model = cvae.unimodal_cvae_init(cvae.CVAEConfig(z_dim=4, num_blocks=(1, 1, 1, 1)),
                                    torch.Generator().manual_seed(0), device="cpu")
    ckpt = str(tmp_path / "m.ckpt")
    ckpt_mod.save_lightning_ckpt(ckpt, model.state_dict())
    art = str(tmp_path / "m.hippie")
    export.export_from_checkpoint(ckpt, art, device=traced_on)
    on_card, _ = export.load_artifact(art, device="cuda")
    on_host, _ = export.load_artifact(art, device="cpu")
    card_model = model.to("cuda")
    r = np.random.default_rng(1)
    for n in (1, 3, 415):
        x = r.normal(size=(n, 50)).astype(np.float32)
        s = r.integers(0, 5, size=n)
        got = on_card(x, s)
        assert got.device.type == "cuda"
        want = emb.embed_unimodal(card_model, torch.from_numpy(x).cuda(), torch.from_numpy(s).cuda())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        torch.testing.assert_close(on_host(x, s), want.cpu(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_ensemble_epoch_on_the_card_launches_k_times_the_kernels(cuda_device):
    """A K=3 ensemble epoch with the loss and block kernels launches every
    kernel exactly 3 times as often as one model's epoch, and replica 0's
    losses are those of its single-model epoch from the same init, lr and
    noise (within 1e-4: cuDNN's and cuBLAS's backward algorithms may reduce
    in another order from run to run)."""
    from hippie_tpu_torch.data.device_data import batch_plan
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.ops import cuda_blocks
    from hippie_tpu_torch.train import ensemble, loop, optim, step

    cfg = cvae.CVAEConfig(z_dim=4, num_blocks=(1, 1, 1, 1))
    r = np.random.default_rng(0)
    data = torch.from_numpy(r.normal(size=(70, 50)).astype(np.float32)).cuda()
    source = torch.from_numpy(r.integers(0, 5, size=70)).cuda()
    idx, mask = batch_plan(np.arange(70), 32, shuffle=False)

    def counts():
        return {**cuda_ops.launches, **cuda_blocks.launches}

    states = ensemble.init_unimodal_ensemble(3, cfg, lambda ps: optim.make_optimizer(ps, 1e-3, 0.01), 3,
                                             device="cuda")
    train, _ = ensemble.make_unimodal_ensemble_epoch_fns(loss_backend="pallas", block_backend="pallas")
    cuda_ops.reset_launches()
    cuda_blocks.reset_launches()
    states, ms = train(states, data, source, None, idx, mask,
                       generators=[loop.key_generator(7, 1, k, device="cuda") for k in range(3)])
    ens = counts()
    model = cvae.unimodal_cvae_init(cfg, loop.key_generator(3, 0), device="cuda")
    single, _ = step.make_unimodal_epoch_fns(loss_backend="pallas", block_backend="pallas")
    cuda_ops.reset_launches()
    cuda_blocks.reset_launches()
    _, m0 = single(step.TrainState(model, optim.make_optimizer(model.parameters(), 1e-3, 0.01)), data, source,
                   None, idx, mask, generator=loop.key_generator(7, 1, 0, device="cuda"))
    one = counts()
    assert one["enc_block_fwd"] == 4 * 3 and ens == {k: 3 * v for k, v in one.items()}
    torch.testing.assert_close(ms.loss[:, 0], m0.loss, rtol=1e-4, atol=0)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((x.double() - b[k].double()).abs().max()) if x.is_floating_point()
               else (0.0 if torch.equal(x, b[k]) else float("inf")) for k, x in a.items())


@pytest.mark.cuda
def test_resumed_stage_fit_on_the_card_equals_the_uninterrupted_one(cuda_device, tmp_path):
    """A stage fit through the kernels (the small model, 4 epochs) cut after
    2 epochs and resumed from fresh weights on the card: bit for bit the
    uninterrupted fit where two uninterrupted fits agree bit for bit, else
    within twice their spread (chip_smoke.py phase 15's rule); the resumed
    call launches the kernels of its 2 epochs only."""
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.ops import cuda_blocks
    from hippie_tpu_torch.train import optim, pipeline, step

    cfg = pipeline.PipelineConfig(device="cuda", loss_backend="pallas", block_backend="pallas",
                                  verbose=False, batch_size=32,
                                  fit_loop="host")  # the wrappers' counters count its every launch
    cfg_m = cvae.CVAEConfig(z_dim=4, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
    r = np.random.default_rng(0)
    data = torch.from_numpy(r.normal(size=(90, 50)).astype(np.float32)).cuda()
    source = torch.from_numpy(r.integers(0, 5, size=90)).cuda()

    def fit(max_epochs, resume_dir=None, seed=0):
        model = cvae.unimodal_cvae_init(cfg_m, torch.Generator().manual_seed(seed), device="cuda")
        ts = step.TrainState(model, optim.make_optimizer(model.parameters(), 1e-3, 0.01))
        cuda_ops.reset_launches()
        cuda_blocks.reset_launches()
        res = pipeline.fit_unimodal_stage(
            cfg=cfg, ts=ts, data=data, source=source, class_=source, train_indices=np.arange(70),
            val_indices=np.arange(70, 90), batch_size=32, max_epochs=max_epochs, beta=1.0,
            use_class_labels=False, shuffle_train=True, resume_dir=resume_dir)
        return res, {**cuda_ops.launches, **cuda_blocks.launches}

    full, a = fit(4)[0], fit(4)[0]
    spread = _max_diff(full.state.model.state_dict(), a.state.model.state_dict())
    rdir = str(tmp_path / "resume")
    fit(2, rdir)
    resumed, launches = fit(4, rdir, seed=9)
    d = _max_diff(full.state.model.state_dict(), resumed.state.model.state_dict())
    assert d == 0.0 if spread == 0.0 else d <= 2 * spread, (d, spread)
    assert resumed.epochs_run == 4 and len(resumed.val_losses) == 2
    steps = 2 * 3
    assert launches["enc_block_fwd"] == 4 * steps and launches["vae_sums_bwd"] == steps


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fused", "bf16"])
def test_fused_and_bf16_steps_run_on_the_card(cuda_device, backend):
    """One train step on the card with the block backend ``backend`` and the
    loss kernels: no block kernel launches (both backends run torch ops),
    one launch of each loss kernel, and the loss within 5e-2 of the
    "xla" step's from the same weights, batch and noise."""
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.ops import cuda_blocks
    from hippie_tpu_torch.train import optim, step

    cfg_m = cvae.CVAEConfig(z_dim=4, num_blocks=(1, 1, 1, 1))
    r = np.random.default_rng(1)
    bd = torch.from_numpy(r.normal(size=(64, 50)).astype(np.float32)).cuda()
    bs = torch.from_numpy(r.integers(0, 5, size=64)).cuda()
    eps = torch.from_numpy(r.normal(size=(64, 4)).astype(np.float32)).cuda()
    losses = {}
    for b in ("xla", backend):
        model = cvae.unimodal_cvae_init(cfg_m, torch.Generator().manual_seed(0), device="cuda")
        ts = step.TrainState(model, optim.make_optimizer(model.parameters(), 1e-3, 0.01))
        batch_step, _ = step.make_unimodal_steps(loss_backend="pallas", block_backend=b)
        cuda_ops.reset_launches()
        cuda_blocks.reset_launches()
        _, m = batch_step(ts, bd, bs, None, None, eps=eps)
        losses[b] = float(m.loss)
        torch.cuda.synchronize()
    assert all(v == 0 for v in cuda_blocks.launches.values())
    assert cuda_ops.launches["vae_sums_fwd"] == cuda_ops.launches["vae_sums_bwd"] == 1
    assert np.isfinite(losses[backend]) and abs(losses[backend] - losses["xla"]) <= 5e-2 * abs(losses["xla"])


# ---------------------------------------------------------------------------
# The segmented entry points of data parallelism (ops/cuda_blocks.py
# *_block_fwd_mesh / *_block_bwd_mesh) at one rank over NCCL: a merge of one
# rank's moments is those moments, so every output equals the unsegmented
# call's bit for bit.
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_nccl(cuda_device, tmp_path):
    import torch.distributed as dist

    from hippie_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        yield pmesh.make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [("enc", s) for s in ENC_SHAPES[:4]] + [("dec", s) for s in DEC_SHAPES[:4]],
                         ids=lambda v: v if isinstance(v, str) else "s{}-L{}-{}-{}".format(*v))
def test_segmented_entries_equal_the_unsegmented_at_one_rank(one_rank_nccl, kind, shape):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    mesh = one_rank_nccl
    ops = cb.ENC_OPS if kind == "enc" else cb.DEC_OPS
    make = _block_inputs if kind == "enc" else _dec_inputs
    args, g = make(torch.device("cuda"), *shape, n_real=415, seed=sum(shape))
    cb.reset_launches()
    got, ref = ops.fwd_mesh(mesh, shape[0], *args), ops.fwd_cuda(shape[0], *args)
    dgot = ops.bwd_mesh(mesh, shape[0], *args, *got[1:], g)
    dref = ops.bwd_cuda(shape[0], *args, *ref[1:], g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(dgot, dref))
    assert cb.seg_launches[f"{kind}_block_fwd_seg"] == cb.seg_launches[f"{kind}_block_bwd_seg"] == 1
    assert cb.seg_launches["bn_stats_merge"] == 2


# ---------------------------------------------------------------------------
# CUDA graphs (train/device_fit.py): each kernel wrapper and a whole step
# replayed from a graph equal their eager calls bit for bit; the device fit
# loop equals the host loop on the card.
# ---------------------------------------------------------------------------


def _replay_equals_eager(fn):
    """``fn()`` once eagerly on a side stream (its workspace is made there),
    then captured on that stream and replayed into outputs filled with NaN:
    the replay's outputs equal the eager call's bit for bit."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        want = [t.clone() for t in fn() if t is not None]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=s):
            out = [t for t in fn() if t is not None]
        for t in out:
            t.fill_(float("nan"))
        g.replay()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    assert len(out) == len(want) and all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vae_sums_fwd", "vae_sums_bwd", "masked_sse_fwd", "enc_block_fwd",
                                    "enc_block_bwd", "dec_block_fwd", "dec_block_bwd"])
def test_kernel_wrappers_replay_from_a_cuda_graph(cuda_device, kernel):
    from hippie_tpu_torch.ops import cuda_blocks as cb

    if kernel.startswith("vae_sums"):
        x = _inputs(cuda_device, 415, 1e4)
        g = torch.tensor([1.0 / (415 * L), 1.0 / 415], device=cuda_device)
        fn = ((lambda: [cuda_ops.vae_sums_fwd_cuda(*x)]) if kernel == "vae_sums_fwd"
              else (lambda: cuda_ops.vae_sums_bwd_cuda(*x, g)))
    elif kernel == "masked_sse_fwd":
        x = _sse_inputs(cuda_device, 415, np.inf)
        fn = lambda: [cuda_ops.masked_sse_fwd_cuda(*x)]  # noqa: E731
    else:
        enc = kernel.startswith("enc")
        args, g = (_block_inputs(cuda_device, 2, 13, 128, 256, n_real=300, seed=2) if enc
                   else _dec_inputs(cuda_device, 2, 8, 256, 128, n_real=300, seed=2))
        fwd = cb.enc_block_fwd_cuda if enc else cb.dec_block_fwd_cuda
        bwd = cb.enc_block_bwd_cuda if enc else cb.dec_block_bwd_cuda
        st = fwd(2, *args)[1:]
        fn = (lambda: fwd(2, *args)) if kernel.endswith("fwd") else (lambda: bwd(2, *args, *st, g))
    cuda_ops.reset_launches()
    cb.reset_launches()
    _replay_equals_eager(fn)
    # the eager call launched; the capture recorded and launched nothing
    assert {**cuda_ops.launches, **cb.launches}[kernel] == 1


@pytest.mark.cuda
def test_a_first_call_inside_a_capture_raises(cuda_device):
    """A loss kernel whose workspace does not exist on the capturing stream
    raises instead of taking it from the graph's pool."""
    x = _inputs(cuda_device, 100)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s), pytest.raises(RuntimeError, match="before the capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=s):
            cuda_ops.vae_sums_fwd_cuda(*x)
    torch.cuda.synchronize()


def _small_fit(fit_loop: str, max_epochs: int = 3, optimizer: str = "adamw", mesh=None):
    """``mesh``: the optimizer sharded over it (parallel/fsdp.py), the fit
    under it."""
    import contextlib

    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.parallel import mesh as pmesh
    from hippie_tpu_torch.parallel.fsdp import ShardedOptimizer
    from hippie_tpu_torch.train import optim, pipeline, step

    cfg = pipeline.PipelineConfig(device="cuda", loss_backend="pallas", block_backend="pallas", verbose=False,
                                  fit_loop=fit_loop, early_stopping_patience=None, optimizer=optimizer)
    cfg_m = cvae.CVAEConfig(z_dim=4, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
    model = cvae.unimodal_cvae_init(cfg_m, torch.Generator().manual_seed(0), device="cuda")
    clip = 1.0 if optimizer == "adamw" else None
    if mesh is None:
        opt = optim.make_optimizer(model.parameters(), 1e-3, 0.01, clip, algorithm=optimizer)
    else:
        opt = ShardedOptimizer(model, mesh, lambda ps: optim.make_optimizer(ps, 1e-3, 0.01, algorithm=optimizer),
                               clip)
    ts = step.TrainState(model, opt)
    r = np.random.default_rng(0)
    data = torch.from_numpy(r.normal(size=(150, 50)).astype(np.float32)).cuda()
    source = torch.from_numpy(r.integers(0, 5, size=150)).cuda()
    with pmesh.data_parallel(mesh) if mesh is not None else contextlib.nullcontext():
        return pipeline.fit_unimodal_stage(
            cfg=cfg, ts=ts, data=data, source=source, class_=source, train_indices=np.arange(120),
            val_indices=np.arange(120, 150), batch_size=32, max_epochs=max_epochs, beta=1.0,
            use_class_labels=False, shuffle_train=True)


def _assert_same_fit(dev, host):
    assert dev.graphs["captured"] and not host.graphs
    assert (dev.train_losses, dev.val_losses, dev.best_epoch) == (host.train_losses, host.val_losses,
                                                                  host.best_epoch)
    for a, b in ((dev.state.model.state_dict(), host.state.model.state_dict()),
                 (dev.best_state_dict, host.best_state_dict)):
        assert all(torch.equal(v, b[k]) for k, v in a.items())
    for a, b in ((dev.state.optimizer.state_dict(), host.state.optimizer.state_dict()),
                 (dev.best_opt_state, host.best_opt_state)):
        for i, e in a["state"].items():
            assert all(torch.equal(v, b["state"][i][m]) for m, v in e.items()), i


@pytest.mark.cuda
def test_device_fit_on_the_card_equals_the_host_loop(cuda_device):
    """A stage fit with the loss and block kernels (the small model, B=32, 4
    train and 1 val step per epoch, 3 epochs): the device loop captured and
    replayed both steps, and its FitResult equals the host loop's bit for
    bit."""
    host = _small_fit("host")
    dev = _small_fit("device")
    assert (dev.graphs["train_replays"], dev.graphs["eval_replays"]) == (3 * 4 - 1, 3 - 1)
    _assert_same_fit(dev, host)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["adamw", "schedule-free"])
def test_fsdp_device_fit_on_one_nccl_rank_equals_the_host_loop(cuda_device, tmp_path, optimizer):
    """An FSDP stage fit (AdamW clipped at 1.0, or schedule-free) through a
    one-rank NCCL mesh: the device loop captures the sharded step (its
    reduce-scatter, update and in-place gather) and equals the host loop
    bit for bit."""
    import torch.distributed as dist

    from hippie_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1)
        host = _small_fit("host", optimizer=optimizer, mesh=mesh)
        dev = _small_fit("device", optimizer=optimizer, mesh=mesh)
        _assert_same_fit(dev, host)  # the sharded optimizers' state_dict gathers: inside the group
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_device_ensemble_on_the_card_equals_the_host_ensemble(cuda_device):
    """K=2 replicas (the small model, the loss and block kernels, B=32, 4
    train and 1 val step per epoch, 2 epochs): device_fit_ensemble captured
    one graph per step kind for both replicas and replayed it, and equals
    host_fit_ensemble bit for bit."""
    from hippie_tpu_torch.data.device_data import batch_plan
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import ensemble, optim, step

    cfg_m = cvae.CVAEConfig(z_dim=4, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
    r = np.random.default_rng(0)
    data = torch.from_numpy(r.normal(size=(150, 50)).astype(np.float32)).cuda()
    source = torch.from_numpy(r.integers(0, 5, size=150)).cuda()
    val = batch_plan(np.arange(120, 150), 32, shuffle=False)
    kw = dict(arrays=(data,), source=source, class_=None, train_stream=np.arange(120), batch_size=32,
              val_idx=val[0], val_mask=val[1], max_epochs=2, seed=3)
    backends = dict(loss_backend="pallas", block_backend="pallas")
    res = {}
    for fit_loop in ("host", "device"):
        states = ensemble.init_unimodal_ensemble(
            4, cfg_m, lambda ps: optim.make_optimizer(ps, 1e-3, 0.01, 1.0), 2, device="cuda")
        states = ensemble.set_ensemble_lr(states, [1e-3, 3e-3])
        if fit_loop == "device":
            batch_step, eval_step = step.make_unimodal_steps(**backends)
            res[fit_loop] = ensemble.device_fit_ensemble(states, batch_step=batch_step, eval_step=eval_step, **kw)
        else:
            res[fit_loop] = ensemble.host_fit_ensemble(
                states, epoch_fns=ensemble.make_unimodal_ensemble_epoch_fns(**backends), **kw)
    dev, host = res["device"], res["host"]
    assert dev.graphs["captured"] and (dev.graphs["train_replays"], dev.graphs["eval_replays"]) == (2 * 4 - 1, 1)
    assert np.array_equal(dev.best_val_loss, host.best_val_loss) and np.array_equal(dev.best_epoch, host.best_epoch)
    assert all(np.array_equal(a, b) for a, b in zip(dev.train_losses, host.train_losses))
    for a, b in zip(dev.state, host.state):
        assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
        for i, e in a.optimizer.state_dict()["state"].items():
            assert all(torch.equal(v, b.optimizer.state_dict()["state"][i][m]) for m, v in e.items()), i
    for a, b in zip(dev.best_state_dict, host.best_state_dict):
        assert all(torch.equal(v, b[k]) for k, v in a.items())


@pytest.mark.cuda
def test_replica_plans_on_the_card_equal_the_host_fit(cuda_device):
    """K=3 replicas of the full-width cVAE (z=10) on the loss and block
    kernels, each on its own fixed plan over the pool rows of datasets/ (2
    train batches of B=512, the second padded, and 1 val batch) with its own
    seed, 2 epochs: device_fit_replica_plans captured one graph per step
    kind for the three, replayed it at every K-step after the first, and
    equals host_fit_replica_plans bit for bit."""
    import pathlib

    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.data.device_data import batch_plan
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import ensemble, loop, optim, pipeline, step

    root = str(pathlib.Path(__file__).resolve().parents[1] / "datasets")
    pool = pipeline.load_pretrain_pool(pipeline.PipelineConfig(dataset="cellexplorer-celltype", data_root=root,
                                                               device="cuda", verbose=False))
    cfg_m = cvae.CVAEConfig(z_dim=10, output_size=50, class_hidden_dim=5, num_sources=registry.NUM_SOURCES,
                            num_classes=5)
    t_idx, t_mask = (np.stack(p) for p in zip(*(batch_plan(np.arange(a, a + 900), 512, shuffle=False)
                                                 for a in (0, 700, 1400))))
    v_idx, v_mask = (np.stack(p) for p in zip(*(batch_plan(np.arange(a, a + 300), 512, shuffle=False)
                                                 for a in (2400, 2500, 2600))))
    kw = dict(arrays=(pool.wave,), source=pool.source, class_=None, train_idx=t_idx, train_mask=t_mask,
              val_idx=v_idx, val_mask=v_mask, max_epochs=2, early_stopping_patience=1, seeds=[1000, 1010, 1020])
    backends = dict(loss_backend="pallas", block_backend="pallas")
    res = {}
    for fit_loop in ("host", "device"):
        models = [cvae.unimodal_cvae_init(cfg_m, loop.key_generator(19, k), device="cuda") for k in range(3)]
        states = [step.TrainState(m, optim.make_optimizer(m.parameters(), 1e-3, 0.01)) for m in models]
        if fit_loop == "device":
            batch_step, eval_step = step.make_unimodal_steps(**backends)
            res[fit_loop] = ensemble.device_fit_replica_plans(states, batch_step=batch_step, eval_step=eval_step,
                                                              **kw)
        else:
            res[fit_loop] = ensemble.host_fit_replica_plans(
                states, epoch_fns=ensemble.make_unimodal_ensemble_epoch_fns(**backends), **kw)
    dev, host = res["device"], res["host"]
    assert dev.graphs["captured"] and (dev.graphs["train_replays"], dev.graphs["eval_replays"]) == (2 * 2 - 1, 1)
    assert np.array_equal(dev.best_val_loss, host.best_val_loss) and np.array_equal(dev.best_epoch, host.best_epoch)
    assert dev.epochs_run == host.epochs_run == 2
    for name in ("train_losses", "val_losses"):
        assert np.array_equal(np.asarray(getattr(dev, name)), np.asarray(getattr(host, name)), equal_nan=True)
    for a, b in zip(dev.state, host.state):
        assert all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items())
    for a, b in zip(dev.best_state_dict, host.best_state_dict):
        assert all(torch.equal(v, b[k]) for k, v in a.items())


@pytest.mark.cuda
def test_clip_inside_a_captured_step(cuda_device):
    """clip_by_global_norm_ on 8 ResNet-shaped leaves, above and below the
    clip: its norm within 2e-7 of float64 on the card, each leaf
    ``(g / n) * c`` (or ``g``) bit for bit, and a CUDA graph's replay equal
    to the eager call."""
    from hippie_tpu_torch.train import optim

    shapes = [(512, 512, 3), (512, 256, 3), (256, 256, 3), (128, 64, 3), (64, 1, 7), (512,), (10, 512), (5, 5)]
    r = np.random.default_rng(0)
    g0 = [torch.from_numpy((r.normal(size=s) * r.uniform(1e-3, 3.0)).astype(np.float32)).cuda() for s in shapes]
    n = torch.sqrt(torch.stack(optim.leaf_square_sums(g0)).sum())
    want = np.sqrt(sum(float((x.double() ** 2).sum()) for x in g0))
    assert abs(float(n) - want) / want < 2e-7
    for c in (0.25 * float(n), 4.0 * float(n)):
        eager = [x.clone() for x in g0]
        optim.clip_by_global_norm_(eager, c)
        for x, y in zip(g0, eager):
            assert torch.equal(y, torch.where(n < c, x, (x / n) * c))
        graphed = [x.clone() for x in g0]
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            optim.clip_by_global_norm_([x.clone() for x in g0], c)  # warm-up on the capture stream
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=s):
                optim.clip_by_global_norm_(graphed, c)
            torch._foreach_copy_(graphed, g0)
            g.replay()
        torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(graphed, eager))


@pytest.mark.cuda
def test_device_fit_refuses_gloo_on_cuda(cuda_device, tmp_path):
    """Gloo carries CUDA tensors through the host, which a graph cannot
    capture: the device loop raises, it does not run eager steps instead."""
    import torch.distributed as dist

    from hippie_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0, world_size=1)
    try:
        with pmesh.data_parallel(pmesh.make_mesh(1)), pytest.raises(ValueError, match="gloo moves CUDA"):
            _small_fit("device", max_epochs=1)
    finally:
        dist.destroy_process_group()


def _small_ckpts(tmp_path) -> dict:
    """Unimodal wave and time and joint checkpoints of the small models."""
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import checkpoint as ckpt_mod

    out = {}
    for name, make, cfg in (("wave", cvae.unimodal_cvae_init, cvae.CVAEConfig(z_dim=4, num_blocks=(1, 1, 1, 1))),
                            ("time", cvae.unimodal_cvae_init,
                             cvae.CVAEConfig(z_dim=4, output_size=100, num_blocks=(1, 1, 1, 1))),
                            ("joint", cvae.multimodal_cvae_init,
                             cvae.MultiModalConfig(z_dim=4, num_blocks=(1, 1, 1, 1)))):
        out[name] = str(tmp_path / f"{name}.ckpt")
        ckpt_mod.save_lightning_ckpt(out[name], make(cfg, torch.Generator().manual_seed(len(out)),
                                                     device="cpu").state_dict())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", [False, True])
def test_tensor_widths_equal_int_widths_on_the_card(cuda_device, normalize):
    """preprocess_pair_padded with the widths as 0-d device tensors (what a
    server graph reads) gives the Python-int call's bits on the card too
    (the division by the ISI width rounds as a division by a Python float,
    a multiplication by its float32 reciprocal there)."""
    from hippie_tpu_torch.ops import preprocess

    r = np.random.default_rng(3)
    for w, i in ((41, 91), (120, 333), (256, 512)):
        wf = torch.zeros(64, 256, device=cuda_device)
        isi = torch.zeros(64, 512, device=cuda_device)
        wf[:, :w] = torch.from_numpy(r.normal(size=(64, w)).astype(np.float32)).to(cuda_device)
        isi[:, :i] = torch.from_numpy(np.abs(r.normal(size=(64, i))).astype(np.float32)).to(cuda_device)
        mats = (preprocess.device_interp_matrix(w, 50, 256, "cuda"), preprocess.device_interp_matrix(i, 100, 512, "cuda"))
        widths = torch.tensor([w, i], device=cuda_device)
        got = preprocess.preprocess_pair_padded(wf, isi, *mats, widths[0], widths[1], normalize=normalize)
        want = preprocess.preprocess_pair_padded(wf, isi, *mats, w, i, normalize=normalize)
        for g, e in zip(got, want):
            assert torch.equal(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dual", "joint"])
def test_server_replays_equal_the_eager_program(cuda_device, tmp_path, mode):
    """The server on the card: the ladder (512) captures one graph; requests
    of two widths under the caps and a coalesced group replay it; a request
    wider than the caps and one with normalize capture a key each; every
    reply equals _run_group's eager program on the same rows bit for bit,
    and the model called directly within 1e-5; a coalesced group's replies
    the lone requests' within 1e-6."""
    from hippie_tpu_torch import export
    from hippie_tpu_torch.evaluate import embeddings as emb
    from hippie_tpu_torch.ops import preprocess
    from hippie_tpu_torch.scripts import serve_embeddings as se

    ckpts = _small_ckpts(tmp_path)
    kw = ({"joint_ckpt": ckpts["joint"]} if mode == "joint" else
          {"wave_ckpt": ckpts["wave"], "time_ckpt": ckpts["time"]})
    service = se.EmbeddingService(z_dim=4, device="cuda", **kw)
    service.warmup([512])
    assert (service.graph_captures, service.graph_replays) == (1, 1)
    r = np.random.default_rng(4)
    requests = [(r.normal(size=(n, w)).astype(np.float32), np.abs(r.normal(size=(n, i))).astype(np.float32), s, norm)
                for n, w, i, s, norm in ((64, 41, 91, 0, False), (300, 46, 100, 2, False), (5, 300, 91, 1, False),
                                         (7, 41, 91, 3, True))]
    for wf, isi, s, norm in requests:
        _, _, j, _ = service.embed(wf, isi, s, norm)
        item = se._Item(wf, isi, s, norm)
        service._run_group([item], eager=True)
        np.testing.assert_array_equal(j, item.out[2])
        wave, isi_p = preprocess.preprocess_pair(wf, isi, normalize=norm, device="cuda")
        src = torch.full((len(wf),), s, dtype=torch.long, device="cuda")
        if mode == "joint":
            m, _ = export.load_model_from_ckpt(ckpts["joint"], device="cuda")
            want = emb.embed_multimodal(m, wave, isi_p, src)
        else:
            mw, _ = export.load_model_from_ckpt(ckpts["wave"], device="cuda")
            mt, _ = export.load_model_from_ckpt(ckpts["time"], device="cuda")
            want = torch.cat([emb.embed_unimodal(mw, wave, src), emb.embed_unimodal(mt, isi_p, src)], dim=1)
        np.testing.assert_allclose(j, want.cpu().numpy(), rtol=0, atol=1e-5)
    items = [se._Item(wf[:5], isi[:5], s, False) for wf, isi, s, _ in (requests[0], requests[0])]
    service._run_group(items)
    for it in items:
        _, _, j, _ = service.embed(it.wf, it.isi, it.source, False)
        np.testing.assert_allclose(it.out[2], j, rtol=0, atol=1e-6)
    assert (service.graph_captures, service.graph_replays) == (3, 8)


@pytest.mark.cuda
def test_artifact_buckets_replay_equal_the_eager_program(cuda_device, tmp_path):
    """load_artifact's call on the card: 1 and 415 rows share the 512-row
    graph, 600 rows capture the 1,024-row one; every reply equals the
    call's eager twin bit for bit."""
    from hippie_tpu_torch import export

    art = str(tmp_path / "joint.hippie")
    export.export_from_checkpoint(_small_ckpts(tmp_path)["joint"], art, device="cuda")
    call, _ = export.load_artifact(art, device="cuda")
    r = np.random.default_rng(5)
    for n in (1, 415, 600, 415):
        arrays = (r.normal(size=(n, 50)).astype(np.float32), r.normal(size=(n, 100)).astype(np.float32),
                  r.integers(0, 5, size=n))
        got = call(*arrays)
        assert got.device.type == "cuda" and got.shape == (n, 4)
        assert torch.equal(got, call.eager(*arrays))
    assert (call.space.captures, call.space.replays) == (2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["kmeans", "gmm"])
def test_clustering_replays_equal_the_eager_loop(cuda_device, method):
    """k-means and the GMM on the card, their iterations replayed, equal
    the same iteration functions looped eagerly on the card bit for bit; a
    second call of the shape captures nothing and repeats the bits."""
    import math

    from hippie_tpu_torch.evaluate.knn_eval import pairwise_sq_dists
    from hippie_tpu_torch.ops import clustering

    x = torch.from_numpy(_blobs(4, 20, 2000, 7)).to(cuda_device)
    k, seed = 4, 5
    clustering._ITERATIONS.pop((2000, 20, k, str(x.device)), None)  # captures counted from none
    got = getattr(clustering, method)(x, k, seed=seed)
    centers = clustering._seed(x, k, torch.Generator().manual_seed(seed))
    for _ in range(50 if method == "kmeans" else 10):
        clustering._lloyd(x, centers, k)
    if method == "kmeans":
        dists = pairwise_sq_dists(x, centers)
        want = (torch.argmin(dists, dim=1), centers, dists.min(dim=1).values.sum())
    else:
        assign = torch.argmin(pairwise_sq_dists(x, centers), dim=1)
        counts = torch.clamp(clustering._onehot(assign, k, x.dtype).sum(dim=0), min=1.0)
        means, var, weights = centers, torch.ones_like(centers), counts / x.shape[0]
        for _ in range(100):
            clustering._em(x, means, var, weights)
        lp = clustering._log_prob(x, means, var, weights)
        want = (torch.argmax(lp, dim=1), means, var, weights, torch.logsumexp(lp, dim=1).sum())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    it = clustering._ITERATIONS[(2000, 20, k, str(x.device))]
    captures = it.space.captures
    assert captures == (1 if method == "kmeans" else 2)
    again = getattr(clustering, method)(x, k, seed=seed)
    assert it.space.captures == captures and all(torch.equal(a, b) for a, b in zip(again, got))
    assert not math.isnan(float(got[-1]))


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device):
    """An EvalGraph whose function cannot be captured (it waits for the
    card) raises on every call: no eager fall back."""
    from hippie_tpu_torch.evaluate import eval_graph

    space = eval_graph.GraphSpace(cuda_device)
    x = torch.ones(8, device=cuda_device)
    g = eval_graph.EvalGraph(lambda t: t * float(t.sum()), [x], space)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            g()
        assert g.graph is None and g.runs == 0 and space.replays == 0
    torch.cuda.synchronize()
