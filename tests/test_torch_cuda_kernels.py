"""The fused VAE-loss kernel (hippie_tpu_torch/csrc/vae_sums.cu) on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither jax nor hippie_tpu, so it also runs where only the port is
installed; on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: values rtol 4e-6 (two summation orders of up to 25,600
nonnegative float32 terms, each within about 9.5e-7 of the exact sum);
gradients rtol 1e-5 / atol 1e-7 (elementwise, as tests/test_pallas.py).
"""

import numpy as np
import pytest
import torch

from hippie_tpu_torch.ops import cuda_ops

torch.set_num_threads(1)

B, L, Z = 512, 50, 10
CASES = {"full": (B, None), "tail": (415, None), "one_row": (1, 1e7), "one_row_inf": (1, np.inf)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 3 runs these checks on the card")
    return torch.device("cuda")


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


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(cuda_device):
    x = _inputs(cuda_device, n_real=415)
    runs = [cuda_ops.vae_sums_fwd_cuda(*x) for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)


@pytest.mark.cuda
def test_autograd_launches_both_kernels(cuda_device):
    data, dec, mu, logvar, mask = _inputs(cuda_device, n_real=300)
    leaves = [t.clone().requires_grad_(True) for t in (dec, mu, logvar)]
    cuda_ops.reset_launches()
    total, _ = cuda_ops.vae_loss_pallas(data, *leaves, beta=0.5, mask=mask[:, 0])
    total.backward()
    assert cuda_ops.launches == {"vae_sums_fwd": 1, "vae_sums_bwd": 1}
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
