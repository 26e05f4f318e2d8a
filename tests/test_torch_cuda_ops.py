"""The fused VAE-loss kernel's wrapper and plain version against hippie_tpu.

On the CPU, hippie_tpu_torch.ops.cuda_ops.FusedVaeSums takes its plain
version; it is held against hippie_tpu's vae_loss_pallas (Pallas interpret
mode, as tests/test_pallas.py runs it) and losses.vae_loss, with the
tolerances of tests/test_pallas.py: rtol 1e-6 on values, rtol 1e-5 / atol
1e-7 on gradients. The port's losses.vae_loss (loss_backend="xla") is held to
the same. The kernel itself needs the card: tests/test_torch_cuda_kernels.py
holds it against the plain version, and chip_smoke.py runs the same
comparison at the main path's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.ops import losses as jlosses
from hippie_tpu.ops.pallas_ops import vae_loss_pallas as j_vae_loss_pallas
from hippie_tpu_torch.ops import cuda_ops
from hippie_tpu_torch.ops import losses as tlosses

torch.set_num_threads(1)


def _inputs(b=32, l=50, z=10, seed=0, n_real=None, pad=None):
    r = np.random.default_rng(seed)
    data = r.normal(size=(b, l)).astype(np.float32)
    dec = r.normal(size=(b, l)).astype(np.float32)
    mu = r.normal(size=(b, z)).astype(np.float32)
    logvar = (r.normal(size=(b, z)) * 0.3).astype(np.float32)
    mask = np.ones((b,), np.float32)
    if n_real is not None:
        mask[n_real:] = 0.0
        if pad is not None:  # blown-up padded rows: exp(logvar) overflows
            dec[n_real:] = 3.0 * pad
            mu[n_real:] = pad
            logvar[n_real:] = pad
    return data, dec, mu, logvar, mask


CASES = {
    "full": dict(),
    "tail": dict(b=24, n_real=17),
    "one_row": dict(b=16, n_real=1, pad=np.float32(1e7)),
    "one_row_inf": dict(b=16, n_real=1, pad=np.float32(np.inf)),
}


def _jax_value_and_grads(fn, data, dec, mu, logvar, mask, beta):
    def f(dec, mu, logvar):
        return fn(jnp.asarray(data), dec, mu, logvar, beta=beta, mask=jnp.asarray(mask))[0]

    val, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(dec), jnp.asarray(mu), jnp.asarray(logvar))
    return float(val), [np.asarray(g) for g in grads]


def _torch_value_and_grads(fn, data, dec, mu, logvar, mask, beta):
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (dec, mu, logvar)]
    total, (mse, kl) = fn(torch.from_numpy(data), *leaves, beta=beta, mask=torch.from_numpy(mask))
    total.backward()
    return float(total.detach()), [t.grad.numpy() for t in leaves], (float(mse.detach()),
                                                                     float(kl.detach()))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("port_fn", ["pallas", "xla"])
def test_loss_and_grads_match_jax(port_fn, case):
    data, dec, mu, logvar, mask = _inputs(**CASES[case])
    fn = cuda_ops.vae_loss_pallas if port_fn == "pallas" else tlosses.vae_loss
    got, g_got, (mse, kl) = _torch_value_and_grads(fn, data, dec, mu, logvar, mask, beta=0.7)
    assert np.isfinite([got, mse, kl]).all()
    for ref_fn in (j_vae_loss_pallas, jlosses.vae_loss):
        ref, g_ref = _jax_value_and_grads(ref_fn, data, dec, mu, logvar, mask, beta=0.7)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        for a, b in zip(g_got, g_ref):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # padded rows are invisible: the loss of the real rows alone
    n = int(mask.sum())
    small = jlosses.vae_loss(*(jnp.asarray(x[:n]) for x in (data, dec, mu, logvar)), beta=0.7)[0]
    np.testing.assert_allclose(got, float(small), rtol=1e-6)


def test_unmasked_loss_matches_jax():
    data, dec, mu, logvar, _ = _inputs()
    ref, (ref_mse, ref_kl) = jlosses.vae_loss(*(jnp.asarray(x) for x in (data, dec, mu, logvar)),
                                              beta=0.7)
    for fn in (cuda_ops.vae_loss_pallas, tlosses.vae_loss):
        total, (mse, kl) = fn(*(torch.from_numpy(x) for x in (data, dec, mu, logvar)), beta=0.7)
        np.testing.assert_allclose([float(total), float(mse), float(kl)],
                                   [float(ref), float(ref_mse), float(ref_kl)], rtol=1e-6)


def test_fused_sums_gradient_matches_autograd_of_plain():
    """The hand-written backward equals autograd through the plain forward."""
    data, dec, mu, logvar, mask = _inputs(b=20, n_real=13)
    mask_col = torch.from_numpy(mask).reshape(-1, 1)
    g = torch.tensor([0.3, -1.7])
    a = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (data, dec, mu, logvar)]
    (cuda_ops.vae_sums_plain(*a, mask_col) * g).sum().backward()
    b = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (data, dec, mu, logvar)]
    sse, kl = cuda_ops.fused_vae_sums(*b, mask_col)
    (sse * g[0] + kl * g[1]).backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.grad.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-7)


def test_cpu_wrapper_counts_no_kernel_launch():
    cuda_ops.reset_launches()
    data, dec, mu, logvar, mask = _inputs(b=8)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (dec, mu, logvar)]
    cuda_ops.vae_loss_pallas(torch.from_numpy(data), *leaves, mask=torch.from_numpy(mask))[0].backward()
    assert cuda_ops.launches == {"vae_sums_fwd": 0, "vae_sums_bwd": 0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device_mix"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    data, dec, mu, logvar, mask = (torch.from_numpy(x) for x in _inputs(b=8))
    mask_col = mask.reshape(-1, 1)
    if bad == "dtype":
        dec = dec.double()
    elif bad == "shape":
        mu = mu[:, :5]
    elif bad == "contiguity":
        dec = torch.from_numpy(np.asfortranarray(dec.numpy()))
    else:
        data = data.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cuda_ops.fused_vae_sums(data, dec, mu, logvar, mask_col)
