"""The loss backward's plain version with its gradient flags against
hippie_tpu's ``_fused_bwd`` (the Pallas backward of fused_vae_sums).

``cuda_ops.vae_sums_bwd_plain(..., want)`` computes the gradients whose flag
is set and returns None for the others, as the kernel (csrc/vae_sums.cu)
writes only those autograd asks for. Each of the 16 flag patterns is held
against the JAX backward, run jitted in Pallas interpret mode as
tests/test_pallas.py runs it, on a full batch of 512, a 415-row tail whose
padded rows hold +-1e4 and +-inf, B=100 and B=1, at the gradients'
tolerance of tests/test_pallas.py (rtol 1e-5, atol 1e-7). Through autograd
(``fused_vae_sums``) the flags are ``ctx.needs_input_grad``: an input that
needs no gradient gets none. The kernel against this plain version is
tests/test_torch_cuda_kernels.py's, on the card.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.ops import pallas_ops
from hippie_tpu_torch.ops import cuda_ops

torch.set_num_threads(1)

L, Z = 50, 10
# case -> (B, real rows, pad of the padded rows)
CASES = {"B512": (512, 512, None), "tail415_pad1e4": (512, 415, 1e4), "tail415_padinf": (512, 415, np.inf),
         "B100": (100, 100, None), "B1": (1, 1, None)}
WANTS = list(itertools.product((False, True), repeat=4))
_jax_bwd = jax.jit(pallas_ops._fused_bwd)
_ref: dict = {}


def _inputs(case):
    b, n_real, pad = CASES[case]
    r = np.random.default_rng(b + n_real)
    data = r.normal(size=(b, L)).astype(np.float32)
    dec = r.normal(size=(b, L)).astype(np.float32)
    mu = r.normal(size=(b, Z)).astype(np.float32)
    logvar = (0.3 * r.normal(size=(b, Z))).astype(np.float32)
    mask = (np.arange(b) < n_real).astype(np.float32).reshape(b, 1)
    if pad is not None:
        sign = np.where(r.random((b - n_real, 1)) < 0.5, 1.0, -1.0).astype(np.float32)
        dec[n_real:] = pad * sign
        mu[n_real:] = pad * sign
        logvar[n_real:] = pad * sign
    g = np.array([1.0 / (n_real * L), 0.7 / n_real], np.float32)
    return data, dec, mu, logvar, mask, g


def _jax_grads(case):
    """(ddata, ddec, dmu, dlogvar) of the JAX backward, once per case."""
    if case not in _ref:
        data, dec, mu, logvar, mask, g = _inputs(case)
        res = tuple(jnp.asarray(x) for x in (data, dec, mu, logvar, mask))
        _ref[case] = [np.asarray(x) for x in _jax_bwd(res, jnp.asarray(g))[:4]]
    return _ref[case]


@pytest.mark.parametrize("want", WANTS, ids=lambda w: "".join("1" if x else "0" for x in w))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_with_flags_matches_jax(case, want):
    data, dec, mu, logvar, mask, g = _inputs(case)
    got = cuda_ops.vae_sums_bwd_plain(*(torch.from_numpy(x) for x in (data, dec, mu, logvar, mask, g)),
                                      want=want)
    ref = _jax_grads(case)
    for name, a, b, w in zip(("ddata", "ddec", "dmu", "dlogvar"), got, ref, want):
        if not w:
            assert a is None, name
            continue
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("needs", [(False, True, True, True), (True, True, True, True), (False, False, True, False)],
                         ids=["step", "all", "mu"])
def test_autograd_asks_for_the_inputs_that_need_a_gradient(needs, monkeypatch):
    """fused_vae_sums passes ctx.needs_input_grad as the flags: the inputs
    that need no gradient get None (the train step's data), the others the
    JAX backward's gradients."""
    data, dec, mu, logvar, mask, g = _inputs("tail415_padinf")
    seen = []
    plain = cuda_ops.vae_sums_bwd_plain
    monkeypatch.setattr(cuda_ops, "vae_sums_bwd_plain", lambda *a: seen.append(a[-1]) or plain(*a))
    leaves = [torch.from_numpy(x).requires_grad_(n) for x, n in zip((data, dec, mu, logvar), needs)]
    sse, kl = cuda_ops.fused_vae_sums(*leaves, torch.from_numpy(mask))
    (float(g[0]) * sse + float(g[1]) * kl).backward()
    assert seen == [needs]
    for t, b, n in zip(leaves, _jax_grads("tail415_padinf"), needs):
        assert (t.grad is None) == (not n)
        if n:
            np.testing.assert_allclose(t.grad.numpy(), b, rtol=1e-5, atol=1e-7)
