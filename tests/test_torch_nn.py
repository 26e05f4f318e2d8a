"""hippie_tpu_torch.nn against hippie_tpu.nn on the CPU.

Masked BatchNorm in train and eval mode over [B, C] and [B, C, L] (the JAX
package's [B, L, C] transposed), with no mask, a padded tail and a single real
row, including the new running statistics. Tolerances: rtol 1e-5 / atol 1e-6
on float32 values of unit scale (the two frameworks reduce in different
orders); num_batches_tracked exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.nn import functional as jfn
from hippie_tpu_torch.nn import functional as tfn
from hippie_tpu_torch.nn import init as tinit
from hippie_tpu_torch.nn.modules import MaskedBatchNorm1d

torch.set_num_threads(1)

B, C, L = 12, 6, 5
MASKS = {
    "none": None,
    "tail": np.array([1.0] * 9 + [0.0] * 3, np.float32),
    "one_row": np.array([1.0] + [0.0] * 11, np.float32),
}


def _bn_case(ndim, seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(B, L, C)) * 2.0 + 0.5).astype(np.float32)
    if ndim == 2:
        x = x[:, 0, :]
    params = {"weight": r.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": r.normal(size=C).astype(np.float32)}
    state = {"running_mean": r.normal(size=C).astype(np.float32),
             "running_var": r.uniform(0.5, 2.0, C).astype(np.float32),
             "num_batches_tracked": np.int32(3)}
    return x, params, state


def _to_torch_layout(x):
    return torch.from_numpy(np.ascontiguousarray(x if x.ndim == 2 else x.transpose(0, 2, 1)))


@pytest.mark.parametrize("mask_name", list(MASKS))
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("training", [True, False])
def test_masked_batch_norm_matches_jax(training, ndim, mask_name):
    x, params, state = _bn_case(ndim)
    mask = MASKS[mask_name]
    y_j, new_j = jfn.batch_norm(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, training=training,
        mask=None if mask is None else jnp.asarray(mask),
    )
    bn = MaskedBatchNorm1d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["weight"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(state["running_mean"]))
        bn.running_var.copy_(torch.from_numpy(state["running_var"]))
        bn.num_batches_tracked.fill_(int(state["num_batches_tracked"]))
    bn.train(training)
    y_t = bn(_to_torch_layout(x), None if mask is None else torch.from_numpy(mask))

    y_ref = np.asarray(y_j)
    if ndim == 3:
        y_ref = y_ref.transpose(0, 2, 1)
    rows = slice(None) if mask is None else mask > 0  # padded rows are unconstrained
    np.testing.assert_allclose(y_t.detach().numpy()[rows], y_ref[rows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_j["running_mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_j["running_var"]),
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == int(new_j["num_batches_tracked"])
    assert bn.num_batches_tracked.dtype == torch.int64


def test_batch_norm_state_dict_keys_match_torch():
    ours = list(MaskedBatchNorm1d(4).state_dict())
    assert ours == list(torch.nn.BatchNorm1d(4).state_dict())


def test_masked_batch_norm_gradient_matches_unpadded_batch():
    """Padded rows neither move the statistics nor receive gradient through
    them: grads on real rows equal those of the unpadded batch."""
    x, params, state = _bn_case(3)
    mask = torch.from_numpy(MASKS["tail"])
    xt = _to_torch_layout(x).requires_grad_(True)
    bn = MaskedBatchNorm1d(C).train()
    (bn(xt, mask) * mask[:, None, None]).square().sum().backward()
    x_small = _to_torch_layout(x)[:9].clone().requires_grad_(True)
    MaskedBatchNorm1d(C).train()(x_small).square().sum().backward()
    np.testing.assert_allclose(xt.grad[:9].numpy(), x_small.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slope", [0.01, 0.2])
def test_leaky_relu_matches_jax(slope):
    x = np.random.default_rng(1).normal(size=(7, 9)).astype(np.float32)
    np.testing.assert_array_equal(tfn.leaky_relu(torch.from_numpy(x), slope).numpy(),
                                  np.asarray(jfn.leaky_relu(jnp.asarray(x), slope)))


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_nearest_matches_jax(scale):
    x = np.random.default_rng(2).normal(size=(3, 4, 6)).astype(np.float32)  # [B, L, C]
    got = tfn.upsample_nearest(_to_torch_layout(x), scale).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got, np.asarray(jfn.upsample_nearest(jnp.asarray(x), scale)))


def test_adaptive_avg_pool_matches_jax():
    x = np.random.default_rng(3).normal(size=(3, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(tfn.adaptive_avg_pool_to_1(_to_torch_layout(x)).numpy(),
                               np.asarray(jfn.adaptive_avg_pool_to_1(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_init_bounds_and_generator_determinism():
    conv = torch.nn.Conv1d(8, 16, 3)
    lin = torch.nn.Linear(20, 5)
    g = torch.Generator().manual_seed(0)
    tinit.conv1d_(conv, g)
    tinit.dense_(lin, g)
    assert conv.weight.abs().max() <= 1 / np.sqrt(24) and conv.bias.abs().max() <= 1 / np.sqrt(24)
    assert lin.weight.abs().max() <= 1 / np.sqrt(20)
    # a fixed seed fixes the weights and leaves torch's global generator alone
    state = torch.random.get_rng_state()
    conv2 = torch.nn.Conv1d(8, 16, 3)
    torch.random.set_rng_state(state)
    tinit.conv1d_(conv2, torch.Generator().manual_seed(0))
    torch.testing.assert_close(conv2.weight, conv.weight, rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)
