"""Weights and the model forward: hippie_tpu_torch against hippie_tpu on the CPU.

(c) state_dict_from_jax equals hippie_tpu's to_torch_state_dict key for key
and array for array, and loads strictly; the full-depth model has 8,056,639
parameters. (d) The cVAE forward in train and eval mode, with injected noise
and a masked tail, for (encoded, mu, logvar, decoded) and the new BatchNorm
state. Tolerance rtol 1e-4 / atol 1e-5 on outputs of unit scale: float32
convolutions of XLA:CPU and torch round differently, and train-mode BatchNorm
passes those differences through 20+ layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.models import cvae as jcvae
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train.checkpoint import state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=4, output_size=50, class_hidden_dim=3, num_sources=5, num_classes=4,
           num_blocks=(1, 1, 1, 1))
B = 16


def _numpy_tree(tree):
    """JAX pytree -> nested dicts of numpy arrays, keeping the dicts' insertion
    order (jax.device_get would sort the keys)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_from_jax(params, state, cfg):
    with torch.device("meta"):
        model = tcvae.UnimodalCVAE(tcvae.CVAEConfig(**cfg))
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax(_numpy_tree(params), _numpy_tree(state)),
                          strict=True)
    return model


@pytest.fixture(scope="module")
def jax_model():
    return jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), jcvae.CVAEConfig(**CFG))


@pytest.fixture(scope="module")
def batch():
    r = np.random.default_rng(0)
    data = r.normal(size=(B, 50)).astype(np.float32)
    source = r.integers(0, 5, size=B).astype(np.int32)
    class_ = r.integers(0, 4, size=B).astype(np.int32)
    eps = r.normal(size=(B, CFG["z_dim"])).astype(np.float32)
    mask = np.array([1.0] * 11 + [0.0] * 5, np.float32)
    return data, source, class_, eps, mask


def test_state_dict_from_jax_matches_to_torch_state_dict(jax_model):
    params, state = jax_model
    ours = state_dict_from_jax(_numpy_tree(params), _numpy_tree(state))
    ref = jckpt.to_torch_state_dict(params, state, prefix="")
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_port_state_dict_keys_and_shapes_match_jax(jax_model):
    params, state = jax_model
    ref = jckpt.to_torch_state_dict(params, state, prefix="")
    model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**CFG), torch.Generator().manual_seed(0),
                                     device="cpu")
    sd = model.state_dict()
    assert list(sd) == list(ref)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    _port_from_jax(params, state, CFG)  # strict load


def test_full_depth_parameter_count():
    cfg = dict(z_dim=10, output_size=50, class_hidden_dim=5, num_sources=5, num_classes=5)
    with torch.device("meta"):
        model = tcvae.UnimodalCVAE(tcvae.CVAEConfig(**cfg))
    assert tcvae.param_count(model) == 8_056_639
    p, _ = jax.eval_shape(lambda k: jcvae.unimodal_cvae_init(k, jcvae.CVAEConfig(**cfg)),
                          jax.random.PRNGKey(0))
    assert jcvae.param_count(p) == 8_056_639


def test_init_is_seeded_and_device_independent():
    cfg = tcvae.CVAEConfig(**CFG)
    a = tcvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tcvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert float(a.encoder.linear.weight.detach().abs().max()) <= 1 / np.sqrt(512)
    assert int(a.encoder.bn1.num_batches_tracked) == 0


@pytest.mark.parametrize("use_class", [False, True])
@pytest.mark.parametrize("mode", ["train_masked", "train", "eval_noise", "eval_mu"])
def test_forward_matches_jax(jax_model, batch, mode, use_class):
    params, state = jax_model
    data, source, class_, eps, mask = batch
    training = mode.startswith("train")
    use_mask = mode == "train_masked"
    use_eps = mode != "eval_mu"
    (enc_j, mu_j, lv_j, dec_j), new_j = jcvae.unimodal_cvae_apply(
        params, state, jnp.asarray(data), jnp.asarray(source),
        jnp.asarray(class_) if use_class else None,
        eps=jnp.asarray(eps) if use_eps else None, training=training,
        mask=jnp.asarray(mask) if use_mask else None,
    )
    model = _port_from_jax(params, state, CFG).train(training)
    with torch.no_grad():
        outs = model(
            torch.from_numpy(data), torch.from_numpy(source).long(),
            torch.from_numpy(class_).long() if use_class else None,
            eps=torch.from_numpy(eps) if use_eps else None,
            mask=torch.from_numpy(mask) if use_mask else None,
        )
    rows = mask > 0 if use_mask else slice(None)
    for name, got, ref in zip(("encoded", "mu", "logvar", "decoded"), outs,
                              (enc_j, mu_j, lv_j, dec_j)):
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    new_sd = state_dict_from_jax(_numpy_tree(params), _numpy_tree(new_j))
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new_sd[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == int(new_sd[k]) == (1 if training else 0), k


def test_masked_tail_equals_unpadded_batch(jax_model, batch):
    """Rows with mask 0 do not change what the real rows get (reference
    semantics are unpadded per-batch statistics). Same tolerance as above:
    masked statistics sum in another order than the unpadded means."""
    params, state = jax_model
    data, source, class_, eps, mask = batch
    n = int(mask.sum())
    a = _port_from_jax(params, state, CFG).train()
    b = _port_from_jax(params, state, CFG).train()
    with torch.no_grad():
        full = a(torch.from_numpy(data), torch.from_numpy(source).long(), eps=torch.from_numpy(eps),
                 mask=torch.from_numpy(mask))
        small = b(torch.from_numpy(data[:n]), torch.from_numpy(source[:n]).long(),
                  eps=torch.from_numpy(eps[:n]))
    for got, ref in zip(full, small):
        np.testing.assert_allclose(got[:n].numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
