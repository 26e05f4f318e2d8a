""".ckpt I/O (train/checkpoint.py) against hippie_tpu.train.checkpoint and
hippie_tpu.train.optim.

A checkpoint written by either package loads into the other with every
weight, buffer and AdamW moment on the parameter of its name (compared key
by key, exactly), and one more step from it on both sides agrees:
- the loss rtol 1e-5 (the same weights, batch and noise);
- each parameter tensor's update (new minus loaded) to a relative L2 error
  of 5e-2 (measured at most 1.4e-2, a BatchNorm bias): the update is
  lr * m_hat / (sqrt(v_hat) + eps) with m and v carried over equal, so only
  the step's own gradients differ (relative L2 1e-3 per tensor,
  tests/test_torch_train.py), and AdamW's second step divides them by
  moments of the same size, which magnifies that error where g changes
  sign. Biases whose layer feeds a BatchNorm have a gradient that is
  rounding noise on both sides; they, and every element, stay within
  2 * lr per step of the other side.
The two packages' files have the same layout: keys, dtypes and shapes of
``state_dict``, the AdamW entries (``step`` a numpy float32, moments numpy
float32 arrays in torch layout), the param group and the other fields.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops import losses as jlosses
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import optim as joptim
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)

CFG = dict(z_dim=4, output_size=50, class_hidden_dim=3, num_sources=5, num_classes=5,
           num_blocks=(1, 1, 1, 1))
B, LR, WD = 16, 1e-3, 0.01
_TX = joptim.make_optimizer(LR, WD)
_ZERO_GRAD_BIAS = re.compile(
    r"(layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)|encoder\.linear|encoder_fc\.[03]|decoder_fc\.2)\.bias$")


@jax.jit
def _jax_step(params, bn, opt_state, bd, bs, bmask, eps):
    def loss_fn(p):
        (_, mu, logvar, dec), new_bn = jcvae.unimodal_cvae_apply(
            p, bn, bd, bs, None, eps=eps, training=True, mask=bmask)
        total, _ = jlosses.vae_loss(bd, dec, mu, logvar, beta=1.0, mask=bmask)
        return total, new_bn

    (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = _TX.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_bn, opt_state, loss, grads


def _shapes(cfg):
    """unimodal_cvae_init's (params, state) shapes in its own key order,
    without running it (tests/test_torch_multimodal.py:_init_shapes)."""
    seen = []
    jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(map(shapes, t))
        return jax.ShapeDtypeStruct(t.shape, t.dtype)

    return shapes(seen[0])


SHAPES = _shapes(jcvae.CVAEConfig(**CFG))


def _batches(n):
    r = np.random.default_rng(21)
    out = []
    for i in range(n):
        n_real = B - 3 * i
        bd = r.normal(size=(B, 50)).astype(np.float32)
        bs = r.integers(0, 5, size=B).astype(np.int32)
        eps = r.normal(size=(B, CFG["z_dim"])).astype(np.float32)
        bmask = (np.arange(B) < n_real).astype(np.float32)
        bd[n_real:], bs[n_real:] = bd[n_real - 1], bs[n_real - 1]
        out.append((bd, bs, bmask, eps))
    return out


def _port_model(seed, num_classes=5):
    return tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**{**CFG, "num_classes": num_classes}),
                                    torch.Generator().manual_seed(seed), device="cpu")


def _port_step(ts, batch):
    bd, bs, bmask, eps = (torch.from_numpy(x) for x in batch)
    batch_step, _ = tstep.make_unimodal_steps(beta=1.0, loss_backend="xla")
    return batch_step(ts, bd, bs.long(), None, bmask, eps=eps)[1]


def _flat(params, bn=None):
    return {k: np.asarray(v) for k, v in jckpt.to_torch_state_dict(params, bn, prefix="").items()}


def _assert_moments_equal(opt: torch.optim.Optimizer, keys, jax_opt, params, bn):
    """The port optimizer's moments, index by index, equal the JAX state's
    moments of the parameter with the same name (torch layout), exactly."""
    ref = joptim.adamw_state_to_torch(jax_opt, params, bn, lr=LR, weight_decay=WD)["state"]
    state = opt.state_dict()["state"]
    assert len(state) == len(ref) == len(keys) == len(jckpt.parameter_key_order(params, bn))
    for i, k in enumerate(keys):
        assert jckpt.parameter_key_order(params, bn)[i] == k
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(state[i][m].numpy(), ref[i][m], err_msg=f"{k} {m}")
        assert float(state[i]["step"]) == float(ref[i]["step"])


def _assert_continued_step_agrees(model, before, params, loss, loss_ref):
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    ref = _flat(params)
    checked = 0
    for k, p in model.named_parameters():
        v = p.detach().numpy()
        assert np.abs(v - ref[k]).max() <= 4 * LR, k
        if _ZERO_GRAD_BIAS.search(k):
            continue
        upd, upd_ref = v - before[k], ref[k] - before[k]
        assert np.linalg.norm(upd - upd_ref) <= 5e-2 * np.linalg.norm(upd_ref), k
        checked += 1
    assert checked > 30


@pytest.mark.parametrize("num_blocks", [(1, 1, 1, 1), (2, 2, 2, 2)])
def test_parameter_order_is_the_jax_order(num_blocks):
    """The optimizer's index order (model.parameters()) is the JAX package's
    parameter_key_order, name by name, and the state_dict order its
    flatten_interleaved order."""
    cfg = {**CFG, "num_blocks": num_blocks}
    with torch.device("meta"):
        model = tcvae.UnimodalCVAE(tcvae.CVAEConfig(**cfg))
    params, bn = _shapes(jcvae.CVAEConfig(**cfg))
    assert tckpt.parameter_key_order(model) == jckpt.parameter_key_order(params, bn)
    assert list(model.state_dict()) == list(jckpt.flatten_interleaved(params, bn))


def test_jax_ckpt_loads_into_the_port_and_continues(tmp_path):
    b0, b1 = _batches(2)
    params, bn, _, _ = jckpt.from_torch_state_dict(_port_model(3).state_dict(), *SHAPES, prefix="")
    params, bn, opt, _, _ = _jax_step(params, bn, _TX.init(params), *b0)
    # jit returns key-sorted dicts; the ckpt's order is the registration order
    params, bn = (jckpt.reorder_like(t, x) for t, x in zip(SHAPES, (params, bn)))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_lightning_ckpt(path, params, bn, optimizer_state=joptim.adamw_state_to_torch(
        opt, params, bn, lr=LR, weight_decay=WD))

    ck = tckpt.load_lightning_ckpt(path)
    model = _port_model(9)  # other weights, all overwritten
    assert tckpt.load_model_state(model, tckpt.model_state_from_ckpt(ck)) == []
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), _flat(params, bn)[k], err_msg=k)
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD))
    tckpt.load_optimizer_state(ts.optimizer, ck["optimizer_states"][0])
    keys = tckpt.parameter_key_order(model)
    _assert_moments_equal(ts.optimizer, keys, opt, params, bn)
    assert all(s["step"].dtype == torch.float32 for s in ts.optimizer.state_dict()["state"].values())

    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    m = _port_step(ts, b1)
    params2, bn2, opt2, loss, grads = _jax_step(params, bn, opt, *b1)
    _assert_continued_step_agrees(ts.model, before, params2, m.loss, loss)
    assert float(ts.optimizer.state_dict()["state"][0]["step"]) == 2.0


def test_port_ckpt_loads_into_jax_and_continues(tmp_path):
    b0, b1 = _batches(2)
    model = _port_model(4)
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD))
    _port_step(ts, b0)
    sd = model.state_dict()
    path = str(tmp_path / "port.ckpt")
    keys = tckpt.parameter_key_order(model)
    tckpt.save_lightning_ckpt(path, sd, optimizer_state=tckpt.adamw_state_to_torch(
        ts.optimizer.state_dict(), sd, keys, lr=LR, weight_decay=WD))

    ck = jckpt.load_lightning_ckpt(path)
    params, bn, loaded, skipped = jckpt.from_torch_state_dict(ck["state_dict"], *SHAPES)
    assert not skipped and len(loaded) == len(sd)
    opt = joptim.adamw_state_from_torch(ck["optimizer_states"][0], _TX.init(params), *SHAPES)
    for k, v in _flat(params, bn).items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)
    _assert_moments_equal(ts.optimizer, keys, opt, params, bn)

    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    params2, bn2, opt2, loss, grads = _jax_step(params, bn, opt, *b1)
    m = _port_step(ts, b1)
    _assert_continued_step_agrees(ts.model, before, params2, m.loss, loss)


def test_ckpt_layout_equals_the_jax_layout(tmp_path):
    """The same weights and moments written by both packages: the same
    fields, keys, dtypes, shapes and AdamW entry types."""
    model = _port_model(5)
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD))
    _port_step(ts, _batches(1)[0])
    sd = model.state_dict()
    keys = tckpt.parameter_key_order(model)
    tckpt.save_lightning_ckpt(str(tmp_path / "t.ckpt"), sd, optimizer_state=tckpt.adamw_state_to_torch(
        ts.optimizer.state_dict(), sd, keys, lr=LR, weight_decay=WD))
    params, bn, _, _ = jckpt.from_torch_state_dict(sd, *SHAPES, prefix="")
    opt = joptim.adamw_state_from_torch(
        tckpt.adamw_state_to_torch(ts.optimizer.state_dict(), sd, keys, lr=LR, weight_decay=WD),
        _TX.init(params), *SHAPES)
    jckpt.save_lightning_ckpt(str(tmp_path / "j.ckpt"), params, bn, optimizer_state=joptim.adamw_state_to_torch(
        opt, params, bn, lr=LR, weight_decay=WD))
    t, j = (torch.load(tmp_path / f"{x}.ckpt", weights_only=False) for x in "tj")
    assert list(t) == list(j)
    for field in ("epoch", "global_step", "pytorch-lightning_version", "hyper_parameters"):
        assert t[field] == j[field]
    assert list(t["state_dict"]) == list(j["state_dict"]) == list(jckpt.to_torch_state_dict(params, bn))
    for k, v in t["state_dict"].items():
        assert isinstance(v, torch.Tensor) and v.dtype == j["state_dict"][k].dtype, k
        assert torch.equal(v, j["state_dict"][k]), k
    (to,), (jo,) = t["optimizer_states"], j["optimizer_states"]
    assert to["param_groups"] == jo["param_groups"]
    assert list(to["state"]) == list(jo["state"]) == list(range(len(keys)))
    for i, e in to["state"].items():
        for m, v in e.items():
            ref = jo["state"][i][m]
            assert type(v) is type(ref) and v.dtype == ref.dtype and v.shape == ref.shape, (i, m)
            np.testing.assert_array_equal(v, ref)


def test_class_embedding_heals_on_a_class_count_change(tmp_path):
    """Quirk Q10: a ckpt of a 5-class model loads into a 4-class one with
    strict=False minus the class embedding, which keeps its fresh values; at
    the same class count it loads too."""
    src = _port_model(6)
    path = str(tmp_path / "five.ckpt")
    tckpt.save_lightning_ckpt(path, src.state_dict())
    state = tckpt.model_state_from_ckpt(tckpt.load_lightning_ckpt(path))
    dst = _port_model(7, num_classes=4)
    fresh = dst.class_embedding.weight.detach().clone()
    assert tckpt.load_model_state(dst, state) == ["class_embedding.weight"]
    assert torch.equal(dst.class_embedding.weight, fresh)
    for k, v in dst.state_dict().items():
        if k != "class_embedding.weight":
            assert torch.equal(v, src.state_dict()[k]), k
    same = _port_model(8)
    assert tckpt.load_model_state(same, state) == []
    assert torch.equal(same.class_embedding.weight, src.class_embedding.weight)
    with pytest.raises(RuntimeError):  # any other mismatch raises
        tckpt.load_model_state(tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**{**CFG, "z_dim": 5}),
                                                        torch.Generator().manual_seed(0), device="cpu"),
                               state)


def test_a_failed_write_leaves_no_file(tmp_path, monkeypatch):
    path = tmp_path / "x.ckpt"

    def broken_save(obj, f, *a, **k):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_lightning_ckpt(str(path), _port_model(0).state_dict())
    assert list(tmp_path.iterdir()) == []
