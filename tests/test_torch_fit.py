"""The fit loop (train/loop.py) against hippie_tpu.train.loop.

(a) Bookkeeping, exactly: both loops are driven by the same scripted
per-batch losses through plain callables; best epoch, epochs run, the
per-epoch losses, which epoch's state the best snapshot holds, the prints and
the log records must be equal, for improvement, early stopping at patience,
a tie (not an improvement), a NaN validation loss and max_epochs=0; a NaN
train loss raises in both. (b) ``limit_count`` and the epoch plans: the
port's ``limit_batches(batch_plan(...))`` equals the first ``n_keep`` rows of
``host_epoch_plan`` given the same order. (c) A 3-epoch run of the small
model (num_blocks=(1, 1, 1, 1), B=16) through both loops with the same
injected plans and noise.

Tolerances of (c), float32 on the CPU: the first step's loss rtol 1e-5 (the
same weights on both sides, as tests/test_torch_train.py); the first epoch's
mean train loss rtol 1e-5 (measured 3.1e-7) and its val loss, after three
steps, rtol 1e-3 (measured 1.1e-4); the later epochs' rtol 1e-2 (measured
2.2e-5 and 2.3e-3 train, 4.8e-5 and 1.4e-4 val), because the trajectories
drift after the first step within the 2 * lr envelope of AdamW's sign-like
first updates (test_torch_train.py: second-step loss rtol 2e-3); best epoch
and epochs run exactly; the best snapshot's weights within 2 * lr per step.
"""

import re
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hippie_tpu.data import device_data as jdd
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops import losses as jlosses
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import loop as jloop
from hippie_tpu.train import optim as joptim
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import loop as tloop
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)


class _M(NamedTuple):
    loss: object
    mse: object
    kl: object


# ---------------------------------------------------------------------------
# (a) bookkeeping on scripted losses
# ---------------------------------------------------------------------------

SCRIPTS = {
    # name: (train [epoch][batch], val [epoch][batch], patience, max_epochs)
    "improving": ([[3.0, 2.0], [1.5, 1.0], [0.9, 0.7]], [[2.0, 1.0], [1.0, 0.5], [0.4, 0.3]], 2, 3),
    "early_stop": ([[1.0]] * 6, [[1.0], [0.5], [0.7], [0.6], [0.1], [0.1]], 2, 6),
    "tie_is_not_better": ([[1.0]] * 4, [[0.5, 1.5], [1.0], [0.25, 1.75], [2.0]], 2, 4),
    "nan_val": ([[1.0]] * 4, [[0.5], [np.nan], [0.4], [0.6]], 3, 4),
    "no_patience": ([[1.0]] * 5, [[0.5], [0.6], [0.7], [0.8], [0.2]], None, 5),
    "no_epochs": ([], [], 2, 0),
}


def _jax_scripted(train, val):
    def run_train(state, key, epoch):
        t = np.asarray(train[epoch], np.float32)
        params = {"w": jnp.full((2,), float(epoch + 1))}
        return jstep.TrainState(params, state.bn_state, state.opt_state), _M(t, t / 2, t / 4)

    def run_val(state, key, epoch):
        v = np.asarray(val[epoch], np.float32)
        return _M(v, v / 2, v / 4)

    state = jstep.TrainState({"w": jnp.zeros((2,))}, {}, {"m": jnp.zeros((2,))})
    return state, run_train, run_val


def _port_scripted(train, val):
    model = torch.nn.Linear(2, 1)
    with torch.no_grad():
        model.weight.zero_()
    state = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), 1e-3))

    def run_train(state, key, epoch):
        t = torch.tensor(train[epoch], dtype=torch.float32)
        with torch.no_grad():
            state.model.weight.fill_(epoch + 1)
        return state, tstep.Metrics(t, t / 2, t / 4)

    def run_val(state, key, epoch):
        v = torch.tensor(val[epoch], dtype=torch.float32)
        return tstep.Metrics(v, v / 2, v / 4)

    return state, run_train, run_val


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_fit_bookkeeping_matches_jax(name, capsys):
    train, val, patience, max_epochs = SCRIPTS[name]
    logs = {"jax": [], "port": []}
    out = {}
    for side, make, fit in (("jax", _jax_scripted, jloop.fit), ("port", _port_scripted, tloop.fit)):
        state, run_train, run_val = make(train, val)
        out[side] = fit(state, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=max_epochs,
                        early_stopping_patience=patience, seed=3, log_fn=logs[side].append, lr=0.5)
        out[f"{side}_printed"] = capsys.readouterr().out
    j, t = out["jax"], out["port"]
    assert (t.best_epoch, t.epochs_run) == (j.best_epoch, j.epochs_run)
    assert t.train_losses == j.train_losses
    np.testing.assert_array_equal(t.val_losses, j.val_losses)  # NaN where NaN
    assert t.best_val_loss == j.best_val_loss
    assert out["port_printed"] == out["jax_printed"]
    assert len(logs["port"]) == len(logs["jax"]) == j.epochs_run
    for a, b in zip(logs["port"], logs["jax"]):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(list(a.values()), list(b.values()))
    # the snapshot holds the best epoch's state (the live state at max_epochs=0)
    want = j.best_epoch + 1 if j.best_epoch >= 0 else 0.0
    assert float(t.best_state_dict["weight"][0, 0]) == float(j.best_params["w"][0]) == want
    assert t.best_opt_state["param_groups"][0]["lr"] == 1e-3
    expected = {"improving": (2, 3), "early_stop": (1, 4), "tie_is_not_better": (0, 3),
                "nan_val": (2, 4), "no_patience": (4, 5), "no_epochs": (-1, 0)}[name]
    assert (j.best_epoch, j.epochs_run) == expected


def test_fit_snapshot_is_a_copy():
    """The best snapshot is a clone: later epochs leave it as it was."""
    state, run_train, run_val = _port_scripted([[1.0]] * 3, [[0.1], [0.5], [0.6]])
    r = tloop.fit(state, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=3, verbose=False)
    assert r.best_epoch == 0 and float(r.best_state_dict["weight"][0, 0]) == 1.0
    assert float(r.state.model.weight.detach()[0, 0]) == 3.0


@pytest.mark.parametrize("side", ["jax", "port"])
def test_nan_train_loss_raises(side):
    make, fit = (_jax_scripted, jloop.fit) if side == "jax" else (_port_scripted, tloop.fit)
    state, run_train, run_val = make([[1.0], [np.nan]], [[1.0], [1.0]])
    with pytest.raises(FloatingPointError, match="epoch 1"):
        fit(state, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=2, verbose=False)


def test_resume_dir_raises():
    state, run_train, run_val = _port_scripted([[1.0]], [[1.0]])
    with pytest.raises(ValueError, match="Queue 1 item 12"):
        tloop.fit(state, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=1,
                  resume_dir="/nonexistent")


def test_epoch_keys_depend_on_seed_and_epoch_alone():
    keys = {}

    def run_train(state, key, epoch):
        keys[("t", epoch)] = key
        return state, tstep.Metrics(torch.ones(1), torch.ones(1), torch.ones(1))

    def run_val(state, key, epoch):
        keys[("v", epoch)] = key
        return tstep.Metrics(torch.ones(1), torch.ones(1), torch.ones(1))

    state, _, _ = _port_scripted([], [])
    tloop.fit(state, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=3, seed=5,
              verbose=False)
    assert len(set(keys.values())) == 6
    assert keys[("t", 2)] == tloop.epoch_key(5, 4, 1) and keys[("v", 2)] == tloop.epoch_key(5, 4, 2)
    g1, g2 = tloop.key_generator(keys[("t", 1)], 0), tloop.key_generator(keys[("t", 1)], 0)
    assert torch.equal(torch.randperm(50, generator=g1), torch.randperm(50, generator=g2))


# ---------------------------------------------------------------------------
# (b) limits and epoch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,limit", [(10, None), (10, 0.5), (10, 0.01), (10, 1.0), (10, 3),
                                      (10, 30), (10, 3.0), (7, 2.5), (1, 0.5), (4, 0)])
def test_limit_count_matches_jax(nb, limit):
    assert tloop.limit_count(nb, limit) == jloop.limit_count(nb, limit)
    idx, mask = np.arange(nb * 3).reshape(nb, 3), np.ones((nb, 3), np.float32)
    for a, b in zip(tloop.limit_batches((idx, mask), limit), jloop.limit_batches((idx, mask), limit)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,batch,limit", [(37, 8, None), (37, 8, 2), (37, 8, 0.5), (64, 16, None),
                                           (5, 16, None), (1, 4, 1.0), (33, 16, 3)])
def test_epoch_plan_is_the_host_epoch_plan(n, batch, limit):
    """Given one order, the port's plan is the first n_keep rows of the JAX
    host loop's bucketed plan: real rows in order, pad slots holding the last
    real index, mask 1 on real rows only."""
    stream = np.random.default_rng(n).permutation(200)[:n]
    idx, mask = tloop.limit_batches(batch_plan(stream, batch, shuffle=False), limit)
    ref_idx, ref_mask, n_keep = jdd.host_epoch_plan(stream, batch, False, None, limit)
    assert idx.shape == (n_keep, batch)
    np.testing.assert_array_equal(idx, ref_idx[:n_keep])
    np.testing.assert_array_equal(mask, ref_mask[:n_keep])


# ---------------------------------------------------------------------------
# (c) three epochs of the small model through both loops
# ---------------------------------------------------------------------------

CFG = dict(z_dim=4, output_size=50, class_hidden_dim=3, num_sources=5, num_classes=5,
           num_blocks=(1, 1, 1, 1))
B, LR, WD, EPOCHS = 16, 1e-3, 0.01, 3
_TX = joptim.make_optimizer(LR, WD)
_ZERO_GRAD_BIAS = re.compile(
    r"(layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)|encoder\.linear|encoder_fc\.[03]|decoder_fc\.2)\.bias$")


@jax.jit
def _jax_train_step(params, bn, opt_state, bd, bs, bmask, eps):
    def loss_fn(p):
        (_, mu, logvar, dec), new_bn = jcvae.unimodal_cvae_apply(
            p, bn, bd, bs, None, eps=eps, training=True, mask=bmask)
        total, (mse, kl) = jlosses.vae_loss(bd, dec, mu, logvar, beta=1.0, mask=bmask)
        return total, (new_bn, mse, kl)

    (loss, (new_bn, mse, kl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = _TX.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_bn, opt_state, jnp.stack([loss, mse, kl])


@jax.jit
def _jax_eval_step(params, bn, bd, bs, bmask, eps):
    (_, mu, logvar, dec), _ = jcvae.unimodal_cvae_apply(params, bn, bd, bs, None, eps=eps,
                                                        training=False, mask=bmask)
    total, (mse, kl) = jlosses.vae_loss(bd, dec, mu, logvar, beta=1.0, mask=bmask)
    return jnp.stack([total, mse, kl])


def _unimodal_shapes(cfg):
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


def test_three_epochs_match_the_jax_host_loop():
    r = np.random.default_rng(0)
    n = 60
    data = r.normal(size=(n, 50)).astype(np.float32)
    source = r.integers(0, 5, size=n).astype(np.int32)
    train_idx, val_idx = np.arange(40), np.arange(40, n)
    plans = [batch_plan(train_idx[r.permutation(40)], B, shuffle=False) for _ in range(EPOCHS)]
    val_plan = batch_plan(val_idx, B, shuffle=False)
    eps = r.normal(size=(EPOCHS, 2, 3, B, CFG["z_dim"])).astype(np.float32)  # [epoch, t/v, batch]

    model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**CFG), torch.Generator().manual_seed(3),
                                     device="cpu")
    params, bn, _, skipped = jckpt.from_torch_state_dict(
        model.state_dict(), *_unimodal_shapes(jcvae.CVAEConfig(**CFG)), prefix="")
    assert not skipped

    def jax_train(state, key, epoch):
        p, s, o = state
        ms = []
        idx, mask = plans[epoch]
        for i in range(idx.shape[0]):
            p, s, o, m = _jax_train_step(p, s, o, data[idx[i]], source[idx[i]], mask[i], eps[epoch, 0, i])
            ms.append(m)
        ms = np.asarray(jnp.stack(ms))
        return jstep.TrainState(p, s, o), _M(ms[:, 0], ms[:, 1], ms[:, 2])

    def jax_val(state, key, epoch):
        idx, mask = val_plan
        ms = np.asarray(jnp.stack([_jax_eval_step(state.params, state.bn_state, data[idx[i]],
                                                  source[idx[i]], mask[i], eps[epoch, 1, i])
                                   for i in range(idx.shape[0])]))
        return _M(ms[:, 0], ms[:, 1], ms[:, 2])

    ref = jloop.fit(jstep.TrainState(params, bn, _TX.init(params)), run_train_epoch=jax_train,
                    run_val_epoch=jax_val, max_epochs=EPOCHS, early_stopping_patience=1, verbose=False)

    train_epoch, eval_epoch = tstep.make_unimodal_epoch_fns(loss_backend="pallas")
    tdata, tsource = torch.from_numpy(data), torch.from_numpy(source).long()
    first = []

    def port_train(state, key, epoch):
        idx, mask = plans[epoch]
        state, ms = train_epoch(state, tdata, tsource, None, idx, mask,
                                eps=torch.from_numpy(eps[epoch, 0, :idx.shape[0]]))
        first.append(float(ms.loss[0]))
        return state, ms

    def port_val(state, key, epoch):
        idx, mask = val_plan
        return eval_epoch(state.model, tdata, tsource, None, idx, mask,
                          eps=torch.from_numpy(eps[epoch, 1, :idx.shape[0]]))

    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD))
    got = tloop.fit(ts, run_train_epoch=port_train, run_val_epoch=port_val, max_epochs=EPOCHS,
                    early_stopping_patience=1, verbose=False)

    ms0 = _jax_train_step(params, bn, _TX.init(params), data[plans[0][0][0]], source[plans[0][0][0]],
                          plans[0][1][0], eps[0, 0, 0])[3]
    np.testing.assert_allclose(first[0], float(ms0[0]), rtol=1e-5)
    assert (got.best_epoch, got.epochs_run) == (ref.best_epoch, ref.epochs_run)
    assert got.epochs_run == EPOCHS and got.best_epoch == EPOCHS - 1  # the loss falls every epoch
    np.testing.assert_allclose(got.train_losses[0], ref.train_losses[0], rtol=1e-5)
    np.testing.assert_allclose(got.val_losses[0], ref.val_losses[0], rtol=1e-3)
    np.testing.assert_allclose(got.train_losses[1:], ref.train_losses[1:], rtol=1e-2)
    np.testing.assert_allclose(got.val_losses[1:], ref.val_losses[1:], rtol=1e-2)
    # the best snapshot: the last epoch's weights, within the 2 * lr envelope per step
    steps = sum(p[0].shape[0] for p in plans)
    best = {k: np.asarray(v) for k, v in jckpt.to_torch_state_dict(ref.best_params, ref.best_bn_state,
                                                                     prefix="").items()}
    for k, v in got.best_state_dict.items():
        if "running_" in k or k.endswith("num_batches_tracked") or _ZERO_GRAD_BIAS.search(k):
            continue
        assert np.abs(v.numpy() - best[k]).max() <= 2 * steps * LR, k
    assert int(got.best_opt_state["state"][0]["step"]) == steps == int(
        joptim._find_adam_state(ref.best_opt_state).count)
