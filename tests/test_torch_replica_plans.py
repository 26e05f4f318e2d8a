"""The replica-plan device fit (train/ensemble.py:device_fit_replica_plans)
against the replica-plan host fit (``host_fit_replica_plans``), and against
the JAX ``device_fit_replica_plans``.

(a) On the CPU the device fit runs its replicas' steps eagerly over the
static buffers its CUDA graphs read on the card (train/device_fit.py:
StepGraph with one plan per model). K=3 replicas on distinct fixed plans
(2 train batches and 1 val batch of B=8 each, the last train batch
padded) with their own seeds and patience 1 stop at different epochs; the
device fit must give the host fit's result bit for bit: every replica's
parameters and BatchNorm buffers (frozen at its own stop), best snapshots,
best losses and epochs, epochs run and the per-epoch losses, NaN after each
replica's stop, for the unimodal model and for the joint model with class
labels (num_blocks=(1, 1, 1, 1), z=4). A replica's frozen state equals a
run of the same program cut at its stop epoch without patience (the JAX
``test_replica_plans_per_replica_freeze``). A non-finite train loss raises
FloatingPointError naming its epoch only for a replica still training.

(b) The JAX program and the port's, driven by one deterministic stub (a
linear map per replica trained by plain gradient descent at its own rate
on its own plan, no noise, the same weights from numpy): where the two
programs agree (no replica improves after its stop) the best and stop
epochs and ``epochs_run`` exactly, the losses up to each stop and the best
weights within rtol 1e-6 (float32 on both sides, as
tests/test_torch_device_ensemble.py holds the shared-plan fit), the frozen
weights within rtol 1e-6 and atol 1e-7. A scripted
stub whose first replica improves after its stop shows ROADMAP Queue 3
decision 1: the JAX program moves that replica's best past its stop and
reports its losses there; the port keeps the best of its own fit and
reports NaN.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.train import ensemble as jens
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import ensemble as tens
from hippie_tpu_torch.train import loop as tloop
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)

B, K = 8, 3
_R = np.random.default_rng(0)
WAVE = torch.from_numpy(_R.normal(size=(40, 50)).astype(np.float32))
ISI = torch.from_numpy(_R.normal(size=(40, 100)).astype(np.float32))
SRC = torch.zeros(40, dtype=torch.long)
LABELS = torch.from_numpy(_R.integers(0, 3, size=40)).long()
SEEDS = [1042, 1052, 1062]


def _plans(streams):
    return tuple(np.stack(p) for p in zip(*(batch_plan(s, B, shuffle=False) for s in streams)))


T_IDX, T_MASK = _plans([np.arange(0, 14), np.arange(8, 24), np.arange(16, 30)])
V_IDX, V_MASK = _plans([np.arange(30, 35), np.arange(33, 38), np.arange(35, 40)])
# (model, lr, class labels): each case's replicas stop at two different epochs
CASES = {"unimodal": (False, 1e-2, False), "joint-labels": (True, 3e-3, True)}


def _states(joint: bool, lr: float):
    if joint:
        cfg, init = tcvae.MultiModalConfig(z_dim=4, num_classes=3, num_blocks=(1, 1, 1, 1)), tcvae.multimodal_cvae_init
    else:
        cfg, init = tcvae.CVAEConfig(z_dim=4, output_size=50, num_classes=3, num_blocks=(1, 1, 1, 1)), \
            tcvae.unimodal_cvae_init
    models = [init(cfg, tloop.key_generator(5, k), device="cpu") for k in range(K)]
    return [tstep.TrainState(m, toptim.make_optimizer(m.parameters(), lr, 0.01, 1.0)) for m in models]


def _fit(fit_loop: str, case: str, max_epochs: int = 5, patience=1):
    joint, lr, labels = CASES[case]
    kw = dict(arrays=(WAVE, ISI) if joint else (WAVE,), source=SRC, class_=LABELS, train_idx=T_IDX,
              train_mask=T_MASK, val_idx=V_IDX, val_mask=V_MASK, max_epochs=max_epochs,
              early_stopping_patience=patience, seeds=SEEDS)
    if fit_loop == "device":
        batch_step, eval_step = (tstep.make_multimodal_steps if joint else tstep.make_unimodal_steps)()
        return tens.device_fit_replica_plans(_states(joint, lr), batch_step=batch_step, eval_step=eval_step,
                                             use_class_labels=labels, **kw)
    fns = (tens.make_multimodal_ensemble_epoch_fns if joint else tens.make_unimodal_ensemble_epoch_fns)(
        use_class_labels=labels)
    return tens.host_fit_replica_plans(_states(joint, lr), epoch_fns=fns, **kw)


def _equal_sd(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _stop_epochs(res) -> list:
    """Each replica's last epoch: the epochs before its first NaN loss."""
    vl = np.asarray(res.val_losses)
    return [int(np.argmax(np.isnan(col))) - 1 if np.isnan(col).any() else len(col) - 1 for col in vl.T]


@pytest.fixture(scope="module")
def unimodal_device():
    return _fit("device", "unimodal")


@pytest.mark.parametrize("case", list(CASES))
def test_device_replica_plans_equal_the_host_fit(case, unimodal_device):
    dev = unimodal_device if case == "unimodal" else _fit("device", case)
    host = _fit("host", case)
    for a, b in zip(dev.state, host.state):
        assert _equal_sd(a.model.state_dict(), b.model.state_dict())
    assert all(_equal_sd(a, b) for a, b in zip(dev.best_state_dict, host.best_state_dict))
    assert np.array_equal(dev.best_val_loss, host.best_val_loss)
    assert np.array_equal(dev.best_epoch, host.best_epoch) and dev.epochs_run == host.epochs_run
    for name in ("train_losses", "val_losses"):
        assert np.array_equal(np.asarray(getattr(dev, name)), np.asarray(getattr(host, name)), equal_nan=True)
    stops = _stop_epochs(dev)
    assert len(set(stops)) > 1 and max(stops) == dev.epochs_run - 1  # own stops; the last ends the fit
    for r, s in enumerate(stops):  # NaN exactly after each replica's stop
        assert np.isnan(np.asarray(dev.train_losses)[s + 1:, r]).all()
        assert np.isfinite(np.asarray(dev.train_losses)[:s + 1, r]).all()
    assert dev.graphs["captured"] is False  # no graphs off the card


def test_frozen_state_is_the_truncated_run(unimodal_device):
    """Replica k's state is the program's state after k's stop epoch: a run
    with the epoch budget cut there and no patience gives the same
    parameters and BatchNorm buffers bit for bit."""
    stops = _stop_epochs(unimodal_device)
    for stop in sorted(set(stops)):
        cut = _fit("device", "unimodal", max_epochs=stop + 1, patience=None)
        assert cut.epochs_run == stop + 1
        for r in (r for r, s in enumerate(stops) if s == stop):
            assert _equal_sd(unimodal_device.state[r].model.state_dict(), cut.state[r].model.state_dict())


def test_plans_and_seeds_must_match_the_replicas():
    batch_step, eval_step = tstep.make_unimodal_steps()
    with pytest.raises(ValueError, match="plans of 3/3 replicas and 2 seeds for 3 replicas"):
        tens.device_fit_replica_plans(_states(False, 1e-3), batch_step=batch_step, eval_step=eval_step,
                                      arrays=(WAVE,), source=SRC, class_=None, train_idx=T_IDX, train_mask=T_MASK,
                                      val_idx=V_IDX, val_mask=V_MASK, max_epochs=1, seeds=SEEDS[:2])


# --- (b) against the JAX device_fit_replica_plans ---------------------------

D, KOUT = 8, 3
STUB_LRS = (0.01, 0.004, 0.02)


def _stub_data():
    r = np.random.default_rng(3)
    x = r.normal(size=(40, D)).astype(np.float32)
    y = x @ r.normal(size=(D, KOUT)).astype(np.float32)
    y[30:] *= 0.3  # the val rows' map: training overshoots it, so val turns and patience fires
    return x, y.astype(np.float32)


def _jax_linear():
    def sums(w, bx, by, mask):
        err = (bx @ w - by) * mask[:, None]
        n = jnp.maximum(mask.sum(), 1.0)
        return err, n, jnp.sum(err * err) / n

    def batch_step(t, bx, by, bs, bc, mask, key):
        err, n, mse = sums(t.params["w"], bx, by, mask)
        kl = jnp.sum(jnp.abs(t.params["w"])) * 1e-3
        w = t.params["w"] - t.opt_state["lr"] * 2.0 * (bx.T @ err) / n
        return t._replace(params={"w": w}), jstep.Metrics(mse + kl, mse, kl)

    def eval_step(params, bn, bx, by, bs, bc, mask, key):
        _, _, mse = sums(params["w"], bx, by, mask)
        kl = jnp.sum(jnp.abs(params["w"])) * 1e-3
        return jstep.Metrics(mse + kl, mse, kl)

    return batch_step, eval_step


def _port_linear():
    def sums(w, bx, by, mask):
        err = (bx @ w - by) * mask[:, None]
        n = torch.clamp(mask.sum(), min=1.0)
        return err, n, torch.sum(err * err) / n

    @torch.no_grad()
    def batch_step(ts, bx, by, bs, bc, mask, *, eps=None, generator=None):
        w = ts.model.w
        err, n, mse = sums(w, bx, by, mask)
        kl = torch.sum(torch.abs(w)) * 1e-3
        w -= ts.optimizer.param_groups[0]["lr"] * (2.0 * (bx.T @ err) / n)
        return ts, tstep.Metrics(mse + kl, mse, kl)

    @torch.no_grad()
    def eval_step(model, bx, by, bs, bc, mask, *, eps=None, generator=None):
        _, _, mse = sums(model.w, bx, by, mask)
        kl = torch.sum(torch.abs(model.w)) * 1e-3
        return tstep.Metrics(mse + kl, mse, kl)

    return batch_step, eval_step


def _stub_states(w0: np.ndarray, lrs):
    states = []
    for w, lr in zip(w0, lrs):
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        model.z_mean = types.SimpleNamespace(out_features=1)  # the noise buffer's width (unused by the stubs)
        states.append(tstep.TrainState(model, torch.optim.SGD(model.parameters(), lr=lr)))
    return states


def _both(jax_steps, port_steps, arrays, w0, lrs, t_plan, v_plan, max_epochs, patience):
    """(JAX result, port result) of the same stub fit."""
    j_arrays = tuple(jnp.asarray(a) for a in arrays)
    n = len(arrays[0])
    ts = jstep.TrainState({"w": jnp.asarray(w0)}, {}, {"lr": jnp.asarray(lrs, jnp.float32)})
    jres = jens.device_fit_replica_plans(
        ts, batch_step=jax_steps[0], eval_step=jax_steps[1], arrays=j_arrays, source=jnp.zeros(n, jnp.int32),
        class_=None, train_idx=t_plan[0], train_mask=t_plan[1], val_idx=v_plan[0], val_mask=v_plan[1],
        max_epochs=max_epochs, early_stopping_patience=patience, seed=11)
    tres = tens.device_fit_replica_plans(
        _stub_states(w0, lrs), batch_step=port_steps[0], eval_step=port_steps[1],
        arrays=tuple(torch.from_numpy(a) for a in arrays), source=torch.zeros(n, dtype=torch.long), class_=None,
        train_idx=t_plan[0], train_mask=t_plan[1], val_idx=v_plan[0], val_mask=v_plan[1], max_epochs=max_epochs,
        early_stopping_patience=patience, seeds=[11, 12, 13][:len(lrs)])
    return jres, tres


def _stub_plans(streams, batch):
    return tuple(np.stack(p) for p in zip(*(batch_plan(s, batch, shuffle=False) for s in streams)))


def test_stub_replica_plans_match_the_jax_program():
    x, y = _stub_data()
    w0 = np.random.default_rng(5).normal(size=(len(STUB_LRS), D, KOUT)).astype(np.float32) * 0.1
    t_plan = _stub_plans([np.arange(0, 12), np.arange(6, 18), np.arange(14, 26)], 4)
    v_plan = _stub_plans([np.arange(30, 36), np.arange(32, 38), np.arange(34, 40)], 4)
    jres, tres = _both(_jax_linear(), _port_linear(), (x, y), w0, STUB_LRS, t_plan, v_plan, 12, 2)
    stops = _stop_epochs(tres)
    assert len(set(stops)) == 3 and tres.epochs_run == jres.epochs_run == max(stops) + 1  # one runs to the end
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)
    np.testing.assert_allclose(tres.best_val_loss, jres.best_val_loss, rtol=1e-6)
    for name in ("train_losses", "val_losses"):
        got, want = np.asarray(getattr(tres, name)), np.asarray(getattr(jres, name))
        for r, s in enumerate(stops):  # the JAX program reports a stopped replica's steps on; the port NaN
            np.testing.assert_allclose(got[:s + 1, r], want[:s + 1, r], rtol=1e-6)
            assert np.isnan(got[s + 1:, r]).all() and np.isfinite(want[s + 1:, r]).all()
    for r in range(len(STUB_LRS)):
        np.testing.assert_allclose(tres.best_state_dict[r]["w"].numpy(), np.asarray(jres.best_params["w"][r]),
                                   rtol=1e-6)
        # the frozen weights also within atol 1e-7, the float32 ulp of the
        # weights' unit scale: an entry near 0 moved 1.7e-8 over 12 epochs
        np.testing.assert_allclose(tres.state[r].model.w.detach().numpy(), np.asarray(jres.state.params["w"][r]),
                                   rtol=1e-6, atol=1e-7)


def test_stub_queue3_decision1_differs_from_the_jax_program():
    """Scripted validation losses (each replica's val row holds its loss per
    epoch; the stub's weight counts the steps): replica 0 stops at epoch 1
    with patience 1 and would improve at epochs 2 and 3. The JAX program
    takes epoch 3 as its best and reports those losses; the port keeps
    epoch 0, reports NaN after the stop, and freezes the same state."""
    table = np.zeros((4, 4), np.float32)
    table[2], table[3] = [1.0, 2.0, 0.5, 0.25], [2.0, 1.5, 1.0, 0.75]

    def j_train(t, bx, bs, bc, mask, key):
        one = jnp.ones((), jnp.float32)
        return t._replace(params={"w": t.params["w"] + 1.0}), jstep.Metrics(one, one, one)

    def j_eval(params, bn, bx, bs, bc, mask, key):
        v = jnp.take(bx[0], params["w"][0].astype(jnp.int32) - 1)
        return jstep.Metrics(v, v, v)

    @torch.no_grad()
    def t_train(ts, bx, bs, bc, mask, *, eps=None, generator=None):
        ts.model.w += 1.0
        one = torch.ones(())
        return ts, tstep.Metrics(one, one, one)

    @torch.no_grad()
    def t_eval(model, bx, bs, bc, mask, *, eps=None, generator=None):
        v = bx[0, int(model.w[0]) - 1]
        return tstep.Metrics(v, v, v)

    t_plan = _stub_plans([np.arange(0, 1), np.arange(1, 2)], 1)
    v_plan = _stub_plans([np.arange(2, 3), np.arange(3, 4)], 1)
    jres, tres = _both((j_train, j_eval), (t_train, t_eval), (table,), np.zeros((2, 1), np.float32), (0.1, 0.1),
                       t_plan, v_plan, 4, 1)
    assert jres.epochs_run == tres.epochs_run == 4
    assert np.asarray(jres.best_epoch).tolist() == [3, 3] and tres.best_epoch.tolist() == [0, 3]
    assert np.asarray(jres.best_val_loss).tolist() == [0.25, 0.75] and tres.best_val_loss.tolist() == [1.0, 0.75]
    assert np.asarray(jres.val_losses)[2].tolist() == [0.5, 1.0]
    assert np.isnan(tres.val_losses[2][0]) and tres.val_losses[2][1] == 1.0
    assert float(np.asarray(jres.best_params["w"])[0, 0]) == 4.0 and float(tres.best_state_dict[0]["w"][0]) == 1.0
    for r, steps in enumerate((2.0, 4.0)):  # the frozen states agree: replica 0 after its stop epoch
        assert float(np.asarray(jres.state.params["w"])[r, 0]) == float(tres.state[r].model.w.detach()[0]) == steps


@pytest.mark.parametrize("bad_replica,raises", [(0, False), (1, True)], ids=["stopped", "training"])
def test_non_finite_train_loss_of_a_training_replica_raises(bad_replica, raises):
    """Scripted train losses, inf from epoch 2 on for one replica: replica 0
    (stopped at epoch 1 by patience 1) steps on inside the graph but no
    longer counts, so its inf is reported as NaN; replica 1 still trains,
    so its inf raises FloatingPointError naming epoch 2."""
    table = np.zeros((2, 4), np.float32)
    table[0], table[1] = [1.0, 2.0, 3.0, 4.0], [2.0, 1.5, 1.0, 0.75]  # val rows: replica 0 stops at epoch 1

    @torch.no_grad()
    def train(ts, bx, bs, bc, mask, *, eps=None, generator=None):
        ts.model.w += 1.0
        loss = torch.tensor(float("inf") if ts.model.w[0] >= 3 and ts.model.r == bad_replica else 1.0)
        return ts, tstep.Metrics(loss, loss, loss)

    @torch.no_grad()
    def evaluate(model, bx, bs, bc, mask, *, eps=None, generator=None):
        v = bx[0, int(model.w[0]) - 1]
        return tstep.Metrics(v, v, v)

    states = _stub_states(np.zeros((2, 1), np.float32), (0.1, 0.1))
    for r, ts in enumerate(states):
        ts.model.r = r
    plan = _stub_plans([np.arange(0, 1), np.arange(1, 2)], 1)
    kw = dict(batch_step=train, eval_step=evaluate, arrays=(torch.from_numpy(table),), source=torch.zeros(2).long(),
              class_=None, train_idx=plan[0], train_mask=plan[1], val_idx=plan[0], val_mask=plan[1], max_epochs=4,
              early_stopping_patience=1, seeds=[11, 12])
    if raises:
        with pytest.raises(FloatingPointError, match="at epoch 2"):
            tens.device_fit_replica_plans(states, **kw)
        return
    res = tens.device_fit_replica_plans(states, **kw)
    assert res.epochs_run == 4 and np.isnan(np.asarray(res.train_losses)[2:, 0]).all()
    assert float(res.state[0].model.w.detach()[0]) == 2.0  # frozen after its stop epoch
