"""The port's device fit loop (train/device_fit.py) against its host loop
(train/loop.py), and against the JAX ``device_fit``.

(a) On the CPU the device loop runs its step functions eagerly over the
static buffers a CUDA graph reads on the card; it must give the host loop's
trajectory bit for bit through ``pipeline.fit_*_stage``: per-epoch losses,
best epoch, epochs run, parameters, BatchNorm buffers, optimizer state, the
best snapshot and the log records, for shuffled and fixed plans, class
labels, ``limit_train_batches`` 2 and 0.5, early stopping at patience 2,
the joint model and schedule-free; chunked progress keeps the trajectory
and the records; ``log_steps`` records one row per executed batch; zero
epochs return the untouched state; each loop resumes the other's stage and
an early-stopped stage resumes as a no-op; a non-finite loss raises
FloatingPointError naming the same epoch in both loops. (num_blocks=(1, 1,
1, 1), z=4, B=16, 40 train and 12 val rows, as tests/test_device_fit.py.)

(b) The JAX ``device_fit`` and the port's, driven by one deterministic stub
(a linear map trained by plain gradient descent, no noise, the same weights
from numpy, ``shuffle=False``, 8 epochs, patience 2): epochs run, best
epoch and the log records' epochs exactly; per-epoch losses, the per-step
records and the best weights within rtol 1e-6 (float32 on both sides; the
JAX loop sums its epoch means on the device, the port takes numpy's mean
of the fetched values).
"""

import dataclasses
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.train import device_fit as jdfit
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import device_fit as tdfit
from hippie_tpu_torch.train import loop as tloop
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import pipeline as tpipe
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)

N, B = 52, 16


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    return (torch.from_numpy(r.normal(size=(N, 50)).astype(np.float32)),
            torch.from_numpy(r.normal(size=(N, 100)).astype(np.float32)),
            torch.zeros(N, dtype=torch.long),
            torch.from_numpy(r.integers(0, 3, size=N)).long())


def _stage(data, fit_loop, *, max_epochs=3, joint=False, lr=3e-3, use_class_labels=False,
           shuffle=True, resume_dir=None, **cfg):
    """One stage fit of a fresh seeded model through the pipeline's stage
    fit; returns (FitResult, log records)."""
    wave, isi, src, labels = data
    logs = []
    pcfg = tpipe.PipelineConfig(seed=7, verbose=False, device="cpu", fit_loop=fit_loop,
                                early_stopping_patience=None, log_fn=logs.append)
    pcfg = dataclasses.replace(pcfg, **cfg)
    if joint:
        model = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(z_dim=4, num_classes=3, num_blocks=(1, 1, 1, 1)),
                                           tloop.key_generator(1, 0), device="cpu")
        fit, kw = tpipe.fit_multimodal_stage, {"wave": wave, "isi": isi}
    else:
        model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=4, num_classes=3, num_blocks=(1, 1, 1, 1)),
                                         tloop.key_generator(1, 0), device="cpu")
        fit, kw = tpipe.fit_unimodal_stage, {"data": wave, "beta": 1.0}
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), lr, 0.01, 1.0,
                                                       algorithm=pcfg.optimizer))
    res = fit(cfg=pcfg, ts=ts, **kw, source=src, class_=labels, train_indices=np.arange(40),
              val_indices=np.arange(40, N), batch_size=B, max_epochs=max_epochs,
              use_class_labels=use_class_labels, shuffle_train=shuffle, stage_seed=3, lr=lr,
              resume_dir=resume_dir)
    return res, logs


def _equal(a, b, path="state"):
    """Bit-equality of two trees of tensors, numbers and containers."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _same_fit(r, s):
    assert (r.epochs_run, r.best_epoch, r.best_val_loss) == (s.epochs_run, s.best_epoch, s.best_val_loss)
    assert r.train_losses == s.train_losses and r.val_losses == s.val_losses
    _equal(r.state.model.state_dict(), s.state.model.state_dict(), "model")
    _equal(r.state.optimizer.state_dict(), s.state.optimizer.state_dict(), "optimizer")
    _equal(r.best_state_dict, s.best_state_dict, "best")
    _equal(r.best_opt_state, s.best_opt_state, "best_opt")


@pytest.mark.parametrize("kw", [
    dict(shuffle=True),
    dict(shuffle=False, use_class_labels=True),
    dict(limit_train_batches=2),
    dict(limit_train_batches=0.5),
    dict(max_epochs=8, early_stopping_patience=2, lr=1e-2, limit_train_batches=1),
    dict(joint=True, use_class_labels=True, max_epochs=2),
    dict(optimizer="schedule-free", max_epochs=3),
], ids=["shuffle", "fixed-plan-labels", "limit-2", "limit-half", "early-stop", "joint", "schedule-free"])
def test_device_loop_is_the_host_loop_bit_for_bit(data, kw):
    host, host_logs = _stage(data, "host", **kw)
    dev, dev_logs = _stage(data, "device", **kw)
    _same_fit(dev, host)
    assert dev_logs == host_logs
    if "early_stopping_patience" in kw:
        assert host.epochs_run < kw["max_epochs"]  # the stop fired


def test_chunked_progress_and_step_records(data, capsys):
    """progress_every=2 against 0: the same fit, prints and epoch records;
    log_steps adds one record per executed train batch after them, whose
    per-epoch mean is the epoch's train loss."""
    one, logs_one = _stage(data, "device", max_epochs=5, progress_every=0, limit_train_batches=1)
    out_one = capsys.readouterr().out
    chk, logs_chk = _stage(data, "device", max_epochs=5, progress_every=2, verbose=True,
                           limit_train_batches=1)
    out_chk = capsys.readouterr().out
    _same_fit(chk, one)
    assert logs_chk == logs_one and out_one == ""
    assert out_chk.count("Average training loss is") == 5
    steps, step_logs = _stage(data, "device", max_epochs=5, log_every_step=True, limit_train_batches=2)
    epoch_recs = [r for r in step_logs if "train_loss" in r]
    step_recs = [r for r in step_logs if "train_loss_step" in r]
    assert step_logs == epoch_recs + step_recs
    assert [(r["epoch"], r["step"]) for r in step_recs] == [(e, 2 * e + i) for e in range(5) for i in range(2)]
    for e, rec in enumerate(epoch_recs):
        losses = np.asarray([r["train_loss_step"] for r in step_recs if r["epoch"] == e], np.float32)
        assert float(np.mean(losses)) == rec["train_loss"]
    assert set(step_recs[0]) == {"epoch", "step", "train_loss_step", "train_mse_step", "train_kl_step"}


def test_zero_epochs_returns_the_untouched_state(data):
    res, logs = _stage(data, "device", max_epochs=0)
    assert (res.epochs_run, res.best_epoch, res.best_val_loss, logs) == (0, -1, float("inf"), [])
    fresh = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=4, num_classes=3, num_blocks=(1, 1, 1, 1)),
                                     tloop.key_generator(1, 0), device="cpu")
    _equal(res.best_state_dict, fresh.state_dict())


@pytest.mark.parametrize("first,then", [("host", "device"), ("device", "host")])
def test_each_loop_resumes_the_other(data, tmp_path, first, then):
    """Two epochs in one loop, the rest resumed by the other: the
    uninterrupted fit of the second loop, bit for bit."""
    full, _ = _stage(data, then, max_epochs=4)
    _stage(data, first, max_epochs=2, resume_dir=str(tmp_path))
    resumed, _ = _stage(data, then, max_epochs=4, resume_dir=str(tmp_path))
    assert resumed.train_losses == full.train_losses[2:] and resumed.epochs_run == 4
    assert resumed.best_epoch == full.best_epoch and resumed.best_val_loss == full.best_val_loss
    _equal(resumed.state.model.state_dict(), full.state.model.state_dict(), "model")
    _equal(resumed.best_state_dict, full.best_state_dict, "best")


def test_early_stopped_resume_is_a_no_op(data, tmp_path, capsys):
    kw = dict(max_epochs=8, early_stopping_patience=1, lr=1e-2, limit_train_batches=1,
              resume_dir=str(tmp_path))
    first, _ = _stage(data, "device", **kw)
    assert first.epochs_run < 8
    again, logs = _stage(data, "device", verbose=True, **kw)
    assert "nothing to resume" in capsys.readouterr().out and logs == []
    assert (again.epochs_run, again.best_epoch, again.train_losses) == (first.epochs_run, first.best_epoch, [])
    _equal(again.best_state_dict, first.best_state_dict, "best")


def test_non_finite_loss_raises_with_its_epoch(data):
    said = []
    for fit_loop in ("host", "device"):
        with pytest.raises(FloatingPointError, match=r"non-finite training loss at epoch \d+") as e:
            _stage(data, fit_loop, max_epochs=6, lr=1e12)
        said.append(re.search(r"at epoch (\d+)", str(e.value)).group(1))
    assert said[0] == said[1]


# ---------------------------------------------------------------------------
# (b) the JAX device_fit on a deterministic stub
# ---------------------------------------------------------------------------

LR_STUB, D, K = 0.05, 8, 3


def _stub_data():
    r = np.random.default_rng(3)
    x = r.normal(size=(40, D)).astype(np.float32)
    w1 = r.normal(size=(D, K)).astype(np.float32)
    y = x @ w1
    y[30:] *= 0.3  # the val rows' map: training overshoots it, so val turns and patience fires
    return x, y.astype(np.float32)


def _jax_stub():
    def sums(w, bx, by, mask):
        err = (bx @ w - by) * mask[:, None]
        n = jnp.maximum(mask.sum(), 1.0)
        return err, n, jnp.sum(err * err) / n

    def batch_step(t, bx, by, bs, bc, mask, key):
        err, n, mse = sums(t.params["w"], bx, by, mask)
        grad = 2.0 * (bx.T @ err) / n
        kl = jnp.sum(jnp.abs(t.params["w"])) * 1e-3
        return t._replace(params={"w": t.params["w"] - LR_STUB * grad}), jstep.Metrics(mse + kl, mse, kl)

    def eval_step(params, bn, bx, by, bs, bc, mask, key):
        _, _, mse = sums(params["w"], bx, by, mask)
        kl = jnp.sum(jnp.abs(params["w"])) * 1e-3
        return jstep.Metrics(mse + kl, mse, kl)

    return batch_step, eval_step


def _port_stub():
    def sums(w, bx, by, mask):
        err = (bx @ w - by) * mask[:, None]
        n = torch.clamp(mask.sum(), min=1.0)
        return err, n, torch.sum(err * err) / n

    @torch.no_grad()
    def batch_step(ts, bx, by, bs, bc, mask, *, eps=None, generator=None):
        w = ts.model.w
        err, n, mse = sums(w, bx, by, mask)
        grad = 2.0 * (bx.T @ err) / n
        kl = torch.sum(torch.abs(w)) * 1e-3
        w -= LR_STUB * grad
        return ts, tstep.Metrics(mse + kl, mse, kl)

    @torch.no_grad()
    def eval_step(model, bx, by, bs, bc, mask, *, eps=None, generator=None):
        _, _, mse = sums(model.w, bx, by, mask)
        kl = torch.sum(torch.abs(model.w)) * 1e-3
        return tstep.Metrics(mse + kl, mse, kl)

    return batch_step, eval_step


def test_stub_fit_matches_the_jax_device_fit():
    from hippie_tpu.data.device_data import batch_plan as jbatch_plan

    x, y = _stub_data()
    w0 = np.zeros((D, K), np.float32)
    stream, val = np.arange(30), np.arange(30, 40)
    v_idx, v_mask = jbatch_plan(val, 4, shuffle=False)
    common = dict(train_stream=stream, batch_size=4, max_epochs=8, early_stopping_patience=2, seed=11,
                  use_class_labels=False, shuffle=False, verbose=False, log_steps=True, lr=LR_STUB)

    jlogs = []
    bstep, estep = _jax_stub()
    jres = jdfit.device_fit(
        jstep.TrainState({"w": jnp.asarray(w0)}, {}, {}), batch_step=bstep, eval_step=estep,
        arrays=(jnp.asarray(x), jnp.asarray(y)), source=jnp.zeros(40, jnp.int32),
        class_=jnp.zeros(40, jnp.int32), val_idx=jnp.asarray(v_idx), val_mask=jnp.asarray(v_mask),
        val_nb=jnp.asarray(v_idx.shape[0], jnp.int32), log_fn=jlogs.append, **common)

    tlogs = []
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    model.z_mean = types.SimpleNamespace(out_features=1)  # the noise buffer's width (unused by the stub)
    ts = tstep.TrainState(model, torch.optim.SGD(model.parameters(), lr=LR_STUB))
    bstep, estep = _port_stub()
    tres = tdfit.device_fit(
        ts, batch_step=bstep, eval_step=estep, arrays=(torch.from_numpy(x), torch.from_numpy(y)),
        source=torch.zeros(40, dtype=torch.long), class_=torch.zeros(40, dtype=torch.long),
        val_idx=v_idx, val_mask=v_mask, log_fn=tlogs.append, **common)

    assert 2 < jres.epochs_run < 8 and (tres.epochs_run, tres.best_epoch) == (jres.epochs_run, jres.best_epoch)
    np.testing.assert_allclose(tres.train_losses, jres.train_losses, rtol=1e-6)
    np.testing.assert_allclose(tres.val_losses, jres.val_losses, rtol=1e-6)
    np.testing.assert_allclose(tres.best_state_dict["w"].numpy(), np.asarray(jres.best_params["w"]), rtol=1e-6)
    assert [sorted(r) for r in tlogs] == [sorted(r) for r in jlogs]
    for t, j in zip(tlogs, jlogs):
        for k in t:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-6, err_msg=k)
