"""The K-replica device fit (train/ensemble.py:device_fit_ensemble) against
the K-replica host fit (``host_fit_ensemble``), and against the JAX
``device_fit_ensemble``.

(a) On the CPU the device fit runs its replicas' steps eagerly over the
static buffers its CUDA graphs read on the card (train/device_fit.py:
StepGraph); it must give the host fit's result bit for bit at K=2 and 3:
every replica's parameters, BatchNorm buffers and optimizer state, the best
snapshots, best losses and epochs, epochs run and the per-epoch losses, for
the unimodal and the joint model, AdamW (the joint model clipped at 1.0)
and schedule-free, with and without patience; each fit resumes the other's
files; the lr_sweep CLI prints the same JSON line with its default loop
(device) and with ``--fit-loop host``. (num_blocks=(1, 1, 1, 1), z=4,
B=8, 15 train rows in 2 batches, the second with a padded row, and 7 val
rows.)

(b) The JAX ``device_fit_ensemble`` and the port's, driven by one
deterministic stub (a linear map per replica trained by plain gradient
descent at the replica's own rate, no noise, the same weights from numpy,
``shuffle=False``, 10 epochs, patience 2): each replica's best epoch, the
joint stop's ``epochs_run`` exactly; the per-epoch losses and the best
weights within rtol 1e-6 (float32 on both sides, as
tests/test_torch_device_fit.py holds ``device_fit``); a second call with
the same ``resume_dir`` after the joint stop runs no epoch in either
package.
"""

import json
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.train import ensemble as jens
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.data import synth
from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import lr_sweep
from hippie_tpu_torch.train import ensemble as tens
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)

B = 8
_R = np.random.default_rng(0)
WAVE = torch.from_numpy(_R.normal(size=(22, 50)).astype(np.float32))
ISI = torch.from_numpy(_R.normal(size=(22, 100)).astype(np.float32))
SRC = torch.zeros(22, dtype=torch.long)
VAL = batch_plan(np.arange(15, 22), B, shuffle=False)
SMALL = dict(z_dim=4, num_blocks=(1, 1, 1, 1))


@pytest.fixture(autouse=True)
def _free_tmp_path(tmp_path):
    """Remove what the test wrote: its resume files are MBs each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _fit(fit_loop, *, joint=False, algorithm="adamw", lrs=(1e-3, 3e-3), max_epochs=3, init_key=4, **kw):
    clip = 1.0 if joint else None
    if joint:
        cfg, init = tcvae.MultiModalConfig(**SMALL), tens.init_multimodal_ensemble
    else:
        cfg, init = tcvae.CVAEConfig(output_size=50, **SMALL), tens.init_unimodal_ensemble
    states = init(init_key, cfg, lambda ps: toptim.make_optimizer(ps, lrs[0], 0.01, clip, algorithm=algorithm),
                  len(lrs), device="cpu")
    states = tens.set_ensemble_lr(states, lrs)
    common = dict(arrays=(WAVE, ISI) if joint else (WAVE,), source=SRC, class_=None,
                  train_stream=np.arange(15), batch_size=B, val_idx=VAL[0], val_mask=VAL[1],
                  max_epochs=max_epochs, seed=3, **kw)
    if fit_loop == "device":
        batch_step, eval_step = (tstep.make_multimodal_steps if joint else tstep.make_unimodal_steps)()
        return tens.device_fit_ensemble(states, batch_step=batch_step, eval_step=eval_step, **common)
    fns = (tens.make_multimodal_ensemble_epoch_fns if joint else tens.make_unimodal_ensemble_epoch_fns)()
    return tens.host_fit_ensemble(states, epoch_fns=fns, **common)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _assert_same(r1, r2, losses=True):
    for a, b in zip(r1.state, r2.state):
        assert _equal(a.model.state_dict(), b.model.state_dict())
        assert _equal(a.optimizer.state_dict(), b.optimizer.state_dict())
    assert _equal(r1.best_state_dict, r2.best_state_dict)
    assert np.array_equal(r1.best_val_loss, r2.best_val_loss)
    assert np.array_equal(r1.best_epoch, r2.best_epoch) and r1.epochs_run == r2.epochs_run
    if losses:
        assert _equal(r1.train_losses, r2.train_losses) and _equal(r1.val_losses, r2.val_losses)


@pytest.mark.parametrize("joint,algorithm,lrs,patience,epochs", [
    (False, "adamw", (1e-3, 3e-3), None, 2),
    (False, "schedule-free", (1e-3, 3e-3, 3e-2), 1, 2),
    (True, "adamw", (1e-3, 2e-2), 1, 2),
    (True, "schedule-free", (2e-3, 5e-3), None, 1),
], ids=["unimodal-adamw", "unimodal-sf-K3-patience", "joint-adamw-patience", "joint-sf"])
def test_device_ensemble_equals_the_host_ensemble(joint, algorithm, lrs, patience, epochs):
    """Every replica of the device fit is the host fit's, bit for bit."""
    kw = dict(joint=joint, algorithm=algorithm, lrs=lrs, early_stopping_patience=patience, max_epochs=epochs)
    host, dev = _fit("host", **kw), _fit("device", **kw)
    _assert_same(dev, host)
    assert len(dev.epoch_s) == dev.epochs_run and dev.graphs["captured"] is False  # no graphs off the card


@pytest.fixture(scope="module")
def uninterrupted():
    return _fit("host", max_epochs=2)


@pytest.mark.parametrize("first,then", [("device", "host"), ("host", "device")])
def test_each_loop_resumes_the_others_files(tmp_path, uninterrupted, first, then):
    """A fit stopped after 1 of 2 epochs on one loop and resumed from fresh
    replicas on the other equals the uninterrupted fit."""
    full = uninterrupted
    rdir = str(tmp_path / "r")
    _fit(first, max_epochs=1, resume_dir=rdir)
    resumed = _fit(then, max_epochs=2, init_key=99, resume_dir=rdir)
    _assert_same(resumed, full, losses=False)
    assert _equal(resumed.train_losses, full.train_losses[1:])


def test_lr_sweep_prints_the_same_line_with_either_loop(tmp_path, capsys):
    """The CLI's default loop is the device loop; ``--fit-loop host`` gives
    the same JSON line and the same exported bytes."""
    root = tmp_path / "datasets"
    synth.make_dataset(str(root), "cellexplorer-celltype", n=48, num_classes=3, seed=0)
    lines = {}
    for name, extra in (("default", []), ("host", ["--fit-loop", "host"])):
        argv = ["--dataset", "cellexplorer-celltype", "--data-root", str(root), "--pool", "self", "--lrs",
                "1e-3,3e-3", "--max-epochs", "1", "--num-blocks", "1,1,1,1", "--z-dim", "4", "--batch-size",
                "16", "--device", "cpu", "--export-winner", str(tmp_path / "w.ckpt")] + extra
        assert lr_sweep.main(argv) == 0
        out = capsys.readouterr().out
        assert ("device loop" if name == "default" else "host loop") in out
        rec = json.loads(out.strip().splitlines()[-1])
        lines[name] = (rec, (tmp_path / "w.ckpt").read_bytes())
    assert lines["default"] == lines["host"]


# --- (b) against the JAX device_fit_ensemble --------------------------------

D, KOUT = 8, 3
STUB_LRS = (0.01, 0.004, 0.02)


def _stub_data():
    r = np.random.default_rng(3)
    x = r.normal(size=(40, D)).astype(np.float32)
    w1 = r.normal(size=(D, KOUT)).astype(np.float32)
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
        return t._replace(params={"w": t.params["w"] - t.opt_state["lr"] * grad}), jstep.Metrics(mse + kl, mse, kl)

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
        w -= ts.optimizer.param_groups[0]["lr"] * grad
        return ts, tstep.Metrics(mse + kl, mse, kl)

    @torch.no_grad()
    def eval_step(model, bx, by, bs, bc, mask, *, eps=None, generator=None):
        _, _, mse = sums(model.w, bx, by, mask)
        kl = torch.sum(torch.abs(model.w)) * 1e-3
        return tstep.Metrics(mse + kl, mse, kl)

    return batch_step, eval_step


def _port_states(w0):
    states = []
    for k, lr in enumerate(STUB_LRS):
        model = torch.nn.Module()
        model.w = torch.nn.Parameter(torch.from_numpy(w0[k].copy()))
        model.z_mean = types.SimpleNamespace(out_features=1)  # the noise buffer's width (unused by the stub)
        states.append(tstep.TrainState(model, torch.optim.SGD(model.parameters(), lr=lr)))
    return states


def test_stub_ensemble_matches_the_jax_device_fit_ensemble(tmp_path):
    from hippie_tpu.data.device_data import batch_plan as jbatch_plan

    x, y = _stub_data()
    w0 = np.random.default_rng(5).normal(size=(len(STUB_LRS), D, KOUT)).astype(np.float32) * 0.1
    stream, val = np.arange(30), np.arange(30, 40)
    v_idx, v_mask = jbatch_plan(val, 4, shuffle=False)
    common = dict(train_stream=stream, batch_size=4, max_epochs=10, early_stopping_patience=2, seed=11,
                  use_class_labels=False, shuffle=False, verbose=False)

    bstep, estep = _jax_stub()

    def jax_fit(resume_dir):
        ts = jstep.TrainState({"w": jnp.asarray(w0)}, {}, {"lr": jnp.asarray(STUB_LRS, jnp.float32)})
        return jens.device_fit_ensemble(
            ts, batch_step=bstep, eval_step=estep, arrays=(jnp.asarray(x), jnp.asarray(y)),
            source=jnp.zeros(40, jnp.int32), class_=None, val_idx=jnp.asarray(v_idx),
            val_mask=jnp.asarray(v_mask), val_nb=v_idx.shape[0], resume_dir=resume_dir, **common)

    jres = jax_fit(str(tmp_path / "jax"))
    bstep_t, estep_t = _port_stub()

    def port_fit(resume_dir):
        return tens.device_fit_ensemble(
            _port_states(w0), batch_step=bstep_t, eval_step=estep_t,
            arrays=(torch.from_numpy(x), torch.from_numpy(y)), source=torch.zeros(40, dtype=torch.long),
            class_=None, val_idx=v_idx, val_mask=v_mask, resume_dir=resume_dir, **common)

    tres = port_fit(str(tmp_path / "port"))
    assert 2 < jres.epochs_run < 10 and tres.epochs_run == jres.epochs_run
    assert len(set(np.asarray(jres.best_epoch).tolist())) > 1  # the replicas' bests differ: a joint stop
    np.testing.assert_array_equal(tres.best_epoch, jres.best_epoch)
    np.testing.assert_allclose(np.asarray(tres.train_losses), np.asarray(jres.train_losses), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tres.val_losses), np.asarray(jres.val_losses), rtol=1e-6)
    np.testing.assert_allclose(tres.best_val_loss, jres.best_val_loss, rtol=1e-6)
    for k in range(len(STUB_LRS)):
        np.testing.assert_allclose(tres.best_state_dict[k]["w"].numpy(), np.asarray(jres.best_params["w"][k]),
                                   rtol=1e-6)

    # the joint stop had fired: resuming runs nothing, in both packages
    jagain, tagain = jax_fit(str(tmp_path / "jax")), port_fit(str(tmp_path / "port"))
    assert jagain.epochs_run == tagain.epochs_run == jres.epochs_run
    assert len(jagain.train_losses) == len(tagain.train_losses) == 0
    np.testing.assert_array_equal(tagain.best_epoch, jagain.best_epoch)
    for k in range(len(STUB_LRS)):
        assert torch.equal(tagain.best_state_dict[k]["w"], tres.best_state_dict[k]["w"])
