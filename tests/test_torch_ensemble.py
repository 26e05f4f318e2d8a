"""K-replica training (hippie_tpu_torch/train/ensemble.py) on the CPU, at
num_blocks=(1, 1, 1, 1), z=4, B=16.

(a) Replica k of the port's ensemble is bit-equal to the port's
single-model fit (train/loop.py:fit) driven with replica k's init, lr and
generator path, for the shared-plan fit (two epochs, two learning rates)
and for the replica-plan fit against ``pipeline.fit_stage`` (per-replica
plans and seeds). (b) A K=2 ensemble epoch against the JAX
``make_unimodal_ensemble_epoch_fns`` with the plan and each (batch, replica)
noise taken from the JAX side (``_step_keys``), under tests/test_torch_fit.py's
limits: the eval epoch on the initial weights and the first step's losses
rtol 1e-5 (the same weights on both sides; measured at most 3.9e-7 and
2.2e-7 over data seeds 0-3 at 1 and 4 threads), every step's rtol 1e-3
(measured 7.1e-5 at this data, at most 4.6e-4 over those seeds): the
trajectories drift within AdamW's first-step envelope; the weights within
2 * lr per step. (c) ``fit_ensemble``'s bookkeeping against the JAX
``fit_ensemble`` on scripted losses, exactly, with a nan validation epoch.
"""

import re
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.models import cvae as jcvae
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import ensemble as jens
from hippie_tpu.train import optim as joptim
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.data.device_data import batch_plan
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train import ensemble as tens
from hippie_tpu_torch.train import loop as tloop
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import pipeline as tpipe
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)

CFG = dict(z_dim=4, output_size=50, class_hidden_dim=5, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
B, WD = 16, 0.01
_ZERO_GRAD_BIAS = re.compile(
    r"(layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)|encoder\.linear|encoder_fc\.[03]|decoder_fc\.2)\.bias$")


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(0)
    n = 40
    return (torch.from_numpy(r.normal(size=(n, 50)).astype(np.float32)),
            torch.from_numpy(r.integers(0, 5, size=n)).long())


def _make_opt(lr):
    return lambda ps: toptim.make_optimizer(ps, lr, WD)


def _equal_state(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# (a) replica k is the single-model fit
# ---------------------------------------------------------------------------


def test_init_set_lr_take_and_stack():
    cfg = tcvae.CVAEConfig(**CFG)
    states = tens.init_unimodal_ensemble(9, cfg, _make_opt(1e-3), 3, device="cpu")
    assert tens.n_replicas(states) == 3
    for k, ts in enumerate(states):
        _equal_state(ts.model.state_dict(),
                     tcvae.unimodal_cvae_init(cfg, tloop.key_generator(9, k), device="cpu").state_dict())
    joint = tens.init_multimodal_ensemble(9, tcvae.MultiModalConfig(z_dim=4, num_blocks=(1, 1, 1, 1)),
                                          _make_opt(1e-3), 2, device="cpu")
    _equal_state(joint[1].model.state_dict(), tcvae.multimodal_cvae_init(
        tcvae.MultiModalConfig(z_dim=4, num_blocks=(1, 1, 1, 1)), tloop.key_generator(9, 1),
        device="cpu").state_dict())
    tens.set_ensemble_lr(states, [0.0, 1e-3, 2e-2])
    assert [ts.optimizer.param_groups[0]["lr"] for ts in states] == [0.0, 1e-3, 2e-2]
    with pytest.raises(ValueError, match="4 learning rates for an ensemble of 3"):
        tens.set_ensemble_lr(states, [1e-3] * 4)
    stacked = tens.stack_trees([ts.model.state_dict() for ts in states])
    assert stacked["z_mean.weight"].shape == (3, 4, 4)
    for k in range(3):
        _equal_state(tens.take_replica(stacked, k), states[k].model.state_dict())
    nested = tens.stack_trees([{"a": (torch.ones(2) * k, [torch.zeros(1)])} for k in range(2)])
    assert torch.equal(tens.take_replica(nested, 1)["a"][0], torch.ones(2))
    mesh = pmesh.Mesh(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="3 replicas do not divide over the 2 ranks"):
        tens.shard_replicas(stacked, mesh)
    with pytest.raises(ValueError, match="3 replicas do not divide over the 2 ranks"):
        tens.shard_replicas(states, mesh)


def test_replicas_are_the_single_model_fits(data):
    """Two epochs of a K=2 shared-plan ensemble (host_fit_ensemble, shuffled
    plan, lrs 1e-3 and 3e-3) against loop.fit of each replica alone from the
    same init with the same lr and generator path: weights, buffers, best
    snapshots and per-batch losses bit-equal."""
    x, src = data
    cfg = tcvae.CVAEConfig(**CFG)
    lrs = [1e-3, 3e-3]
    stream = np.arange(30)
    val_idx, val_mask = batch_plan(np.arange(30, 40), B, shuffle=False)
    states = tens.set_ensemble_lr(tens.init_unimodal_ensemble(4, cfg, _make_opt(lrs[0]), 2, device="cpu"), lrs)
    fns = tens.make_unimodal_ensemble_epoch_fns(loss_backend="pallas", block_backend="pallas")
    seen = []
    train_epoch = fns[0]

    def recording(*a, **kw):
        out = train_epoch(*a, **kw)
        seen.append(out[1].loss.clone())
        return out

    res = tens.host_fit_ensemble(states, epoch_fns=(recording, fns[1]), arrays=(x,), source=src, class_=None,
                                 train_stream=stream, batch_size=B, val_idx=val_idx, val_mask=val_mask,
                                 max_epochs=2, seed=3)
    assert res.epochs_run == 2 and len(seen) == 2
    s_train, s_eval = tstep.make_unimodal_epoch_fns(loss_backend="pallas", block_backend="pallas")
    for k in range(2):
        model = tcvae.unimodal_cvae_init(cfg, tloop.key_generator(4, k), device="cpu")
        losses = []

        def run_train(state, key, epoch):
            idx, mask = batch_plan(stream, B, shuffle=True, generator=tloop.key_generator(key, 0))
            state, ms = s_train(state, x, src, None, idx, mask, generator=tloop.key_generator(key, 1, k))
            losses.append(ms.loss)
            return state, ms

        def run_val(state, key, epoch):
            return s_eval(state.model, x, src, None, val_idx, val_mask, generator=tloop.key_generator(key, k))

        ref = tloop.fit(tstep.TrainState(model, toptim.make_optimizer(model.parameters(), lrs[k], WD)),
                        run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=2, seed=3, verbose=False)
        _equal_state(res.state[k].model.state_dict(), ref.state.model.state_dict())
        _equal_state(res.best_state_dict[k], ref.best_state_dict)
        assert int(res.best_epoch[k]) == ref.best_epoch
        assert res.best_val_loss[k] == ref.best_val_loss
        for e in range(2):
            assert torch.equal(seen[e][:, k], losses[e])
            assert res.train_losses[e][k] == ref.train_losses[e] and res.val_losses[e][k] == ref.val_losses[e]
    assert not torch.equal(seen[0][:, 0], seen[0][:, 1])


def test_schedule_free_snapshots_hold_x(data):
    """With schedule-free AdamW each replica validates at its x iterate and
    its best snapshot holds x, while training goes on from y (the JAX
    fit_ensemble's eval_params_jit route)."""
    x, src = data
    cfg = tcvae.CVAEConfig(**CFG)
    states = tens.init_unimodal_ensemble(
        4, cfg, lambda ps: toptim.make_optimizer(ps, 2e-3, WD, algorithm="schedule-free"), 2, device="cpu")
    val_idx, val_mask = batch_plan(np.arange(30, 40), B, shuffle=False)
    res = tens.host_fit_ensemble(states, epoch_fns=tens.make_unimodal_ensemble_epoch_fns(), arrays=(x,),
                                 source=src, class_=None, train_stream=np.arange(30), batch_size=B,
                                 val_idx=val_idx, val_mask=val_mask, max_epochs=1, seed=3)
    for k, ts in enumerate(res.state):
        names, ys = zip(*ts.model.named_parameters())
        xs = toptim.maybe_eval_params(ts.optimizer, [y.detach() for y in ys])
        best = res.best_state_dict[k]
        assert int(res.best_epoch[k]) == 0
        assert any(not torch.equal(a, b) for a, b in zip(xs, ys))
        for n, xv in zip(names, xs):
            assert torch.equal(best[n], xv), n


def test_replica_plans_are_the_sequential_stage_fits(data):
    """host_fit_replica_plans with per-replica fixed plans and seeds against
    pipeline.fit_stage of each replica alone (shuffle_train=False,
    cfg.seed + stage_seed = its seed): bit-equal, the unimodal and the joint
    model, with class labels."""
    x, src = data
    r = np.random.default_rng(1)
    isi = torch.from_numpy(r.normal(size=(40, 100)).astype(np.float32))
    labels = torch.from_numpy(r.integers(0, 3, size=40)).long()
    streams = [np.arange(0, 20), np.arange(10, 30)]
    vals = [np.arange(30, 36), np.arange(34, 40)]
    t_idx, t_mask = (np.stack(p) for p in zip(*(batch_plan(s, B, shuffle=False) for s in streams)))
    v_idx, v_mask = (np.stack(p) for p in zip(*(batch_plan(s, B, shuffle=False) for s in vals)))
    seeds = [1042, 1052]
    cases = (("uni", tcvae.unimodal_cvae_init, tcvae.CVAEConfig(**{**CFG, "num_classes": 3}), (x,),
              tens.make_unimodal_ensemble_epoch_fns(use_class_labels=True)),
             ("joint", tcvae.multimodal_cvae_init,
              tcvae.MultiModalConfig(z_dim=4, num_classes=3, num_blocks=(1, 1, 1, 1)), (x, isi),
              tens.make_multimodal_ensemble_epoch_fns(use_class_labels=True)))
    for name, init, cfg, arrays, fns in cases:
        states = [tstep.TrainState(m, toptim.make_optimizer(m.parameters(), 2e-3, WD, 1.0))
                  for m in (init(cfg, tloop.key_generator(5, k), device="cpu") for k in range(2))]
        res = tens.host_fit_replica_plans(states, epoch_fns=fns, arrays=arrays, source=src, class_=labels,
                                          train_idx=t_idx, train_mask=t_mask, val_idx=v_idx, val_mask=v_mask,
                                          max_epochs=2, seeds=seeds)
        pcfg = tpipe.PipelineConfig(seed=42, verbose=False, device="cpu", early_stopping_patience=None)
        for k in range(2):
            model = init(cfg, tloop.key_generator(5, k), device="cpu")
            ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), 2e-3, WD, 1.0))
            fit = tpipe.fit_multimodal_stage if name == "joint" else tpipe.fit_unimodal_stage
            kw = {"wave": x, "isi": isi} if name == "joint" else {"data": x, "beta": 1.0}
            ref = fit(cfg=pcfg, ts=ts, **kw, source=src, class_=labels, train_indices=streams[k],
                      val_indices=vals[k], batch_size=B, max_epochs=2, use_class_labels=True,
                      shuffle_train=False, stage_seed=seeds[k] - 42)
            _equal_state(res.state[k].model.state_dict(), ref.state.model.state_dict())
            _equal_state(res.best_state_dict[k], ref.best_state_dict)
            assert int(res.best_epoch[k]) == ref.best_epoch and res.best_val_loss[k] == ref.best_val_loss
    with pytest.raises(ValueError, match="plans of 2/2 replicas and 1 seeds"):
        tens.host_fit_replica_plans(states, epoch_fns=fns, arrays=arrays, source=src, class_=labels,
                                    train_idx=t_idx, train_mask=t_mask, val_idx=v_idx, val_mask=v_mask,
                                    max_epochs=1, seeds=seeds[:1])


# ---------------------------------------------------------------------------
# (b) one K=2 epoch against the JAX vmapped epoch
# ---------------------------------------------------------------------------


def _unimodal_shapes(cfg):
    """unimodal_cvae_init's (params, state) shapes in its own key order
    (tests/test_torch_fit.py:_unimodal_shapes)."""
    seen = []
    jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(map(shapes, t))
        return jax.ShapeDtypeStruct(t.shape, t.dtype)

    return shapes(seen[0])


def test_ensemble_epoch_matches_the_jax_vmapped_epoch(data):
    x, src = data
    K, lr = 2, 1e-3
    idx, mask = batch_plan(np.random.default_rng(2).permutation(40), B, shuffle=False)  # 3 steps, tail of 8
    cfg = tcvae.CVAEConfig(**CFG)
    states = tens.init_unimodal_ensemble(6, cfg, _make_opt(lr), K, device="cpu")
    templates = _unimodal_shapes(jcvae.CVAEConfig(**CFG))
    carried = [jckpt.from_torch_state_dict(ts.model.state_dict(), *templates, prefix="")[:2] for ts in states]
    params = jens.stack_trees([c[0] for c in carried])
    bn = jens.stack_trees([c[1] for c in carried])
    tx = joptim.make_optimizer(lr, WD)
    jts = jstep.TrainState(params, bn, jax.vmap(tx.init)(params))
    e_train, e_eval = jens.make_unimodal_ensemble_epoch_fns(tx, beta=1.0)
    rng, vrng = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    xs, ss = jnp.asarray(x.numpy()), jnp.asarray(src.numpy(), jnp.int32)
    jvm = e_eval(jts.params, jts.bn_state, xs, ss, None, jnp.asarray(idx), jnp.asarray(mask), vrng)
    jts, jtm = e_train(jts, xs, ss, None, jnp.asarray(idx), jnp.asarray(mask), rng)

    def noise(key):  # the (batch, replica) noise the JAX steps drew
        keys = jens._step_keys(key, idx.shape[0], K)
        return torch.from_numpy(np.array(jax.vmap(jax.vmap(
            lambda kk: jax.random.normal(kk, (B, CFG["z_dim"]), jnp.float32)))(keys)))

    train_epoch, eval_epoch = tens.make_unimodal_ensemble_epoch_fns(loss_backend="pallas")
    vm = eval_epoch([ts.model for ts in states], x, src, None, idx, mask, eps=noise(vrng))
    states, tm = train_epoch(states, x, src, None, idx, mask, eps=noise(rng))
    jl, jv = np.asarray(jtm.loss), np.asarray(jvm.loss)
    assert tm.loss.shape == (3, K) and vm.loss.shape == (3, K)
    np.testing.assert_allclose(tm.loss[0].numpy(), jl[0], rtol=1e-5)
    np.testing.assert_allclose(tm.loss.numpy(), jl, rtol=1e-3)
    np.testing.assert_allclose(vm.loss.numpy(), jv, rtol=1e-5)
    for k in range(K):
        want = {n: np.asarray(v) for n, v in jckpt.to_torch_state_dict(
            jens.take_replica(jts.params, k), jens.take_replica(jts.bn_state, k), prefix="").items()}
        for n, v in states[k].model.state_dict().items():
            if "running_" in n or n.endswith("num_batches_tracked") or _ZERO_GRAD_BIAS.search(n):
                continue
            assert np.abs(v.numpy() - want[n]).max() <= 2 * 3 * lr, n


# ---------------------------------------------------------------------------
# (c) fit_ensemble's bookkeeping against the JAX fit_ensemble
# ---------------------------------------------------------------------------


class _M(NamedTuple):
    loss: object
    mse: object
    kl: object


# name: (train [epoch][batch][replica], val [epoch][batch][replica], patience, max_epochs)
SCRIPTS = {
    "joint_stop": ([[[1.0, 1.0]]] * 6, [[[2.0, 2.0]], [[1.0, 3.0]], [[1.5, 1.0]], [[1.25, 1.5]], [[0.5, 1.25]],
                                        [[0.75, 0.25]]], 2, 6),
    "nan_val": ([[[1.0, 1.0]]] * 4, [[[2.0, 0.5]], [[np.nan, 0.25]], [[1.0, np.nan]], [[1.5, 0.125]]], 3, 4),
    "never_finite": ([[[1.0, 1.0]]] * 3, [[[np.nan, 1.0], [np.nan, 2.0]]] * 3, None, 3),
    "no_epochs": ([], [], 2, 0),
}


def _jax_side(train, val):
    def run_train(ts, key, epoch):
        t = np.asarray(train[epoch], np.float32)
        return jstep.TrainState({"w": jnp.full((2, 3), float(epoch + 1))}, {}, ()), _M(t, t, t)

    def run_val(ts, key, epoch):
        v = np.asarray(val[epoch], np.float32)
        return _M(v, v, v)

    return jstep.TrainState({"w": jnp.zeros((2, 3))}, {}, ()), run_train, run_val


def _port_side(train, val):
    states = []
    for _ in range(2):
        model = torch.nn.Linear(3, 1, bias=False)
        with torch.no_grad():
            model.weight.zero_()
        states.append(tstep.TrainState(model, toptim.make_optimizer(model.parameters(), 1e-3)))

    def run_train(sts, key, epoch):
        for ts in sts:
            with torch.no_grad():
                ts.model.weight.fill_(epoch + 1)
        t = torch.tensor(train[epoch], dtype=torch.float32)
        return sts, tstep.Metrics(t, t, t)

    def run_val(sts, key, epoch):
        v = torch.tensor(val[epoch], dtype=torch.float32)
        return tstep.Metrics(v, v, v)

    return states, run_train, run_val


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_fit_ensemble_bookkeeping_matches_jax(name, capsys):
    train, val, patience, max_epochs = SCRIPTS[name]
    state, run_train, run_val = _jax_side(train, val)
    j = jens.fit_ensemble(state, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=max_epochs,
                          early_stopping_patience=patience, seed=3, verbose=True)
    j_out = capsys.readouterr().out
    states, run_train, run_val = _port_side(train, val)
    t = tens.fit_ensemble(states, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=max_epochs,
                          early_stopping_patience=patience, seed=3, verbose=True)
    assert capsys.readouterr().out == j_out
    assert t.epochs_run == j.epochs_run
    np.testing.assert_array_equal(t.best_epoch, j.best_epoch)
    np.testing.assert_array_equal(t.best_val_loss, j.best_val_loss)
    np.testing.assert_array_equal(t.train_losses, j.train_losses)
    np.testing.assert_array_equal(t.val_losses, j.val_losses)  # nan where nan
    for k in range(2):  # each snapshot holds its best epoch's weights (the first epoch's if none)
        want = float(j.best_params["w"][k, 0]) if j.best_params is not None else 0.0
        assert float(t.best_state_dict[k]["weight"][0, 0]) == want
    expected = {"joint_stop": ([4, 5], 6), "nan_val": ([2, 3], 4), "never_finite": ([-1, 0], 3),
                "no_epochs": ([-1, -1], 0)}[name]
    assert (list(j.best_epoch), j.epochs_run) == expected


def test_nan_train_loss_raises():
    states, run_train, run_val = _port_side([[[1.0, 1.0]], [[1.0, np.nan]]], [[[1.0, 1.0]]] * 2)
    with pytest.raises(FloatingPointError, match="epoch 1"):
        tens.fit_ensemble(states, run_train_epoch=run_train, run_val_epoch=run_val, max_epochs=2)
