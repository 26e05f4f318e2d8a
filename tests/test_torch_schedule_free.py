"""Schedule-free AdamW (train/schedule_free.py, train/optim.py), its stage
fork (train/pipeline.py:_sf_fork_state) and its ``.sfstate`` sidecar,
against hippie_tpu's optax version, which runs here (the torch reference
the JAX tests compare with is absent).

Gradients are drawn with numpy and handed to both sides, so no model noise
enters. Limits: ``k`` exact; ``weight_sum`` and ``lr_max`` rtol 1e-6 (0-d
float32 arithmetic in a different order); y, z, exp_avg_sq and the x and y
iterates of eval_params / train_params rtol 1e-5 / atol 1e-7 (float32
elementwise updates whose rounding may differ by a few ulp a step, over 24
steps). The sidecar crosses between the packages exactly, both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hippie_tpu.models import cvae as jcvae
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import optim as joptim
from hippie_tpu.train import pipeline as jpipe
from hippie_tpu.train import schedule_free as jsf
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import train_model as tcli
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import pipeline as tpipe
from hippie_tpu_torch.train import schedule_free as tsf

torch.set_num_threads(1)

LR, WD, CLIP, STEPS = 1e-2, 0.01, 1.0, 24
SHAPES = {"class_embedding.weight": (5, 3), "enc.weight": (6, 4), "enc.bias": (6,),
          "dec.weight": (2, 3, 4)}


def _close(got, want, rtol=1e-5, atol=1e-7, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def _grads(r, scale):
    return {k: (r.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _nest(flat):
    """{'a.b': x} -> {'a': {'b': x}} in insertion order (the JAX params tree)."""
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


class Tiny(torch.nn.Module):
    """Parameters named as SHAPES, in its order (a class embedding first,
    as the fork's drop needs)."""

    def __init__(self, values):
        super().__init__()
        for name in ("class_embedding", "enc", "dec"):
            setattr(self, name, torch.nn.Module())
        for k, v in values.items():
            mod, leaf = k.split(".")
            getattr(self, mod).register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(v.copy())))


_JTX = joptim.make_optimizer(LR, WD, clip_val=CLIP, algorithm="schedule-free")


@jax.jit
def _jax_step(params, st, grads):
    updates, st = _JTX.update(grads, st, params)
    return optax.apply_updates(params, updates), st


def _run_both(r, params, steps, jp=None, jst=None, model=None, opt=None):
    """``steps`` steps on both sides from (jp, jst) and (model, opt); every
    third step's gradients are small, so the clip is off for them."""
    if jp is None:
        jp = _nest({k: jnp.asarray(v) for k, v in params.items()})
        jst = jax.jit(_JTX.init)(jp)
        model = Tiny(params)
        opt = toptim.make_optimizer(model.parameters(), LR, WD, clip_val=CLIP, algorithm="schedule-free")
    named = dict(model.named_parameters())
    for i in range(steps):
        scale = 0.01 if i % 3 == 2 else 1.0
        g = {k: (r.normal(size=tuple(p.shape)) * scale).astype(np.float32) for k, p in named.items()}
        jp, jst = _jax_step(jp, jst, _nest({k: jnp.asarray(v) for k, v in g.items()}))
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return jp, jst, model, opt


def _assert_state_equal(jp, jst, model, opt):
    sf = joptim.find_schedule_free_state(jst)
    tsf_state = toptim.find_schedule_free_state(opt)
    assert int(tsf_state.k) == int(sf.k)
    _close(tsf_state.weight_sum, sf.weight_sum, rtol=1e-6, atol=0, what="weight_sum")
    _close(tsf_state.lr_max, sf.lr_max, rtol=1e-6, atol=0, what="lr_max")
    jy, jz, jv = _flat(jp), _flat(sf.z), _flat(sf.exp_avg_sq)
    for (k, p), z, v in zip(model.named_parameters(), tsf_state.z, tsf_state.exp_avg_sq):
        _close(p.detach(), jy[k], what=f"y {k}")
        _close(z, jz[k], what=f"z {k}")
        _close(v, jv[k], what=f"exp_avg_sq {k}")


def test_trajectory_matches_optax():
    r = np.random.default_rng(0)
    params = _grads(r, 1.0)
    jp, jst, model, opt = _run_both(r, params, STEPS)
    _assert_state_equal(jp, jst, model, opt)
    sf = joptim.find_schedule_free_state(jst)
    assert int(sf.k) == STEPS and float(sf.lr_max) > 0
    ps = list(model.parameters())
    z = toptim.find_schedule_free_state(opt).z
    jx = _flat(jsf.eval_params(sf, jp))
    jy = _flat(jsf.train_params(sf, jsf.eval_params(sf, jp)))
    x = tsf.eval_params(ps, z)
    y = tsf.train_params(x, z)
    for (k, _), xi, yi in zip(model.named_parameters(), x, y):
        _close(xi.detach(), jx[k], what=f"eval_params {k}")
        _close(yi.detach(), jy[k], what=f"train_params {k}")
    # maybe_eval_params: x for schedule-free, the parameters for AdamW
    for a, b in zip(toptim.maybe_eval_params(opt, ps), x):
        assert torch.equal(a, b)
    adamw = toptim.make_optimizer(ps, LR, WD)
    assert toptim.maybe_eval_params(adamw, ps) is ps and toptim.find_schedule_free_state(adamw) is None


def test_step_makes_no_host_sync_and_keeps_device_scalars():
    """The group's k, weight_sum and lr_max stay 0-d tensors updated in
    place (int32, float32, float32), the state_dict carries them, and a
    snapshot of it (train/loop.py:snapshot) is independent of later steps."""
    from hippie_tpu_torch.train import loop

    r = np.random.default_rng(1)
    _, _, model, opt = _run_both(r, _grads(r, 1.0), 2)
    g = opt.param_groups[0]
    assert (g["k"].dtype, g["weight_sum"].dtype, g["lr_max"].dtype) == (torch.int32, torch.float32,
                                                                       torch.float32)
    assert all(g[n].dim() == 0 for n in ("k", "weight_sum", "lr_max"))
    _, snap = loop.snapshot(type("TS", (), {"model": model, "optimizer": opt})())
    k_before = int(snap["param_groups"][0]["k"])
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert int(snap["param_groups"][0]["k"]) == k_before == 2 and int(g["k"]) == 3
    assert toptim.find_schedule_free_state(snap) is not None


def test_stage_fork_matches_jax_and_keeps_the_class_embedding_fresh():
    """Stage 3's fork (the x iterate of a stage grafted into a model with
    another class count): the JAX _sf_fork_state against the port's, then
    three more steps on both."""
    r = np.random.default_rng(2)
    params = _grads(r, 1.0)
    jp, jst, model, opt = _run_both(r, params, 6)
    sf = joptim.find_schedule_free_state(jst)
    jx = _flat(jsf.eval_params(sf, jp))
    fresh_ce = r.normal(size=(4, 3)).astype(np.float32)  # the stage-3 model's class count
    x3 = {k: (fresh_ce if k.startswith("class_embedding") else jx[k]) for k in SHAPES}
    jts = jpipe._sf_fork_state(_nest({k: jnp.asarray(v) for k, v in x3.items()}), {}, _JTX, jst,
                               drop=("class_embedding",))
    cfg = tpipe.PipelineConfig(optimizer="schedule-free", weight_decay=WD, device="cpu")
    model3 = Tiny(x3)
    prev = opt.state_dict()
    ts = tpipe._sf_fork_state(cfg, model3, LR, CLIP, prev, drop=("class_embedding",))
    _assert_state_equal(jts.params, jts.opt_state, model3, ts.optimizer)
    st = toptim.find_schedule_free_state(ts.optimizer)
    ce = 0  # class_embedding.weight is the first parameter
    assert torch.equal(st.z[ce], torch.from_numpy(fresh_ce)) and not st.exp_avg_sq[ce].any()
    assert torch.equal(model3.class_embedding.weight.detach(), torch.from_numpy(fresh_ce))
    assert int(st.k) == 6
    # the fork with an AdamW predecessor (or none) is a fresh optimizer
    fresh = tpipe._stage_fork(cfg, Tiny(x3), LR, CLIP, None)
    assert int(toptim.find_schedule_free_state(fresh.optimizer).k) == 0
    jp3, jst3, model3, _ = _run_both(r, None, 3, jts.params, jts.opt_state, model3, ts.optimizer)
    _assert_state_equal(jp3, jst3, model3, ts.optimizer)


def test_finalize_and_validation_at_x():
    """_finalize_fit hands the x iterate to every consumer: the model's
    parameters and the best snapshot's; evaluated_at_x holds x inside and
    restores y bit for bit."""
    from hippie_tpu_torch.train import loop

    r = np.random.default_rng(3)
    _, _, model, opt = _run_both(r, _grads(r, 1.0), 4)
    ps = list(model.parameters())
    y = [p.detach().clone() for p in ps]
    x = tsf.eval_params(y, toptim.find_schedule_free_state(opt).z)
    with toptim.evaluated_at_x(opt):
        assert all(torch.equal(p, xi) for p, xi in zip(ps, x))
    assert all(torch.equal(p, yi) for p, yi in zip(ps, y))
    sd, osd = loop.snapshot(type("TS", (), {"model": model, "optimizer": opt})())
    result = loop.FitResult(state=tpipe.step.TrainState(model, opt), best_state_dict=sd,
                            best_opt_state=osd, best_val_loss=1.0, best_epoch=0, epochs_run=1)
    cfg = tpipe.PipelineConfig(optimizer="schedule-free", device="cpu")
    out = tpipe._finalize_fit(cfg, result)
    keys = tckpt.parameter_key_order(model)
    assert all(torch.equal(out.best_state_dict[k], xi) for k, xi in zip(keys, x))
    assert all(torch.equal(p, xi) for p, xi in zip(ps, x))
    assert list(out.best_state_dict) == list(sd) and all(torch.equal(sd[k], yi) for k, yi in zip(keys, y))
    adamw_cfg = tpipe.PipelineConfig(device="cpu")
    assert tpipe._finalize_fit(adamw_cfg, result) is result


def _cvae_templates():
    """unimodal_cvae_init's (params, state) at num_blocks=(1, 1, 1, 1) as
    zeros in its key order, without running it."""
    cfg = jcvae.CVAEConfig(z_dim=4, output_size=50, class_hidden_dim=3, num_blocks=(1, 1, 1, 1))
    seen = []
    jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return np.zeros(t.shape, t.dtype)

    return zeros(seen[0][0]), zeros(seen[0][1])


@pytest.fixture(scope="module")
def cvae_sf():
    """A port cVAE with a schedule-free optimizer after two steps, and the
    same weights as JAX pytrees."""
    model = tcvae.unimodal_cvae_init(
        tcvae.CVAEConfig(z_dim=4, output_size=50, class_hidden_dim=3, num_blocks=(1, 1, 1, 1)),
        torch.Generator().manual_seed(0), device="cpu")
    opt = toptim.make_optimizer(model.parameters(), LR, WD, algorithm="schedule-free")
    r = np.random.default_rng(4)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy((r.normal(size=tuple(p.shape)) * 0.1).astype(np.float32))
        opt.step()
    pt, st = _cvae_templates()
    sd = {"model." + k: v.detach().numpy() for k, v in model.state_dict().items()}
    jparams, _, _, _ = jckpt.from_torch_state_dict(sd, pt, st)
    return model, opt, jparams


def test_sidecar_written_by_the_port_loads_in_jax(cvae_sf, tmp_path):
    model, opt, jparams = cvae_sf
    keys = tckpt.parameter_key_order(model)
    path = str(tmp_path / "m.ckpt")
    assert toptim.save_schedule_free_sidecar(path, opt, keys) == path + ".sfstate"
    assert toptim.save_schedule_free_sidecar(path, toptim.make_optimizer(model.parameters(), LR), keys) is None
    tx = joptim.make_optimizer(LR, WD, algorithm="schedule-free")
    jst = joptim.load_schedule_free_sidecar(path, jax.jit(tx.init)(jparams))
    sf = joptim.find_schedule_free_state(jst)
    port = toptim.find_schedule_free_state(opt)
    assert int(sf.k) == int(port.k) == 2
    assert float(sf.weight_sum) == float(port.weight_sum) and float(sf.lr_max) == float(port.lr_max)
    jz, jv = jckpt.flatten_interleaved(sf.z, None), jckpt.flatten_interleaved(sf.exp_avg_sq, None)
    assert sorted(jz) == sorted(keys)
    for k, z, v in zip(keys, port.z, port.exp_avg_sq):
        np.testing.assert_array_equal(np.asarray(jz[k]), tckpt._from_torch_layout(k, z.numpy()), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jv[k]), tckpt._from_torch_layout(k, v.numpy()), err_msg=k)


@pytest.mark.parametrize("drop", [(), ("class_embedding",)])
def test_sidecar_written_by_jax_loads_in_the_port(cvae_sf, tmp_path, drop):
    model, _, jparams = cvae_sf
    keys = tckpt.parameter_key_order(model)
    tx = joptim.make_optimizer(LR, WD, algorithm="schedule-free")
    jst = jax.jit(tx.init)(jparams)
    r = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(r.normal(size=p.shape), jnp.float32), jparams)
    jp = jparams
    for _ in range(3):
        updates, jst = jax.jit(tx.update)(grads, jst, jp)
        jp = optax.apply_updates(jp, updates)
    path = str(tmp_path / "j.ckpt")
    joptim.save_schedule_free_sidecar(path, jst)
    opt = toptim.make_optimizer(model.parameters(), LR, WD, algorithm="schedule-free")
    fresh = toptim.find_schedule_free_state(opt)
    fresh_z = [z.clone() for z in fresh.z]
    toptim.load_schedule_free_sidecar(path, opt, keys, drop_keys=drop)
    sf = joptim.find_schedule_free_state(jst)
    port = toptim.find_schedule_free_state(opt)
    assert int(port.k) == int(sf.k) == 3
    assert float(port.weight_sum) == float(sf.weight_sum) and float(port.lr_max) == float(sf.lr_max)
    jz, jv = jckpt.flatten_interleaved(sf.z, None), jckpt.flatten_interleaved(sf.exp_avg_sq, None)
    for k, z, v, z0 in zip(keys, port.z, port.exp_avg_sq, fresh_z):
        if drop and k.startswith(drop[0]):
            assert torch.equal(z, z0) and not v.any(), k
        else:
            np.testing.assert_array_equal(tckpt._from_torch_layout(k, z.numpy()), np.asarray(jz[k]), err_msg=k)
            np.testing.assert_array_equal(tckpt._from_torch_layout(k, v.numpy()), np.asarray(jv[k]), err_msg=k)


def test_cli_takes_the_optimizer_flags():
    """--optimizer schedule-free and --opt-state-dtype bfloat16 reach the
    pipeline's config; together they raise the JAX make_optimizer's error."""
    parse = tcli.build_parser().parse_args
    cfg = tcli.config_from_args(parse(["--optimizer", "schedule-free"]))
    assert (cfg.optimizer, cfg.opt_state_dtype) == ("schedule-free", None)
    cfg = tcli.config_from_args(parse(["--opt-state-dtype", "bfloat16"]))
    assert (cfg.optimizer, cfg.opt_state_dtype) == ("adamw", "bfloat16")
    assert tcli.config_from_args(parse([])).opt_state_dtype is None
    with pytest.raises(ValueError) as jax_err:
        joptim.make_optimizer(LR, state_dtype="bfloat16", algorithm="schedule-free")
    with pytest.raises(ValueError) as port_err:
        tcli.config_from_args(parse(["--optimizer", "schedule-free", "--opt-state-dtype", "bfloat16"]))
    assert str(port_err.value) == str(jax_err.value)
