"""AdamW with bf16 Adam moments (train/optim.py, ``state_dtype="bfloat16"``)
against hippie_tpu's ``make_optimizer(..., state_dtype="bfloat16")``
(``cast_state_dtype`` around optax.adamw), on gradients drawn with numpy and
handed to both sides.

Limits: the stored moments within one bf16 ulp of the JAX ones (both round
a float32 moment to nearest even; the float32 moments may differ in their
last bits, which can move a value across a rounding boundary); the
parameters at the AdamW parity limits of tests/test_torch_train.py (rtol
1e-6 / atol 1e-7). A checkpoint's moments are float32 and load into the
JAX optimizer; loading them into a bf16-moment optimizer rounds them to
bf16.
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
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import loop
from hippie_tpu_torch.train import optim as toptim

torch.set_num_threads(1)

LR, WD, STEPS = 1e-3, 0.01, 12
SHAPES = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _assert_within_one_ulp(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert not bad.any(), f"{what}: {got[bad][:5]} vs {want[bad][:5]}"


@pytest.mark.parametrize("clip_val", [None, 0.5])
def test_bf16_moments_match_cast_state_dtype(clip_val):
    r = np.random.default_rng(7)
    params = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = joptim.make_optimizer(LR, WD, clip_val=clip_val, state_dtype="bfloat16")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = jax.jit(tx.init)(jp)

    @jax.jit
    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = toptim.make_optimizer(list(tp.values()), LR, WD, clip_val=clip_val, state_dtype="bfloat16")
    for i in range(STEPS):
        g = {k: (r.normal(size=s) * (0.3 if i % 2 else 1.0)).astype(np.float32) for k, s in SHAPES.items()}
        jp, st = jstep(jp, st, {k: jnp.asarray(v) for k, v in g.items()})
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    adam = joptim._find_adam_state(st)
    assert int(adam.count) == STEPS and adam.mu["a"].dtype == jnp.bfloat16
    for i, (k, p) in enumerate(tp.items()):
        s = opt.state[p]
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.bfloat16
        assert s["step"].dtype == torch.float32 and float(s["step"]) == STEPS
        _assert_within_one_ulp(s["exp_avg"].float().numpy(), np.asarray(adam.mu[k], np.float32), f"mu {k}")
        _assert_within_one_ulp(s["exp_avg_sq"].float().numpy(), np.asarray(adam.nu[k], np.float32), f"nu {k}")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_bf16_update_is_computed_in_float32():
    """One step from stored moments: the parameter update uses the float32
    moments before their rounding, which torch.optim.AdamW with bf16 state
    would not (its arithmetic is in bf16)."""
    r = np.random.default_rng(8)
    p32 = torch.nn.Parameter(torch.from_numpy(r.normal(size=(64,)).astype(np.float32)))
    ref = torch.nn.Parameter(p32.detach().clone())
    opt = toptim.make_optimizer([p32], LR, WD, state_dtype="bfloat16")
    full = toptim.make_optimizer([ref], LR, WD)
    g = torch.from_numpy((r.normal(size=(64,)) * 0.1).astype(np.float32))
    p32.grad, ref.grad = g.clone(), g.clone()
    opt.step()
    full.step()
    # a fresh state: the first update equals float32 AdamW's exactly
    assert torch.equal(p32.detach(), ref.detach())
    assert torch.equal(opt.state[p32]["exp_avg"], full.state[ref]["exp_avg"].to(torch.bfloat16))


def _templates():
    cfg = jcvae.CVAEConfig(z_dim=4, output_size=50, class_hidden_dim=3, num_blocks=(1, 1, 1, 1))
    seen = []
    jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        return np.zeros(t.shape, t.dtype)

    return zeros(seen[0][0]), zeros(seen[0][1])


def test_ckpt_moments_are_float32_and_load_in_jax(tmp_path):
    model = tcvae.unimodal_cvae_init(
        tcvae.CVAEConfig(z_dim=4, output_size=50, class_hidden_dim=3, num_blocks=(1, 1, 1, 1)),
        torch.Generator().manual_seed(0), device="cpu")
    opt = toptim.make_optimizer(model.parameters(), LR, WD, state_dtype="bfloat16")
    r = np.random.default_rng(9)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy((r.normal(size=tuple(p.shape)) * 0.1).astype(np.float32))
        opt.step()
    sd, osd = loop.snapshot(type("TS", (), {"model": model, "optimizer": opt})())
    keys = tckpt.parameter_key_order(model)
    path = str(tmp_path / "bf16.ckpt")
    tckpt.save_lightning_ckpt(path, sd, optimizer_state=tckpt.adamw_state_to_torch(
        osd, sd, keys, lr=LR, weight_decay=WD))
    ck = tckpt.load_lightning_ckpt(path)
    saved = ck["optimizer_states"][0]["state"]
    assert len(saved) == len(keys)
    for i, e in osd["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            assert saved[i][m].dtype == np.float32
            np.testing.assert_array_equal(saved[i][m], e[m].float().numpy())
    # the JAX package loads them into its own bf16-moment optimizer
    pt, st = _templates()
    jparams, _, _, _ = jckpt.from_torch_state_dict({"model." + k: v.numpy() for k, v in sd.items()}, pt, st)
    tx = joptim.make_optimizer(LR, WD, state_dtype="bfloat16")
    jst = joptim.adamw_state_from_torch(ck["optimizer_states"][0], jax.jit(tx.init)(jparams), pt, st)
    adam = joptim._find_adam_state(jst)
    assert int(adam.count) == 2
    mu = jckpt.flatten_interleaved(adam.mu, None)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(np.asarray(mu[k], np.float32),
                                      tckpt._from_torch_layout(k, saved[i]["exp_avg"]), err_msg=k)
    # and back into a bf16-moment port optimizer: the moments rounded to bf16 again
    fresh = toptim.make_optimizer(model.parameters(), LR, WD, state_dtype="bfloat16")
    tckpt.load_optimizer_state(fresh, ck["optimizer_states"][0])
    for i, p in enumerate(model.parameters()):
        for m in ("exp_avg", "exp_avg_sq"):
            assert fresh.state[p][m].dtype == torch.bfloat16
            assert torch.equal(fresh.state[p][m], osd["state"][i][m])


def test_schedule_free_with_a_state_dtype_raises_the_jax_error():
    with pytest.raises(ValueError) as jax_err:
        joptim.make_optimizer(LR, state_dtype="bfloat16", algorithm="schedule-free")
    with pytest.raises(ValueError) as port_err:
        toptim.make_optimizer([torch.nn.Parameter(torch.zeros(3))], LR, state_dtype="bfloat16",
                              algorithm="schedule-free")
    assert str(port_err.value) == str(jax_err.value)


def _bf16_run(steps: int = 4):
    """Parameters and stored moments after ``steps`` bf16-moment steps (clip
    0.5) on numpy gradients."""
    r = np.random.default_rng(11)
    tp = [torch.nn.Parameter(torch.from_numpy(r.normal(size=s).astype(np.float32))) for s in SHAPES.values()]
    opt = toptim.make_optimizer(tp, LR, WD, clip_val=0.5, state_dtype="bfloat16")
    for _ in range(steps):
        for p in tp:
            p.grad = torch.from_numpy(r.normal(size=tuple(p.shape)).astype(np.float32))
        opt.step()
    return [p.detach().clone() for p in tp] + [opt.state[p][m].clone() for p in tp
                                               for m in ("exp_avg", "exp_avg_sq")]


@pytest.mark.parametrize("limit", [1, 30, 37, 60])
def test_bf16_update_is_the_same_in_any_bucket_size(monkeypatch, limit):
    """The upcast runs bucket by bucket (the parameters hold 30, 7 and 24
    elements); the update is elementwise, so any cut gives the same bits as
    one bucket over every parameter."""
    whole = _bf16_run()
    monkeypatch.setattr(toptim, "UPCAST_BUCKET", limit)
    sizes = [[p.numel() for p in b] for b in toptim._buckets(
        [torch.empty(s) for s in SHAPES.values()], limit)]
    assert sum(sizes, []) == [30, 7, 24]
    assert all(sum(b) <= limit or len(b) == 1 for b in sizes)
    assert len(sizes) == {1: 3, 30: 3, 37: 2, 60: 2}[limit]
    for a, b in zip(_bf16_run(), whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
