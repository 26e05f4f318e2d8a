"""The train step and the slice end to end: hippie_tpu_torch against hippie_tpu.

(f) One ``batch_step(loss_backend="pallas")`` of the port against a JAX step
built from ``cvae.unimodal_cvae_apply(eps=...)``, ``vae_loss_pallas`` (Pallas
interpret mode) and ``optim.make_optimizer``, from the same weights, batch,
mask and noise. (h) The slice: the cellexplorer-celltype pretraining pool is
loaded and preprocessed on both sides, two steps run over a JAX-made plan with
a masked tail, and the target's rows are embedded.

Tolerances, all float32 on the CPU:
- loss rtol 1e-5;
- gradients: relative L2 error per tensor below 1e-3. Left out: biases whose
  layer feeds a BatchNorm (directly, or through a linear layer), whose
  gradient is zero in exact arithmetic, so that both sides hold rounding noise;
- parameters after the step: AdamW's first update is about lr * sign(g), so
  an element whose gradient is rounding noise may move either way. Where
  |g| > 1e-4 on both sides the new values agree to atol 1e-6 (lr / 1000);
  everywhere they agree to 2 * lr;
- BatchNorm running statistics rtol 1e-4 / atol 1e-5 (as the forward test);
- the second step's loss rtol 2e-3: it is computed from parameters that
  already differ within that 2 * lr envelope (from the same parameters the
  two forwards agree to 1e-6);
- the second step's BatchNorm running statistics atol 1e-3 (measured 3.6e-4),
  for the same reason;
- embeddings (z-scored over z = 4 values) after two steps: atol 5e-2
  (measured 2.4e-2), the 2 * lr envelope carried through the encoder and
  magnified by the z-score; from the same weights on both sides, atol 1e-5.

In the batch with one real row every BatchNorm over [B, C] outputs its bias,
which is 0 at init, so LeakyReLU sees exactly 0; the port's gradient there is
1, as the JAX package's (hippie_tpu_torch.nn.functional.leaky_relu), so that
case holds the gradients' values to the same relative L2 1e-3 per tensor.

The class embedding, which the loss does not reach without class labels, is
held to the JAX tree too: the port's step hands AdamW a zero gradient for it,
so it decays by (1 - lr * wd) per step as optax's adamw decays it.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hippie_tpu.data import device_data as jdd
from hippie_tpu.evaluate import embeddings as jemb
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops.pallas_ops import vae_loss_pallas as j_vae_loss_pallas
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import optim as joptim
from hippie_tpu.train import pipeline as jpipe
from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.ops import cuda_ops
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import pipeline as tpipe
from hippie_tpu_torch.train import step as tstep
from hippie_tpu_torch.train.checkpoint import state_dict_from_jax

torch.set_num_threads(1)

DATA_ROOT = str(pathlib.Path(__file__).resolve().parent.parent / "datasets")
CFG = dict(z_dim=4, output_size=50, class_hidden_dim=3, num_sources=5, num_classes=5,
           num_blocks=(1, 1, 1, 1))
B = 16
LR, WD = 1e-3, 0.01
_TX = joptim.make_optimizer(LR, WD)
_ZERO_GRAD_BIAS = re.compile(
    r"(layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)|encoder\.linear|encoder_fc\.[03]|decoder_fc\.2)\.bias$")


@jax.jit
def _jax_step(params, bn, opt_state, bd, bs, bmask, eps):
    def loss_fn(p):
        (_, mu, logvar, dec), new_bn = jcvae.unimodal_cvae_apply(
            p, bn, bd, bs, None, eps=eps, training=True, mask=bmask)
        total, _ = j_vae_loss_pallas(bd, dec, mu, logvar, beta=1.0, mask=bmask)
        return total, new_bn

    (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, opt_state = _TX.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_bn, opt_state, loss, grads


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_state(params, bn):
    with torch.device("meta"):
        model = tcvae.UnimodalCVAE(tcvae.CVAEConfig(**CFG))
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax(_numpy_tree(params), _numpy_tree(bn)), strict=True)
    return tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD))


def _flat(tree, state=None):
    return {k: np.asarray(v) for k, v in jckpt.to_torch_state_dict(tree, state, prefix="").items()}


def _assert_params_and_bn_match(model, params, bn, grads, before, steps=1):
    """New parameters and BN state of the port against the JAX trees.

    The class embedding, which the loss does not reach without class labels,
    has a zero gradient on both sides; both optimizers decay it by
    (1 - lr * wd) every step, to rtol 1e-6 of each other.
    """
    ref = _flat(params, bn)
    g_ref = _flat(grads)
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref[k]), k
        elif "running_" in k:
            np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5 if steps == 1 else 1e-3,
                                       err_msg=k)
        elif k == "class_embedding.weight":
            assert not dict(model.named_parameters())[k].grad.any()
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(ref[k], before[k] * (1 - LR * WD) ** steps, rtol=1e-6)
        else:
            assert np.abs(v - ref[k]).max() <= 2 * steps * LR * (1 + 1e-3), k
            if steps == 1:
                g_got = dict(model.named_parameters())[k].grad.numpy()
                decisive = (np.abs(g_got) > 1e-4) & (np.abs(g_ref[k]) > 1e-4)
                np.testing.assert_allclose(v[decisive], ref[k][decisive], rtol=0, atol=1e-6,
                                           err_msg=k)


def _assert_grads_match(model, grads):
    checked = 0
    for k, g_ref in _flat(grads).items():
        if _ZERO_GRAD_BIAS.search(k):
            continue
        g = dict(model.named_parameters())[k].grad.numpy().astype(np.float64)
        # some gradients are exactly 0 on both sides (one real row: BN of a constant)
        assert np.linalg.norm(g - g_ref) <= 1e-3 * np.linalg.norm(g_ref), k
        checked += 1
    assert checked > 30


@pytest.fixture(scope="module")
def jax_init():
    return jcvae.unimodal_cvae_init(jax.random.PRNGKey(1), jcvae.CVAEConfig(**CFG))


@pytest.mark.parametrize("n_real", [B, 11, 1])
def test_batch_step_matches_jax(jax_init, n_real):
    params, bn = jax_init
    r = np.random.default_rng(n_real)
    bd = r.normal(size=(B, 50)).astype(np.float32)
    bs = r.integers(0, 5, size=B).astype(np.int32)
    eps = r.normal(size=(B, CFG["z_dim"])).astype(np.float32)
    bmask = (np.arange(B) < n_real).astype(np.float32)
    bd[n_real:], bs[n_real:] = bd[n_real - 1], bs[n_real - 1]  # the plan pads with the last real row

    new_p, new_bn, _, loss_j, grads = _jax_step(
        params, bn, _TX.init(params), *(jnp.asarray(x) for x in (bd, bs, bmask, eps)))

    ts = _port_state(params, bn)
    batch_step, _ = tstep.make_unimodal_steps(beta=1.0, loss_backend="pallas")
    ts, m = batch_step(ts, torch.from_numpy(bd), torch.from_numpy(bs).long(), None,
                       torch.from_numpy(bmask), eps=torch.from_numpy(eps))
    assert np.isfinite([float(m.loss), float(m.mse), float(m.kl)]).all()
    np.testing.assert_allclose(float(m.loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(m.mse + m.kl), float(m.loss), rtol=1e-6)
    for p in ts.model.parameters():
        assert torch.isfinite(p).all() and torch.isfinite(p.grad).all()
    _assert_grads_match(ts.model, grads)
    _assert_params_and_bn_match(ts.model, new_p, new_bn, grads, _flat(params, bn))


def test_loss_backends_agree_in_the_step(jax_init):
    """loss_backend "xla" (ops/losses.py) and "pallas" (the kernel's wrapper)
    give the same step; neither launches a kernel on CPU tensors."""
    params, bn = jax_init
    r = np.random.default_rng(5)
    bd = torch.from_numpy(r.normal(size=(B, 50)).astype(np.float32))
    bs = torch.from_numpy(r.integers(0, 5, size=B)).long()
    eps = torch.from_numpy(r.normal(size=(B, CFG["z_dim"])).astype(np.float32))
    bmask = torch.from_numpy((np.arange(B) < 13).astype(np.float32))
    cuda_ops.reset_launches()
    out = {}
    for backend in ("xla", "pallas"):
        ts = _port_state(params, bn)
        step, _ = tstep.make_unimodal_steps(loss_backend=backend)
        ts, m = step(ts, bd, bs, None, bmask, eps=eps)
        out[backend] = (float(m.loss), [p.detach().clone() for p in ts.model.parameters()])
    np.testing.assert_allclose(out["pallas"][0], out["xla"][0], rtol=1e-6)
    for a, b in zip(out["pallas"][1], out["xla"][1]):
        assert (a - b).abs().max() <= 2 * LR
    assert cuda_ops.launches == {"vae_sums_fwd": 0, "vae_sums_bwd": 0, "masked_sse_fwd": 0}
    with pytest.raises(ValueError):
        tstep.make_unimodal_steps(loss_backend="cuda")


def test_slice_end_to_end_matches_jax(jax_init):
    """Pool -> preprocess -> 2 steps over a plan with a masked tail -> embed."""
    params, bn = jax_init
    jpool = jpipe.load_pretrain_pool(jpipe.PipelineConfig(data_root=DATA_ROOT, verbose=False))
    pcfg = tpipe.PipelineConfig(data_root=DATA_ROOT, verbose=False, device="cpu")
    tpool = tpipe.load_pretrain_pool(pcfg)
    stream = np.asarray(jax.random.permutation(jax.random.PRNGKey(7), len(jpool)))[:B + 9]
    idx, mask = jdd.batch_plan(stream, B, shuffle=True, key=jax.random.PRNGKey(8))
    assert idx.shape == (2, B) and mask[1].sum() == 9
    eps = np.random.default_rng(9).normal(size=(2, B, CFG["z_dim"])).astype(np.float32)

    opt = _TX.init(params)
    losses_j = []
    for i in range(2):
        params, bn, opt, loss, grads = _jax_step(
            params, bn, opt, jpool.wave[idx[i]], jpool.source[idx[i]], jnp.asarray(mask[i]),
            jnp.asarray(eps[i]))
        losses_j.append(float(loss))

    ts = _port_state(*jax_init)
    train_epoch, _ = tstep.make_unimodal_epoch_fns(loss_backend="pallas")
    ts, ms = train_epoch(ts, tpool.wave, tpool.source, None, idx, mask, eps=torch.from_numpy(eps))
    assert ms.loss.shape == (2,)
    np.testing.assert_allclose(float(ms.loss[0]), losses_j[0], rtol=1e-5)
    np.testing.assert_allclose(float(ms.loss[1]), losses_j[1], rtol=2e-3)
    _assert_params_and_bn_match(ts.model, params, bn, grads, _flat(*jax_init), steps=2)

    target = tpipe.load_dataset(pcfg, "cellexplorer-celltype")
    jtarget = jpipe.load_dataset(jpipe.PipelineConfig(data_root=DATA_ROOT, verbose=False),
                                 "cellexplorer-celltype")
    ref = np.asarray(jemb.embed_unimodal(params, bn, jtarget.wave, jtarget.source))
    got = temb.embed_unimodal(ts.model, target.wave, target.source)
    assert got.shape == ref.shape == (392, CFG["z_dim"])
    assert not ts.model.training
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-2)
    # the same weights on both sides: the embed forward itself
    same = temb.embed_unimodal(_port_state(params, bn).model, target.wave, target.source)
    np.testing.assert_allclose(same.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("clip_val", [None, 0.5, 100.0])
def test_adamw_and_clip_match_optax(clip_val):
    """Two AdamW steps with the optional global-norm clip (quirk Q7) against
    optim.make_optimizer, on gradients handed to both; rtol 1e-6 / atol 1e-7
    (the updates are far from the sign-flip regime: every gradient is of unit
    scale)."""
    r = np.random.default_rng(11)
    shapes = {"a": (6, 5), "b": (7,)}
    params = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * 0.3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    tx = joptim.make_optimizer(LR, WD, clip_val=clip_val)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = toptim.make_optimizer(list(tp.values()), LR, WD, clip_val=clip_val)
    for g in grads:
        updates, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_eval_epoch_matches_jax(jax_init):
    """eval_epoch: running BN statistics, noise still sampled (here injected),
    the masked loss per batch; the model's state is left as it was."""
    params, bn = jax_init
    r = np.random.default_rng(12)
    data = r.normal(size=(40, 50)).astype(np.float32)
    source = r.integers(0, 5, size=40).astype(np.int32)
    idx, mask = jdd.batch_plan(np.arange(3, 30), B, shuffle=False)
    eps = r.normal(size=idx.shape + (CFG["z_dim"],)).astype(np.float32)
    ref = []
    for i in range(idx.shape[0]):
        (_, mu, logvar, dec), _ = jcvae.unimodal_cvae_apply(
            params, bn, jnp.asarray(data[idx[i]]), jnp.asarray(source[idx[i]]), None,
            eps=jnp.asarray(eps[i]), training=False, mask=jnp.asarray(mask[i]))
        ref.append(float(j_vae_loss_pallas(jnp.asarray(data[idx[i]]), dec, mu, logvar,
                                           mask=jnp.asarray(mask[i]))[0]))
    model = _port_state(params, bn).model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, eval_epoch = tstep.make_unimodal_epoch_fns(loss_backend="pallas")
    ms = eval_epoch(model, torch.from_numpy(data), torch.from_numpy(source).long(), None, idx, mask,
                    eps=torch.from_numpy(eps))
    np.testing.assert_allclose(ms.loss.numpy(), ref, rtol=1e-5)
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
