"""The joint (wave + ISI) cVAE: hippie_tpu_torch against hippie_tpu on the CPU.

At a small size (MultiModalConfig(z_dim=4, class_hidden_dim=3,
num_blocks=(1, 1, 1, 1)), B=16 with an 11-real-row tail whose padded rows
repeat the last real row, as the batch plan pads), from the same weights and
noise on both sides; the JAX side is jitted, and its Pallas kernels run in
interpret mode:

(a) multimodal_vae_loss and the CPU multimodal_vae_loss_pallas against
    JAX's losses.multimodal_vae_loss and multimodal_vae_loss_pallas, with
    inf in the padded rows: values rtol 1e-6, gradients rtol 1e-5 / atol 1e-7
    (tests/test_pallas.py:87-111);
(b) masked_sse_plain and its backward against fused_masked_sse and its vjp,
    at the same limits;
(c) state_dict_from_jax of the joint trees against to_torch_state_dict, and
    the full-depth count 16,115,748;
(d) MultiModalCVAE.forward against multimodal_cvae_apply, rtol 1e-4 / atol
    1e-5 (tests/test_torch_model.py's limits);
(e) one make_multimodal_steps batch_step (loss_backend="pallas",
    block_backend="xla", clip 1.0) against JAX's step with the same
    settings, at tests/test_torch_train.py's limits, the class embedding
    included;
(f) one batch_step with block_backend="pallas" against JAX's "fused": the
    whole gradient's cosine above 0.97 (tests/test_torch_dec_blocks.py's
    step limit), loss and BN buffers 1e-2, parameters within 2 * lr;
(g) a two-step epoch: finite Metrics, and mse = mse1 + mse2;
(h) embed_multimodal against JAX's from the same weights, atol 1e-5;
(i) unknown backends raise ValueError.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hippie_tpu.evaluate import embeddings as jemb
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops import losses as jlosses
from hippie_tpu.ops import pallas_ops as jpo
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import optim as joptim
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.data import device_data
from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.ops import cuda_ops, losses as tlosses
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep
from hippie_tpu_torch.train.checkpoint import state_dict_from_jax

torch.set_num_threads(1)

CFG = dict(z_dim=4, output_size_wave=50, output_size_isi=100, class_hidden_dim=3, num_sources=5,
           num_classes=5, num_blocks=(1, 1, 1, 1))
Z = CFG["z_dim"]
B, N_REAL = 16, 11
LR, WD, CLIP = 1e-3, 0.01, 1.0
# biases whose layer feeds a BatchNorm (directly or through a linear layer):
# zero gradient in exact arithmetic, rounding noise on both sides
_ZERO_GRAD_BIAS = re.compile(
    r"(layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)|encoder_mod\d\.linear|fusion_encoder\.0"
    r"|decoder_fc_mod\d\.2)\.bias$")


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, state=None):
    return {k: np.asarray(v) for k, v in jckpt.to_torch_state_dict(tree, state, prefix="").items()}


def _port_model(params, bn):
    with torch.device("meta"):
        model = tcvae.MultiModalCVAE(tcvae.MultiModalConfig(**CFG))
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax(_numpy_tree(params), _numpy_tree(bn)), strict=True)
    return model


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _init_shapes(cfg):
    """multimodal_cvae_init's (params, state) shapes in its own key order,
    without running it (its eager init takes 10 s on this CPU): the dicts it
    builds under jax.eval_shape, whose output would sort their keys."""
    seen = []
    jax.eval_shape(lambda: seen.append(jcvae.multimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def shapes(t):
        if isinstance(t, (dict, tuple)):
            return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(map(shapes, t))
        return jax.ShapeDtypeStruct(t.shape, t.dtype)

    return shapes(seen[0])


@pytest.fixture(scope="module")
def jax_weights():
    """JAX trees of the small config, in the JAX package's key order, from a
    seeded port model."""
    shapes = _init_shapes(jcvae.MultiModalConfig(**CFG))
    model = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(**CFG), torch.Generator().manual_seed(1),
                                       device="cpu")
    params, bn, _, skipped = jckpt.from_torch_state_dict(model.state_dict(), *shapes, prefix="")
    assert not skipped
    return params, bn


@pytest.fixture(scope="module")
def batch():
    """(wave, isi, source, class_, mask) with a padded tail as the plan pads it."""
    r = np.random.default_rng(0)
    wave = r.normal(size=(B, 50)).astype(np.float32)
    isi = r.normal(size=(B, 100)).astype(np.float32)
    source = r.integers(0, 5, size=B).astype(np.int32)
    class_ = r.integers(0, 5, size=B).astype(np.int32)
    for a in (wave, isi, source, class_):
        a[N_REAL:] = a[N_REAL - 1]
    return wave, isi, source, class_, (np.arange(B) < N_REAL).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# (a), (b): the losses and the masked SSE
# ---------------------------------------------------------------------------


def _loss_inputs(masked: bool):
    r = np.random.default_rng(3)
    xs = [r.normal(size=s).astype(np.float32) for s in ((B, 50), (B, 100), (B, 50), (B, 100), (B, Z))]
    logvar = (0.3 * r.normal(size=(B, Z))).astype(np.float32)
    mask = (np.arange(B) < N_REAL).astype(np.float32) if masked else None
    if masked:  # padded rows blown up: inf - data and exp(inf) would poison an unguarded sum
        xs[2][N_REAL:], xs[3][N_REAL:], xs[4][N_REAL:], logvar[N_REAL:] = np.inf, -np.inf, np.inf, np.inf
    return (*xs, logvar), mask


@pytest.mark.parametrize("masked", [True, False], ids=["mask_inf", "no_mask"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_multimodal_loss_matches_jax(backend, masked):
    (d1, d2, e1, e2, mu, lv), mask = _loss_inputs(masked)
    kw = dict(beta=0.7, mod1_weight=0.5, mod2_weight=2.0)
    jfn = jlosses.multimodal_vae_loss if backend == "xla" else jpo.multimodal_vae_loss_pallas
    tfn = tlosses.multimodal_vae_loss if backend == "xla" else cuda_ops.multimodal_vae_loss_pallas

    def jloss(e1, e2, mu, lv):
        return jfn(jnp.asarray(d1), jnp.asarray(d2), e1, e2, mu, lv, **kw,
                   mask=None if mask is None else jnp.asarray(mask))

    (ref, ref_parts), ref_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(x) for x in (e1, e2, mu, lv)))
    leaves = [t.requires_grad_(True) for t in _t(e1, e2, mu, lv)]
    got, parts = tfn(*_t(d1, d2), *leaves, **kw, mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert np.isfinite(got.item()) and all(torch.isfinite(t.grad).all() for t in leaves)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for a, b in zip(parts, ref_parts):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)
    for t, g in zip(leaves, ref_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


def test_masked_sse_plain_matches_jax_vjp():
    (d1, d2, e1, e2, mu, lv), mask = _loss_inputs(True)
    mask_col = mask.reshape(B, 1)
    g = 0.37
    ref, vjp = jax.vjp(jpo.fused_masked_sse, *(jnp.asarray(x) for x in (d2, e2, mask_col)))
    ref_d, ref_e, _ = vjp(jnp.float32(g))
    data, dec, m = _t(d2, e2, mask_col)
    plain = cuda_ops.masked_sse_plain(data, dec, m)
    data.requires_grad_(True)
    dec.requires_grad_(True)
    fused = cuda_ops.fused_masked_sse(data, dec, m)
    (fused * g).backward()
    assert torch.equal(fused.detach(), plain) and torch.isfinite(plain)
    np.testing.assert_allclose(float(plain), float(ref), rtol=1e-6)
    bwd = cuda_ops.masked_sse_bwd(*_t(d2, e2, mask_col), torch.tensor(g))
    for got, auto, want in zip(bwd, (data.grad, dec.grad), (ref_d, ref_e)):
        assert torch.isfinite(got).all() and torch.equal(got, auto)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# (c), (d): weights and the forward
# ---------------------------------------------------------------------------


def test_state_dict_from_jax_matches_to_torch_state_dict(jax_weights):
    params, bn = jax_weights
    ours = state_dict_from_jax(_numpy_tree(params), _numpy_tree(bn))
    ref = jckpt.to_torch_state_dict(params, bn, prefix="")
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    model = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(**CFG), torch.Generator().manual_seed(1),
                                       device="cpu")
    assert list(model.state_dict()) == list(ref)
    assert list(ref)[0].startswith("encoder_mod1.") and list(ref)[-1].startswith("decoder_mod2.")
    _port_model(params, bn)  # strict load


def test_full_depth_parameter_count():
    cfg = dict(z_dim=10, output_size_wave=50, output_size_isi=100, class_hidden_dim=5, num_sources=5,
               num_classes=5, num_blocks=(2, 2, 2, 2))
    p, _ = jax.eval_shape(lambda k: jcvae.multimodal_cvae_init(k, jcvae.MultiModalConfig(**cfg)),
                          jax.random.PRNGKey(0))
    assert jcvae.param_count(p) == 16_115_748
    with torch.device("meta"):
        model = tcvae.MultiModalCVAE(tcvae.MultiModalConfig(**cfg))
    assert tcvae.param_count(model) == 16_115_748


@pytest.mark.parametrize("mode", ["train_masked", "eval"])
def test_forward_matches_jax(jax_weights, batch, mode):
    params, bn = jax_weights
    wave, isi, source, class_, mask = batch
    training = mode == "train_masked"
    eps = np.random.default_rng(4).normal(size=(B, Z)).astype(np.float32)

    @jax.jit
    def fwd(params, bn, wave, isi, source, class_, eps, mask):
        return jcvae.multimodal_cvae_apply(params, bn, wave, isi, source, class_, eps=eps,
                                           training=training, mask=mask if training else None)

    outs_j, new_j = fwd(params, bn, *(jnp.asarray(x) for x in (wave, isi, source, class_, eps, mask)))
    model = _port_model(params, bn).train(training)
    tw, ti, ts_, tc, te, tm = _t(wave, isi, source.astype(np.int64), class_.astype(np.int64), eps, mask)
    with torch.no_grad():
        outs = model(tw, ti, ts_, tc, eps=te, mask=tm if training else None)
    rows = mask > 0
    names = ("encoded", "mu", "logvar", "decoded1", "decoded2")
    for name, got, ref in zip(names, outs, outs_j):
        np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    new_sd = state_dict_from_jax(_numpy_tree(params), _numpy_tree(new_j))
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), new_sd[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(v) == int(new_sd[k]) == int(training), k


# ---------------------------------------------------------------------------
# (e), (f): one train step
# ---------------------------------------------------------------------------


def _jax_step(params, bn, batch, block_backend, key):
    """JAX's joint batch_step (loss_backend="pallas", clip 1.0): the new trees,
    the loss and the gradients after the clip (the port clips .grad in place)."""
    wave, isi, source, _, mask = batch
    adamw = joptim.make_optimizer(LR, WD, clip_val=CLIP)
    # AdamW that also keeps the gradients it was handed, so one compiled step gives both
    tx = optax.GradientTransformation(
        lambda p: (adamw.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p: (lambda u, s2: (u, (s2, g)))(*adamw.update(g, s[0], p)))
    step, _ = jstep.make_multimodal_steps(tx, beta=1.0, loss_backend="pallas",
                                          block_backend=block_backend)
    new_ts, m = jax.jit(lambda p, bn, *a: step(jstep.TrainState(p, bn, tx.init(p)), *a))(
        params, bn, *(jnp.asarray(x) for x in (wave, isi, source)), None, jnp.asarray(mask), key)
    grads = _flat(new_ts.opt_state[1])
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    scale = min(1.0, CLIP / norm)
    return new_ts, float(m.loss), {k: g * scale for k, g in grads.items()}


def _port_step(params, bn, batch, block_backend, eps):
    wave, isi, source, _, mask = batch
    model = _port_model(params, bn)
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD, clip_val=CLIP))
    batch_step, _ = tstep.make_multimodal_steps(beta=1.0, loss_backend="pallas",
                                                block_backend=block_backend)
    tw, ti, tsrc, tm = _t(wave, isi, source.astype(np.int64), mask)
    ts, m = batch_step(ts, tw, ti, tsrc, None, tm, eps=torch.from_numpy(eps))
    return model, m


def test_batch_step_matches_jax(jax_weights, batch):
    """Loss rtol 1e-5; gradients relative L2 1e-3 per tensor (but biases
    before a BatchNorm, rounding noise on both sides); parameters within
    2 * lr, and to 1e-6 where |g| > 1e-4 on both sides; BN buffers rtol
    1e-4 / atol 1e-5; the class embedding decayed as optax decays it."""
    params, bn = jax_weights
    key = jax.random.PRNGKey(61)
    eps = np.array(jax.random.normal(key, (B, Z), jnp.float32))
    new_ts, loss_j, grads = _jax_step(params, bn, batch, "xla", key)
    model, m = _port_step(params, bn, batch, "xla", eps)

    np.testing.assert_allclose(float(m.loss), loss_j, rtol=1e-5)
    named = dict(model.named_parameters())
    checked = 0
    for k, g_ref in grads.items():
        if not _ZERO_GRAD_BIAS.search(k):
            g = named[k].grad.numpy().astype(np.float64)
            assert np.linalg.norm(g - g_ref) <= 1e-3 * np.linalg.norm(g_ref), k
            checked += 1
    assert checked > 60
    ref = _flat(new_ts.params, new_ts.bn_state)
    before = _flat(params, bn)
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref[k]) == 1, k
        elif "running_" in k:
            np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            assert np.abs(v - ref[k]).max() <= 2 * LR * (1 + 1e-3), k
            g = named[k].grad.numpy()
            decisive = (np.abs(g) > 1e-4) & (np.abs(grads[k]) > 1e-4)
            np.testing.assert_allclose(v[decisive], ref[k][decisive], rtol=0, atol=1e-6, err_msg=k)
    assert not named["class_embedding.weight"].grad.any()
    np.testing.assert_allclose(model.class_embedding.weight.detach().numpy(),
                               before["class_embedding.weight"] * (1 - LR * WD), rtol=1e-6)


def test_batch_step_pallas_blocks_matches_jax_fused(jax_weights, batch):
    params, bn = jax_weights
    key = jax.random.PRNGKey(62)
    eps = np.array(jax.random.normal(key, (B, Z), jnp.float32))
    new_ts, loss_j, grads = _jax_step(params, bn, batch, "fused", key)
    model, m = _port_step(params, bn, batch, "pallas", eps)

    np.testing.assert_allclose(float(m.loss), loss_j, rtol=1e-2)
    named = dict(model.named_parameters())
    got = np.concatenate([named[k].grad.numpy().ravel() for k in grads]).astype(np.float64)
    want = np.concatenate([g.ravel() for g in grads.values()]).astype(np.float64)
    assert got @ want / (np.linalg.norm(got) * np.linalg.norm(want)) > 0.97
    ref = _flat(new_ts.params, new_ts.bn_state)
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref[k]) == 1, k
        elif "running" in k:
            assert _rel(v, ref[k]) < 1e-2, k
        else:
            assert np.abs(v - ref[k]).max() <= 2 * LR * (1 + 1e-3), k


# ---------------------------------------------------------------------------
# (g), (h), (i): the epoch, the embeddings, the backends
# ---------------------------------------------------------------------------


def test_epoch_metrics(jax_weights):
    """Two steps over a plan with a 9-row tail; Metrics finite, and the first
    step's (loss, mse, kl) those of a forward from the same weights with
    mse = mse1 + mse2 (rtol 1e-6; the same ops in the same order)."""
    r = np.random.default_rng(8)
    n = B + 9
    wave, isi = _t(r.normal(size=(n, 50)).astype(np.float32), r.normal(size=(n, 100)).astype(np.float32))
    source = torch.from_numpy(r.integers(0, 5, size=n))
    idx, mask = device_data.batch_plan(np.arange(n), B, shuffle=True, generator=torch.Generator().manual_seed(0))
    eps = torch.from_numpy(r.normal(size=(2, B, Z)).astype(np.float32))
    model = _port_model(*jax_weights)
    first = _port_model(*jax_weights).train()
    bi, bm = torch.from_numpy(idx[0]).long(), torch.from_numpy(mask[0])
    with torch.no_grad():
        _, mu, lv, d1, d2 = first(wave[bi], isi[bi], source[bi], eps=eps[0], mask=bm)
        total, (mse1, mse2, kl) = cuda_ops.multimodal_vae_loss_pallas(wave[bi], isi[bi], d1, d2, mu, lv,
                                                                      mask=bm)

    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD, clip_val=CLIP))
    train_epoch, eval_epoch = tstep.make_multimodal_epoch_fns(loss_backend="pallas")
    ts, ms = train_epoch(ts, wave, isi, source, None, idx, mask, eps=eps)
    assert ms.loss.shape == ms.mse.shape == ms.kl.shape == (2,)
    assert all(torch.isfinite(x).all() for x in ms)
    np.testing.assert_allclose(ms.loss[0].item(), total.item(), rtol=1e-6)
    np.testing.assert_allclose(ms.mse[0].item(), (mse1 + mse2).item(), rtol=1e-6)
    np.testing.assert_allclose(ms.kl[0].item(), kl.item(), rtol=1e-6)
    ev = eval_epoch(ts.model, wave, isi, source, None, idx, mask, generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(x).all() for x in ev) and not ts.model.training


def test_embed_multimodal_matches_jax(jax_weights):
    params, bn = jax_weights
    r = np.random.default_rng(9)
    wave = r.normal(size=(40, 50)).astype(np.float32)
    isi = r.normal(size=(40, 100)).astype(np.float32)
    source = r.integers(0, 5, size=40).astype(np.int32)
    ref = np.asarray(jemb.embed_multimodal(params, bn, wave, isi, source))
    model = _port_model(params, bn).train()
    got = temb.embed_multimodal(model, *_t(wave, isi, source.astype(np.int64)))
    assert got.shape == ref.shape == (40, Z) and not model.training
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("which", ["loss", "block", "epoch", "model"])
def test_unknown_backends_raise(which):
    with pytest.raises(ValueError):
        if which == "loss":
            tstep.make_multimodal_steps(loss_backend="cuda")
        elif which == "block":
            tstep.make_multimodal_steps(block_backend="fused")
        elif which == "epoch":
            tstep.make_multimodal_epoch_fns(block_backend="bf16")
        else:
            model = tcvae.MultiModalCVAE(tcvae.MultiModalConfig(**CFG))
            model(torch.zeros(4, 50), torch.zeros(4, 100), torch.zeros(4).long(), backend="fused")
