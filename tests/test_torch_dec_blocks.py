"""The decoder block's plain versions, the decoder and the train step with
block_backend="pallas", against hippie_tpu on the CPU.

The port's ``dec_block_fwd_plain`` / ``dec_block_bwd_plain`` repeat
``pallas_blocks._dec_fwd_math`` / ``_dec_bwd_math``; they are held against
the JAX primitive ``_dec_block_prim(stride, "xla")`` (the same math as plain
XLA ops: the Pallas kernel runs it in VMEM), its ``jax.vjp``,
``basic_block_dec_fused(impl="xla")``, ``resnet18_dec_apply(backend=
"fused")`` and a JAX train step with ``block_backend="fused"``. Inputs come
from numpy seeds, with a masked tail whose padded rows of x hold +-1e3.

Tolerances, as tests/test_torch_blocks.py for the encoder. Both sides
multiply the same bf16 operands exactly into float32 and round to bf16 at
the same points; they differ only in the order of the float32 sums, which
flips a bf16 rounding (2^-8 relative) only where a value lies within about
1e-7 of a rounding boundary. So bf16 tensors and the float32 gradients built
from them are held at relative Frobenius norm 1e-2, and the statistics at
rtol 1e-5 of their scale. The conv-bias gradients dc1b and dcsb are zero in
exact arithmetic (a bias before BatchNorm is absorbed by it), so both sides
hold rounding noise there; _bias_grad_tol says how large it can be.
Running buffers after one fused block: rtol 1e-5 / atol 1e-6 (float32
statistics, no bf16 rounding before them in the first BatchNorm).

The decoder and the model chain blocks, and there a flip moves the next
block's statistics and a value at LeakyReLU's kink turns its gradient from 1
to 0.01; test_torch_blocks.py measured that spread for the encoder. So the
decoder's output and BN buffers are held at 1e-2, each parameter gradient
within twice the JAX path's own spread (measured in the test) and the cosine
of the whole gradient above 0.99. One train step runs both backbones' fused
blocks: loss rtol 1e-2, BN buffers 1e-2, the updated parameters within 2 * lr
of JAX's (AdamW's first update is about lr * sign(g)), and the whole
gradient's cosine above 0.97, the JAX package's limit for its fused model
against float32 (test_pallas_blocks.py:245). Measured on this CPU: port
against JAX 0.9897, and each bf16 path against its own float32 path 0.983
(JAX) and 0.985 (port); a 1e-6 change of the input moves the JAX step's own
gradient to cosines of 0.9918-0.99999 over 4 seeds.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hippie_tpu.models import backbones as jbb
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops import pallas_blocks as pb
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import optim as joptim
from hippie_tpu.train import step as jstep
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.models.backbones import BasicBlockDec, ResNet18Dec
from hippie_tpu_torch.ops import cuda_blocks
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep
from hippie_tpu_torch.train.checkpoint import state_dict_from_jax

torch.set_num_threads(1)

B, N_REAL = 24, 17
SHAPES = [(1, 8, 64), (2, 8, 128), (2, 4, 256), (1, 32, 64)]  # (stride, L_in, C_in)
GRADS = ("dx", "dw2", "dg2", "db2", "dw1", "dc1b", "dg1", "db1", "dws", "dcsb", "dgs", "dbs")
SHORT = ("dc1b", "dws", "dcsb", "dgs", "dbs")  # zero at stride 1
REL = 1e-2
LR, WD = 1e-3, 0.01
_PRE_BN_BIAS = re.compile(r"layer\d\.\d\.(conv1\.conv|shortcut\.0\.conv)\.bias$")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t, jnp.float32))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _block_inputs(stride, L, C, seed):
    """The 13 operands of _dec_block_prim (x float32, rounded to bf16 by each
    side) with N_REAL real rows of B, and the output cotangent."""
    r = np.random.default_rng(seed)
    co = C // stride
    f = lambda *s: r.normal(size=s).astype(np.float32)  # noqa: E731
    x = f(L, B, C)
    x[:, N_REAL:] = 1e3 * np.where(r.random((L, B - N_REAL, C)) < 0.5, 1.0, -1.0)
    vec = lambda c: (r.uniform(0.5, 1.5, c).astype(np.float32), 0.1 * f(c))  # noqa: E731
    g2, b2 = vec(C)
    g1, b1 = vec(co)
    w2, w1 = f(3, C, C) / np.sqrt(3 * C), f(3, C, co) / np.sqrt(3 * C)
    if stride != 1:
        c1b, csb, ws = 0.1 * f(co), 0.1 * f(co), f(3, C, co) / np.sqrt(3 * C)
        gs, bs = vec(co)
    else:
        c1b = csb = gs = bs = np.zeros(co, np.float32)
        ws = np.zeros((3, C, co), np.float32)
    m = (np.arange(B) < N_REAL).astype(np.float32).reshape(B, 1)
    return [x, w2, g2, b2, w1, c1b, g1, b1, ws, csb, gs, bs, m], f(L * stride, B, co)


def _jax_args(args):
    return [jnp.asarray(args[0]).astype(jnp.bfloat16)] + [jnp.asarray(a) for a in args[1:]]


def _torch_args(args, stride):
    t = [torch.from_numpy(args[0]).bfloat16()] + [torch.from_numpy(a) for a in args[1:]]
    if stride == 1:  # the port passes no conv bias or shortcut; the plain version makes the zeros
        for i in (5, 8, 9, 10, 11):
            t[i] = None
    return t


def _bias_grad_tol(g, gamma, st, dgamma):
    """Limit of |port - JAX| for a conv bias's gradient (dc1b, dcsb). In
    exact arithmetic it is -gamma * inv * dgamma * sum(m * xh) / n: the mean
    of the bf16 xh over the real rows, zero but for rounding, times
    gamma * inv * dgamma, which padded rows far out (+-1e3, with a nonzero
    cotangent) make large. Held to 1e-2 * |g| (the JAX package's limit,
    test_pallas_blocks.py:172-181) plus 1e-3 of that factor (measured
    at most 3.9e-5 of it over 8 seeds)."""
    return 1e-2 * np.linalg.norm(g) + 1e-3 * np.linalg.norm(gamma * st[2] * dgamma)


def _check_stats(got, ref, what, rtol=1e-5):
    """(mean, var, inv) rows; the mean against its scale |mean| + std."""
    scale = np.stack([np.abs(ref[0]) + np.sqrt(ref[1]), np.abs(ref[1]), np.abs(ref[2])])
    err = np.abs(got - ref)
    assert (err <= rtol * scale).all(), (what, float((err / np.maximum(scale, 1e-30)).max()))


@pytest.mark.parametrize("stride,L,C", SHAPES)
def test_plain_forward_matches_jax(stride, L, C):
    args, _ = _block_inputs(stride, L, C, seed=L + C)
    ref = jax.jit(pb._dec_block_prim(stride, "xla"))(*_jax_args(args))
    got = cuda_blocks.dec_block_fwd_plain(stride, *_torch_args(args, stride))
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == ref[0].shape
    assert _rel(_np(got[0])[:, :N_REAL], _np(ref[0])[:, :N_REAL]) < REL
    for name, a, b in zip(("st2", "st1", "sts"), got[1:], ref[1:]):
        assert a.shape == b.shape, name
        _check_stats(_np(a), _np(b), name)


@pytest.mark.parametrize("stride,L,C", SHAPES)
def test_plain_backward_matches_jax_vjp(stride, L, C):
    args, g = _block_inputs(stride, L, C, seed=7 * L + C)
    prim = pb._dec_block_prim(stride, "xla")

    @jax.jit
    def fwd_vjp(jargs, gb):
        outs, vjp = jax.vjp(prim, *jargs)
        return outs, vjp((gb, *(jnp.zeros_like(s) for s in outs[1:])))[:12]

    outs, ref = fwd_vjp(_jax_args(args), jnp.asarray(g).astype(jnp.bfloat16))
    st = [torch.from_numpy(_np(s)) for s in outs[1:]]
    got = cuda_blocks.dec_block_bwd_plain(stride, *_torch_args(args, stride), *st,
                                          torch.from_numpy(g).bfloat16())
    assert got[0].dtype == torch.bfloat16
    ref = [_np(b) for b in ref]
    bias_tol = {"dc1b": _bias_grad_tol(g, args[6], _np(outs[2]), ref[6]),
                "dcsb": _bias_grad_tol(g, args[10], _np(outs[3]), ref[10])}
    for name, a, b in zip(GRADS, got, ref):
        a = _np(a)
        assert a.shape == b.shape, name
        if stride == 1 and name in SHORT:
            assert not a.any() and not b.any(), name
        elif name in bias_tol:
            assert np.linalg.norm(a - b) <= bias_tol[name], (name, np.linalg.norm(a - b), bias_tol[name])
        else:
            assert _rel(a, b) < REL, (name, _rel(a, b))


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_block_updates_bn_buffers_as_jax(stride):
    """Running buffers after one block: BN2 counts the input length, BN1 and
    the shortcut's the output length, which only a stride-2 block tells apart."""
    L, C = 8, 128
    args, _ = _block_inputs(stride, L, C, seed=30 + stride)
    p, s = jbb._basic_block_dec_init(jax.random.PRNGKey(stride), C, stride)
    mask = args[12][:, 0]
    x = _jax_args(args)[0]
    out_j, new_j = jax.jit(lambda p, s, x, m: pb.basic_block_dec_fused(
        p, s, x, stride=stride, mask=m, impl="xla"))(p, s, x, jnp.asarray(mask))
    block = BasicBlockDec(C, stride)
    block.load_state_dict(state_dict_from_jax(_numpy_tree(p), _numpy_tree(s)), strict=True)
    block.train()
    out = cuda_blocks.basic_block_dec_fused(block, torch.from_numpy(args[0]).bfloat16(),
                                            torch.from_numpy(mask))
    assert tuple(out.shape) == out_j.shape == (L * stride, B, C // stride)
    assert _rel(_np(out)[:, :N_REAL], _np(out_j)[:, :N_REAL]) < REL
    ref_sd = state_dict_from_jax(_numpy_tree(p), _numpy_tree(new_j))
    for k, v in block.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref_sd[k]) == 1, k
        elif "running" in k:
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def _assert_grads_close(named_grads, ref_g, per_param=1e-1, cos_min=0.99):
    """Each gradient within ``per_param`` (None: not each) but the conv biases
    before a BatchNorm, whose gradients are rounding noise (zero in exact
    arithmetic); the whole gradient's cosine above ``cos_min``."""
    got, want = [], []
    for name, grad in named_grads:
        got.append(_np(grad).ravel())
        want.append(ref_g[name].numpy().ravel())
        if per_param is not None and not _PRE_BN_BIAS.search(name):
            assert _rel(got[-1], want[-1]) < per_param, (name, _rel(got[-1], want[-1]))
    got, want = np.concatenate(got).astype(np.float64), np.concatenate(want).astype(np.float64)
    cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > cos_min, cos


def test_resnet18_dec_pallas_matches_jax_fused():
    """Per-parameter limit: twice the JAX fused path's own worst spread when
    its input is scaled by 1 + 1e-6 (measured here; 0.08-0.13 over 5 seeds,
    where the encoder's was under 0.10), and 1e-1 at least."""
    z, nb, Bm = 4, (1, 1, 1, 1), 16
    r = np.random.default_rng(40)
    x = r.normal(size=(Bm, 2 * z)).astype(np.float32)
    mask = (np.arange(Bm) < 11).astype(np.float32)
    cot = r.normal(size=(Bm, 50)).astype(np.float32) * mask[:, None]
    p, s = jbb.resnet18_dec_init(jax.random.PRNGKey(41), z_dim=z, output_size=50, num_blocks=nb)

    def loss(p, x):
        out, new_s = jbb.resnet18_dec_apply(p, s, x, training=True, mask=jnp.asarray(mask),
                                            backend="fused")
        return jnp.sum(out * cot), (out, new_s)

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, (out_j, new_j)), grads_j = step(p, jnp.asarray(x))
    own = state_dict_from_jax(_numpy_tree(step(p, jnp.asarray(x * (1 + 1e-6)))[1]), None)
    ref_g = state_dict_from_jax(_numpy_tree(grads_j), None)
    spread = max(_rel(own[k], v) for k, v in ref_g.items() if not _PRE_BN_BIAS.search(k))

    dec = ResNet18Dec(z_dim=z, output_size=50, num_blocks=nb)
    dec.load_state_dict(state_dict_from_jax(_numpy_tree(p), _numpy_tree(s)), strict=True)
    dec.train()
    cuda_blocks.reset_launches()
    out = dec(torch.from_numpy(x), torch.from_numpy(mask), backend="pallas")
    (out * torch.from_numpy(cot)).sum().backward()
    assert all(v == 0 for v in cuda_blocks.launches.values())  # CPU tensors: the plain versions

    rows = mask > 0
    assert out.dtype == torch.float32
    assert _rel(_np(out)[rows], _np(out_j)[rows]) < 1e-2
    _assert_grads_close(((n, p.grad) for n, p in dec.named_parameters()), ref_g,
                        per_param=max(1e-1, 2 * spread))
    ref_sd = state_dict_from_jax(_numpy_tree(p), _numpy_tree(new_j))
    for k, v in dec.state_dict().items():
        if "running" in k:
            assert _rel(v.numpy(), ref_sd[k].numpy()) < 1e-2, k
        elif k.endswith("num_batches_tracked"):
            assert int(v) == int(ref_sd[k]) == 1, k


CFG = dict(z_dim=4, output_size=50, class_hidden_dim=3, num_sources=5, num_classes=5,
           num_blocks=(1, 1, 1, 1))


def _jax_weights():
    """JAX parameter and BN trees of the small config, from a seeded port
    model (JAX's eager init takes seconds on this CPU; only its shapes are
    needed)."""
    shapes = jax.eval_shape(lambda: jcvae.unimodal_cvae_init(jax.random.PRNGKey(0),
                                                             jcvae.CVAEConfig(**CFG)))
    model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**CFG), torch.Generator().manual_seed(1),
                                     device="cpu")
    params, bn, _, skipped = jckpt.from_torch_state_dict(model.state_dict(), *shapes, prefix="")
    assert not skipped
    return params, bn


def _port_model(params, bn):
    with torch.device("meta"):
        model = tcvae.UnimodalCVAE(tcvae.CVAEConfig(**CFG))
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax(_numpy_tree(params), _numpy_tree(bn)), strict=True)
    return model


def _flat(tree, state=None):
    return {k: np.asarray(v) for k, v in jckpt.to_torch_state_dict(tree, state, prefix="").items()}


def test_batch_step_pallas_blocks_matches_jax_fused():
    """One step of both backbones' fused blocks and the fused loss: the port's
    batch_step(loss_backend="pallas", block_backend="pallas") against the
    JAX package's make_unimodal_steps(loss_backend="pallas",
    block_backend="fused"), from the same weights, batch and noise (the noise
    the JAX step draws from its key, handed to the port as eps)."""
    Bm, n_real = 16, 11
    params, bn = _jax_weights()
    r = np.random.default_rng(60)
    bd = r.normal(size=(Bm, 50)).astype(np.float32)
    bs = r.integers(0, 5, size=Bm).astype(np.int32)
    bmask = (np.arange(Bm) < n_real).astype(np.float32)
    bd[n_real:], bs[n_real:] = bd[n_real - 1], bs[n_real - 1]  # the plan pads with the last real row
    key = jax.random.PRNGKey(61)
    eps = np.array(jax.random.normal(key, (Bm, CFG["z_dim"]), jnp.float32))

    adamw = joptim.make_optimizer(LR, WD)
    # AdamW that also keeps the gradients it was handed, so one compiled step gives both
    tx = optax.GradientTransformation(
        lambda p: (adamw.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p: (lambda u, s2: (u, (s2, g)))(*adamw.update(g, s[0], p)))
    jax_step, _ = jstep.make_unimodal_steps(tx, loss_backend="pallas", block_backend="fused")
    new_ts, m_j = jax.jit(lambda p, bn, *a: jax_step(jstep.TrainState(p, bn, tx.init(p)), *a))(
        params, bn, jnp.asarray(bd), jnp.asarray(bs), None, jnp.asarray(bmask), key)
    grads_j = new_ts.opt_state[1]

    model = _port_model(params, bn)
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), LR, WD))
    batch_step, _ = tstep.make_unimodal_steps(beta=1.0, loss_backend="pallas", block_backend="pallas")
    ts, m = batch_step(ts, torch.from_numpy(bd), torch.from_numpy(bs).long(), None,
                       torch.from_numpy(bmask), eps=torch.from_numpy(eps))

    np.testing.assert_allclose(float(m.loss), float(m_j.loss), rtol=1e-2)
    grads = _flat(grads_j)
    _assert_grads_close(((k, dict(model.named_parameters())[k].grad) for k in grads),
                        {k: torch.from_numpy(v) for k, v in grads.items()}, per_param=None,
                        cos_min=0.97)
    ref = _flat(new_ts.params, new_ts.bn_state)
    for k, v in model.state_dict().items():
        v = v.numpy()
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref[k]) == 1, k
        elif "running" in k:
            assert _rel(v, ref[k]) < 1e-2, k
        else:  # the class embedding too: a zero gradient, decayed on both sides
            assert np.abs(v - ref[k]).max() <= 2 * LR * (1 + 1e-3), k


@pytest.mark.parametrize("which", ["cvae", "decoder"])
def test_pallas_backend_in_eval_mode_is_the_xla_path(which):
    r = np.random.default_rng(50)
    if which == "decoder":
        model = ResNet18Dec(z_dim=4, output_size=50, num_blocks=(1, 1, 1, 1)).eval()
        args = (torch.from_numpy(r.normal(size=(8, 8)).astype(np.float32)),)
        run = lambda backend: model(*args, backend=backend)  # noqa: E731
    else:
        model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**CFG), torch.Generator().manual_seed(0),
                                         device="cpu").eval()
        args = (torch.from_numpy(r.normal(size=(8, 50)).astype(np.float32)),
                torch.from_numpy(r.integers(0, 5, size=8)).long())
        run = lambda backend: model(*args, backend=backend)[3]  # noqa: E731
    with torch.no_grad():
        assert torch.equal(run("pallas"), run("xla"))


@pytest.mark.parametrize("backend", ["fused", "bf16"])
def test_unported_block_backends_raise(backend):
    with pytest.raises(ValueError):
        tstep.make_unimodal_steps(block_backend=backend)
    with pytest.raises(ValueError):
        tstep.make_unimodal_epoch_fns(block_backend=backend)
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ResNet18Dec(z_dim=4, num_blocks=(1, 1, 1, 1))(x, backend=backend)
    with pytest.raises(ValueError):
        tcvae.UnimodalCVAE(tcvae.CVAEConfig(**CFG))(torch.zeros(4, 50), torch.zeros(4).long(),
                                                    backend=backend)
