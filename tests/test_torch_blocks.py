"""The encoder block's plain versions against hippie_tpu on the CPU.

The port's ``enc_block_fwd_plain`` / ``enc_block_bwd_plain`` repeat
``pallas_blocks._enc_fwd_math`` / ``_enc_bwd_math``; they are held against
the JAX primitive ``_enc_block_prim(stride, has_short, "xla")`` (the same
math as plain XLA ops: the Pallas kernel runs it in VMEM), its ``jax.vjp``,
``basic_block_enc_fused(impl="xla")`` and ``resnet18_enc_apply(backend=
"fused")``. Inputs come from numpy seeds, with a masked tail whose padded
rows hold +-1e3; the ISI encoder's shapes (input length 100: blocks at
L = 50 and, past the waveform encoder's, 512 channels at L = 7) at B=16.

Tolerances. Both sides multiply the same bf16 operands exactly into float32
and round to bf16 at the same points; they differ only in the order of the
float32 sums (XLA:CPU's dot against torch's matmul). Such a difference moves
a value by about 1e-7 of its size, and flips its bf16 rounding (one ulp,
2^-8 = 3.9e-3 relative) only where it lies that close to a rounding
boundary: a small fraction of the elements, which then carry through the
later steps. So bf16 tensors and the float32 gradients built from them are
compared by relative Frobenius norm at 1e-2, and the float32 statistics,
which see no bf16 rounding in the forward, at rtol 1e-5 of their scale.

The full encoder chains four blocks, and there a flip is no longer rare in
effect: it moves the next block's statistics, which moves every value a
little, and where a value sits at LeakyReLU's kink its gradient jumps from 1
to 0.01. Measured on this CPU: the JAX fused path alone, given its input
scaled by 1 + 1e-6, moves its own output by 4e-3 and its parameter
gradients by up to 0.10 (relative Frobenius, B=64); the fp32 path moves by
1e-6. So the encoder's output and BN buffers are held at 1e-2, and each
parameter gradient at 1e-1 (the JAX package's own limit for the fused
block's gradients, test_pallas_blocks.py:89), with the cosine of the whole
gradient above 0.99.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.models import backbones as jbb
from hippie_tpu.ops import pallas_blocks as pb
from hippie_tpu_torch.models.backbones import BasicBlockEnc, ResNet18Enc
from hippie_tpu_torch.ops import cuda_blocks
from hippie_tpu_torch.train.checkpoint import state_dict_from_jax

torch.set_num_threads(1)

B, N_REAL = 24, 17
SHAPES = [(1, 25, 64), (2, 25, 64), (2, 13, 128), (2, 7, 64)]  # test_pallas_blocks.py:22
# the ISI encoder's (input length 100) shapes that the waveform encoder's lack,
# at a smaller batch: (stride, L, C_in)
ISI_SHAPES = [(1, 50, 64), (2, 50, 64), (1, 7, 512)]
ISI_B, ISI_N_REAL = 16, 11
REL = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t, jnp.float32))  # a writable copy


def _block_inputs(stride, L, C, seed, b=B, n_real=N_REAL):
    """x [L,b,C] float32 (rounded to bf16 by each side), weights, BN vectors,
    the [b,1] mask with n_real real rows, and the output cotangent."""
    r = np.random.default_rng(seed)
    co = C * stride
    lo = L if stride == 1 else (L - 1) // 2 + 1
    x = r.normal(size=(L, b, C)).astype(np.float32)
    x[:, n_real:] = 1e3 * np.where(r.random((L, b - n_real, C)) < 0.5, 1.0, -1.0)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    w = {"w1": f(3, C, co) / np.sqrt(3 * C), "w2": f(3, co, co) / np.sqrt(3 * co),
         "ws": f(1, C, co) / np.sqrt(C) if stride != 1 else np.zeros((1, C, co), np.float32)}
    v = {k: r.uniform(0.5, 1.5, co).astype(np.float32) for k in ("g1", "g2", "gs")}
    v.update({k: 0.1 * f(co) for k in ("b1", "b2", "bs")})
    if stride == 1:
        v["gs"], v["bs"] = np.zeros(co, np.float32), np.zeros(co, np.float32)
    m = (np.arange(b) < n_real).astype(np.float32).reshape(b, 1)
    g = f(lo, b, co)
    args = [x, w["w1"], v["g1"], v["b1"], w["w2"], v["g2"], v["b2"], w["ws"], v["gs"], v["bs"], m]
    return args, g


def _jax_args(args):
    return [jnp.asarray(args[0]).astype(jnp.bfloat16)] + [jnp.asarray(a) for a in args[1:]]


def _torch_args(args, stride):
    t = [torch.from_numpy(args[0]).bfloat16()] + [torch.from_numpy(a) for a in args[1:]]
    if stride == 1:  # the port passes no shortcut operands; the plain version makes the zeros
        t[7:10] = [None, None, None]
    return t


def _check_stats(got, ref, what, rtol=1e-5):
    """(mean, var, inv) rows; the mean against its scale |mean| + std."""
    scale = np.stack([np.abs(ref[0]) + np.sqrt(ref[1]), np.abs(ref[1]), np.abs(ref[2])])
    err = np.abs(got - ref)
    assert (err <= rtol * scale).all(), (what, float((err / np.maximum(scale, 1e-30)).max()))


@pytest.mark.parametrize("stride,L,C", SHAPES)
def test_plain_forward_matches_jax(stride, L, C):
    _check_forward(stride, L, C, B, N_REAL)


@pytest.mark.parametrize("stride,L,C", ISI_SHAPES)
def test_plain_forward_matches_jax_at_isi_shapes(stride, L, C):
    _check_forward(stride, L, C, ISI_B, ISI_N_REAL)


def _check_forward(stride, L, C, rows, n_real):
    args, _ = _block_inputs(stride, L, C, seed=L + C, b=rows, n_real=n_real)
    has_short = stride != 1
    ref = jax.jit(pb._enc_block_prim(stride, has_short, "xla"))(*_jax_args(args))
    got = cuda_blocks.enc_block_fwd_plain(stride, has_short, *_torch_args(args, stride))
    assert got[0].dtype == torch.bfloat16 and tuple(got[0].shape) == ref[0].shape
    assert _rel(_np(got[0])[:, :n_real], _np(ref[0])[:, :n_real]) < REL
    for name, a, b in zip(("st1", "st2", "sts"), got[1:], ref[1:]):
        _check_stats(_np(a), _np(b), name)


@pytest.mark.parametrize("stride,L,C", SHAPES)
def test_plain_backward_matches_jax_vjp(stride, L, C):
    _check_backward(stride, L, C, B, N_REAL)


@pytest.mark.parametrize("stride,L,C", ISI_SHAPES)
def test_plain_backward_matches_jax_vjp_at_isi_shapes(stride, L, C):
    _check_backward(stride, L, C, ISI_B, ISI_N_REAL)


def _check_backward(stride, L, C, rows, n_real):
    args, g = _block_inputs(stride, L, C, seed=7 * L + C, b=rows, n_real=n_real)
    has_short = stride != 1
    prim = pb._enc_block_prim(stride, has_short, "xla")

    @jax.jit
    def fwd_vjp(jargs, gb):
        outs, vjp = jax.vjp(prim, *jargs)
        return outs, vjp((gb, *(jnp.zeros_like(s) for s in outs[1:])))[:10]

    outs, ref = fwd_vjp(_jax_args(args), jnp.asarray(g).astype(jnp.bfloat16))
    st = [torch.from_numpy(_np(s)) for s in outs[1:]]
    got = cuda_blocks.enc_block_bwd_plain(stride, has_short, *_torch_args(args, stride), *st,
                                          torch.from_numpy(g).bfloat16())
    assert got[0].dtype == torch.bfloat16
    names = ("dx", "dw1", "dg1", "db1", "dw2", "dg2", "db2", "dws", "dgs", "dbs")
    for name, a, b in zip(names, got, ref):
        if not has_short and name in ("dws", "dgs", "dbs"):
            assert not _np(a).any() and not _np(b).any(), name
            continue
        assert _rel(_np(a), _np(b)) < REL, (name, _rel(_np(a), _np(b)))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_block_updates_bn_buffers_as_jax(stride):
    L, C = 13, 64
    args, _ = _block_inputs(stride, L, C, seed=30 + stride)
    p, s = jbb._basic_block_enc_init(jax.random.PRNGKey(stride), C, stride)
    mask = args[10][:, 0]
    x = _jax_args(args)[0]
    out_j, new_j = jax.jit(lambda p, s, x, m: pb.basic_block_enc_fused(
        p, s, x, stride=stride, mask=m, impl="xla"))(p, s, x, jnp.asarray(mask))
    block = BasicBlockEnc(C, stride)
    block.load_state_dict(state_dict_from_jax(_numpy_tree(p), _numpy_tree(s)), strict=True)
    block.train()
    out = cuda_blocks.basic_block_enc_fused(block, torch.from_numpy(args[0]).bfloat16(),
                                            torch.from_numpy(mask))
    assert _rel(_np(out)[:, :N_REAL], _np(out_j)[:, :N_REAL]) < REL
    ref_sd = state_dict_from_jax(_numpy_tree(p), _numpy_tree(new_j))
    for k, v in block.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(ref_sd[k]) == 1, k
        elif "running" in k:
            np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_resnet18_enc_pallas_matches_jax_fused():
    z, nb, Bm = 4, (1, 1, 1, 1), 16
    r = np.random.default_rng(40)
    x = r.normal(size=(Bm, 50)).astype(np.float32)
    mask = (np.arange(Bm) < 11).astype(np.float32)
    cot = r.normal(size=(Bm, 2 * z)).astype(np.float32) * mask[:, None]
    p, s = jbb.resnet18_enc_init(jax.random.PRNGKey(41), z_dim=z, num_blocks=nb)

    def loss(p):
        out, new_s = jbb.resnet18_enc_apply(p, s, jnp.asarray(x)[:, :, None], training=True,
                                            mask=jnp.asarray(mask), backend="fused")
        return jnp.sum(out * cot), (out, new_s)

    (_, (out_j, new_j)), grads_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)

    enc = ResNet18Enc(z_dim=z, num_blocks=nb)
    enc.load_state_dict(state_dict_from_jax(_numpy_tree(p), _numpy_tree(s)), strict=True)
    enc.train()
    out = enc(torch.from_numpy(x)[:, None, :], torch.from_numpy(mask), backend="pallas")
    (out * torch.from_numpy(cot)).sum().backward()

    rows = mask > 0
    assert _rel(_np(out)[rows], _np(out_j)[rows]) < 1e-2
    ref_g = state_dict_from_jax(_numpy_tree(grads_j), None)
    got, want = [], []
    for name, prm in enc.named_parameters():
        got.append(_np(prm.grad).ravel())
        want.append(ref_g[name].numpy().ravel())
        assert _rel(got[-1], want[-1]) < 1e-1, (name, _rel(got[-1], want[-1]))
    got, want = np.concatenate(got).astype(np.float64), np.concatenate(want).astype(np.float64)
    assert got @ want / (np.linalg.norm(got) * np.linalg.norm(want)) > 0.99
    ref_sd = state_dict_from_jax(_numpy_tree(p), _numpy_tree(new_j))
    for k, v in enc.state_dict().items():
        if "running" in k:
            assert _rel(v.numpy(), ref_sd[k].numpy()) < 1e-2, k
        elif k.endswith("num_batches_tracked"):
            assert int(v) == int(ref_sd[k]) == 1, k


def test_pallas_backend_in_eval_mode_is_the_xla_path():
    enc = ResNet18Enc(z_dim=4, num_blocks=(1, 1, 1, 1)).eval()
    x = torch.from_numpy(np.random.default_rng(50).normal(size=(8, 1, 50)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(enc(x, backend="pallas"), enc(x))
    with pytest.raises(ValueError):
        enc(x, backend="fused")
