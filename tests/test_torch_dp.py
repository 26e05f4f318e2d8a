"""Data parallelism of the port on two gloo CPU ranks (parallel/mesh.py),
held to the single-process port and to the JAX package's data-parallel epoch
on a 2-device mesh (hippie_tpu/parallel/mesh.py:shard_epoch_inputs).

The contract is the JAX one (tests/test_parallel.py): the data-parallel
update is the single-device update on the global batch, so its losses are
within rtol 1e-3, atol 1e-4 and every parameter within 4.5e-3 after 2 AdamW
steps at lr 1e-3 (Adam's first steps move a parameter whose gradient sits at
the float32 noise floor by up to lr each, whichever its sign). The ranks'
parameters are bit-equal. The plan has a masked tail in which rank 1 has no
real row, so a rank's empty share of the statistics and of the loss is
covered. Rank workers (tests/_torch_dp_workers.py) import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_workers as W
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops.losses import vae_loss as j_vae_loss
from hippie_tpu.parallel import mesh as jmesh
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import optim as joptim
from hippie_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

N, B, NB = 80, 32, 2
ENVELOPE = 4.5e-3


def _data(kind="unimodal", seed=0):
    r = np.random.default_rng(seed)
    data = (r.normal(size=(N, 50)).astype(np.float32),)
    if kind == "joint":
        data = data + (r.normal(size=(N, 100)).astype(np.float32),)
    source = r.integers(0, 5, size=N).astype(np.int64)
    idx = r.permutation(N)[:NB * B].reshape(NB, B)
    mask = np.ones((NB, B), np.float32)
    mask[1, 11:] = 0  # the tail: 11 real rows, all in rank 0's columns
    eps = r.normal(size=(NB, B, W.CFG["z_dim"])).astype(np.float32)
    return data, source, idx, mask, eps


def _weights(kind="unimodal"):
    return W.numpy_state(W.build(kind))


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# The "pallas" blocks on CPU tensors are their plain versions, bf16 at the
# JAX math's points: a one-ulp flip of a bf16 activation moves the next
# block's statistics, so this path's step is chaotic. Measured on these two
# batches, a 1e-6 change of the input moves the single-process gradient by
# 0.004 and 0.087 relative (L2 over all leaves; leaves whose gradient sits
# near 0 by up to 11x their own norm) and the loss by up to 4e-4; the 2-rank
# gradient is 0.005 and 0.082 from the single-process one. So the limit is
# 0.15 on the whole gradient and 1e-3 on the loss; the seam's exact sums are
# held per block in test_plain_blocks_take_global_statistics.
PALLAS_ALL, PALLAS_LOSS = 0.15, 1e-3


BLOCKS = [("enc", 2), ("enc", 1), ("dec", 2), ("dec", 1)]


def _calls():
    """Every worker call of this file: one launch of 2 ranks runs them all."""
    data, source, idx, mask, eps = _data()
    sd = _weights()
    batch = (tuple(a[idx[1]] for a in data), source[idx[1]], mask[1], eps[1])
    jdata, jsource, jidx, jmask, jeps = _data("joint", seed=1)
    jbatch = (tuple(a[jidx[1]] for a in jdata), jsource[jidx[1]], jmask[1], jeps[1])
    return ([(f"grads_{b}", "grads", ("unimodal", b, sd, *batch)) for b in ("xla", "pallas")]
            + [("grads_joint", "grads", ("joint", "xla", _weights("joint"), *jbatch))]
            + [(f"block_{k}{s}", "plain_block", (k, s)) for k, s in BLOCKS]
            + [("epoch", "epoch", ("unimodal", "xla", sd, data, source, idx, mask, eps))])


@pytest.fixture(scope="module")
def runs():
    """(single process, [rank 0, rank 1]) results of every call."""
    calls = _calls()
    return W.run_all(None, calls), pmesh.launch(W.run_all, 2, calls, device="cpu")


@pytest.mark.parametrize("block", ["xla", "pallas"])
def test_step_gradients_match_single_process(runs, block):
    """One step's gradients of 2 ranks (each its columns, summed over the
    ranks; the block kernels' BatchNorm gamma and beta come out of the seam
    global) against the single-process gradients of the global batch."""
    ref = runs[0][f"grads_{block}"]
    got = [r[f"grads_{block}"] for r in runs[1]]
    assert got[0].keys() == ref.keys()
    for k in ref:
        if k == "loss":
            np.testing.assert_allclose(got[0][k], ref[k], rtol=1e-6 if block == "xla" else PALLAS_LOSS)
            continue
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)  # every rank the same sum
        if not np.any(ref[k]):
            assert not np.any(got[0][k]), k
        elif block == "xla":
            assert _rel(got[0][k], ref[k]) <= 1e-4, (k, _rel(got[0][k], ref[k]))
    if block == "pallas":
        flat = lambda g: np.concatenate([g[k].ravel() for k in ref if k != "loss"])  # noqa: E731
        assert _rel(flat(got[0]), flat(ref)) <= PALLAS_ALL


@pytest.mark.parametrize("kind,stride", BLOCKS)
def test_plain_blocks_take_global_statistics(runs, kind, stride):
    """The block kernels' plain versions on 2 ranks (each its columns of a
    batch whose 6 real rows are all rank 0's) against one process on the
    whole batch: the statistics within 1e-6 of their scale, the BatchNorm
    gamma and beta gradients global on every rank (within 1e-5 relative; the
    first ones the backward finishes are exact sums of the same bf16
    products), the outputs within one bf16 ulp flip."""
    ref = runs[0][f"block_{kind}{stride}"]
    got = [r[f"block_{kind}{stride}"] for r in runs[1]]
    for name, v in ref.items():
        if name in ("out", "dx"):  # this rank's rows: [L, B, C] columns in rank order
            a = np.concatenate([got[0][name], got[1][name]], axis=1)
            assert np.mean(a != v) < 0.02 and np.abs(a - v).max() <= 0.07 * np.abs(v).max(), name
        elif name.startswith("st"):
            np.testing.assert_array_equal(got[0][name], got[1][name])
            np.testing.assert_allclose(got[0][name], v, rtol=0, atol=1e-6 * np.abs(v).max(), err_msg=name)
        elif name in W.GLOBAL_SUMS[kind][0]:  # the seam's first sums: of identical bf16 values
            np.testing.assert_array_equal(got[0][name], got[1][name])
            assert _rel(got[0][name], v) <= 1e-5, (name, _rel(got[0][name], v))


def test_joint_step_matches_single_process(runs):
    """The joint model's step once: its gradients on 2 ranks against the
    single process's, within 1e-4 relative per leaf."""
    ref = runs[0]["grads_joint"]
    got = [r["grads_joint"] for r in runs[1]]
    for k in ref:
        if k != "loss" and np.any(ref[k]):
            assert _rel(got[0][k], ref[k]) <= 1e-4, k
    np.testing.assert_allclose(got[1]["loss"], ref["loss"], rtol=1e-6)


def _init_shapes(cfg):
    seen = []
    jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return jax.ShapeDtypeStruct(t.shape, t.dtype)

    return shapes(seen[0][0]), shapes(seen[0][1])


def _jax_mesh_epoch(sd, data, source, idx, mask, eps):
    """The JAX package's data-parallel epoch with injected noise: the train
    state and data replicated and the plan sharded over a 2-device mesh by
    shard_epoch_inputs, each step one jitted program (GSPMD's collectives)."""
    cfg = jcvae.CVAEConfig(output_size=50, **W.CFG)
    params, bn, _, skipped = jckpt.from_torch_state_dict(sd, *_init_shapes(cfg), prefix="")
    assert not skipped
    tx = joptim.make_optimizer(W.LR, W.WD)

    @jax.jit
    def step(params, bn, opt_state, data, source, idx, mask, eps):
        def loss_fn(p):
            (_, mu, logvar, dec), new_bn = jcvae.unimodal_cvae_apply(
                p, bn, data[idx], source[idx], None, eps=eps, training=True, mask=mask)
            total, _ = j_vae_loss(data[idx], dec, mu, logvar, beta=1.0, mask=mask)
            return total, new_bn

        (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bn, opt_state, loss

    mesh = jmesh.make_mesh(2)
    ts = (params, bn, tx.init(params))
    with mesh:
        ts, (d, s), idx_s, mask_s = jmesh.shard_epoch_inputs(mesh, ts, (jnp.asarray(data[0]), jnp.asarray(source)),
                                                             jnp.asarray(idx), jnp.asarray(mask))
        eps_s = jax.device_put(jnp.asarray(eps), jmesh.batch_sharded(mesh, batch_axis=1, ndim=3))
        losses = []
        for i in range(idx.shape[0]):
            *ts, loss = step(*ts, d, s, idx_s[i], mask_s[i], eps_s[i])
            losses.append(float(loss))
    return np.asarray(losses), {k: np.asarray(v) for k, v in
                                jckpt.to_torch_state_dict(ts[0], ts[1], prefix="").items()}


def test_epoch_matches_single_process_and_jax_mesh(runs):
    """A 2-step epoch on 2 ranks against the single-process port and against
    the JAX epoch on a 2-device mesh, from the same weights, plan and noise:
    losses within rtol 1e-3, atol 1e-4, every parameter and BatchNorm buffer
    within the envelope; the ranks' states bit-equal."""
    data, source, idx, mask, eps = _data()
    sd = _weights()
    single, ranks = runs[0]["epoch"], [r["epoch"] for r in runs[1]]
    for k in ranks[0]["state"]:
        np.testing.assert_array_equal(ranks[0]["state"][k], ranks[1]["state"][k], err_msg=k)
    np.testing.assert_array_equal(ranks[0]["loss"], ranks[1]["loss"])
    j_loss, j_state = _jax_mesh_epoch(sd, data, source, idx, mask, eps)
    for name, (loss, state) in {"single": (single["loss"], single["state"]), "jax": (j_loss, j_state)}.items():
        np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-3, atol=1e-4, err_msg=name)
        for k, v in ranks[0]["state"].items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == int(state[k]) == NB, (name, k)
            else:
                assert np.abs(v - state[k]).max() < ENVELOPE, (name, k, np.abs(v - state[k]).max())
