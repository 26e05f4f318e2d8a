"""parallel/mesh.py of the port against hippie_tpu/parallel/mesh.py, with no
ranks spawned: the FSDP axis of every leaf of both full-width models, the
columns ``batch_sharded`` gives each rank, and the cross-rank Chan merge of
(count, sum, M2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.parallel import mesh as jmesh
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.ops import cuda_blocks
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train.checkpoint import _from_torch_layout, _to_torch_layout

torch.set_num_threads(1)


def _mesh(rank: int, size: int) -> pmesh.Mesh:
    return pmesh.Mesh(rank, size, torch.device("cpu"), "gloo")


def _full_width(kind: str):
    with torch.device("meta"):  # shapes only
        if kind == "joint":
            return tcvae.MultiModalCVAE(tcvae.MultiModalConfig(z_dim=10))
        return tcvae.UnimodalCVAE(tcvae.CVAEConfig(z_dim=10, output_size=50))


@pytest.mark.parametrize("kind", ["unimodal", "joint"])
@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_sharding_for_picks_the_jax_logical_axis(kind, n):
    """For every parameter of the full-width model, the port's dim is the
    torch dim of the axis JAX shards the same leaf along in its own layout
    (None where JAX replicates it)."""
    jm = jmesh.make_mesh(n)
    checked = sharded = 0
    for key, p in _full_width(kind).named_parameters():
        jax_shape = _from_torch_layout(key, np.empty(p.shape, np.int8)).shape
        spec = jmesh.fsdp_sharding_for(jm, jax.ShapeDtypeStruct(jax_shape, jnp.float32)).spec
        jax_axis = next((i for i, s in enumerate(spec) if s == "data"), None)
        dim = pmesh.fsdp_sharding_for(_mesh(0, n), key, tuple(p.shape))
        if jax_axis is None:
            assert dim is None, key
        else:
            # an array in the JAX layout whose entries are their index along the
            # sharded axis, moved to the torch layout by the checkpoint code,
            # varies along the port's dim alone
            along = lambda shape, a: np.arange(shape[a]).reshape(  # noqa: E731
                [-1 if i == a else 1 for i in range(len(shape))])
            probe = _to_torch_layout(key, np.broadcast_to(along(jax_shape, jax_axis), jax_shape))
            assert dim is not None and probe.shape == tuple(p.shape), key
            np.testing.assert_array_equal(probe, np.broadcast_to(along(probe.shape, dim), probe.shape),
                                          err_msg=key)
            sharded += 1
        checked += 1
    assert checked > 100 and sharded > 50


def test_batch_sharded_gives_jax_addressable_shards():
    """Rank r's columns of an [nb, B] plan are the block JAX's P(None, "data")
    places on device r of a 2-device mesh."""
    plan = np.arange(3 * 32).reshape(3, 32)
    jm = jmesh.make_mesh(2)
    placed = jax.device_put(jnp.asarray(plan), jmesh.batch_sharded(jm, batch_axis=1, ndim=2))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r, d in enumerate(jm.devices.flat):
        np.testing.assert_array_equal(pmesh.batch_sharded(_mesh(r, 2), plan), by_device[d])
        np.testing.assert_array_equal(pmesh.batch_sharded(_mesh(r, 2), torch.from_numpy(plan)).numpy(),
                                      by_device[d])
    with pytest.raises(ValueError, match="does not divide over 3"):
        pmesh.batch_sharded(_mesh(0, 3), plan)


def _moments(x, m):
    """(count, sum, M2 about the set's own mean) per column of x [n, C]."""
    cnt = m.sum()
    s = (x * m[:, None]).sum(0)
    mean = s / max(cnt, 1.0)
    return np.stack([np.full_like(s, cnt), s, (((x - mean) ** 2) * m[:, None]).sum(0)])


@pytest.mark.parametrize("split,real", [(7, 20), (13, 20), (10, 10), (0, 20)])
def test_chan_merge_of_two_row_sets(split, real):
    """Two ranks' (count, sum, M2) merged in rank order equal the plain
    statistics of their union within 1e-6 (a rank with no real rows merges
    as nothing), and the merge's plain version writes (mean, var, inv)."""
    r = np.random.default_rng(split)
    x = (r.normal(size=(20, 6)) * 3 + 1).astype(np.float64)
    m = (np.arange(20) < real).astype(np.float64)
    rows = np.stack([_moments(x[:split], m[:split]), _moments(x[split:], m[split:])])
    merged = pmesh.merge_moments(torch.from_numpy(rows).float()).double().numpy()
    xs = x[m > 0]
    np.testing.assert_allclose(merged[0], len(xs), rtol=0)
    np.testing.assert_allclose(merged[1] / merged[0], xs.mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(merged[2] / merged[0], xs.var(0), rtol=1e-6, atol=1e-6)
    st = cuda_blocks.bn_stats_merge_plain(torch.from_numpy(rows).float()).double().numpy()
    np.testing.assert_allclose(st[0], xs.mean(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st[1], xs.var(0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st[2], 1 / np.sqrt(xs.var(0) + 1e-5), rtol=1e-6)


def test_merge_of_one_row_is_that_row():
    """One rank's moments merge to themselves, bit for bit (the segmented
    kernels' one-rank identity rests on it)."""
    rows = torch.randn(1, 6, 64)
    assert torch.equal(pmesh.merge_moments(rows), rows[0])
