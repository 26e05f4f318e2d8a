"""The global-norm clip of the port (train/optim.py:clip_by_global_norm_,
and parallel/fsdp.py:ShardedOptimizer._clip) against
optax.clip_by_global_norm: the norm is the square root of the leaves' sums
of squares added up, within 2e-7 relative of float64, and each gradient
becomes ``(g / norm) * clip`` (bit for bit, for the port's norm) when the
norm is not below the clip, ``g`` itself when it is. AdamW, schedule-free
AdamW and the FSDP optimizer on one gloo rank clip before their update."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.parallel.fsdp import ShardedOptimizer
from hippie_tpu_torch.train import optim
from hippie_tpu_torch.train.schedule_free import ScheduleFreeAdamW

torch.set_num_threads(1)

# leaves of the 1-D ResNet18 cVAE: convs [C_out, C_in, K], BatchNorm vectors,
# the stem, a dense head and the class embedding
SHAPES = [(512, 512, 3), (512, 256, 3), (256, 256, 3), (128, 64, 3), (64, 1, 7), (512,), (10, 512), (5, 5)]


def _grads(seed: int = 0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=s) * r.uniform(1e-3, 3.0)).astype(np.float32) for s in SHAPES]


def _norm(grads) -> torch.Tensor:
    return torch.sqrt(torch.stack(optim.leaf_square_sums(grads)).sum())


def test_norm_is_within_2e7_of_float64():
    """The port's norm against float64, beside optax's global_norm."""
    g = _grads()
    want = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in g))
    got = float(_norm([torch.from_numpy(x) for x in g]))
    jax_norm = float(optax.global_norm([jnp.asarray(x) for x in g]))
    assert abs(got - want) / want < 2e-7, (got, want)
    assert abs(got - jax_norm) / want < 4e-7, (got, jax_norm)


@pytest.mark.parametrize("factor", [0.25, 4.0], ids=["above", "below"])
def test_clip_matches_optax(factor):
    """Above the clip every leaf is ``(g / n) * c`` bit for bit for the
    port's n and within an ulp-level distance of optax's; below it every
    leaf is unchanged, as optax's select leaves it."""
    g = _grads(1)
    t = [torch.from_numpy(x.copy()) for x in g]
    n = _norm(t)
    c = float(n) * factor
    optim.clip_by_global_norm_(t, c)
    for x, y in zip(g, t):
        np.testing.assert_array_equal(y.numpy(), torch.where(n < c, torch.from_numpy(x),
                                                             (torch.from_numpy(x) / n) * c).numpy())
    ref, _ = optax.clip_by_global_norm(c).update([jnp.asarray(x) for x in g], optax.EmptyState())
    for x, y in zip(ref, t):
        if factor > 1:
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        else:
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6, atol=0)


def _model():
    cfg = cvae.CVAEConfig(z_dim=4, output_size=50, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
    return cvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(3), device="cpu")


def _set_grads(model, seed: int = 2, scale: float = 1.0):
    r = np.random.default_rng(seed)
    for p in model.parameters():
        p.grad = torch.from_numpy((r.normal(size=p.shape) * scale).astype(np.float32))


@pytest.mark.parametrize("algorithm", ["adamw", "schedule-free"])
def test_optimizers_clip_before_their_update(algorithm):
    """A step with ``clip_val`` equals, bit for bit, the unclipped
    optimizer's step on the gradients clipped by clip_by_global_norm_."""
    clip = 1.0
    runs = []
    for pre_clip in (False, True):
        model = _model()
        _set_grads(model)
        if pre_clip:
            optim.clip_by_global_norm_([p.grad for p in model.parameters()], clip)
        opt = optim.make_optimizer(model.parameters(), 1e-3, 0.01, None if pre_clip else clip,
                                   algorithm=algorithm)
        assert isinstance(opt, ScheduleFreeAdamW) == (algorithm == "schedule-free")
        opt.step()
        runs.append((model.state_dict(), opt.state_dict()))
    (sd_a, opt_a), (sd_b, opt_b) = runs
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    for i, st in opt_a["state"].items():
        for name, v in st.items():
            assert torch.equal(v, opt_b["state"][i][name]), (i, name)


@pytest.fixture
def one_gloo_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        yield pmesh.Mesh(0, 1, torch.device("cpu"), "gloo")
    finally:
        dist.destroy_process_group()


def test_sharded_clip_on_one_gloo_rank(one_gloo_rank):
    """ShardedOptimizer._clip (the shards' squares summed over the ranks)
    on one rank scales as clip_by_global_norm_ does; the FSDP AdamW step
    with the clip equals the replicated one bit for bit."""
    mesh = one_gloo_rank
    model = _model()
    fs = ShardedOptimizer(model, mesh, lambda ps: optim.make_optimizer(ps, 1e-3, 0.01), clip_val=0.5)
    split = fs._split()
    assert split == list(range(len(fs.params)))  # one rank: every leaf is one chunk
    r = np.random.default_rng(4)
    for s in fs.shards:
        s.grad = torch.from_numpy(r.normal(size=s.shape).astype(np.float32))
    want = [s.grad.clone() for s in fs.shards]
    optim.clip_by_global_norm_(want, 0.5)
    fs._clip(split, [])
    for s, w in zip(fs.shards, want):
        assert torch.equal(s.grad, w)
    fs.zero_grad()

    runs = []
    for sharded in (False, True):
        model = _model()
        _set_grads(model, 5, 0.3)
        opt = (ShardedOptimizer(model, mesh, lambda ps: optim.make_optimizer(ps, 1e-3, 0.01), clip_val=1.0)
               if sharded else optim.make_optimizer(model.parameters(), 1e-3, 0.01, 1.0))
        with pmesh.data_parallel(mesh if sharded else None):
            opt.step()
        runs.append((model.state_dict(), opt.state_dict()))
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k
    for i, st in runs[0][1]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[name], runs[1][1]["state"][i][name]), (i, name)
