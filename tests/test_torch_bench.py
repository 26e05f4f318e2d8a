"""``hippie-tpu-torch bench`` (hippie_tpu_torch/scripts/bench.py) on the CPU.

- ``step_flops`` (hippie_tpu_torch/utils/flops.py) equals 3 x the JAX
  training forward's convolution and dot FLOPs, each counted here as
  2 * output elements * (window * input channels) over the equations of
  ``jax.make_jaxpr(unimodal_cvae_apply(training=True))`` (traced, not
  compiled): exactly, at the bench's config (151,427,702,784) and at
  num_blocks=(1, 1, 1, 1) with the ISI width 100, so the count follows depth
  and length.
- ``run`` at num_blocks=(1, 1, 1, 1), n=300, B=64, one warm-up and one timed
  epoch on the CPU returns every key of the JSON line, finite.
- The epoch the bench times (train/device_fit.py:run_graphed_epoch over
  ``make_train_graph``, eager on the CPU) against the JAX step, from the
  same weights (carried with ``state_dict_from_jax``), over the bench's own
  plan (3 batches, a masked tail) with the noise the bench's generator
  draws, injected into the JAX forward through ``unimodal_cvae_apply(eps=)``.
  Tolerances are tests/test_torch_train.py's: the first loss rtol 1e-5 (one
  step from the same weights), the later ones rtol 2e-3, since they are
  computed from parameters that already differ within AdamW's 2 * lr
  envelope (measured: 1.6e-4 at the third step), and parameters and
  BatchNorm buffers by its ``_assert_params_and_bn_match``.
- The CLI without a CUDA device exits 1 with one line on stderr.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from hippie_tpu.models import cvae as jcvae
from hippie_tpu_torch import cli
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import bench
from hippie_tpu_torch.train import device_fit
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep
from hippie_tpu_torch.train.checkpoint import state_dict_from_jax
from hippie_tpu_torch.utils.flops import step_flops
from test_torch_train import _TX, _assert_params_and_bn_match, _flat, _jax_step, _numpy_tree

torch.set_num_threads(1)

KEYS = ("metric", "value", "unit", "vs_baseline", "ms_per_batch", "mfu_vs_bf16_peak", "flops_per_batch",
        "device_busy_ms_per_batch", "idle_share", "block_backend", "loss_backend", "device")


def _jaxpr_flops(jaxpr) -> int:
    """2 * output elements * (window * input channels) of every convolution,
    2 * output elements * contracted size of every dot, in ``jaxpr`` and the
    jaxprs its equations hold."""
    total = 0
    for eqn in jaxpr.eqns:
        out = math.prod(eqn.outvars[0].aval.shape)
        if eqn.primitive.name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            total += 2 * out * (math.prod(rhs) // rhs[eqn.params["dimension_numbers"].rhs_spec[0]])
        elif eqn.primitive.name == "dot_general":
            (contracting, _), _ = eqn.params["dimension_numbers"]
            total += 2 * out * math.prod(eqn.invars[0].aval.shape[d] for d in contracting)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    total += _jaxpr_flops(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    total += _jaxpr_flops(sub)
    return total


@pytest.mark.parametrize("num_blocks,length,want", [((2, 2, 2, 2), 50, 151_427_702_784),
                                                    ((1, 1, 1, 1), 100, None)])
def test_step_flops_match_the_jax_jaxpr(num_blocks, length, want):
    B = bench.BATCH_SIZE
    cfg = bench.bench_config(num_blocks)._replace(output_size=length)
    jcfg = jcvae.CVAEConfig(**cfg._asdict())
    params, state = jax.eval_shape(lambda: jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), jcfg))
    shape = jax.ShapeDtypeStruct
    jaxpr = jax.make_jaxpr(
        lambda p, s, d, src, eps: jcvae.unimodal_cvae_apply(p, s, d, src, None, eps=eps, training=True))(
        params, state, shape((B, length), jnp.float32), shape((B,), jnp.int32), shape((B, cfg.z_dim), jnp.float32))
    got = step_flops(cfg, B, length)
    assert got == 3 * _jaxpr_flops(jaxpr.jaxpr)
    assert want is None or got == want
    # a model counts as its config does
    model = tcvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert step_flops(model, B, length) == got


def test_run_returns_the_json_line_on_the_cpu(capsys):
    cfg = bench.bench_config((1, 1, 1, 1))
    line = bench.run(cfg, 300, 64, 1, "cpu", "xla", "pallas")
    assert tuple(line) == KEYS
    assert line["metric"] == "cvae_pretrain_waveforms_per_sec" and line["unit"] == "waveforms/s/chip"
    assert (line["block_backend"], line["loss_backend"], line["device"]) == ("xla", "pallas", "cpu")
    assert line["flops_per_batch"] == step_flops(cfg, 64, bench.LENGTH)
    numbers = [v for k, v in line.items() if k not in ("metric", "unit", "block_backend", "loss_backend", "device")]
    assert all(isinstance(v, (int, float)) and math.isfinite(v) for v in numbers), line
    assert line["value"] > 0 and line["ms_per_batch"] > 0 and line["device_busy_ms_per_batch"] > 0
    # vs_baseline is rounded from the unrounded rate (scripts/bench.py, as the
    # JAX bench.py), value to 0.1: the two roundings allow half a step of
    # 0.01 plus 0.05 / BASELINE_WAVEFORMS_PER_SEC between them
    slack = 0.005 + 0.05 / bench.BASELINE_WAVEFORMS_PER_SEC
    assert abs(line["vs_baseline"] - line["value"] / bench.BASELINE_WAVEFORMS_PER_SEC) <= slack + 1e-9
    assert "timed epochs of 5 batches" in capsys.readouterr().err


def test_cli_without_cuda_exits_with_one_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and out.err.count("\n") == 1 and "no CUDA device" in out.err


@pytest.fixture(scope="module")
def jax_init():
    cfg = jcvae.CVAEConfig(**bench.bench_config((1, 1, 1, 1))._asdict())
    return jcvae.unimodal_cvae_init(jax.random.PRNGKey(1), cfg)


def test_the_timed_epoch_matches_the_jax_step(jax_init):
    params, bn = jax_init
    n, B = 70, 32
    data, source = bench.make_data(n, "cpu")
    idx, mask = bench.make_plan(n, B)
    nb, z = idx.shape[0], bench.bench_config().z_dim
    assert nb == 3 and mask[-1].sum() == n - 2 * B

    model = tcvae.UnimodalCVAE(bench.bench_config((1, 1, 1, 1)))
    model.load_state_dict(state_dict_from_jax(_numpy_tree(params), _numpy_tree(bn)), strict=True)
    ts = tstep.TrainState(model, toptim.make_optimizer(model.parameters(), bench.LR, bench.WD, clip_val=None))
    with device_fit.graph_stream(torch.device("cpu")) as (stream, pool):
        train = bench.make_train_graph(ts, data, source, nb=nb, batch_size=B, stream=stream, pool=pool,
                                       block_backend="xla", loss_backend="pallas")
        metrics = device_fit.run_graphed_epoch(train, idx, mask, [bench.noise_generator(0, "cpu")])
    assert train.graph is None and metrics.shape == (3, 1, nb)

    gen = bench.noise_generator(0, "cpu")  # the draws the epoch made, in its order
    eps = [torch.empty((B, z)).normal_(0.0, 1.0, generator=gen).numpy() for _ in range(nb)]
    before = _flat(params, bn)
    opt, wave, src = _TX.init(params), data.numpy(), source.numpy().astype(np.int32)
    losses = []
    for i in range(nb):
        params, bn, opt, loss, grads = _jax_step(params, bn, opt, jnp.asarray(wave[idx[i]]), jnp.asarray(src[idx[i]]),
                                                 jnp.asarray(mask[i]), jnp.asarray(eps[i]))
        losses.append(float(loss))
    got = metrics[0, 0].numpy()
    np.testing.assert_allclose(got[0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], losses[1:], rtol=2e-3)
    _assert_params_and_bn_match(ts.model, params, bn, grads, before, steps=nb)
