"""The plain reference (perfbench/reference/) against the port on the CPU at
a small size (num_blocks (1, 1, 1, 1), B <= 64): the state dict's layout,
the preprocessing of real dataset rows, the training forward and loss, three
training steps with the clip and AdamW, and the embedding. The port runs
its float32 paths here (block and loss backend ``xla``), so the two agree
to float32 rounding. No JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hippie_tpu_torch.evaluate import embeddings as port_emb
from hippie_tpu_torch.models import cvae as port_cvae
from hippie_tpu_torch.ops import losses as port_losses
from hippie_tpu_torch.ops import preprocess as port_pre
from hippie_tpu_torch.train import optim as port_optim
from hippie_tpu_torch.train import step as port_step
from perfbench.harness import data, weights
from perfbench.reference import cvae, preprocess, train
from perfbench.reference.compare import train_gaps
from perfbench.reference.numerics import Numerics, round_fp8, round_tf32

torch.set_num_threads(2)
SMALL = (1, 1, 1, 1)


def _arch(multimodal: bool, num_blocks=SMALL) -> cvae.Arch:
    return cvae.Arch(multimodal, 10, 5, 5, 5, num_blocks, 50, 100)


def _port_model(arch: cvae.Arch, sd):
    if arch.multimodal:
        model = port_cvae.MultiModalCVAE(port_cvae.MultiModalConfig(num_blocks=arch.num_blocks))
    else:
        model = port_cvae.UnimodalCVAE(port_cvae.CVAEConfig(num_blocks=arch.num_blocks))
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("multimodal", [False, True])
@pytest.mark.parametrize("num_blocks", [SMALL, (2, 2, 2, 2)])
def test_state_dict_layout_is_the_ports(multimodal, num_blocks):
    arch = _arch(multimodal, num_blocks)
    spec = cvae.param_spec(arch)
    with torch.device("meta"):
        model = (port_cvae.MultiModalCVAE(port_cvae.MultiModalConfig(num_blocks=num_blocks)) if multimodal
                 else port_cvae.UnimodalCVAE(port_cvae.CVAEConfig(num_blocks=num_blocks)))
    sd = model.state_dict()
    assert list(sd) == list(spec)
    assert all(tuple(sd[k].shape) == spec[k].shape for k in sd)
    trained = sum(int(np.prod(leaf.shape)) for leaf in spec.values() if leaf.trained)
    if num_blocks == (2, 2, 2, 2):
        assert trained == (16_115_748 if multimodal else 8_056_639)


def test_weights_are_seeded_and_bounded():
    arch = _arch(True)
    a = weights.make_state_dict(arch, 2**31 + 7, "cpu")
    b = weights.make_state_dict(arch, 2**31 + 7, "cpu")
    c = weights.make_state_dict(arch, 2**31 + 8, "cpu")
    spec = cvae.param_spec(arch)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder_mod1.conv1.weight"], c["encoder_mod1.conv1.weight"])
    for k, leaf in spec.items():
        if leaf.init == "uniform":
            assert float(a[k].abs().max()) <= leaf.bound * (1 + 1e-6)
            if a[k].numel() >= 100:
                assert float(a[k].abs().max()) > 0.9 * leaf.bound


def test_preprocessing_of_the_raw_rows():
    for s in data.load_sets({"juxtacellular-mouse-s1-area": 4, "extracellular-mouse-a1": 1}):
        want = port_pre.preprocess_pair(s.wf, s.isi, device="cpu")
        got = preprocess.preprocess(s.wf, s.isi, "cpu")
        for w, g in zip(want, got):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def _batch(arch, b, seed):
    g = torch.Generator().manual_seed(seed)
    inputs = (torch.randn(b, 50, generator=g),) + ((torch.randn(b, 100, generator=g).abs(),) if arch.multimodal else ())
    return inputs, torch.randint(0, 5, (b,), generator=g), torch.randn(b, 10, generator=g)


@pytest.mark.parametrize("multimodal", [False, True])
def test_training_forward_and_loss(multimodal):
    arch = _arch(multimodal)
    sd = weights.make_state_dict(arch, 5, "cpu")
    model = _port_model(arch, sd).train()
    inputs, src, eps = _batch(arch, 48, 1)
    out = model(*inputs, src, None, eps=eps)
    ref = cvae.forward(sd, arch, inputs, src, eps, Numerics(), training=True)
    for a, b in zip(out, ref):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)
    if multimodal:
        want = port_losses.multimodal_vae_loss(inputs[0], inputs[1], out[3], out[4], out[1], out[2])[0]
    else:
        want = port_losses.vae_loss(inputs[0], out[3], out[1], out[2])[0]
    torch.testing.assert_close(cvae.loss(inputs, ref, 1.0), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("multimodal", [False, True])
def test_three_training_steps_with_clip_and_adamw(multimodal):
    arch = _arch(multimodal)
    sd = weights.make_state_dict(arch, 6, "cpu")
    model = _port_model(arch, sd)
    opt = port_optim.make_optimizer(model.parameters(), 1e-3, 0.01, clip_val=1.0)
    ts = port_step.TrainState(model, opt)
    make = port_step.make_multimodal_steps if multimodal else port_step.make_unimodal_steps
    batch_step, _ = make(loss_backend="xla", block_backend="xla")
    batches, metrics = [_batch(arch, 32, 10 + t) for t in range(3)], []
    for inputs, src, eps in batches:
        metrics.append([float(x) for x in batch_step(ts, *inputs, src, None, torch.ones(32), eps=eps)[1]])
        if len(metrics) == 1:
            grad1 = {k: opt.state[p]["exp_avg"] / 0.1 for k, p in model.named_parameters()}
            var1 = {k: b.clone() for k, b in model.named_buffers() if k.endswith("running_var")}
    hp = train.Hyper(1e-3, 0.01, 1.0, 1.0, (1.0, 1.0))
    ref = train.run_steps(sd, arch, batches, hp, Numerics())
    losses, mses, kls = zip(*metrics)
    np.testing.assert_allclose([ref.losses[0], ref.mses[0], ref.kls[0]], metrics[0], rtol=1e-5)
    for k, p in model.named_parameters():
        torch.testing.assert_close(ref.grad1[k], grad1[k], rtol=1e-3, atol=1e-6)
    # later steps: Adam moves an element whose gradient is rounding noise by
    # about lr whichever its sign, so the steps are compared as the benchmark
    # compares them (reference/compare.py)
    delta = {k: p.detach() - sd[k] for k, p in model.named_parameters()}
    gaps = train_gaps((losses, mses, kls), (ref.losses, ref.mses, ref.kls), grad1, ref.grad1, delta,
                      {k: v - sd[k] for k, v in ref.params.items()}, var1, ref.running_var1)
    assert gaps["bn_var_gap"] < 1e-5 and gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-2, gaps


def test_embedding():
    arch = _arch(True)
    sd = weights.make_state_dict(arch, 9, "cpu")
    sd["encoder_mod1.bn1.running_var"].fill_(2.0)
    model = _port_model(arch, sd)
    inputs, src, _ = _batch(arch, 40, 3)
    want = port_emb.embed_multimodal(model, *inputs, src)
    torch.testing.assert_close(cvae.embed(sd, arch, inputs, src, Numerics()), want, rtol=1e-4, atol=1e-5)


def test_rounding_of_the_controls():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12])
    # ties round to even: 1 + 2^-11 down to 1, 1 + 3 * 2^-11 up to 1 + 2^-9
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2.0 ** -9, 1.0]
    y = torch.randn(1000)
    rel = ((round_fp8(y) - y).abs() / y.abs().clamp(min=1e-3)).median()
    assert 0.005 < float(rel) < 0.07  # e4m3: 3 mantissa bits
    assert float((round_tf32(y) - y).abs().max()) <= float(y.abs().max()) * 2.0 ** -11
