"""The train and eval steps and epochs of hippie_tpu_torch/train/step.py
require reparameterization noise, as the JAX steps require their key.

With neither ``eps`` nor ``generator`` each of them raises ``ValueError``
(a step without noise would decode ``mu`` and train a plain autoencoder);
with either one it runs. Unimodal and joint models at a small size
(num_blocks=(1, 1, 1, 1), z=4, B=16, a two-batch plan with a masked tail),
on the CPU. No JAX.
"""

import numpy as np
import pytest
import torch

from hippie_tpu_torch.data import device_data
from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.train import optim, step

torch.set_num_threads(1)

Z, B, N = 4, 16, 27  # latent width, batch, rows (two batches, the second with 11 real rows)


def _setup(model_kind):
    r = np.random.default_rng(0)
    wave = torch.from_numpy(r.normal(size=(N, 50)).astype(np.float32))
    isi = torch.from_numpy(r.normal(size=(N, 100)).astype(np.float32))
    source = torch.from_numpy(r.integers(0, 5, size=N)).long()
    if model_kind == "unimodal":
        cfg = cvae.CVAEConfig(z_dim=Z, class_hidden_dim=3, num_blocks=(1, 1, 1, 1))
        model = cvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        steps = step.make_unimodal_steps(loss_backend="pallas")
        epochs = step.make_unimodal_epoch_fns(loss_backend="pallas")
        arrays = (wave,)
    else:
        cfg = cvae.MultiModalConfig(z_dim=Z, class_hidden_dim=3, num_blocks=(1, 1, 1, 1))
        model = cvae.multimodal_cvae_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        steps = step.make_multimodal_steps(loss_backend="pallas")
        epochs = step.make_multimodal_epoch_fns(loss_backend="pallas")
        arrays = (wave, isi)
    ts = step.TrainState(model, optim.make_optimizer(model.parameters(), 1e-3, 0.01))
    idx, mask = device_data.batch_plan(np.arange(N), B, shuffle=False)
    return ts, steps, epochs, arrays, source, idx, mask


def _call(fn_kind, ts, steps, epochs, arrays, source, idx, mask, **noise):
    """One call of the step or epoch function ``fn_kind`` with ``noise``;
    returns its Metrics."""
    batch_step, eval_step = steps
    train_epoch, eval_epoch = epochs
    if fn_kind.endswith("epoch"):
        if "eps" in noise:
            noise = {"eps": torch.randn(idx.shape[0], B, Z, generator=torch.Generator().manual_seed(3))}
        fn = train_epoch if fn_kind == "train_epoch" else eval_epoch
        out = fn(ts if fn_kind == "train_epoch" else ts.model, *arrays, source, None, idx, mask, **noise)
        return out[1] if fn_kind == "train_epoch" else out
    rows = torch.as_tensor(idx[0]).long()
    batch = [a[rows] for a in arrays]
    bmask = torch.as_tensor(mask[0], dtype=torch.float32)
    if fn_kind == "train_step":
        return batch_step(ts, *batch, source[rows], None, bmask, **noise)[1]
    return eval_step(ts.model, *batch, source[rows], None, bmask, **noise)


@pytest.mark.parametrize("noise", ["none", "eps", "generator"])
@pytest.mark.parametrize("fn_kind", ["train_step", "eval_step", "train_epoch", "eval_epoch"])
@pytest.mark.parametrize("model_kind", ["unimodal", "joint"])
def test_steps_and_epochs_require_noise(model_kind, fn_kind, noise):
    ts, steps, epochs, arrays, source, idx, mask = _setup(model_kind)
    before = [p.detach().clone() for p in ts.model.parameters()]
    if noise == "none":
        with pytest.raises(ValueError, match="noise"):
            _call(fn_kind, ts, steps, epochs, arrays, source, idx, mask)
        # nothing ran: the parameters did not move
        assert all(torch.equal(a, b) for a, b in zip(before, ts.model.parameters()))
        return
    given = ({"eps": torch.randn(B, Z, generator=torch.Generator().manual_seed(3))} if noise == "eps"
             else {"generator": torch.Generator().manual_seed(4)})
    metrics = _call(fn_kind, ts, steps, epochs, arrays, source, idx, mask, **given)
    assert all(bool(torch.isfinite(t).all()) for t in metrics)
    moved = any(not torch.equal(a, b) for a, b in zip(before, ts.model.parameters()))
    assert moved == fn_kind.startswith("train")
