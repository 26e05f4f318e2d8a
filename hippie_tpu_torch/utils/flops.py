"""The train step's FLOPs, counted from the layers' shapes, and the H100's peaks.

The JAX package's bench.py divides XLA's cost analysis of its compiled step
by a TPU peak; the port has no XLA, so ``step_flops`` counts the work
itself: 3 x the forward's convolution and linear FLOPs (the usual forward
plus backward count: the backward computes a gradient with respect to the
input and one with respect to the weight, each as large as the forward).
A convolution costs 2 * B * L_out * C_out * C_in * k, a linear layer
2 * B * in * out; BatchNorm, activations, the embeddings, the loss and the
optimizer are not counted. At bench.py's shapes (z=10, B=512, L=50) this is
151,427,702,784 FLOPs per batch; XLA's cost analysis of the JAX step gives
137,221,783,552 (PERF.md).

The peaks are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity, at its 700 W limit).
"""

from __future__ import annotations

import copy

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # bf16 dense, tensor cores


def forward_flops(model_or_cfg, batch: int, length: int) -> int:
    """The training forward's convolution and linear FLOPs of a unimodal
    cVAE (a ``UnimodalCVAE`` or its ``CVAEConfig``) on a ``[batch,
    length]`` input: each layer's shapes are read by a forward hook while a
    copy of the model runs on the meta device (no memory, no arithmetic)."""
    import torch

    from hippie_tpu_torch.models.cvae import UnimodalCVAE

    if isinstance(model_or_cfg, torch.nn.Module):
        model = copy.deepcopy(model_or_cfg).to("meta")
    else:
        with torch.device("meta"):
            model = UnimodalCVAE(model_or_cfg)
    total = 0

    def count(mod, inputs, out):
        nonlocal total
        if isinstance(mod, torch.nn.Conv1d):
            c_out, c_in, k = mod.weight.shape  # c_in: the input channels per group
            total += 2 * out.shape[0] * out.shape[2] * c_out * c_in * k
        else:
            total += 2 * out.numel() * mod.in_features

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear))]
    try:
        z = model.z_mean.out_features
        model.train()
        with torch.no_grad():
            model(torch.empty((batch, length), device="meta"),
                  torch.zeros((batch,), dtype=torch.long, device="meta"),
                  eps=torch.empty((batch, z), device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total


def step_flops(model_or_cfg, batch: int, length: int) -> int:
    """FLOPs of one train step: 3 x ``forward_flops``."""
    return 3 * forward_flops(model_or_cfg, batch, length)
