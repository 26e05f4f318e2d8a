"""A configuration's weights, made by the benchmark from ``--seed`` on the
device, in a few large calls: one uniform draw for every convolution and
linear leaf (each then scaled to PyTorch's default bound, 1/sqrt(fan_in)),
one normal draw for the embeddings; BatchNorm starts at weight 1, bias 0,
running mean 0 and variance 1. The same tensors load into the program's
model and serve the plain reference.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from perfbench.harness.common import sub_seed
from perfbench.reference.cvae import Arch, param_spec


def make_state_dict(arch: Arch, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    spec = param_spec(arch)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    numel = lambda s: int(torch.Size(s).numel())  # noqa: E731
    uni = [(k, leaf) for k, leaf in spec.items() if leaf.init == "uniform"]
    nrm = [(k, leaf) for k, leaf in spec.items() if leaf.init == "normal"]
    flat_u = torch.empty(sum(numel(leaf.shape) for _, leaf in uni), device=device).uniform_(-1.0, 1.0, generator=gen)
    bounds = torch.tensor([leaf.bound for _, leaf in uni], device=device)
    flat_u.mul_(torch.repeat_interleave(bounds, torch.tensor([numel(leaf.shape) for _, leaf in uni], device=device)))
    flat_n = torch.empty(sum(numel(leaf.shape) for _, leaf in nrm), device=device).normal_(generator=gen)
    views, off = {}, {"uniform": 0, "normal": 0}
    for k, leaf in spec.items():
        if leaf.init in off:
            src = flat_u if leaf.init == "uniform" else flat_n
            n = numel(leaf.shape)
            views[k] = src[off[leaf.init]:off[leaf.init] + n].view(leaf.shape)
            off[leaf.init] += n
        elif leaf.init == "count":
            views[k] = torch.zeros((), dtype=torch.long, device=device)
        else:
            views[k] = (torch.ones if leaf.init == "ones" else torch.zeros)(leaf.shape, device=device)
    return OrderedDict((k, views[k]) for k in spec)
