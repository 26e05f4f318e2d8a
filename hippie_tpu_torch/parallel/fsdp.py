"""FSDP: parameters and optimizer state sharded per leaf across the ranks.

Counterpart of the JAX pipeline's ``--fsdp`` (hippie_tpu/train/pipeline.py:
_place_train_state with parallel/mesh.py:shard_params_fsdp), where GSPMD
keeps each leaf of the parameters and of the optimizer state split along one
axis over the mesh, all-gathers the parameters on use and reduce-scatters
the gradients. Here the sharding is written on the collectives:

  - each leaf is split along the torch dim of the logical axis the JAX rule
    picks (``mesh.fsdp_sharding_for``); a leaf no axis of which divides the
    mesh stays whole (replicated) on every rank;
  - the inner optimizer (the port's AdamW, float32 or bf16 moments) holds
    this rank's shard of each split leaf and the whole replicated leaves,
    and updates them elementwise, as the replicated run does;
  - ``step`` sums the gradients of the split leaves over the ranks into this
    rank's shard (reduce-scatter on NCCL; all-reduce plus a slice on gloo,
    which has no reduce-scatter of CUDA tensors) and the replicated leaves'
    in one all-reduce; a gradient a kernel seam already summed
    (``mesh.mark_reduced``) is only sliced. The global-norm clip sums the
    shards' squares over the ranks and counts the replicated leaves once,
    then scales as optax does, ``(g / norm) * clip``;
  - after the update ``gather`` all-gathers the shards into the model's
    split leaves IN PLACE: each parameter keeps one full-size storage at a
    fixed address for the whole fit, so a CUDA graph can capture the step
    (reduce-scatter, sharded update, gather) and replay it
    (train/device_fit.py), and both fit loops run the same step. The cost:
    every rank holds the whole parameters (the joint model's 64.5 MB); the
    moments, and schedule-free's ``z`` and ``exp_avg_sq``, stay sharded;
  - the inner optimizer may be schedule-free AdamW (train/schedule_free.py)
    over the shards: ``z`` and ``exp_avg_sq`` split as the AdamW moments,
    the 0-d ``k``, ``weight_sum`` and ``lr_max`` replicated in the param
    group;
  - ``state_dict`` gathers the per-leaf state and returns the replicated
    optimizer's layout, so the ``.ckpt``, the ``.sfstate`` sidecar, the
    resume files and the best snapshots hold the full state,
    byte-compatible with the replicated run's; ``load_state_dict`` takes
    that layout and keeps this rank's shards, re-reading the parameter
    shards from the model.

Every rank runs every collective in the same order; ``state_dict`` is one of
them, so every rank calls it (the fit loop's snapshots do).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train.optim import leaf_square_sums, scale_to_norm_

# the per-leaf state split as its parameter: AdamW's moments, schedule-free's
# z and second moment
SPLIT_STATE = ("exp_avg", "exp_avg_sq", "z")


class ShardedOptimizer(torch.optim.Optimizer):
    """An optimizer over ``model``'s parameters with the parameters and its
    state sharded over ``mesh`` (module note). ``make_inner(params)`` builds
    the inner optimizer (without a clip); ``clip_val`` is the global-norm
    clip of the whole gradient."""

    is_sharded = True

    def __init__(self, model: torch.nn.Module, mesh: pmesh.Mesh, make_inner: Callable,
                 clip_val: Optional[float] = None):
        self.mesh = mesh
        named = list(model.named_parameters())
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self.shapes = [tuple(p.shape) for p in self.params]
        placed = pmesh.shard_params_fsdp(mesh, named)
        self.dims = [placed[k][0] for k, _ in named]
        with torch.no_grad():  # a replicated leaf is its parameter; a shard a copy of its chunk
            self.shards = [p if d is None else placed[k][1].clone() for (k, p), d in zip(named, self.dims)]
        self.inner = make_inner(self.shards)
        self.clip_val = clip_val
        super().__init__(self.shards, {})
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state

    # --- the step ------------------------------------------------------------

    def zero_grad(self, set_to_none: bool = True):
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=True)

    def _split(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d is not None]

    @torch.no_grad()
    def step(self, closure=None):
        mesh = self.mesh
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        split = self._split()
        summed = [i for i in split if not pmesh.is_reduced(self.params[i])]
        if summed:
            # row r of the bucket: every summed leaf's chunk r, flattened
            rows = torch.stack([torch.cat([grads[i].chunk(mesh.size, self.dims[i])[r].reshape(-1)
                                           for i in summed]) for r in range(mesh.size)])
            mine = pmesh.reduce_scatter_rows(rows, mesh)
            sizes = [grads[i].numel() // mesh.size for i in summed]
            for i, v in zip(summed, torch.split(mine, sizes)):
                self.shards[i].grad = v.view_as(self.shards[i])
        for i in split:
            if self.shards[i].grad is None:  # summed by a kernel seam: this rank's chunk
                self.shards[i].grad = grads[i].chunk(mesh.size, self.dims[i])[mesh.rank].contiguous()
        whole = [i for i, d in enumerate(self.dims) if d is None]
        self._sum_whole(whole, grads)
        if self.clip_val is not None:
            self._clip(split, whole)
        self.inner.step()
        for i in split:
            self.shards[i].grad = None
            self.params[i].grad = None
        self.gather()

    def _sum_whole(self, whole: List[int], grads: List[torch.Tensor]):
        """The replicated leaves' gradients, summed over the ranks in one bucket."""
        for i in whole:
            self.params[i].grad = grads[i]
        pmesh.sum_gradients([self.params[i] for i in whole], self.mesh)

    def _clip(self, split: List[int], whole: List[int]):
        """optax's clip_by_global_norm on the whole gradient: the shards'
        squares summed over the ranks, the replicated leaves' counted once."""
        shard_grads = [self.shards[i].grad for i in split]
        whole_grads = [self.params[i].grad for i in whole]
        sq = self.params[0].new_zeros(())
        if shard_grads:
            sq = torch.stack(leaf_square_sums(shard_grads)).sum()
        sq = pmesh.all_sum(sq, self.mesh)
        if whole_grads:
            sq = sq + torch.stack(leaf_square_sums(whole_grads)).sum()
        scale_to_norm_(shard_grads + whole_grads, torch.sqrt(sq), self.clip_val)

    # --- parameters ----------------------------------------------------------

    @torch.no_grad()
    def gather(self):
        """All-gather the shards into the model's split leaves, in place:
        one collective, then each rank's chunk copied into its place."""
        split = self._split()
        if not split:
            return
        rows = pmesh.gather_rows(torch.cat([self.shards[i].reshape(-1) for i in split]), self.mesh)
        sizes = [self.shards[i].numel() for i in split]
        parts = [torch.split(rows[r], sizes) for r in range(self.mesh.size)]
        dst, src = [], []
        for k, i in enumerate(split):
            for r, chunk in enumerate(self.params[i].chunk(self.mesh.size, self.dims[i])):
                dst.append(chunk)
                src.append(parts[r][k].view(self.shards[i].shape))
        torch._foreach_copy_(dst, src)

    def local(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's part of whole per-leaf tensors in parameter order (a
        split leaf's chunk, a replicated leaf whole): views."""
        return [t if d is None else t.chunk(self.mesh.size, d)[self.mesh.rank] for t, d in zip(leaves, self.dims)]

    @torch.no_grad()
    def refresh_shards(self):
        """Re-read this rank's shards from the model's (whole) parameters."""
        for i in self._split():
            self.shards[i].copy_(self.params[i].chunk(self.mesh.size, self.dims[i])[self.mesh.rank])

    def state_bytes(self) -> int:
        """Bytes this rank holds of the parameters and the optimizer state:
        the model's (whole) parameters, the shards and the per-leaf state."""
        total = sum(p.numel() * p.element_size() for p in self.params)
        total += sum(self.shards[i].numel() * self.shards[i].element_size() for i in self._split())
        for st in self.inner.state.values():
            total += sum(v.numel() * v.element_size() for v in st.values()
                         if isinstance(v, torch.Tensor) and v.ndim > 0)
        return total

    # --- state ---------------------------------------------------------------

    def state_dict(self):
        """The inner optimizer's state_dict with every split leaf's per-leaf
        state gathered whole: the replicated optimizer's layout (collective)."""
        sd = self.inner.state_dict()
        split = [i for i in self._split() if i in sd["state"]]
        for name in SPLIT_STATE:
            have = [i for i in split if name in sd["state"][i]]
            by_dtype = {}
            for i in have:
                by_dtype.setdefault(sd["state"][i][name].dtype, []).append(i)
            for idx in by_dtype.values():
                rows = pmesh.gather_rows(torch.cat([sd["state"][i][name].reshape(-1) for i in idx]), self.mesh)
                sizes = [sd["state"][i][name].numel() for i in idx]
                parts = [torch.split(rows[r], sizes) for r in range(self.mesh.size)]
                for k, i in enumerate(idx):
                    shape = sd["state"][i][name].shape
                    sd["state"][i] = dict(sd["state"][i])
                    sd["state"][i][name] = torch.cat([parts[r][k].view(shape) for r in range(self.mesh.size)],
                                                     dim=self.dims[i])
        return sd

    def load_state_dict(self, state_dict):
        """Take the replicated layout: this rank's chunk of every split leaf's
        per-leaf state; the parameter shards re-read from the model."""
        sd = {"param_groups": state_dict["param_groups"], "state": {}}
        for i, st in state_dict["state"].items():
            d = self.dims[int(i)]
            sd["state"][i] = {k: (v.chunk(self.mesh.size, d)[self.mesh.rank].clone()
                                  if d is not None and k in SPLIT_STATE else v)
                              for k, v in st.items()}
        self.inner.load_state_dict(sd)
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state
        self.refresh_shards()
