"""Rank workers of the data-parallel tests (tests/test_torch_dp*.py,
test_torch_fsdp.py): each runs in a rank spawned by
hippie_tpu_torch.parallel.mesh.launch, or in the test process with mesh
None for the single-process reference. They import no JAX and return numpy
arrays. Every model is the port's at num_blocks=(1, 1, 1, 1)."""

import os

import numpy as np
import torch

from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.ops import cuda_blocks, losses
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.parallel.fsdp import ShardedOptimizer
from hippie_tpu_torch.train import checkpoint as ckpt_mod
from hippie_tpu_torch.train import optim, step

CFG = dict(z_dim=4, class_hidden_dim=3, num_sources=5, num_classes=5, num_blocks=(1, 1, 1, 1))
LR, WD = 1e-3, 0.01


def build(kind: str, sd=None):
    """The port's model: from a numpy state_dict, or seeded."""
    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(5)
    if kind == "joint":
        model = cvae.multimodal_cvae_init(cvae.MultiModalConfig(**CFG), gen, device="cpu")
    else:
        model = cvae.unimodal_cvae_init(cvae.CVAEConfig(output_size=50, **CFG), gen, device="cpu")
    if sd is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model


def run_all(mesh, calls):
    """Several workers in one launch: ``calls`` is [(key, worker name,
    args)] -> {key: the worker's result}."""
    return {key: globals()[name](mesh, *args) for key, name, args in calls}


def numpy_state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _arrays(kind, data):
    return tuple(torch.from_numpy(a) for a in data)


def grads(mesh, kind, block, sd, data, source, mask, eps):
    """One forward and backward of a batch (this rank's columns under the
    mesh), the gradients summed over the ranks as the step sums them ->
    {name: gradient} and the loss."""
    model = build(kind, sd)
    model.train()
    arrays, source, mask, eps = _arrays(kind, data), torch.from_numpy(source), torch.from_numpy(mask), \
        torch.from_numpy(eps)
    with pmesh.data_parallel(mesh), pmesh.step_scope():
        if mesh is not None:
            arrays = tuple(pmesh.batch_sharded(mesh, a, batch_axis=0) for a in arrays)
            source, mask, eps = (pmesh.batch_sharded(mesh, t, batch_axis=0) for t in (source, mask, eps))
        outs = model(*arrays, source, None, eps=eps, mask=mask, backend=block)
        if kind == "joint":
            total, _ = losses.multimodal_vae_loss(arrays[0], arrays[1], outs[3], outs[4], outs[1], outs[2],
                                                  mask=mask)
        else:
            total, _ = losses.vae_loss(arrays[0], outs[3], outs[1], outs[2], mask=mask)
        total.backward()
        params = list(model.parameters())
        if mesh is not None:
            pmesh.sum_gradients(params)
            total = pmesh.all_sum(total.detach())
    return {"loss": float(total.detach()), **{k: (p.grad.numpy().copy() if p.grad is not None else np.zeros(p.shape, np.float32))
                                     for k, p in model.named_parameters()}}


# the dgamma, dbeta the seam sums first (from g0, which both runs round alike)
GLOBAL_SUMS = {"enc": (("dg2", "db2", "dgs", "dbs"),), "dec": (("dg1", "db1", "dgs", "dbs"),)}


def plain_block(mesh, kind, stride):
    """A block's plain forward and backward (ops/cuda_blocks.py) on a batch of
    8 whose last 2 rows are padding, this rank's columns under the mesh."""
    g = torch.Generator().manual_seed(3)
    L, B, ci = 12, 8, 64
    co = ci * 2 if (kind == "enc" and stride == 2) else (ci // 2 if stride == 2 else ci)
    rnd = lambda *shape, s=1.0: torch.randn(*shape, generator=g) * s  # noqa: E731
    vec = lambda c: (rnd(c, s=0.1) + 1, rnd(c, s=0.1))  # noqa: E731
    x = rnd(L, B, ci).to(torch.bfloat16)
    m = torch.ones(B, 1)
    m[6:] = 0
    if kind == "enc":
        w1, w2, ws = rnd(3, ci, co, s=0.1), rnd(3, co, co, s=0.1), rnd(1, ci, co, s=0.1)
        (g1, b1), (g2, b2), (gs, bs) = vec(co), vec(co), vec(co)
        lo = cuda_blocks._out_len(L, stride)
        args = [x, w1.to(torch.bfloat16), g1, b1, w2.to(torch.bfloat16), g2, b2,
                ws.to(torch.bfloat16) if stride == 2 else None, gs if stride == 2 else None,
                bs if stride == 2 else None, m]
        fwd, bwd = cuda_blocks.ENC_OPS.fwd_plain, cuda_blocks.ENC_OPS.bwd_plain
        names = "out st1 st2 sts dx dw1 dg1 db1 dw2 dg2 db2 dws dgs dbs".split()
    else:
        w2, w1, ws = rnd(3, ci, ci, s=0.1), rnd(3, ci, co, s=0.1), rnd(3, ci, co, s=0.1)
        (g2, b2), (g1, b1), (gs, bs) = vec(ci), vec(co), vec(co)
        c1b, csb = rnd(co, s=0.1), rnd(co, s=0.1)
        lo = L * stride
        short = stride == 2
        args = [x, w2.to(torch.bfloat16), g2, b2, w1.to(torch.bfloat16), c1b if short else None, g1, b1,
                ws.to(torch.bfloat16) if short else None, csb if short else None, gs if short else None,
                bs if short else None, m]
        fwd, bwd = cuda_blocks.DEC_OPS.fwd_plain, cuda_blocks.DEC_OPS.bwd_plain
        names = "out st2 st1 sts dx dw2 dg2 db2 dw1 dc1b dg1 db1 dws dcsb dgs dbs".split()
    gout = rnd(lo, B, co).to(torch.bfloat16)
    if mesh is not None:
        args[0] = pmesh.batch_sharded(mesh, args[0], batch_axis=1)
        args[-1] = pmesh.batch_sharded(mesh, m, batch_axis=0)
        gout = pmesh.batch_sharded(mesh, gout, batch_axis=1)
    with pmesh.data_parallel(mesh):
        outs = fwd(stride, *args)
        grads = bwd(stride, *args, *outs[1:], gout)
    return {n: t.float().numpy().copy() for n, t in zip(names, (*outs, *grads)) if t is not None}


def epoch(mesh, kind, block, sd, data, source, idx, mask, eps, fsdp=False, clip=None, ckpt_path=None,
          state_dtype=None):
    """One train epoch over the [nb, B] plan with injected noise [nb, B, z]
    -> losses, the state_dict after it, the seam's launches, and with FSDP
    the rank's parameter and moment bytes after the first step and its
    shards of the moments; rank 0 writes a Lightning .ckpt to
    ``ckpt_path`` when given."""
    model = build(kind, sd)
    arrays = _arrays(kind, data)
    if fsdp:
        opt = ShardedOptimizer(model, mesh, lambda ps: optim.make_optimizer(ps, LR, WD, None,
                                                                             state_dtype=state_dtype), clip)
    else:
        opt = optim.make_optimizer(model.parameters(), LR, WD, clip, state_dtype=state_dtype)
    ts = step.TrainState(model, opt)
    out = {}
    maker = step.make_multimodal_epoch_fns if kind == "joint" else step.make_unimodal_epoch_fns
    train_epoch, _ = maker(block_backend=block)
    batch_step, _ = (step.make_multimodal_steps if kind == "joint" else step.make_unimodal_steps)(
        block_backend=block)
    cuda_blocks.reset_launches()
    with pmesh.data_parallel(mesh):
        if fsdp:  # the first step by hand, to read the bytes held between steps
            i0, m0, e0 = step._rank_plan(idx[:1], mask[:1], torch.from_numpy(eps[:1]))
            i0 = torch.as_tensor(i0).long()
            batch_step(ts, *(a[i0[0]] for a in arrays), torch.from_numpy(source)[i0[0]], None,
                       torch.from_numpy(np.asarray(m0[0])), eps=e0[0])
            out["bytes"] = opt.state_bytes()
            out["replicated_bytes"] = 3 * 4 * sum(int(np.prod(s)) for s in opt.shapes)
            out["param_bytes"] = 4 * sum(int(np.prod(s)) for s in opt.shapes)
            out["whole_bytes"] = 3 * 4 * sum(int(np.prod(s)) for s, d in zip(opt.shapes, opt.dims) if d is None)
            idx, mask, eps = idx[1:], mask[1:], eps[1:]
        ts, ms = train_epoch(ts, *arrays, torch.from_numpy(source), None, idx, mask,
                             eps=torch.from_numpy(eps))
        osd = opt.state_dict()
        if fsdp:
            out["shards"] = {i: {m: st[m].float().numpy().copy() for m in ("exp_avg", "exp_avg_sq")}
                             for i, st in opt.inner.state_dict()["state"].items()}
            out["dims"] = list(opt.dims)
        if ckpt_path is not None and pmesh.is_writer():
            sd_now = model.state_dict()
            keys = ckpt_mod.parameter_key_order(model)
            ckpt_mod.save_lightning_ckpt(ckpt_path, sd_now, optimizer_state=ckpt_mod.adamw_state_to_torch(
                ckpt_mod.host_tree(osd), ckpt_mod.host_tree(sd_now), keys, lr=LR, weight_decay=WD))
    out["moments"] = {i: {m: st[m].float().numpy().copy() for m in ("exp_avg", "exp_avg_sq")}
                      for i, st in osd["state"].items()}
    out["loss"] = ms.loss.numpy().copy()
    out["state"] = numpy_state(model)
    out["seg_launches"] = dict(cuda_blocks.seg_launches)
    return out


_WRITES: list = []  # one list of file writes per pipeline call in this process


def pipeline(mesh, cfg_kwargs):
    """The pipeline in this rank, recording every file write per rank ->
    (rank, writes, results' accuracies)."""
    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.train import pipeline as tpipe
    from hippie_tpu_torch.train import resume

    torch.set_num_threads(1)
    if not _WRITES:  # the recording wrappers, once per rank process

        def recorded(fn, name):
            def wrapper(*a, **kw):
                _WRITES[-1].append(name)
                return fn(*a, **kw)
            return wrapper

        registry.write_csv = tpipe.write_csv = recorded(registry.write_csv, "csv")
        ckpt_mod.save_lightning_ckpt = recorded(ckpt_mod.save_lightning_ckpt, "ckpt")
        resume._atomic_save = recorded(resume._atomic_save, "resume")
    _WRITES.append(writes := [])
    results = tpipe.run_pipeline(tpipe.PipelineConfig(**cfg_kwargs))
    return (mesh.rank, writes, {k: list(v) for k, v in results["balanced_accuracy"].items()},
            sorted(os.listdir(cfg_kwargs["output_dir"])) if os.path.isdir(cfg_kwargs["output_dir"]) else [])


def embed_and_knn(mesh, sd, data, source, train_x, train_y, test_x):
    """Embeddings and the KNN sweep with ``mesh=`` (None: unsharded)."""
    from hippie_tpu_torch.evaluate import embeddings, knn_eval

    model = build("unimodal", sd)
    e = embeddings.embed_unimodal(model, torch.from_numpy(data), torch.from_numpy(source), mesh=mesh)
    preds = knn_eval.knn_predict_sweep(train_x, train_y, test_x, list(range(5, 20)), device="cpu", mesh=mesh)
    return e.numpy(), np.stack([preds[k] for k in range(5, 20)])


def ensemble(mesh, data, source, idx, mask, k):
    """A K-replica host fit of 2 epochs, sharded over the mesh (None:
    unsharded) -> best losses, best epochs and the best state_dicts."""
    from hippie_tpu_torch.train import ensemble as tens

    torch.set_num_threads(1)
    cfg = cvae.CVAEConfig(output_size=50, **CFG)
    states = tens.init_unimodal_ensemble(3, cfg, lambda ps: optim.make_optimizer(ps, LR, WD), k, device="cpu")
    if mesh is not None:
        states = tens.shard_replicas(states, mesh)
    fns = tens.make_unimodal_ensemble_epoch_fns()
    d = torch.from_numpy(data)
    res = tens.host_fit_ensemble(states, epoch_fns=fns, arrays=(d,), source=torch.from_numpy(source), class_=None,
                                 train_stream=np.arange(len(data)), batch_size=16, val_idx=idx, val_mask=mask,
                                 max_epochs=2, seed=11, shuffle=True, mesh=mesh)
    return (np.asarray(res.best_val_loss), np.asarray(res.best_epoch),
            [{k: v.numpy().copy() for k, v in sd.items()} for sd in res.best_state_dict])


def _np_tree(tree):
    """A nested dict / list of tensors with every tensor as a numpy copy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy().copy() if tree.is_floating_point() else tree.numpy().copy()
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree


def fsdp_stage(mesh, sd, data, source, fit_loop, optimizer, clip=None):
    """A 2-epoch unimodal stage fit with FSDP through
    pipeline.fit_unimodal_stage on ``fit_loop`` -> its losses, final state,
    gathered optimizer state and best snapshot, as numpy."""
    from hippie_tpu_torch.train import pipeline as tpipe

    torch.set_num_threads(1)
    model = build("unimodal", sd)
    cfg = tpipe.PipelineConfig(device="cpu", fit_loop=fit_loop, fsdp=True, dp_devices=mesh.size,
                               optimizer=optimizer, verbose=False, seed=5)
    d, src = torch.from_numpy(data), torch.from_numpy(source)
    with pmesh.data_parallel(mesh):
        ts = tpipe._place_train_state(cfg, step.TrainState(model, tpipe._optimizer(cfg, model, LR, clip)))
        res = tpipe.fit_unimodal_stage(cfg=cfg, ts=ts, data=d, source=src, class_=src,
                                       train_indices=np.arange(32), val_indices=np.arange(32, len(data)),
                                       batch_size=16, max_epochs=2, beta=1.0, use_class_labels=False,
                                       shuffle_train=True, stage_seed=0, lr=LR)
        opt = res.state.optimizer.state_dict()
    return {"losses": (res.train_losses, res.val_losses, res.best_epoch, res.epochs_run),
            "state": numpy_state(model), "opt": _np_tree(opt), "best": _np_tree(res.best_state_dict),
            "best_opt": _np_tree(res.best_opt_state), "graphs": dict(res.graphs)}


def sf_epoch(mesh, sd, data, source, idx, mask, eps, fsdp, sidecar):
    """One train epoch with schedule-free AdamW, replicated (data-parallel) or
    with FSDP -> the losses, the state, the x iterate from maybe_eval_params
    and from evaluated_at_x, the gathered optimizer state; rank 0 writes the
    .sfstate sidecar to ``sidecar``. With FSDP also the stage fork over the
    shards (pipeline._sf_fork_state) beside the unsharded fork from the same
    gathered state."""
    import dataclasses

    from hippie_tpu_torch.train import pipeline as tpipe

    torch.set_num_threads(1)
    model = build("unimodal", sd)

    def make(ps):
        return optim.make_optimizer(ps, LR, WD, None, algorithm="schedule-free")

    opt = ShardedOptimizer(model, mesh, make, None) if fsdp else make(model.parameters())
    train_epoch, _ = step.make_unimodal_epoch_fns()
    names = [k for k, _ in model.named_parameters()]
    out = {}
    with pmesh.data_parallel(mesh):
        ts, ms = train_epoch(step.TrainState(model, opt), torch.from_numpy(data), torch.from_numpy(source), None,
                             idx, mask, eps=torch.from_numpy(eps))
        payload = optim.schedule_free_payload(opt, ckpt_mod.parameter_key_order(model))
        if pmesh.is_writer():
            optim.write_sidecar(sidecar, payload)
        x = optim.maybe_eval_params(opt, [p.detach() for p in model.parameters()])
        out["x"] = {k: v.numpy().copy() for k, v in zip(names, x)}
        with optim.evaluated_at_x(opt):
            out["x_model"] = numpy_state(model)
        out["state"] = numpy_state(model)
        out["opt"] = _np_tree(opt.state_dict())
        if fsdp:
            cfg = tpipe.PipelineConfig(device="cpu", fsdp=True, dp_devices=mesh.size, optimizer="schedule-free",
                                       verbose=False)
            prev = opt.state_dict()
            x_sd = {**out["state"], **out["x"]}
            forks = {}
            for name, c, prev_opt in (("sharded", cfg, opt), ("unsharded", dataclasses.replace(
                    cfg, fsdp=False, dp_devices=None), prev)):
                m = build("unimodal", x_sd)
                fork = tpipe._sf_fork_state(c, m, LR / 10, None, prev_opt, drop=("class_embedding",))
                forks[name] = (numpy_state(m), _np_tree(fork.optimizer.state_dict()))
            out["forks"] = forks
    out["loss"] = ms.loss.numpy().copy()
    return out


def _ensemble_fit(mesh, data, source, idx, mask, k, max_epochs, resume_dir=None, init_key=3):
    """A K-replica device fit (eager off the card), sharded over the mesh
    (None: unsharded) -> its result."""
    from hippie_tpu_torch.train import ensemble as tens

    torch.set_num_threads(1)
    cfg = cvae.CVAEConfig(output_size=50, **CFG)
    states = tens.init_unimodal_ensemble(init_key, cfg, lambda ps: optim.make_optimizer(ps, LR, WD), k,
                                         device="cpu")
    states = tens.set_ensemble_lr(states, [LR * (r + 1) for r in range(k)])
    if mesh is not None:
        states = tens.shard_replicas(states, mesh)
    batch_step, eval_step = step.make_unimodal_steps()
    return tens.device_fit_ensemble(states, batch_step=batch_step, eval_step=eval_step,
                                    arrays=(torch.from_numpy(data),), source=torch.from_numpy(source),
                                    class_=None, train_stream=np.arange(len(data)), batch_size=16,
                                    val_idx=idx, val_mask=mask, max_epochs=max_epochs, seed=11, shuffle=True,
                                    resume_dir=resume_dir, mesh=mesh)


def ensemble_summary(res) -> dict:
    """A K-replica fit's result as numpy: the [K] arrays, every replica's
    best snapshot and this process's replicas' model and optimizer states."""
    return {"best_val": np.asarray(res.best_val_loss), "best_epoch": np.asarray(res.best_epoch),
            "epochs_run": res.epochs_run, "best": _np_tree(res.best_state_dict),
            "models": [numpy_state(ts.model) for ts in res.state],
            "opts": [_np_tree(ts.optimizer.state_dict()) for ts in res.state]}


def ensemble_resume(mesh, data, source, idx, mask, k, sharded_dir, unsharded_dir):
    """The sharded K-replica fit of 2 epochs: uninterrupted; stopped after
    one epoch (resume files in ``sharded_dir``) and resumed from fresh
    replicas; and resumed from ``unsharded_dir``, an unsharded fit's file
    after its first epoch -> their summaries."""
    full = _ensemble_fit(mesh, data, source, idx, mask, k, 2)
    _ensemble_fit(mesh, data, source, idx, mask, k, 1, sharded_dir)
    resumed = _ensemble_fit(mesh, data, source, idx, mask, k, 2, sharded_dir, init_key=99)
    from_unsharded = _ensemble_fit(mesh, data, source, idx, mask, k, 2, unsharded_dir, init_key=99)
    return {name: ensemble_summary(r) for name, r in
            (("full", full), ("resumed", resumed), ("from_unsharded", from_unsharded))}
