"""The ``train_epochs`` kind: the device fit loop's train epochs, replayed
back to back, closed loop.

The mix (``perfbench/traffic/<name>.json``) gives ``datasets`` (name:
source id), ``epoch_rows`` and ``batch``. A run's dataset is
``epoch_rows`` rows drawn with replacement from the datasets' raw rows;
each epoch is a fresh seeded permutation of them cut into batches of
``batch`` (the last one padded with its last real row, mask 0), and each
epoch's noise comes from a fresh seeded generator.

Set-up reads the raw rows, preprocesses them with the program's data layer
(``ops/preprocess.py``), draws the run's dataset, makes the weights, and
builds ONE training step: the program's model, its AdamW (with the clip)
and its step (``train/step.py``) as the device fit loop's ``StepGraph``
(``train/device_fit.py``). It runs the first epoch through that object's
own calls (the first step eager, the second captured, the rest replayed),
then puts the weights, the BatchNorm buffers and the optimizer's state back
to where they started, in place, and replays the first epoch's first three
steps again: the checked steps are replays of the graph the window runs.
After the first of them it reads the gradient as the optimizer got it
(AdamW's first moment after one step is ``(1 - b1) g``) and the running
variances, after the third the three losses and the parameters. The window
then runs ``device_fit.run_graphed_epoch`` epoch after epoch on the same
object, each with a fresh plan and noise generator, and fetches each
epoch's metrics as the fit loop does (one copy to the host, which waits for
the epoch), until ``--seconds`` have passed. After the window the plain
reference repeats the three steps from the same weights, raw rows, plan and
noise.

``--trace 1`` runs one more epoch after the window under torch.profiler,
between two CUDA events on the fit's stream, as ``hippie-tpu-torch bench``
profiles one epoch outside its timed ones.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import common, data, weights
from perfbench.harness.common import resolve, rng, sub_seed
from perfbench.harness.trace import profile, read_trace
from perfbench.reference import cvae as ref_cvae
from perfbench.reference import preprocess as ref_pre
from perfbench.reference import train as ref_train
from perfbench.reference.compare import train_gaps
from perfbench.reference.numerics import Numerics, full_float32
from perfbench.yardstick import bounds, flops

CHECK_STEPS = 3
ADAM_B1 = 0.9
FAULTS = ("frozen", "half_batch")


class TrainEpochs:
    """A run's dataset and each epoch's plan and noise seed, from ``--seed``."""

    def __init__(self, spec: dict, seed: int, pool_rows: int):
        self.seed = seed
        self.rows = int(spec["epoch_rows"])
        self.batch = int(spec["batch"])
        self.nb = -(-self.rows // self.batch)
        self.draw = rng(seed, 10).integers(0, pool_rows, size=self.rows)  # pool row of each dataset row

    def plan(self, epoch: int) -> tuple:
        """``(idx [nb, B] int64, mask [nb, B] float32)`` of epoch ``epoch``."""
        order = rng(self.seed, 11, epoch).permutation(self.rows)
        padded = np.full(self.nb * self.batch, order[-1], np.int64)
        padded[:self.rows] = order
        mask = np.zeros(self.nb * self.batch, np.float32)
        mask[:self.rows] = 1.0
        return padded.reshape(self.nb, self.batch), mask.reshape(self.nb, self.batch)

    def noise_seed(self, epoch: int) -> int:
        return sub_seed(self.seed, 12, epoch)


def _arch(ctx) -> ref_cvae.Arch:
    cfg = dict(ctx.cell.config)
    if ctx.rehearsal:
        cfg["model"] = {**cfg["model"], **cfg.get("rehearsal", {}).get("model", {})}
    return ref_cvae.Arch.from_config(cfg)


def _program_model(arch: ref_cvae.Arch, sd, device):
    from hippie_tpu_torch.models import cvae

    if arch.multimodal:
        cls, pcfg = cvae.MultiModalCVAE, cvae.MultiModalConfig(
            z_dim=arch.z_dim, output_size_wave=arch.wave_len, output_size_isi=arch.isi_len,
            class_hidden_dim=arch.class_hidden_dim, num_sources=arch.num_sources, num_classes=arch.num_classes,
            num_blocks=arch.num_blocks)
    else:
        cls, pcfg = cvae.UnimodalCVAE, cvae.CVAEConfig(
            z_dim=arch.z_dim, output_size=arch.wave_len, class_hidden_dim=arch.class_hidden_dim,
            num_sources=arch.num_sources, num_classes=arch.num_classes, num_blocks=arch.num_blocks)
    with torch.device("meta"):
        model = cls(pcfg)
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    return model


@torch.no_grad()
def _restart(model, opt, sd):
    """The weights, the BatchNorm buffers and AdamW's moments and step
    counters back to where the run started, in place (the graph keeps their
    addresses)."""
    for k, t in list(model.named_parameters()) + list(model.named_buffers()):
        t.copy_(sd[k])
    for state in opt.state.values():
        for t in state.values():
            if torch.is_tensor(t):
                t.zero_()


def run(ctx) -> dict:
    from hippie_tpu_torch.ops import preprocess
    from hippie_tpu_torch.train import device_fit, optim, step

    dev = ctx.device
    arch = _arch(ctx)
    spec = resolve(ctx.cell.traffic, ctx.rehearsal)
    hp = ctx.cell.config["train"]
    sets = data.load_sets(spec["datasets"])

    # the program's data layer on the raw rows
    pool = [preprocess.preprocess_pair(s.wf, s.isi, device=dev) for s in sets]
    pool_wave = torch.cat([w for w, _ in pool])
    pool_isi = torch.cat([i for _, i in pool])
    pool_src = torch.cat([torch.full((len(s.wf),), s.source, dtype=torch.long, device=dev) for s in sets])
    traffic = TrainEpochs(spec, ctx.seed, len(pool_src))
    draw = torch.as_tensor(traffic.draw, device=dev)
    wave, isi, src = pool_wave[draw], pool_isi[draw], pool_src[draw]
    del pool, pool_wave, pool_isi, pool_src

    sd = weights.make_state_dict(arch, ctx.seed, dev)
    model = _program_model(arch, sd, dev)
    opt = optim.make_optimizer(model.parameters(), hp["learning_rate"], hp["weight_decay"],
                               clip_val=hp["gradient_clip_val"])
    ts = step.TrainState(model, opt)
    kw = dict(beta=hp["beta"], loss_backend=hp["loss_backend"], block_backend=hp["block_backend"])
    if arch.multimodal:
        batch_step, _ = step.make_multimodal_steps(mod1_weight=hp["modality_weights"][0],
                                                   mod2_weight=hp["modality_weights"][1], **kw)
        rows = lambda idx: (wave[idx], isi[idx])  # noqa: E731
    else:
        batch_step, _ = step.make_unimodal_steps(**kw)
        rows = lambda idx: (wave[idx],)  # noqa: E731
    B, nb = traffic.batch, traffic.nb
    if ctx.fault == "frozen":  # the step leaves the state as it was
        opt.step = lambda closure=None: None
    keep = None
    if ctx.fault == "half_batch":  # half of each batch left out, the mean taken over the rest
        keep = torch.ones(B, device=dev)
        keep[B // 2:] = 0.0

    def train_fn(idx, mask, eps):
        return batch_step(ts, *rows(idx), src[idx], None, mask if keep is None else mask * keep, eps=eps)[1]

    def gen(epoch):
        return torch.Generator(device=dev).manual_seed(traffic.noise_seed(epoch))

    params = dict(model.named_parameters())
    on_card = dev.type == "cuda"
    with device_fit.graph_stream(dev) as (stream, mempool):
        g = device_fit.StepGraph([train_fn], nb=nb, batch=B, noise_shape=(B, arch.z_dim), dtype=wave.dtype,
                                 device=dev, stream=stream, pool=mempool,
                                 before_capture=lambda: opt.zero_grad(set_to_none=True))
        # the warm-up: the first epoch through the window's own calls (eager, captured, replayed)
        idx0, mask0 = traffic.plan(0)
        device_fit.run_graphed_epoch(g, idx0, mask0, [gen(0)]).cpu()
        # the checked steps: the first epoch's first three again, from the start, replayed
        _restart(model, opt, sd)
        g.load_plan(idx0, mask0)
        gens = [gen(0)]
        for i in range(CHECK_STEPS):
            g(gens)
            if i == 0:
                # no state: the step never reached the optimizer (a fault)
                prog_grad1 = {k: (opt.state[p]["exp_avg"] / (1.0 - ADAM_B1)).cpu() if opt.state.get(p)
                              else torch.zeros(p.shape) for k, p in params.items()}
                prog_var1 = {k: b.to("cpu", copy=True) for k, b in model.named_buffers()
                             if k.endswith(".running_var")}
        prog_metrics = g.metrics[:, 0, :CHECK_STEPS].tolist()  # loss, mse, kl of each step
        prog_delta = {k: (p.detach() - sd[k]).cpu() for k, p in params.items()}
        replayed = g.replays
        setup_s = time.time() - ctx.t_start

        # the window
        epochs = bad = 0
        marks, events = [time.perf_counter()], []
        while marks[-1] - marks[0] < ctx.seconds:
            epochs += 1
            idx, mask = traffic.plan(epochs)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) if on_card else None
            if ev:
                ev[0].record()
            losses = device_fit.run_graphed_epoch(g, idx, mask, [gen(epochs)])
            if ev:
                ev[1].record()
                events.append(ev)
            losses = losses[0, 0].cpu()
            marks.append(time.perf_counter())
            bad += int((~torch.isfinite(losses)).sum())
        window_s = marks[-1] - marks[0]
        _log_epochs(marks, events)
        # --trace 1: one more epoch of the same graph, steady, under the profiler
        prof = _profiled_epoch(g, traffic, epochs + 1, gen, dev) if ctx.trace else None
        g.graph = None
    found = common.forbidden_modules()
    device_info = common.card(dev) if on_card else None
    steps = epochs * nb
    del g, ts, opt, model, params, wave, isi, src, batch_step
    if on_card:
        torch.cuda.empty_cache()

    # the plain reference, after the window, from the same inputs
    t_ref = time.perf_counter()
    numbers, control = _reference(ctx, arch, hp, sets, traffic, (idx0, mask0), sd, dev, prog_metrics, prog_grad1,
                                  prog_delta, prog_var1)
    checked = f"; the checked steps were the graph's replays {replayed - CHECK_STEPS + 1}-{replayed}" if on_card else ""
    common.log(f"reference {time.perf_counter() - t_ref:.1f} s; set-up {setup_s:.2f} s; window {window_s:.3f} s, "
               f"{epochs} epochs, {steps} steps{checked}")
    run_info = {"setup_s": setup_s, "window_s": window_s, "samples": epochs * traffic.rows, "nb": nb,
                "window_steps": steps, "prof": prof, "step_flops": flops.step_flops(arch, B),
                "block_step_ms": bounds.block_step_ms(arch, B)}
    return {"numbers": numbers, "control": control, "attempted": steps, "failed": bad, "found": found,
            "device": device_info, "run": run_info}


def _log_epochs(marks, events):
    """Each window epoch's wall time, and on the card its span on the
    device's timeline (CUDA events on the fit's stream, from before the
    plan's copy to after the last replay), on stderr."""
    ms = np.diff(marks) * 1e3
    if not len(ms):
        return
    common.log(f"epoch ms min {ms.min():.2f} median {np.median(ms):.2f} max {ms.max():.2f}")
    if events:
        dev_ms = np.array([a.elapsed_time(b) for a, b in events])
        common.log(f"epoch device span ms min {dev_ms.min():.2f} median {np.median(dev_ms):.2f} "
                   f"max {dev_ms.max():.2f}; wall less span median {np.median(ms - dev_ms):.2f}")


def _profiled_epoch(g, traffic, epoch, gen, dev) -> dict:
    """Epoch ``epoch`` under the profiler: its trace, the device's busy time
    in it, and its span on the device's timeline (CUDA events on the fit's
    stream, around the plan's copy, the replays and the metrics' fetch: every
    device event of the profile). A trace in which some kernel's count is not a multiple of the
    epoch's steps (plus at most one) dropped events; the epoch is then run
    and traced again (up to 3 traces)."""
    from hippie_tpu_torch.train import device_fit

    on_card = dev.type == "cuda"
    idx, mask = traffic.plan(epoch)
    for attempt in range(1, 4):
        out = {}

        def run_epoch():
            if on_card:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t = time.perf_counter()
            device_fit.run_graphed_epoch(g, idx, mask, [gen(epoch)]).cpu()  # the fetch, as in the window
            if on_card:
                end.record()
                end.synchronize()
            out["span_s"] = start.elapsed_time(end) / 1e3 if on_card else time.perf_counter() - t

        out["trace"] = read_trace(profile(run_epoch, host=True))
        if all(n % g.nb in (0, 1) for _, n in out["trace"].by_name().values()):
            break
    out["traces"] = attempt
    out["busy_s"] = out["trace"].busy_ns() / 1e9
    out["clipped"] = True
    out["gaps"] = out["trace"].idle_gaps()
    return out


def _reference(ctx, arch, hp, sets, traffic, plan0, sd, dev, prog_metrics, prog_grad1, prog_delta,
               prog_var1) -> tuple:
    """The reference's three steps from the same weights, raw rows, plan and
    noise, and the gaps; with ``--control 1`` also the gaps of the reference
    computed one precision down (fp8 block operands) in the program's place,
    and (``stated``) those of the reference at the stated precision (bf16
    block operands), which show what that precision alone moves."""
    with full_float32():
        pre = [ref_pre.preprocess(s.wf, s.isi, dev) for s in sets]
        pool = [torch.cat([p[0] for p in pre]), torch.cat([p[1] for p in pre])]
        pool_src = torch.cat([torch.full((len(s.wf),), s.source, dtype=torch.long, device=dev) for s in sets])
        noise = torch.Generator(device=dev).manual_seed(traffic.noise_seed(0))
        batches = []
        for t in range(CHECK_STEPS):
            eps = torch.empty(traffic.batch, arch.z_dim, device=dev).normal_(0.0, 1.0, generator=noise)
            real = plan0[1][t] > 0  # the batch's real rows: the padded ones enter no statistic and no loss
            eps = eps[torch.as_tensor(real, device=dev)]
            rows = torch.as_tensor(traffic.draw[plan0[0][t][real]], device=dev)
            inputs = (pool[0][rows],) if not arch.multimodal else (pool[0][rows], pool[1][rows])
            batches.append((inputs, pool_src[rows], eps))
        hyper = ref_train.Hyper(hp["learning_rate"], hp["weight_decay"], hp["gradient_clip_val"], hp["beta"],
                                tuple(hp["modality_weights"]))
        ref = ref_train.run_steps(sd, arch, batches, hyper, Numerics("float32"))

        def gaps(steps):
            return train_gaps((steps.losses, steps.mses, steps.kls), (ref.losses, ref.mses, ref.kls),
                              {k: v.cpu() for k, v in steps.grad1.items()}, ref_grad1,
                              {k: (v - sd[k]).cpu() for k, v in steps.params.items()}, ref_delta,
                              {k: v.cpu() for k, v in steps.running_var1.items()}, ref_var1)

        ref_delta = {k: (v - sd[k]).cpu() for k, v in ref.params.items()}
        ref_grad1 = {k: v.cpu() for k, v in ref.grad1.items()}
        ref_var1 = {k: v.cpu() for k, v in ref.running_var1.items()}
        numbers = train_gaps(prog_metrics, (ref.losses, ref.mses, ref.kls), prog_grad1, ref_grad1, prog_delta,
                             ref_delta, prog_var1, ref_var1)
        control = None
        if ctx.control:
            control = gaps(ref_train.run_steps(sd, arch, batches, hyper, Numerics("fp8_blocks")))
            control["stated"] = gaps(ref_train.run_steps(sd, arch, batches, hyper, Numerics("bf16_blocks")))
    common.log(f"losses program {prog_metrics[0]} reference {ref.losses}; worst grad leaf {numbers['grad_leaf']}, "
               f"worst change leaf {numbers['change_leaf']}, {numbers['left_out']} leaves left out of the medians")
    return numbers, control
