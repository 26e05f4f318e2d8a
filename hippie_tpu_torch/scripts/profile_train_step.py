"""Time the parts of the unimodal train step on one device.

    python -m hippie_tpu_torch.scripts.profile_train_step [--batch 512] [--iters 50] \
        [--block-backend pallas] [--loss-backend pallas] [--device cuda]

Counterpart of the JAX package's scripts/profile_train_step.py: bench.py's
step (the z=10 cVAE, 8,056,639 parameters, AdamW lr 1e-3 wd 0.01 without a
clip) split into the full step (forward, loss, backward, AdamW), the same
step as the device fit loop runs it (train/device_fit.py:StepGraph: a CUDA
graph replayed per step on the card, the noise drawn before each replay;
the eager step over the same buffers on the CPU), the loss
forward (training mode, no gradient), the gradients alone, the optimizer
alone (fixed gradients), the encoder's and the decoder's training forwards
and forward + backward passes, and the dominant convolution shapes (the
gradients with respect to the input and to the weight, and the forward in
float32 and in bf16 with its TFLOP/s). ``--block-backend`` and
``--loss-backend`` are the train step's (train/step.py); the convolution
shapes are cuDNN's on any backend.

Each part runs ``--iters`` times (``--conv-iters`` for the convolutions)
after as many warm-up calls, timed with CUDA events on the card (the host's
clock on the CPU): the figure is the mean wall time per call, the host's
dispatch included, which is what the eager step costs. Prints one line per
part, then one JSON line with every part's ms per call. A measuring tool,
not the benchmark: it writes no BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time


def build_parser():
    p = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.profile_train_step",
                                description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--conv-iters", type=int, default=200)
    p.add_argument("--block-backend", choices=("xla", "fused", "bf16", "pallas"), default="xla")
    p.add_argument("--loss-backend", choices=("xla", "pallas"), default="xla")
    p.add_argument("--device", default="cuda", help="where the model and the data live (default cuda)")
    p.add_argument("--seed", type=int, default=0)
    return p


def time_ms(fn, iters: int, device) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``iters`` warm-up
    calls: CUDA events on the card, the host's clock on the CPU."""
    import torch

    for _ in range(iters):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.ops import cuda_ops, losses
    from hippie_tpu_torch.train import loop, optim, step

    device = torch.device(args.device)
    B, iters = args.batch, args.iters
    cfg = cvae.CVAEConfig(z_dim=10, output_size=50, class_hidden_dim=5, num_sources=5, num_classes=5)
    model = cvae.unimodal_cvae_init(cfg, loop.key_generator(args.seed, 0), device=device)
    opt = optim.make_optimizer(model.parameters(), 1e-3, 0.01)
    ts = step.TrainState(model, opt)
    rng = np.random.default_rng(args.seed)
    data = torch.from_numpy(rng.normal(size=(B, 50)).astype(np.float32)).to(device)
    source = torch.zeros((B,), dtype=torch.long, device=device)
    gen = loop.key_generator(args.seed, 1, device=device)
    backend = args.block_backend
    vae_loss = cuda_ops.vae_loss_pallas if args.loss_backend == "pallas" else losses.vae_loss
    batch_step, _ = step.make_unimodal_steps(loss_backend=args.loss_backend, block_backend=backend)
    model.train()

    def loss_fn():
        _, mu, logvar, dec = model(data, source, None, generator=gen, backend=backend)
        return vae_loss(data, dec, mu, logvar, beta=1.0)[0]

    def grads():
        opt.zero_grad(set_to_none=True)
        loss_fn().backward()

    def forward():
        with torch.no_grad():
            loss_fn()

    fixed = [torch.full_like(p, 1e-6) for p in model.parameters()]

    def optimizer_only():
        for p, g in zip(model.parameters(), fixed):
            p.grad = g
        opt.step()

    x3 = data[:, None, :]
    zin = torch.from_numpy(rng.normal(size=(B, 20)).astype(np.float32)).to(device)

    def enc_fwd():
        with torch.no_grad():
            model.encoder(x3, backend=backend)

    def dec_fwd():
        with torch.no_grad():
            model.decoder(zin, backend=backend)

    def enc_grad():
        model.zero_grad(set_to_none=True)
        h = model.encoder(x3, backend=backend)
        (h * h).sum().backward()

    def dec_grad():
        model.zero_grad(set_to_none=True)
        h = model.decoder(zin, backend=backend)
        (h * h).sum().backward()

    results = {}

    def record(name, fn, n=iters):
        ms = time_ms(fn, n, device)
        results[name] = ms
        print(f"{name:36s} {ms:8.3f} ms/call")
        return ms

    record("full train step", lambda: batch_step(ts, data, source, None, None, generator=gen))
    from hippie_tpu_torch.train import device_fit

    # the device fit loop's step: warm-up and capture on a side stream, as the loop runs them
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side) if side is not None else contextlib.nullcontext():
        graphed = device_fit.StepGraph(
            [lambda i, m, e: batch_step(ts, data[i], source[i], None, m, eps=e)[1]], nb=1, batch=B,
            noise_shape=(B, cfg.z_dim), dtype=data.dtype, device=device, stream=side,
            pool=torch.cuda.graph_pool_handle() if side is not None else None,
            before_capture=lambda: opt.zero_grad(set_to_none=True))
        graphed.load_plan(np.arange(B)[None], np.ones((1, B), np.float32))
        record("graphed train step (device fit loop)", lambda: (graphed.row.zero_(), graphed([gen])))
    if side is not None:
        torch.cuda.current_stream(device).wait_stream(side)
    graphed.graph = None
    opt.zero_grad(set_to_none=True)
    record("fwd+bwd (no optimizer)", grads)
    record("forward only (train mode)", forward)
    record("optimizer only", optimizer_only)
    record("encoder fwd (train mode)", enc_fwd)
    record("decoder fwd (train mode)", dec_fwd)
    record("encoder fwd+bwd", enc_grad)
    record("decoder fwd+bwd", dec_grad)

    # the dominant convolutions, torch layout [B, C, L], weights [C_out, C_in, K]
    def tensor(shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)

    for name, c, length in (("enc l1 conv 64x64 L25", 64, 25), ("enc l4 conv 512x512 L4", 512, 4),
                            ("dec l1 conv 64x64 L64", 64, 64), ("dec l4 conv 512x512 L4", 512, 4)):
        x, w = tensor((B, c, length)).requires_grad_(), tensor((c, c, 3)).requires_grad_()
        for which, wrt in (("dx", x), ("dw", w)):
            record(f"{name} {which}", lambda wrt=wrt, x=x, w=w: torch.autograd.grad(
                F.conv1d(x, w, padding=1).square().sum(), wrt), args.conv_iters)
    for name, c, length in (("enc l1 conv 64x64 L25", 64, 25), ("enc l2 conv 128x128 L13", 128, 13),
                            ("enc l3 conv 256x256 L7", 256, 7), ("enc l4 conv 512x512 L4", 512, 4),
                            ("dec l1 conv 64x64 L64", 64, 64)):
        for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, w = tensor((B, c, length), dt), tensor((c, c, 3), dt)
            with torch.no_grad():
                ms = record(f"{name} [{dt_name}]", lambda x=x, w=w: F.conv1d(x, w, padding=1),
                            args.conv_iters)
            flops = 2 * B * length * 3 * c * c
            print(f"{'':36s} -> {flops / (ms * 1e-3) / 1e12:.2f} TF/s")

    print(json.dumps({"device": str(device), "batch": B, "block_backend": backend,
                      "loss_backend": args.loss_backend, "iters": iters, "conv_iters": args.conv_iters,
                      "ms": {k: round(v, 4) for k, v in results.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
