#!/usr/bin/env python3
"""Per-kernel device split of the block kernels and of the masked SSE on one
NVIDIA GPU, for the port in a given checkout.

    python3 kernel_split.py [CHECKOUT]

CHECKOUT (default: this one) is a directory that holds hippie_tpu_torch/, for
instance the parent commit unpacked with ``git archive``, so that two
versions of the kernels are measured in one call on one card. With that
package, it runs chip_smoke.py's phases 5b, 5d and 5f (the encoder and the
decoder block kernels against their plain versions at the waveform encoder's,
the decoder's and the ISI encoder's shapes, then each shape's µs/call, device
µs, and each block kernel's device kernels by time and count per call, and
the per-pass sums) and times vae_sums_fwd (at the train step's shapes) and
masked_sse_fwd beside F.mse_loss(dec, data, reduction="sum"), twice. The
helpers are this checkout's chip_smoke.py. Exits non-zero without a CUDA
device.
"""

import importlib.util
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def main() -> int:
    sys.path.insert(0, str(pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 1
    from hippie_tpu_torch.ops import _build, cuda_ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; package {pathlib.Path(_build.__file__).parents[1]}; built {_build.build()}")
    loss = smoke.loss_inputs(415)
    sse = smoke.sse_inputs(415)
    data_all, dec_all, _ = smoke.sse_inputs(smoke.B)
    fns = {"vae_sums_fwd": lambda: cuda_ops.vae_sums_fwd_cuda(*loss),
           "masked_sse_fwd": lambda: cuda_ops.masked_sse_fwd_cuda(*sse),
           "F.mse_loss(sum)": lambda: F.mse_loss(dec_all, data_all, reduction="sum")}
    for _ in range(2):
        for name, fn in fns.items():
            ms = smoke.time_ms(fn)
            us, n, split = smoke.device_profile(fn, n=50)
            print(f"{name}: {ms * 1e3:.2f} us/call, {us:.2f} us device in {n:g} launches per call "
                  f"({smoke.split_line(split)}) on {card}")
    for bb in (smoke.ENC, smoke.DEC, smoke.isi_backbone()):
        errs, per_shape = smoke.phase_blocks(bb, card)
        smoke.block_records(bb, per_shape, errs, dict.fromkeys(smoke.all_launches(), 0), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
