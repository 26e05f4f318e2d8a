"""Deployment-artifact throughput: an exported embedder on one device.

    python -m hippie_tpu_torch.scripts.bench_artifact --artifact wave.hippie \
        [--rows 512,4096,16384] [--iters 20] [--device cuda]

Counterpart of the JAX package's scripts/bench_artifact.py. Loads the
artifact once (``hippie_tpu_torch.export.load_artifact``), then at each row
count calls it on numpy rows drawn with a seed, the host copies both ways
included: the first call (``cold_ms``, the first call of that row bucket,
which on the card captures the bucket's CUDA graph, as the JAX call
compiles it) and the mean of ``--iters`` calls after it (``warm_ms``,
replays of the graph), each ended by the reply's copy to the host. Prints the card's name and power limit (``nvidia-smi``) on
the device ``cuda``, then one JSON line per row count:

  {"device": ..., "rows": N, "cold_ms": ..., "warm_ms": ..., "rows_per_sec": ...,
   "z_dim": ..., "modality": ...}
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.bench_artifact",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", type=str, required=True)
    ap.add_argument("--rows", type=str, default="512,4096,16384")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the artifact runs (default cuda)")
    return ap


def card_line(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device
    itself off the card."""
    if not device.startswith("cuda"):
        return device
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from hippie_tpu_torch import export

    call, manifest = export.load_artifact(args.artifact, device=args.device)
    multimodal = manifest.get("modality") == "multimodal"
    rng = np.random.default_rng(0)
    print(f"card: {card_line(args.device)}")
    records = []
    for rows in (int(r) for r in args.rows.split(",")):
        lens = manifest["input_lens"] if multimodal else [manifest["input_len"]]
        arrays = tuple(rng.normal(size=(rows, n)).astype(np.float32) for n in lens) + (
            np.zeros((rows,), np.int32),)
        t0 = time.perf_counter()
        call(*arrays).cpu()  # the copy to the host waits for the device
        cold_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(args.iters):
            call(*arrays).cpu()
        warm_ms = (time.perf_counter() - t0) * 1e3 / args.iters
        rec = {"device": args.device, "rows": rows, "cold_ms": round(cold_ms, 3),
               "warm_ms": round(warm_ms, 3), "rows_per_sec": round(rows / (warm_ms / 1e3), 1),
               "z_dim": manifest.get("z_dim"), "modality": manifest.get("modality")}
        print(json.dumps(rec))
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
