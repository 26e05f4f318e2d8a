"""Export a trained checkpoint as a deployable embedding artifact.

    python -m hippie_tpu_torch.scripts.export_model --checkpoint ckpts/<ds>_wave_model.ckpt \
        --output wave_embedder.hippie [--platforms cpu,cuda] [--device cuda]

Counterpart of the JAX package's scripts/export_model.py, with its flags
plus ``--device``, where the checkpoint is loaded and the program traced
(default ``cuda``). The artifact (a zip of ``manifest.json`` and
``model.pt2``, a ``torch.export`` program with a symbolic batch) loads in a
fresh process with ``hippie_tpu_torch.export.load_artifact``, on any device
its ``--platforms`` name, with no model code and no checkpoint parsing. The
geometry is inferred from the checkpoint's tensor shapes.
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.export_model",
                                description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True, help="Lightning .ckpt (wave, time or joint model)")
    p.add_argument("--output", required=True, help="artifact path (zip: manifest.json + model.pt2)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated devices the artifact may be loaded on (cpu, cuda)")
    p.add_argument("--precision", choices=("highest", "default"), default="highest",
                   help="matmul precision applied around each call: 'highest' is the full-float32 "
                        "parity contract; 'default' lets the card use TF32 (no effect on cpu)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the checkpoint is loaded and the program traced (default cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from hippie_tpu_torch import export

    manifest = export.export_from_checkpoint(
        args.checkpoint, args.output,
        platforms=tuple(s.strip() for s in args.platforms.split(",") if s.strip()),
        precision=args.precision, device=args.device)
    size = os.path.getsize(args.output)
    print(f"exported {args.checkpoint} -> {args.output} ({size / 1e6:.1f} MB)")
    print(manifest)
    return manifest


if __name__ == "__main__":
    main()
