"""`hippie-tpu-torch` console entry point of the PyTorch/CUDA port.

Counterpart of hippie_tpu/cli.py: the same subcommands, each delegating to
the port's script of the same role (hippie_tpu_torch/scripts/), with their
flags, ``--device`` (default ``cuda``) among them. ``synth`` writes a
synthetic dataset with the port's data/synth.py. ``bench`` runs
scripts/bench.py (the root bench.py's stage-1 throughput, timing the device
loop's replayed train epoch) and returns its exit code: 1 without a CUDA
device unless ``--device cpu`` is given. An unknown command exits 2.
"""

from __future__ import annotations

import sys

USAGE = """usage: hippie-tpu-torch {train,train-multimodal,sweep,lr-sweep,infer,kfold,serve,export,synth,bench} [args...]
  train            3-stage unimodal pipeline (scripts/train_model.py flags)
  train-multimodal unimodal-or-joint pipeline (--model-type multimodal)
  sweep            full pipeline for every dataset target in ONE process
  lr-sweep         K learning rates / seeds trained side by side
  infer            dual-checkpoint embedding export (+ --cluster k)
  kfold            k-fold cross-validated KNN evaluation of embeddings
  serve            HTTP embedding microservice (POST /embed)
  export           checkpoint -> deployable torch.export artifact
  synth            generate a synthetic dataset in the CSV contract
  bench            stage-1 train throughput on the card (scripts/bench.py): one JSON line"""


def _synth(argv):
    import argparse

    from hippie_tpu_torch.data import synth

    p = argparse.ArgumentParser(prog="hippie-tpu-torch synth")
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--name", required=True)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--wave-width", type=int, default=46)
    p.add_argument("--isi-width", type=int, default=100)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with-metadata", action="store_true")
    a = p.parse_args(argv)
    path = synth.make_dataset(a.data_root, a.name, n=a.n, wave_width=a.wave_width, isi_width=a.isi_width,
                              num_classes=a.num_classes, seed=a.seed, with_metadata=a.with_metadata)
    print(f"wrote synthetic dataset to {path}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "train":
        from hippie_tpu_torch.scripts import train_model

        train_model.run(train_model.build_parser().parse_args(rest))
    elif cmd == "train-multimodal":
        from hippie_tpu_torch.scripts import train_model_with_multimodal

        train_model_with_multimodal.main(rest)
    elif cmd == "sweep":
        from hippie_tpu_torch.scripts import sweep_targets

        return sweep_targets.main(rest) or 0
    elif cmd == "lr-sweep":
        from hippie_tpu_torch.scripts import lr_sweep

        return lr_sweep.main(rest) or 0
    elif cmd == "infer":
        from hippie_tpu_torch.scripts import inference_from_trained_model

        inference_from_trained_model.main(rest)
    elif cmd == "kfold":
        from hippie_tpu_torch.scripts import kfold_eval

        kfold_eval.main(rest)
    elif cmd == "serve":
        from hippie_tpu_torch.scripts import serve_embeddings

        serve_embeddings.main(rest)
    elif cmd == "export":
        from hippie_tpu_torch.scripts import export_model

        export_model.main(rest)
    elif cmd == "synth":
        return _synth(rest)
    elif cmd == "bench":
        from hippie_tpu_torch.scripts import bench

        return bench.main(rest)
    else:
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
