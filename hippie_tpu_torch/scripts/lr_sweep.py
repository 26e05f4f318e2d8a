"""Hyperparameter sweep of the stage-1 cVAE pretrain: K learning rates (or K
seeds) trained side by side (train/ensemble.py).

    python -m hippie_tpu_torch.scripts.lr_sweep --dataset cellexplorer-celltype \
        --lrs 1e-2,3e-3,1e-3,3e-4 --max-epochs 40 --patience 10
    python -m hippie_tpu_torch.scripts.lr_sweep --dataset X --mode seeds --n-seeds 4 --lr 1e-3

Counterpart of the JAX package's scripts/lr_sweep.py, with its flags plus
``--device`` (default ``cuda``). As in the port's train_model:
``--fit-loop`` takes only ``host`` (the port's one loop), ``--aot-dir``
has no port target (default none; raises when given), and
``--progress-every`` and ``--resume-dir`` raise, naming ROADMAP Queue 1
item 12. ``--export-winner`` and ``--export-all`` write Lightning
``.ckpt`` files (train/checkpoint.py:save_lightning_ckpt) that the stage-1
seams of both training CLIs load (``--stage1-{wave,time,joint}-ckpt``);
``--export-all`` warns for a replica that never improved (its best epoch is
-1: the file holds its weights after the first epoch). Prints a
per-config table and one final JSON line with the JAX CLI's keys.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.lr_sweep",
                                description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True, help="target dataset name")
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--modality", choices=("wave", "time", "joint"), default="wave",
                   help="wave/time: unimodal cVAE on one data array; joint: the MultiModalCVAE on "
                        "paired (wave, isi) rows; its exported winner feeds "
                        "train_model_with_multimodal --stage1-joint-ckpt")
    p.add_argument("--pool", choices=("pretrain", "self"), default="pretrain",
                   help="pretrain: leave-target-out pool (stage-1 contract); self: the target "
                        "dataset's own rows")
    p.add_argument("--mode", choices=("lr", "seeds"), default="lr",
                   help="lr: one shared init, one replica per --lrs entry; seeds: --n-seeds "
                        "independent inits at --lr")
    p.add_argument("--lrs", default="1e-2,3e-3,1e-3,3e-4",
                   help="comma-separated learning rates (mode=lr)")
    p.add_argument("--lr", type=float, default=1e-3, help="lr for mode=seeds")
    p.add_argument("--n-seeds", type=int, default=4)
    p.add_argument("--z-dim", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--max-epochs", type=int, default=40)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--mod1-weight", type=float, default=1.0,
                   help="joint sweeps only: waveform loss weight; match the --mod1-weight the "
                        "pipeline will train stages 2-3 with")
    p.add_argument("--mod2-weight", type=float, default=1.0,
                   help="joint sweeps only: ISI loss weight (see --mod1-weight)")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--clip-val", type=float, default=None,
                   help="global-norm clip; default mirrors the reference's Q7 asymmetry "
                        "(wave: none, time and joint: 1.0)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train-frac", type=float, default=0.8)
    p.add_argument("--num-blocks", default="2,2,2,2",
                   help="backbone blocks per stage (tests use 1,1,1,1)")
    p.add_argument("--fit-loop", choices=("host",), default="host",
                   help="the port's one fit loop: per-epoch on the host")
    p.add_argument("--progress-every", type=int, default=None,
                   help="device fit loop only: not ported (raises)")
    p.add_argument("--aot-dir", default=None,
                   help="not ported (raises when given; the JAX CLI's compiled-program cache)")
    p.add_argument("--resume-dir", default=None, metavar="DIR", help="not ported (raises)")
    p.add_argument("--export-winner", default=None, metavar="CKPT",
                   help="write the winning replica as a Lightning stage-1 checkpoint; feed it to "
                        "train_model --stage1-{wave,time}-ckpt (or, for --modality joint, "
                        "train_model_with_multimodal --stage1-joint-ckpt)")
    p.add_argument("--export-all", default=None, metavar="PREFIX",
                   help="write EVERY replica's best snapshot as PREFIX<k>.ckpt, to screen each "
                        "candidate with kfold_eval --refit")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the data and models live (default cuda)")
    return p


# flags of the JAX CLI with no port yet: (dest, its default, the ROADMAP Queue 1 item)
UNPORTED = (
    ("progress_every", None, "item 12 (options of the JAX device fit loop, which has no port)"),
    ("resume_dir", None, "item 12 (mid-run resume)"),
    ("aot_dir", None, "item 12 (the AOT program cache has no port target)"),
)


def main(argv=None):
    args = build_parser().parse_args(argv)
    for dest, default, item in UNPORTED:
        if getattr(args, dest) != default:
            raise ValueError(f"--{dest.replace('_', '-')} {getattr(args, dest)!r} is not ported yet: "
                             f"ROADMAP Queue 1 {item}")
    import torch

    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.data.device_data import batch_plan
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import ensemble, loop, optim, pipeline

    clip_val = args.clip_val
    if clip_val is None and args.modality in ("time", "joint"):
        clip_val = 1.0  # reference Q7: time/multimodal trainers clip, wave does not

    cfg = pipeline.PipelineConfig(dataset=args.dataset, data_root=args.data_root, verbose=False,
                                  device=args.device)
    joint = args.modality == "joint"
    if not joint and (args.mod1_weight != 1.0 or args.mod2_weight != 1.0):
        raise SystemExit("lr-sweep: --mod1-weight/--mod2-weight only apply to --modality joint")
    ds = (pipeline.load_pretrain_pool(cfg) if args.pool == "pretrain"
          else pipeline.load_dataset(cfg, args.dataset))
    if joint:
        arrays = (ds.wave, ds.isi)
    else:
        arrays = (ds.wave if args.modality == "wave" else ds.isi,)
    n = int(arrays[0].shape[0])
    if n < 2:
        raise ValueError(f"need at least 2 rows to split train/val, got {n}")
    perm = torch.randperm(n, generator=loop.key_generator(args.seed, 0)).numpy()
    # validation stays disjoint from train when train_frac rounds to every row
    n_train = min(max(1, int(args.train_frac * n)), n - 1)
    tr_idx, va_idx = perm[:n_train], perm[n_train:]

    # the pipeline's stage-1 geometry (num_sources=registry.NUM_SOURCES,
    # num_classes=5), so an exported winner seeds stages 2-3 directly
    nb_cfg = tuple(int(x) for x in args.num_blocks.split(","))
    if joint:
        cfg_m = cvae.MultiModalConfig(z_dim=args.z_dim, output_size_wave=int(arrays[0].shape[1]),
                                      output_size_isi=int(arrays[1].shape[1]),
                                      num_sources=registry.NUM_SOURCES, num_classes=5, num_blocks=nb_cfg)
        init_one, init_ens = cvae.multimodal_cvae_init, ensemble.init_multimodal_ensemble
        epoch_fns = ensemble.make_multimodal_ensemble_epoch_fns(
            beta=args.beta, mod1_weight=args.mod1_weight, mod2_weight=args.mod2_weight)
    else:
        cfg_m = cvae.CVAEConfig(z_dim=args.z_dim, output_size=int(arrays[0].shape[1]),
                                num_sources=registry.NUM_SOURCES, num_classes=5, num_blocks=nb_cfg)
        init_one, init_ens = cvae.unimodal_cvae_init, ensemble.init_unimodal_ensemble
        epoch_fns = ensemble.make_unimodal_ensemble_epoch_fns(beta=args.beta)

    def make_opt(lr):
        return lambda params: optim.make_optimizer(params, lr, args.weight_decay, clip_val)

    if args.mode == "lr":
        lrs = [float(x) for x in args.lrs.split(",")]
        K = len(lrs)
        labels = [f"lr={x:g}" for x in lrs]
        # one shared init, so only the lr differs between replicas
        states = []
        for _ in range(K):
            model = init_one(cfg_m, loop.key_generator(args.seed, 1), device=args.device)
            states.append(ensemble.TrainState(model, make_opt(lrs[0])(model.parameters())))
        states = ensemble.set_ensemble_lr(states, lrs)
    else:
        K = args.n_seeds
        lrs = [args.lr] * K
        labels = [f"seed[{k}] lr={args.lr:g}" for k in range(K)]
        states = init_ens(loop.epoch_key(args.seed, 1), cfg_m, make_opt(args.lr), K, device=args.device)

    va_plan = batch_plan(va_idx, args.batch_size, shuffle=False)
    print(f"sweeping {K} configs on {args.dataset} ({args.pool} pool, {args.modality}, {n} rows, "
          f"{args.device}, {args.fit_loop} loop)")
    res = ensemble.host_fit_ensemble(
        states, epoch_fns=epoch_fns, arrays=arrays, source=ds.source, class_=None,
        train_stream=tr_idx, batch_size=args.batch_size, val_idx=va_plan[0], val_mask=va_plan[1],
        max_epochs=args.max_epochs, early_stopping_patience=args.patience, seed=args.seed,
        shuffle=True, verbose=True)

    # a replica that never logged a finite best must not win: np.argmin would
    # return the first nan
    finite = np.isfinite(res.best_val_loss)
    if not finite.any():
        print(json.dumps({
            "dataset": args.dataset, "modality": args.modality, "mode": args.mode,
            "configs": labels, "lrs": lrs, "best_val_loss": [float(x) for x in res.best_val_loss],
            "error": "no replica produced a finite validation loss",
        }))
        raise SystemExit("lr-sweep: no replica produced a finite validation loss")
    best_k = int(np.argmin(np.where(finite, res.best_val_loss, np.inf)))
    print(f"\n{'config':>18} {'best val':>12} {'best epoch':>10}")
    for k in range(K):
        mark = " <- best" if k == best_k else ""
        print(f"{labels[k]:>18} {res.best_val_loss[k]:12.6f} {int(res.best_epoch[k]):10d}{mark}")

    def export(path, k, hyper):
        ckpt_mod.save_lightning_ckpt(path, res.best_state_dict[k],
                                     epoch=int(res.best_epoch[k]),
                                     hyper_parameters={"lr": float(lrs[k]),
                                                       "best_val_loss": float(res.best_val_loss[k]),
                                                       **hyper, "modality": args.modality})

    exported_all = None
    if args.export_all:
        exported_all = []
        for k in range(K):
            path = f"{args.export_all}{k}.ckpt"
            export(path, k, {"config": labels[k]})
            if res.best_epoch[k] < 0:
                print(f"WARNING: replica {k} ({labels[k]}) never improved on its validation loss "
                      f"(best epoch -1); {path} holds its weights after epoch 0")
            exported_all.append(path)
        print(f"exported all {K} replicas -> {args.export_all}{{0..{K - 1}}}.ckpt")

    exported = None
    if args.export_winner:
        export(args.export_winner, best_k, {"sweep": labels})
        exported = args.export_winner
        print(f"exported winner ({labels[best_k]}) -> {exported}")

    print(json.dumps({
        "dataset": args.dataset, "modality": args.modality, "mode": args.mode,
        "configs": labels, "lrs": lrs,
        "best_val_loss": [float(x) for x in res.best_val_loss],
        "best_epoch": [int(x) for x in res.best_epoch],
        "epochs_run": res.epochs_run,
        "winner": labels[best_k], "winner_lr": lrs[best_k],
        "exported": exported, "exported_all": exported_all,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
