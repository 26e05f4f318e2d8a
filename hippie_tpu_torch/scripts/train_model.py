"""Unimodal 3-stage training CLI of the PyTorch/CUDA port.

    python -m hippie_tpu_torch.scripts.train_model --dataset cellexplorer-celltype \
        --loss-backend pallas --block-backend pallas

The flags, defaults and output files of the JAX package's
scripts/train_model.py (pretraining_<ds>_*_embeddings.csv, <ds>_*_knn.csv,
<ds>_*_embeddings.csv, Lightning .ckpt files, confusion-matrix PNGs), plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions of
the kernels on the host). Differences: ``--fit-loop`` takes only ``host``
(the port's one loop, trajectory-equal to the JAX host loop), ``--aot-dir``
defaults to none, and the JAX options with no port yet (``--resume``,
``--dp-devices``, ``--fsdp``, ``--aot-dir``, ``--profile-dir``,
``--discover-datasets``, ``--progress-every``, ``--log-every-step``,
``--wandb``, ``--block-backend fused|bf16``) raise with the ROADMAP item
that ports them (``UNPORTED``). ``--optimizer schedule-free`` and
``--opt-state-dtype bfloat16`` reach the pipeline; together they raise the
JAX CLI's ValueError. ``--stage1-wave-ckpt`` and
``--stage1-time-ckpt`` seed stage 1 from Lightning checkpoints. ``--beta``
goes into the config, where the joint model
(scripts/train_model_with_multimodal.py) reads it; the unimodal pipeline
keeps beta = 1 (quirk Q6), as the JAX one. Without matplotlib or seaborn
the PNGs are skipped, with one line saying so.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def str2bool(v):
    # The reference uses type=bool (any non-empty string is True, SURVEY.md
    # §5); accept explicit true/false spellings as well.
    if isinstance(v, bool):
        return v
    return v.lower() not in ("false", "0", "no", "")


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.train_model")
    parser.add_argument("--z_dim", type=int, default=5, required=False)
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--learning-rate", type=float, default=0.001)
    parser.add_argument("--beta", type=float, default=1)
    parser.add_argument("--dataset", type=str, default="cellexplorer-celltype")
    parser.add_argument("--upload-model", action="store_true")
    parser.add_argument("--wandb-tag", type=str, default="no_curr_sup_pretrain_data")
    parser.add_argument("--project", type=str, default="HIPPIE final benchmarks w finetune without labels")
    parser.add_argument("--finetune-without-labels", type=str2bool, default=True)
    parser.add_argument("--pretrain-max-epochs", type=int, default=1)
    parser.add_argument("--finetune-max-epochs", type=int, default=1)
    parser.add_argument("--supervised-max-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--supervised-batch-size", type=int, default=64)
    parser.add_argument("--early-stopping-patience", type=int, default=30)
    parser.add_argument("--gradient-clip-val", type=float, default=1.0)
    parser.add_argument("--train-val-split", type=float, default=0.8)
    parser.add_argument("--finetune-split", type=float, default=0.1)
    parser.add_argument("--limit-train-batches", type=float, default=None)
    parser.add_argument("--limit-val-batches", type=float, default=None)
    parser.add_argument("--data-root", type=str, default="datasets")
    parser.add_argument("--output-dir", type=str, default=".")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--wandb", action="store_true", help="not ported (raises)")
    parser.add_argument("--strict-leakage-guard", action="store_true",
                        help="also exclude sister juxtacellular datasets (fixes quirk Q2)")
    parser.add_argument("--discover-datasets", action="store_true", help="not ported (raises)")
    parser.add_argument("--resume", action="store_true", help="not ported (raises)")
    parser.add_argument("--profile-dir", type=str, default=None, help="not ported (raises)")
    parser.add_argument("--log-file", type=str, default=None,
                        help="append per-epoch metrics as JSON lines to this file")
    parser.add_argument("--drop-index-column", action="store_true",
                        help="drop the CSV index feature (fixes quirk Q4; breaks numerical compat)")
    parser.add_argument("--honest-eval", action="store_true",
                        help="extract stage-3 embeddings WITHOUT class conditioning (fixes the label leak)")
    parser.add_argument("--loss-backend", choices=("xla", "pallas"), default="xla",
                        help="VAE loss inside every train/eval step: 'pallas' = the hand-written "
                             "CUDA loss kernels, 'xla' = eager torch ops")
    parser.add_argument("--dp-devices", type=int, default=None, help="not ported (raises)")
    parser.add_argument("--fsdp", action="store_true", help="not ported (raises)")
    parser.add_argument("--aot-dir", type=str, default=None,
                        help="not ported (raises when given; the JAX CLI's compiled-program cache)")
    parser.add_argument("--stage1-wave-ckpt", type=str, default=None,
                        help="seed the wave model from this Lightning stage-1 ckpt and skip its "
                             "pretrain fit; geometry must match --z_dim")
    parser.add_argument("--stage1-time-ckpt", type=str, default=None,
                        help="same for the time/ISI model")
    parser.add_argument("--fit-loop", choices=("host",), default="host",
                        help="the port's one fit loop: per-epoch on the host, the trajectory of "
                             "the JAX CLI's --fit-loop host")
    parser.add_argument("--progress-every", type=int, default=None,
                        help="device fit loop only: not ported (raises)")
    parser.add_argument("--log-every-step", action="store_true",
                        help="device fit loop only: not ported (raises)")
    parser.add_argument("--opt-state-dtype", choices=("float32", "bfloat16"), default="float32",
                        help="Adam moment storage dtype; bfloat16 stores the moments in bf16 "
                             "(the update stays float32)")
    parser.add_argument("--optimizer", choices=("adamw", "schedule-free"), default="adamw",
                        help="'schedule-free' = schedule-free AdamW: validation, embeddings and "
                             "ckpts use the averaged x iterate, ckpts omit optimizer_states and "
                             "keep the averaging state in a .sfstate sidecar")
    parser.add_argument("--block-backend", choices=("xla", "bf16", "fused", "pallas"), default="xla",
                        help="backbone blocks of the training steps: 'pallas' = the hand-written "
                             "CUDA block kernels, 'xla' = torch convolutions; 'fused' and 'bf16' "
                             "are not ported (raise)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the data, models and kernels run (default cuda; 'cpu' runs "
                             "the kernels' plain versions)")
    return parser


def jsonl_logger(path: str):
    """A log_fn appending one JSON object per record to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(event: dict):
        with open(path, "a") as f:
            f.write(json.dumps({"ts": round(time.time(), 3), **event}) + "\n")

    return log


# flags of the JAX CLI with no port yet: (dest, its default, the ROADMAP Queue 1 item that ports it)
UNPORTED = (
    ("resume", False, "item 12 (mid-run resume)"),
    ("dp_devices", None, "item 12 (data parallelism)"),
    ("fsdp", False, "item 12 (FSDP)"),
    ("aot_dir", None, "item 12 (the AOT program cache has no port target)"),
    ("profile_dir", None, "item 12 (profiling with torch.profiler)"),
    ("discover_datasets", False, "item 12 (the remaining CLI)"),
    ("wandb", False, "item 12 (the remaining CLI)"),
    ("progress_every", None, "item 3 (options of the JAX device fit loop, which has no port)"),
    ("log_every_step", False, "item 3 (options of the JAX device fit loop, which has no port)"),
)


def config_from_args(args, model_type: str = "unimodal"):
    """The pipeline's config from the parsed flags; raises ValueError for a
    flag set to what the port has not. The multimodal CLI's flags
    (``--mod1-weight``, ``--mod2-weight``, ``--stage1-joint-ckpt``) keep
    their defaults when the parser has none."""
    from hippie_tpu_torch.models.backbones import check_backend
    from hippie_tpu_torch.train.optim import check_optimizer
    from hippie_tpu_torch.train.pipeline import PipelineConfig

    for dest, default, item in UNPORTED:
        if getattr(args, dest) != default:
            raise ValueError(f"--{dest.replace('_', '-')} {getattr(args, dest)!r} is not ported yet: "
                             f"ROADMAP Queue 1 {item}")
    check_backend(args.block_backend)  # 'fused' and 'bf16' raise (item 13)
    opt_state_dtype = None if args.opt_state_dtype == "float32" else args.opt_state_dtype
    check_optimizer(args.optimizer, opt_state_dtype)  # schedule-free with bf16 moments raises
    return PipelineConfig(
        z_dim=args.z_dim,
        weight_decay=args.weight_decay,
        learning_rate=args.learning_rate,
        beta=args.beta,  # the joint model's; the unimodal pipeline keeps 1 (quirk Q6)
        dataset=args.dataset,
        finetune_without_labels=args.finetune_without_labels,
        pretrain_max_epochs=args.pretrain_max_epochs,
        finetune_max_epochs=args.finetune_max_epochs,
        supervised_max_epochs=args.supervised_max_epochs,
        batch_size=args.batch_size,
        supervised_batch_size=args.supervised_batch_size,
        early_stopping_patience=args.early_stopping_patience,
        gradient_clip_val=args.gradient_clip_val,
        train_val_split=args.train_val_split,
        finetune_split=args.finetune_split,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        model_type=model_type,
        mod1_weight=getattr(args, "mod1_weight", 1.0),
        mod2_weight=getattr(args, "mod2_weight", 1.0),
        data_root=args.data_root,
        output_dir=args.output_dir,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
        strict_leakage_guard=args.strict_leakage_guard,
        drop_index_column=args.drop_index_column,
        honest_eval=args.honest_eval,
        loss_backend=args.loss_backend,
        block_backend=args.block_backend,
        opt_state_dtype=opt_state_dtype,
        optimizer=args.optimizer,
        device=args.device,
        stage1_wave_ckpt=args.stage1_wave_ckpt,
        stage1_time_ckpt=args.stage1_time_ckpt,
        stage1_joint_ckpt=getattr(args, "stage1_joint_ckpt", None),
        log_fn=jsonl_logger(args.log_file) if args.log_file else None,
    )


def save_confmats(results, dataset: str, output_dir: str):
    """The confusion-matrix PNG of each kind, as the JAX CLI writes them; one
    line saying they are skipped when matplotlib or seaborn does not import."""
    try:
        import matplotlib  # noqa: F401
        import seaborn  # noqa: F401
    except ImportError as e:
        print(f"skipped the confusion-matrix PNGs ({e})")
        return
    from hippie_tpu_torch.evaluate.confmat import make_confmat

    label_names = results["label_encoder"].classes_
    for kind, info in results["best"].items():
        fig = make_confmat(info["confusion_matrix"], label_names, info["k"])
        fig_path = os.path.join(output_dir, f"{dataset}_confusion_matrix_{kind}.png")
        fig.savefig(fig_path, dpi=150, bbox_inches="tight")
        print(f"saved {fig_path}")


def run(args, model_type: str = "unimodal"):
    from hippie_tpu_torch.train.pipeline import run_pipeline

    results = run_pipeline(config_from_args(args, model_type))
    for kind, info in results["best"].items():
        print(f"best_balanced_accuracy_{kind}: {info['balanced_accuracy']:.4f} (k={info['k']})")
    save_confmats(results, args.dataset, args.output_dir)
    return results


if __name__ == "__main__":
    run(build_parser().parse_args())
