"""Unimodal 3-stage training CLI of the PyTorch/CUDA port.

    python -m hippie_tpu_torch.scripts.train_model --dataset cellexplorer-celltype \
        --loss-backend pallas --block-backend pallas

The flags, defaults and output files of the JAX package's
scripts/train_model.py (pretraining_<ds>_*_embeddings.csv, <ds>_*_knn.csv,
<ds>_*_embeddings.csv, Lightning .ckpt files, confusion-matrix PNGs), plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions of
the kernels on the host). ``--fit-loop device`` (the default, as in JAX)
runs each stage fit's steps as CUDA graphs replayed on the card
(train/device_fit.py), ``--fit-loop host`` the per-epoch loop of eager
steps, on the same trajectory bit for bit; ``--progress-every`` and
``--log-every-step`` are the device loop's, as in JAX. ``--aot-dir``
(default ``~/.cache/hippie_tpu_aot``, as JAX; ``''``: none) is where the
CUDA kernel libraries load from, or are built once (ops/_build.py), so a
second process, and a card without the CUDA toolkit, builds nothing. On
CUDA the device loop needs NCCL ranks; it captures the
``--fsdp`` step too. ``--dp-devices N`` (N > 1) runs the
pipeline on N data-parallel ranks (parallel/mesh.py:launch): N GPUs over
NCCL, or with ``--device cpu`` N processes over gloo; more ranks than
visible GPUs raise ValueError (the JAX ``make_mesh`` would take fewer).
``--fsdp`` adds the sharding of the parameters and the optimizer state
(parallel/fsdp.py; AdamW's moments or schedule-free's state) and needs
``--dp-devices`` > 1. Rank 0 writes every
file and prints; its results are the command's. ``--resume``
continues every stage fit of an interrupted run where it stopped
(train/resume.py; the port's own format, not orbax), ``--profile-dir``
writes a torch.profiler trace of the run, ``--discover-datasets`` registers
the unknown dataset directories of ``--data-root``, and ``--wandb`` logs
through utils/wandb_shim.py (a no-op without the wandb package).
``--block-backend`` takes all four JAX backends (models/backbones.py).
``--optimizer schedule-free`` and
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
from typing import Optional

from hippie_tpu_torch.ops import _build


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
    parser.add_argument("--wandb", action="store_true",
                        help="log to Weights & Biases when the wandb package is installed (a no-op "
                             "without it)")
    parser.add_argument("--strict-leakage-guard", action="store_true",
                        help="also exclude sister juxtacellular datasets (fixes quirk Q2)")
    parser.add_argument("--discover-datasets", action="store_true",
                        help="register dataset directories under --data-root missing from the "
                             "registry (waveforms.csv + isi_dist.csv) so they can be targets and join "
                             "the pretraining pool")
    parser.add_argument("--resume", action="store_true",
                        help="save every stage fit's full state each epoch under "
                             "<checkpoint-dir>/resume/<dataset>/<stage> and continue an interrupted "
                             "run from there")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of the run (Chrome trace JSON) here")
    parser.add_argument("--log-file", type=str, default=None,
                        help="append per-epoch metrics as JSON lines to this file")
    parser.add_argument("--drop-index-column", action="store_true",
                        help="drop the CSV index feature (fixes quirk Q4; breaks numerical compat)")
    parser.add_argument("--honest-eval", action="store_true",
                        help="extract stage-3 embeddings WITHOUT class conditioning (fixes the label leak)")
    parser.add_argument("--loss-backend", choices=("xla", "pallas"), default="xla",
                        help="VAE loss inside every train/eval step: 'pallas' = the hand-written "
                             "CUDA loss kernels, 'xla' = eager torch ops")
    parser.add_argument("--dp-devices", type=int, default=None,
                        help="data parallelism over N ranks: N GPUs over NCCL, or N CPU processes "
                             "over gloo with --device cpu")
    parser.add_argument("--fsdp", action="store_true",
                        help="with --dp-devices: shard the parameters and the optimizer state per "
                             "leaf over the ranks (on CUDA the stage fits then run on the host loop)")
    parser.add_argument("--aot-dir", type=str,
                        default=_build.CLI_DEFAULT_DIR,
                        help="kernel-library cache: the CUDA kernels load from DIR/torch_kernels, "
                             "or are built there once (later processes, and --dp-devices ranks, "
                             "load them); keys hash the sources and flags, so an edited kernel "
                             "is never loaded stale. Pass '' to disable (build/kernels beside "
                             "the package)")
    parser.add_argument("--stage1-wave-ckpt", type=str, default=None,
                        help="seed the wave model from this Lightning stage-1 ckpt and skip its "
                             "pretrain fit; geometry must match --z_dim")
    parser.add_argument("--stage1-time-ckpt", type=str, default=None,
                        help="same for the time/ISI model")
    parser.add_argument("--fit-loop", choices=("device", "host"), default="device",
                        help="stage fits with each train and eval step a CUDA graph replayed on "
                             "the card (eager steps on the CPU; logs replayed after the stage) or "
                             "the per-epoch loop of eager steps (live prints); the same "
                             "trajectory bit for bit")
    parser.add_argument("--progress-every", type=int, default=None,
                        help="device fit loop: print and log every N epochs (the trajectory does "
                             "not change). Default: auto = patience-sized chunks on watched "
                             "stages of more than 10 epochs; 0 = after the stage")
    parser.add_argument("--log-every-step", action="store_true",
                        help="with --log-file/--wandb: also record per-train-batch "
                             "{train_loss_step, train_mse_step, train_kl_step} (the reference's "
                             "per-step self.log granularity); device fit loop only")
    parser.add_argument("--opt-state-dtype", choices=("float32", "bfloat16"), default="float32",
                        help="Adam moment storage dtype; bfloat16 stores the moments in bf16 "
                             "(the update stays float32)")
    parser.add_argument("--optimizer", choices=("adamw", "schedule-free"), default="adamw",
                        help="'schedule-free' = schedule-free AdamW: validation, embeddings and "
                             "ckpts use the averaged x iterate, ckpts omit optimizer_states and "
                             "keep the averaging state in a .sfstate sidecar")
    parser.add_argument("--block-backend", choices=("xla", "bf16", "fused", "pallas"), default="xla",
                        help="backbone blocks of the training steps: 'pallas' = the hand-written "
                             "CUDA block kernels, 'fused' = the same fused math and backward as "
                             "eager torch ops (bf16 activations, no block kernel), 'bf16' = torch "
                             "convolutions and autograd with bf16 block activations (fp32 BN "
                             "statistics), 'xla' = torch convolutions in float32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the data, models and kernels run (default cuda; 'cpu' runs "
                             "the kernels' plain versions)")
    return parser


def jsonl_logger(path: Optional[str], also=()):
    """A log_fn appending one JSON object per record to ``path`` (when
    given) and handing each record to every callable of ``also``."""
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(event: dict):
        if path:
            with open(path, "a") as f:
                f.write(json.dumps({"ts": round(time.time(), 3), **event}) + "\n")
        for sink in also:
            sink(event)

    return log


def config_from_args(args, model_type: str = "unimodal", log_fn=None):
    """The pipeline's config from the parsed flags; raises ValueError for a
    combination the JAX CLI refuses too. The multimodal CLI's flags
    (``--mod1-weight``, ``--mod2-weight``, ``--stage1-joint-ckpt``) keep
    their defaults when the parser has none. ``log_fn`` defaults to the
    ``--log-file`` logger."""
    from hippie_tpu_torch.models.backbones import check_backend
    from hippie_tpu_torch.train.optim import check_optimizer
    from hippie_tpu_torch.train.pipeline import PipelineConfig

    check_backend(args.block_backend)
    opt_state_dtype = None if args.opt_state_dtype == "float32" else args.opt_state_dtype
    check_optimizer(args.optimizer, opt_state_dtype)  # schedule-free with bf16 moments raises
    if args.fsdp and not (args.dp_devices and args.dp_devices > 1):
        raise ValueError("--fsdp requires --dp-devices > 1 (a device mesh)")
    if args.dp_devices and args.dp_devices > 1:
        from hippie_tpu_torch.parallel.mesh import check_devices

        check_devices(args.dp_devices, args.device)
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
        discover_datasets=args.discover_datasets,
        profile_dir=args.profile_dir,
        resume=args.resume,
        drop_index_column=args.drop_index_column,
        honest_eval=args.honest_eval,
        loss_backend=args.loss_backend,
        block_backend=args.block_backend,
        opt_state_dtype=opt_state_dtype,
        optimizer=args.optimizer,
        dp_devices=args.dp_devices,
        fsdp=args.fsdp,
        fit_loop=args.fit_loop,
        progress_every=args.progress_every,
        log_every_step=args.log_every_step,
        device=args.device,
        stage1_wave_ckpt=args.stage1_wave_ckpt,
        stage1_time_ckpt=args.stage1_time_ckpt,
        stage1_joint_ckpt=getattr(args, "stage1_joint_ckpt", None),
        aot_dir=args.aot_dir or None,
        log_fn=log_fn if log_fn is not None else (jsonl_logger(args.log_file) if args.log_file else None),
    )


def save_confmats(results, dataset: str, output_dir: str, wandb=None):
    """The confusion-matrix PNG of each kind, as the JAX CLI writes them (and
    logs them to ``wandb`` when given); one line saying they are skipped when
    matplotlib or seaborn does not import."""
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
        if wandb is not None:
            wandb.log({f"{dataset}_confusion_matrix_{kind}": wandb.Image(fig)})


def run(args, model_type: str = "unimodal"):
    """Run the pipeline of the parsed flags; with ``--wandb`` (and the wandb
    package) log as the JAX CLI does: the run's init, every epoch's record,
    the confusion matrices, the final accuracies, the outputs as artifacts
    (the supervised checkpoints too with ``--upload-model``) and the flags.
    With ``--dp-devices N`` > 1 on N data-parallel ranks; rank 0's results."""
    if args.dp_devices and args.dp_devices > 1:
        config_from_args(args, model_type)  # the flags' refusals before any rank starts
        from hippie_tpu_torch.parallel import mesh as pmesh

        return pmesh.launch(_rank_run, args.dp_devices, args, model_type, device=args.device)[0]
    return _run(args, model_type)


def _rank_run(mesh, args, model_type: str):
    """One data-parallel rank of ``run``: rank 0 alone prints, logs and
    writes (the pipeline leaves the others' files and logs out itself)."""
    return _run(args, model_type, lead=mesh.rank == 0)


def _run(args, model_type: str, lead: bool = True):
    from hippie_tpu_torch.train.pipeline import run_pipeline
    from hippie_tpu_torch.utils import wandb_shim

    if args.wandb and lead:
        wandb_shim.enable()
    wandb = wandb_shim.get()
    on = lead and wandb_shim.is_enabled()
    if on:
        wandb.init(project=args.project, name=f"{args.wandb_tag}{args.dataset}_{model_type}_{args.z_dim}")
    log_fn = jsonl_logger(args.log_file, also=[wandb.log]) if on else None

    results = run_pipeline(config_from_args(args, model_type, log_fn=log_fn))
    if not lead:
        return results
    final_metrics = {}
    for kind, info in results["best"].items():
        final_metrics[f"best_balanced_accuracy_{kind}"] = info["balanced_accuracy"]
        print(f"best_balanced_accuracy_{kind}: {info['balanced_accuracy']:.4f} (k={info['k']})")
    save_confmats(results, args.dataset, args.output_dir, wandb if on else None)
    if on:
        wandb.log(final_metrics)
        for path in results["paths"].values():
            if isinstance(path, str):
                wandb.log_artifact(path, name=os.path.basename(path), type=os.path.basename(path))
        if args.upload_model:
            for m, path in results["supervised_checkpoints"].items():
                wandb.log_artifact(path, name=f"{m}_model_ft_d{args.dataset}_z{args.z_dim}_lr"
                                              f"{args.learning_rate}.pt", type="model")
        wandb.config.update(args)
    return results


if __name__ == "__main__":
    run(build_parser().parse_args())
