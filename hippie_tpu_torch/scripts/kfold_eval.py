"""K-fold cross-validated KNN evaluation of trained embeddings.

    python -m hippie_tpu_torch.scripts.kfold_eval --wave-checkpoint W --time-checkpoint T \
        [--refit --refit-epochs 20 [--fold-parallel]]
    python -m hippie_tpu_torch.scripts.kfold_eval --joint-checkpoint J

Counterpart of the JAX package's scripts/kfold_eval.py, with its flags plus
``--device`` (default ``cuda``): embed a labeled dataset with trained
checkpoints (no class conditioning), then report the balanced-accuracy KNN
sweep (k = 5..19 step 2) as mean and std across StratifiedKFold(shuffle,
seed 42) folds (evaluate/kfolds.py). Writes ``<ds>_kfold_knn.csv`` and
``<ds>_kfold_knn_folds.csv`` with the ``csv`` module, byte-equal to the JAX
CLI's pandas files for the same numbers. The KNN sweep runs on each fold's
rows as they are: the JAX CLI pads the folds to one shape with far-away
sentinel rows to share a compiled program, which changes no prediction.

``--refit`` re-runs the fine-tune (and ``--refit-supervised-epochs``) stage
per fold on the fold's train rows only, through the pipeline's
``fit_stage``, and embeds every row with that fold's model; the dual pair
or the joint model, as in the JAX CLI. ``--fold-parallel`` refits the
folds side by side: in groups of ``--fold-parallel-max-replicas`` G folds
(default all), each stage of a group is ONE
``ensemble.device_fit_replica_plans``, whose train and eval steps for the
group's folds are one CUDA graph each on the card, captured once per stage
and group instead of once per fold. Each fold keeps its sequential refit's
plans, stage seeds, models and per-fold stop, so the embeddings and both
CSVs equal the sequential run's bit for bit (ROADMAP Queue 3 decisions 1
and 2: the JAX ``--fold-parallel`` differs from its own sequential refits,
with one key root, bests not gated by a replica's stop and the global
majority; the port keeps the sequential protocol). A modality whose folds'
plans disagree on their batch count, or whose group runs out of device
memory, runs the sequential refits, and says so, as the JAX CLI does.

The dataset's source id is resolved as the JAX CLI resolves it
(``registry.discover_datasets``: ``registry.json`` pins, then the data
root's unknown directories). ``--aot-dir`` (default
``~/.cache/hippie_tpu_aot``, as JAX; ``''``: none) is where the refits' CUDA
kernel libraries load from or are built (ops/_build.py).
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np

from hippie_tpu_torch.ops import _build

KS = tuple(range(5, 20, 2))  # the reference's sweep grid


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m hippie_tpu_torch.scripts.kfold_eval",
        description="k-fold cross-validated KNN evaluation of trained embeddings")
    parser.add_argument("--dataset", type=str, default="cellexplorer-celltype")
    parser.add_argument("--data-root", type=str, default="datasets")
    parser.add_argument("--wave-checkpoint", type=str, default=None)
    parser.add_argument("--time-checkpoint", type=str, default=None)
    parser.add_argument("--joint-checkpoint", type=str, default=None,
                        help="a MultiModalCVAE checkpoint instead of the dual pair")
    parser.add_argument("--folds", type=int, default=10,
                        help="StratifiedKFold splits (reference default 10)")
    parser.add_argument("--output-dir", type=str, default="./kfold_eval")
    parser.add_argument("--drop-index-column", action="store_true",
                        help="exclude the pandas index column (quirk Q4 fix)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--refit", action="store_true",
                        help="per fold, re-run the fine-tune (+ optional supervised) stage from the "
                             "checkpoint weights on the fold's train rows only, embed every row with "
                             "that model, and report embed-once vs refit side by side")
    parser.add_argument("--refit-epochs", type=int, default=20, help="per-fold fine-tune epochs (--refit)")
    parser.add_argument("--refit-supervised-epochs", type=int, default=0,
                        help="per-fold supervised epochs on the fold-train labels after the "
                             "fine-tune (0 = off); embeddings stay without class conditioning")
    parser.add_argument("--refit-lr", type=float, default=1e-4,
                        help="per-fold refit lr (pipeline stage-2/3 contract: learning_rate/10)")
    parser.add_argument("--refit-patience", type=int, default=10,
                        help="early-stopping patience within a fold refit (0 = none)")
    parser.add_argument("--refit-batch-size", type=int, default=512)
    parser.add_argument("--fold-parallel", action="store_true",
                        help="refit the folds side by side: one replica-plan fit per stage (one CUDA "
                             "graph per step kind on the card) instead of one fit per fold; the same "
                             "embeddings as the sequential refits, bit for bit")
    parser.add_argument("--fold-parallel-max-replicas", type=int, default=None, metavar="G",
                        help="with --fold-parallel, refit at most G folds at once (ceil(folds/G) "
                             "groups, run one after another; default all folds at once), for models "
                             "whose replicas do not fit in device memory together")
    parser.add_argument("--aot-dir", type=str,
                        default=_build.CLI_DEFAULT_DIR,
                        help="kernel-library cache shared with the pipeline: the CUDA kernels load "
                             "from DIR/torch_kernels, or are built there once; '' disables")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the embeddings, the refits and the KNN sweep run (default cuda)")
    return parser


def _fold_sweep(emb, labels, folds, device="cuda"):
    """{k: [balanced accuracy of each fold]}. ``emb`` is one [N, D] array
    shared by every fold (embed-once) or one per fold (--refit: fold i's
    rows embedded by the model refit without fold i's validation rows)."""
    from hippie_tpu_torch.evaluate import knn_eval, metrics

    embs = emb if isinstance(emb, list) else [emb] * len(folds)
    per_k = {k: [] for k in KS}
    for (tr, va), e in zip(folds, embs):
        preds = knn_eval.knn_predict_sweep(e[tr], labels[tr], e[va], KS, device=device)
        for k in KS:
            per_k[k].append(metrics.balanced_accuracy_score(labels[va], preds[k]))
    return per_k


def _modality(modality: str):
    """(model-family index ``mi``, fine-tune clip, joint?) of a refit: the
    quirk-Q7 clip for the dual pair, clip 1.0 in every joint stage."""
    joint = modality == "joint"
    return {"wave": 0, "time": 1, "joint": 2}[modality], (1.0 if modality != "wave" else None), joint


def _fit_cfg(args):
    from hippie_tpu_torch.train.pipeline import PipelineConfig

    return PipelineConfig(dataset=args.dataset, data_root=args.data_root,
                          early_stopping_patience=(args.refit_patience or None), seed=args.seed,
                          verbose=False, device=args.device)


def _fold_splits(args, folds):
    """Each fold's (fine-tune train, fine-tune val) rows: a train/val split
    WITHIN its train rows, so early stopping never sees the held-out fold."""
    from hippie_tpu_torch.data.device_data import train_val_split
    from hippie_tpu_torch.train import loop

    out = []
    for fi, (tr, _va) in enumerate(folds):
        tr = np.asarray(tr)
        f_tr, f_va = train_val_split(len(tr), 0.8, loop.key_generator(args.seed, 100 + fi))
        out.append((tr[f_tr], tr[f_va]))
    return out


def _sup_template(args, cfg_sup, fi: int, mi: int):
    """Fold ``fi``'s fresh supervised model (its class embedding stays, Q10)."""
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import loop

    init = cvae.multimodal_cvae_init if isinstance(cfg_sup, cvae.MultiModalConfig) else cvae.unimodal_cvae_init
    return init(cfg_sup, loop.key_generator(args.seed, 500 + 10 * fi + mi), device=args.device)


def _embed(model, arrays, source):
    from hippie_tpu_torch.evaluate import embeddings as emb_mod

    if len(arrays) == 2:
        return emb_mod.embed_multimodal(model, *arrays, source).cpu().numpy()
    return emb_mod.embed_unimodal(model, arrays[0], source).cpu().numpy()


def stage_seed(stage: int, fi: int, mi: int) -> int:
    """Fold ``fi``'s ``fit_stage`` stage seed in a refit stage (1000: the
    fine-tune, 2000: the supervised stage) of model family ``mi``; its fits
    draw from ``--seed`` plus this."""
    return stage + 10 * fi + mi


def _with_state(model, state_dict):
    model.load_state_dict(state_dict)
    return model


def _refit_fold_embeddings(args, arrays, source, labels, folds, model0, cfgm, modality):
    """The sequential refit, one fold after another (the JAX CLI's
    ``_refit_fold_embeddings`` and ``_refit_fold_embeddings_joint``): per
    fold, fine-tune a copy of ``model0`` on the fold's train rows at lr
    ``--refit-lr`` (the pipeline's stage-2 recipe), then, with
    ``--refit-supervised-epochs``, a supervised stage from the fine-tune's
    best minus the class embedding (quirk Q10) on the balanced stream with
    clip 1.0. The unimodal fine-tune hands on its LAST-epoch model, the
    joint one its BEST (each pipeline's stage-2 contract); the supervised
    stage its best. Returns one [N, z] embedding per fold."""
    import torch

    from hippie_tpu_torch.data import sampling
    from hippie_tpu_torch.train import optim, pipeline, step

    mi, clip_ft, joint = _modality(modality)
    fit_cfg = _fit_cfg(args)
    fit = pipeline.fit_multimodal_stage if joint else pipeline.fit_unimodal_stage
    data_kw = {"wave": arrays[0], "isi": arrays[1]} if joint else {"data": arrays[0], "beta": 1.0}
    cfg_sup = cfgm._replace(num_classes=int(len(np.unique(labels))))
    labels_dev = torch.as_tensor(labels, device=args.device).long()
    out = []
    for fi, (ft_tr, ft_va) in enumerate(_fold_splits(args, folds)):
        model = copy.deepcopy(model0)
        ts = step.TrainState(model, optim.make_optimizer(model.parameters(), args.refit_lr, 0.01, clip_ft))
        res = fit(cfg=fit_cfg, ts=ts, **data_kw, source=source, class_=source, train_indices=ft_tr,
                  val_indices=ft_va, batch_size=args.refit_batch_size, max_epochs=args.refit_epochs,
                  use_class_labels=False, shuffle_train=False, stage_seed=stage_seed(1000, fi, mi),
                  lr=args.refit_lr)
        best = res.best_state_dict if res.best_epoch >= 0 else res.state.model.state_dict()
        if joint:  # the joint stage 2 hands on its BEST model
            model = _with_state(model, best)
        if args.refit_supervised_epochs > 0:
            sup = pipeline.seed_from_best(_sup_template(args, cfg_sup, fi, mi), best)
            ts_s = step.TrainState(sup, optim.make_optimizer(sup.parameters(), args.refit_lr, 0.01, 1.0))
            stream = sampling.balanced_indices(labels[ft_tr], seed=args.seed)
            res_s = fit(cfg=fit_cfg, ts=ts_s, **data_kw, source=source, class_=labels_dev,
                        train_indices=ft_tr, val_indices=ft_va, batch_size=args.refit_batch_size,
                        max_epochs=args.refit_supervised_epochs, use_class_labels=True,
                        shuffle_train=False, fixed_train_stream=ft_tr[stream],
                        stage_seed=stage_seed(2000, fi, mi), lr=args.refit_lr)
            model = sup if res_s.best_epoch < 0 else _with_state(sup, res_s.best_state_dict)
        out.append(_embed(model, arrays, source))
    return out


def _stacked_fold_plans(streams, batch_size):
    """Each fold's fixed ``[nb, B]`` plan (``batch_plan`` without shuffle,
    as the sequential refit makes it) stacked to ``[K, nb, B]`` (idx, mask),
    or None when the folds' plans disagree on their batch count (the JAX
    CLI's ``_stacked_fold_plans``)."""
    from hippie_tpu_torch.data.device_data import batch_plan

    plans = [batch_plan(np.asarray(s), batch_size, shuffle=False) for s in streams]
    if len({idx.shape[0] for idx, _ in plans}) != 1:
        return None
    return np.stack([p[0] for p in plans]), np.stack([p[1] for p in plans])


def _refit_fold_embeddings_parallel(args, arrays, source, labels, folds, model0, cfgm, modality):
    """The sequential refit (``_refit_fold_embeddings``) with the folds side
    by side, the JAX CLI's ``_refit_fold_embeddings_parallel``: the folds
    split into groups of ``--fold-parallel-max-replicas``; each group's
    fine-tune is one ``ensemble.device_fit_replica_plans`` over the folds'
    own plans and stage seeds, and with ``--refit-supervised-epochs`` its
    supervised stage another, each fold on its own balanced stream from its
    fine-tune's best. Each fold stops at its own patience, and each model
    hands on what the sequential refit hands on (the dual pair's fine-tune
    its last-epoch model, the joint one its best; the supervised stage its
    best), so every embedding equals the sequential one bit for bit.
    Returns one [N, z] embedding per fold, or None when the folds' plans
    disagree on their batch count."""
    import torch

    from hippie_tpu_torch.data import sampling
    from hippie_tpu_torch.train import ensemble, optim, pipeline, step

    mi, clip_ft, joint = _modality(modality)
    fit_cfg = _fit_cfg(args)
    splits = _fold_splits(args, folds)
    bs = args.refit_batch_size
    plans = [_stacked_fold_plans([tr for tr, _ in splits], bs), _stacked_fold_plans([va for _, va in splits], bs)]
    sup = args.refit_supervised_epochs > 0
    if sup:  # each fold's own balanced stream (Queue 3 decision 2)
        plans.append(_stacked_fold_plans([tr[sampling.balanced_indices(labels[tr], seed=args.seed)]
                                          for tr, _ in splits], bs))
    if any(p is None for p in plans):
        return None
    (t_idx, t_mask), (v_idx, v_mask) = plans[:2]
    batch_step, eval_step = pipeline.stage_steps(fit_cfg, joint)
    cfg_sup = cfgm._replace(num_classes=int(len(np.unique(labels))))
    labels_dev = torch.as_tensor(labels, device=args.device).long()

    def fit(models, group, stage, clip, max_epochs, train_plan, class_, use_class_labels):
        states = [step.TrainState(m, optim.make_optimizer(m.parameters(), args.refit_lr, 0.01, clip))
                  for m in models]
        res = ensemble.device_fit_replica_plans(
            states, batch_step=batch_step, eval_step=eval_step, arrays=arrays, source=source, class_=class_,
            train_idx=train_plan[0][group], train_mask=train_plan[1][group], val_idx=v_idx[group],
            val_mask=v_mask[group], max_epochs=max_epochs, early_stopping_patience=fit_cfg.early_stopping_patience,
            seeds=[args.seed + stage_seed(stage, fi, mi) for fi in range(len(folds))[group]],
            use_class_labels=use_class_labels)
        return [res.best_state_dict[k] if res.best_epoch[k] >= 0 else None for k in range(len(models))]

    group_size = args.fold_parallel_max_replicas or len(folds)
    out = []
    for lo in range(0, len(folds), group_size):
        group = slice(lo, min(lo + group_size, len(folds)))
        models = [copy.deepcopy(model0) for _ in range(len(folds))[group]]
        bests = [b if b is not None else m.state_dict()
                 for m, b in zip(models, fit(models, group, 1000, clip_ft, args.refit_epochs, (t_idx, t_mask),
                                             source, False))]
        if joint:  # the joint stage 2 hands on its BEST model
            models = [_with_state(m, b) for m, b in zip(models, bests)]
        if sup:
            sups = [pipeline.seed_from_best(_sup_template(args, cfg_sup, fi, mi), b)
                    for fi, b in zip(range(len(folds))[group], bests)]
            sup_bests = fit(sups, group, 2000, 1.0, args.refit_supervised_epochs, plans[2], labels_dev, True)
            models = [m if b is None else _with_state(m, b) for m, b in zip(sups, sup_bests)]
        out += [_embed(m, arrays, source) for m in models]
    return out


def _refit_or_fall_back(args, arrays, source, labels, folds, model0, cfgm, modality):
    """``--fold-parallel``'s refit of one modality, or the sequential one
    (without the flag, or after the JAX CLI's two fallbacks, each printed:
    the folds' plans disagree on their batch count; the group's replicas
    run out of device memory)."""
    import torch

    if args.fold_parallel:
        out_of_memory = False
        try:
            embs = _refit_fold_embeddings_parallel(args, arrays, source, labels, folds, model0, cfgm, modality)
        except torch.OutOfMemoryError:
            embs, out_of_memory = None, True
        if embs is not None:
            return embs
        if out_of_memory:
            torch.cuda.empty_cache()  # what the failed group held
            print(f"fold-parallel: {modality} replicas exceed device memory (CUDA out of memory); retry with "
                  "--fold-parallel-max-replicas, falling back to sequential refits")
        else:
            print(f"fold-parallel: {modality} fold plan shapes diverge; falling back to sequential refits")
    return _refit_fold_embeddings(args, arrays, source, labels, folds, model0, cfgm, modality)


def write_rows_csv(path: str, rows):
    """``pd.DataFrame(rows).to_csv(path, index=False)``'s bytes for rows of
    str, int and float values (data/registry.py:write_csv)."""
    from hippie_tpu_torch.data.registry import write_csv

    header = list(rows[0]) if rows else []
    write_csv(path, header, ([r[h] for h in header] for r in rows))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.joint_checkpoint is None and (args.wave_checkpoint is None or args.time_checkpoint is None):
        build_parser().error("provide --wave-checkpoint and --time-checkpoint, or --joint-checkpoint")
    import torch

    from hippie_tpu_torch import export
    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.evaluate.kfolds import stratified_kfold_indices
    from hippie_tpu_torch.ops import preprocess

    _build.set_default_dir(args.aot_dir or None)

    os.makedirs(args.output_dir, exist_ok=True)
    wf, isi = registry.load_raw(args.data_root, args.dataset, drop_index_column=args.drop_index_column)
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=args.device)
    labels, _le = registry.load_supervised_labels(args.data_root, args.dataset)
    labels = np.asarray(labels)
    num_classes = int(len(np.unique(labels)))
    smallest = int(np.bincount(labels).min())
    folds = [(tr, va) for tr, va in stratified_kfold_indices(labels, args.folds, seed=args.seed) if len(va)]
    print(f"{args.dataset}: {len(labels)} rows, {num_classes} classes (smallest {smallest}), "
          f"{len(folds)} folds")
    # the dataset's source id as training resolved it: registry.json pins and
    # the data root's directories (a custom dataset's persisted id)
    registry.discover_datasets(args.data_root)
    src_id = registry.DATASET_SOURCE_IDS.get(args.dataset, 0)

    if args.joint_checkpoint is not None:
        models = {"joint": export.load_model_from_ckpt(args.joint_checkpoint, multimodal=True,
                                                       device=args.device)}
    else:
        models = {m: export.load_model_from_ckpt(p, multimodal=False, device=args.device)
                  for m, p in (("wave", args.wave_checkpoint), ("time", args.time_checkpoint))}
    cfg = next(iter(models.values()))[1]
    if src_id >= cfg.num_sources:
        print(f"WARNING: source id {src_id} for {args.dataset} exceeds the model's source-embedding "
              f"table ({cfg.num_sources}); using {src_id % cfg.num_sources} (the inference CLI's "
              f"convention)")
        src_id %= cfg.num_sources
    source = torch.full((len(labels),), src_id, dtype=torch.long, device=args.device)
    inputs = {"joint": (wave, isi_p), "wave": (wave,), "time": (isi_p,)}
    kinds = {}
    if args.joint_checkpoint is not None:
        kinds["joint"] = _embed(models["joint"][0], inputs["joint"], source)
    else:
        kinds["waveform"] = _embed(models["wave"][0], inputs["wave"], source)
        kinds["isi"] = _embed(models["time"][0], inputs["time"], source)
        kinds["joint"] = np.hstack([kinds["waveform"], kinds["isi"]])
    print(f"model geometry: z_dim={cfg.z_dim}, num_sources={cfg.num_sources}")

    modes = {"embed_once": kinds}
    if args.refit:
        print(f"refitting per fold: {args.refit_epochs} fine-tune"
              + (f" + {args.refit_supervised_epochs} supervised" if args.refit_supervised_epochs else "")
              + " epochs")

        def refit(modality):
            model0, cfgm = models[modality]
            return _refit_or_fall_back(args, inputs[modality], source, labels, folds, model0, cfgm, modality)

        if args.joint_checkpoint is not None:
            modes["refit"] = {"joint": refit("joint")}
        else:
            w_embs, t_embs = refit("wave"), refit("time")
            modes["refit"] = {"waveform": w_embs, "isi": t_embs,
                              "joint": [np.hstack([w, t]) for w, t in zip(w_embs, t_embs)]}

    rows, fold_rows, best_by = [], [], {}
    for mode, mode_kinds in modes.items():
        for kind, emb in mode_kinds.items():
            per_k = _fold_sweep(emb, labels, folds, device=args.device)
            best_k = max(KS, key=lambda k: float(np.mean(per_k[k])))
            best_by[(mode, kind)] = (float(np.mean(per_k[best_k])), float(np.std(per_k[best_k])), best_k)
            for k in KS:
                accs = per_k[k]
                rows.append({"mode": mode, "kind": kind, "k": k,
                             "mean_balanced_accuracy": float(np.mean(accs)),
                             "std_balanced_accuracy": float(np.std(accs)), "folds": len(accs)})
                fold_rows.extend({"mode": mode, "kind": kind, "k": k, "fold": fi,
                                  "balanced_accuracy": float(a)} for fi, a in enumerate(accs))
    for kind in kinds:
        m, s, bk = best_by[("embed_once", kind)]
        line = f"{kind}: embed-once {m:.4f} ± {s:.4f} (k={bk})"
        if ("refit", kind) in best_by:
            rm, rs, rbk = best_by[("refit", kind)]
            line += f" | refit {rm:.4f} ± {rs:.4f} (k={rbk}) | leakage delta {m - rm:+.4f}"
        print(line)
    out_path = os.path.join(args.output_dir, f"{args.dataset}_kfold_knn.csv")
    write_rows_csv(out_path, rows)
    # per-fold accuracies too: paired-fold comparisons between recipes need them
    write_rows_csv(os.path.join(args.output_dir, f"{args.dataset}_kfold_knn_folds.csv"), fold_rows)
    print(f"saved {out_path}")
    return modes


if __name__ == "__main__":
    main()
