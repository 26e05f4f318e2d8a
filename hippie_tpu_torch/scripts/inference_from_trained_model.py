"""Inference CLI of the PyTorch/CUDA port: embed a dataset with trained models.

    python -m hippie_tpu_torch.scripts.inference_from_trained_model --dataset cellexplorer-celltype \
        --wave-checkpoint W.ckpt --time-checkpoint T.ckpt [--cluster 4 --cluster-method gmm]

The flags and output files of the JAX package's
scripts/inference_from_trained_model.py, plus ``--device`` (default
``cuda``; ``--device cpu`` runs on the host). It loads dual wave/time
checkpoints, or one joint ``--joint-checkpoint``, with the geometry read
from the checkpoint (export.py), the flags as the fallback, and writes
<output-dir>/<ds>_{waveform,isi,joint}_embeddings.csv (no index column; the
embedding columns, ``label`` and ``label_name``) in the bytes pandas
writes. ``--cluster N`` also clusters the joint embeddings on the device
(``--cluster-method kmeans|gmm``) into <ds>_joint_clusters.csv. The 2-D
plots use a PCA projection when umap-learn is absent; without matplotlib
they are skipped, with one line saying so.

Labels come from the metadata ``label`` column (typed as pandas types it:
int, float, else strings), else dummy zeros named ``unknown``.
``label_name`` indexes the labels in their order of first appearance with
each label's integer value, or is the label itself where that fails (quirk
Q12); the source passed to the models is ``label code % num_sources``, as
in the JAX CLI.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.inference_from_trained_model")
    parser.add_argument("--z_dim", type=int, default=64, required=False,
                        help="Dimensionality of the latent space")
    parser.add_argument("--dataset", type=str, default="cellexplorer-celltype",
                        help="Dataset to perform inference on")
    parser.add_argument("--wave-checkpoint", type=str, default=None,
                        help="Path to the waveform model checkpoint")
    parser.add_argument("--time-checkpoint", type=str, default=None,
                        help="Path to the time model checkpoint")
    parser.add_argument("--joint-checkpoint", type=str, default=None,
                        help="Path to a joint MultiModalCVAE checkpoint (instead of the dual "
                             "wave/time checkpoints); exports joint embeddings only")
    parser.add_argument("--output-dir", type=str, default="./embeddings",
                        help="Directory to save embeddings and visualizations")
    parser.add_argument("--data-root", type=str, default="datasets")
    parser.add_argument("--num-sources", type=int, default=5)
    parser.add_argument("--cluster", type=int, default=0,
                        help="If >0, also cluster the joint embeddings on device with this many clusters")
    parser.add_argument("--cluster-method", type=str, choices=["kmeans", "gmm"], default="kmeans",
                        help="On-device clustering algorithm for --cluster")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the models run (default cuda; 'cpu' runs on the host)")
    return parser


def first_appearance(values: np.ndarray) -> np.ndarray:
    """The distinct values in their order of first appearance (pd.unique)."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def read_labels(data_root: str, dataset: str, n: int):
    """(labels, label_names): the metadata ``label`` column and its distinct
    values by first appearance, or n zeros and ["unknown"]."""
    from hippie_tpu_torch.data import registry

    meta = registry.load_metadata(data_root, dataset)
    if meta and "label" in meta[0]:
        labels = registry.column_values([r.get("label", "") for r in meta])
        label_names = first_appearance(labels)
        print(f"Found {len(label_names)} unique labels: {label_names}")
        return labels, label_names
    print("No labels found, using dummy labels")
    return np.zeros(n, dtype=np.int64), ["unknown"]


def label_name_column(labels: np.ndarray, label_names) -> list:
    """Each label's name: ``label_names[int(label)]``, or the labels as
    strings when any of them is not such an index (quirk Q12)."""
    try:
        return [np.asarray(label_names)[int(i)] for i in labels]
    except (ValueError, IndexError, TypeError):
        return list(np.asarray(labels).astype(str))


def load_weights(model, sd: dict, num_classes: int, model_name: str):
    """Load a Lightning state_dict into ``model`` as the JAX CLI does: a class
    embedding of another class count is dropped (the reference's heal), keys
    the model lacks are skipped with a warning, and the model's keys the
    checkpoint lacks keep their initial values. A misshapen tensor raises."""
    state = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    ce = state.get("class_embedding.weight")
    if ce is not None and ce.shape[0] != num_classes:
        print(f"Warning: Class embedding size mismatch in {model_name} model. Removing from checkpoint.")
        del state["class_embedding.weight"]
    own = model.state_dict()
    skipped = [k for k in state if k not in own]
    model.load_state_dict({k: v for k, v in state.items() if k in own}, strict=False)
    if skipped:
        print(f"Warning: {len(skipped)} checkpoint keys did not match the "
              f"{model_name} model architecture and were skipped (e.g. {skipped[0]}); "
              f"check --z_dim and the model config.")
    return model.eval()


def load_models(args, num_classes: int) -> dict:
    """{"joint": model} or {"wave": model, "time": model} on ``args.device``."""
    from hippie_tpu_torch import export
    from hippie_tpu_torch.models import cvae
    from hippie_tpu_torch.train import checkpoint as ckpt_mod
    from hippie_tpu_torch.train import loop

    joint = args.joint_checkpoint is not None
    paths = {"joint": args.joint_checkpoint} if joint else {
        "wave": args.wave_checkpoint, "time": args.time_checkpoint}
    sds = {name: ckpt_mod.load_lightning_ckpt(p)["state_dict"] for name, p in paths.items()}
    # the geometry of the checkpoint (of the wave one for a dual pair), else the flags'
    geometry = dict(z_dim=args.z_dim, num_sources=args.num_sources, class_hidden_dim=5,
                    num_blocks=(2, 2, 2, 2))
    try:
        base = (export.infer_multimodal_config if joint else export.infer_unimodal_config)(
            sds["joint" if joint else "wave"])
        geometry = {k: getattr(base, k) for k in geometry}
        print(f"Model geometry from checkpoint: z_dim={base.z_dim}, "
              f"num_sources={base.num_sources}, num_blocks={list(base.num_blocks)}")
    except (KeyError, ValueError, IndexError):
        pass  # non-standard keys: trust the flags
    models = {}
    for name, sd in sds.items():
        if joint:
            model = cvae.multimodal_cvae_init(cvae.MultiModalConfig(num_classes=num_classes, **geometry),
                                              loop.key_generator(0), device=args.device)
        else:
            cfg = cvae.CVAEConfig(output_size=50 if name == "wave" else 100, num_classes=num_classes,
                                  **geometry)
            model = cvae.unimodal_cvae_init(cfg, loop.key_generator(0), device=args.device)
        models[name] = load_weights(model, sd, num_classes, name)
    return models


def save_plots(args, kinds, lab_codes, labels):
    """The 2-D projection PNG of each kind and, with several kinds and
    labels, the comparison figure: UMAP when umap-learn imports, else PCA."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"skipped the 2-D visualization PNGs ({e})")
        return
    try:
        import umap  # noqa: F401

        have_umap = True
    except ImportError:
        have_umap = False
        print("umap-learn not installed; falling back to PCA projections")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    projections = {}  # kind -> (points, method); the comparison figure reuses them

    def project_2d(embeddings, kind):
        if kind not in projections:
            if have_umap:
                projections[kind] = umap.UMAP(random_state=42).fit_transform(embeddings), "UMAP"
            else:
                x = np.asarray(embeddings, np.float64)
                x = x - x.mean(axis=0)
                _, _, vt = np.linalg.svd(x, full_matrices=False)
                projections[kind] = x @ vt[:2].T, "PCA"
        return projections[kind]

    print("Generating 2-D visualizations...")
    for kind, arr in kinds:
        u, method = project_2d(arr, kind)
        plt.figure(figsize=(10, 8))
        if len(np.unique(lab_codes)) > 1:
            sc = plt.scatter(u[:, 0], u[:, 1], c=lab_codes, cmap="tab10", alpha=0.7, s=10)
            plt.colorbar(sc, label="Label")
        else:
            plt.scatter(u[:, 0], u[:, 1], alpha=0.7, s=10)
        plt.title(f"{args.dataset} {kind} embeddings")
        plt.xlabel(f"{method} 1")
        plt.ylabel(f"{method} 2")
        plt.tight_layout()
        out_path = os.path.join(args.output_dir, f"{args.dataset}_{kind}_umap.png")
        plt.savefig(out_path, dpi=300, bbox_inches="tight")
        plt.close()
        print(f"Saved {kind} visualization to {out_path}")

    if len(np.unique(labels)) > 1 and len(kinds) > 1:
        print("Generating comparison plots...")
        fig, axs = plt.subplots(1, len(kinds), figsize=(6 * len(kinds), 6), squeeze=False)
        for ax, (kind, arr) in zip(axs[0], kinds):
            u, method = project_2d(arr, kind)
            sc = ax.scatter(u[:, 0], u[:, 1], c=lab_codes, cmap="tab10", alpha=0.7, s=10)
            ax.set_title(f"{kind} embeddings")
            ax.set_xlabel(f"{method} 1")
            ax.set_ylabel(f"{method} 2")
        fig.colorbar(sc, ax=axs[0], label="Label")
        out_path = os.path.join(args.output_dir, f"{args.dataset}_comparison_umap.png")
        plt.savefig(out_path, dpi=300, bbox_inches="tight")
        plt.close()
        print(f"Saved comparison visualization to {out_path}")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.joint_checkpoint is None and (args.wave_checkpoint is None or args.time_checkpoint is None):
        parser.error("provide --wave-checkpoint and --time-checkpoint, or --joint-checkpoint")

    import torch

    from hippie_tpu_torch.data import registry
    from hippie_tpu_torch.data.registry import write_csv
    from hippie_tpu_torch.evaluate import embeddings as emb
    from hippie_tpu_torch.ops import preprocess

    os.makedirs(args.output_dir, exist_ok=True)
    print(f"Loading dataset: {args.dataset}")
    wf, isi = registry.load_raw(args.data_root, args.dataset, dropna=True)
    wave, isi_p = preprocess.preprocess_pair(wf, isi, device=args.device)
    labels, label_names = read_labels(args.data_root, args.dataset, wf.shape[0])
    num_classes = len(np.unique(labels))

    print("Loading models from checkpoints...")
    try:
        models = load_models(args, num_classes)
        print("Models loaded successfully")
    except Exception as e:
        print(f"Error loading models: {e}")
        sys.exit(1)

    # The reference passes the labels through get_embeddings, where they act
    # as *source* labels (scripts/utils.py:79); non-integer labels (quirk
    # Q12) are encoded to integer codes first.
    try:
        lab_codes = labels.astype(np.int64)
    except (ValueError, TypeError):
        lab_codes = registry.LabelEncoder.fit(labels).transform(labels)
    num_sources = models["joint" if "joint" in models else "wave"].source_embedding.num_embeddings
    source = torch.as_tensor(lab_codes % num_sources, device=args.device).long()

    print("Extracting embeddings...")
    if "joint" in models:
        joint = emb.embed_multimodal(models["joint"], wave, isi_p, source)
        kinds = [("joint", joint.cpu().numpy())]
    else:
        wave_emb, isi_emb, joint_np = emb.get_embeddings(models["wave"], models["time"], wave, isi_p, source)
        joint = torch.as_tensor(joint_np, device=args.device)
        kinds = [("waveform", wave_emb), ("isi", isi_emb), ("joint", joint_np)]

    print("Saving embeddings...")
    names = label_name_column(labels, label_names)
    for kind, arr in kinds:
        out_path = os.path.join(args.output_dir, f"{args.dataset}_{kind}_embeddings.csv")
        write_csv(out_path, [str(j) for j in range(arr.shape[1])] + ["label", "label_name"],
                  ([*arr[i], labels[i], names[i]] for i in range(len(arr))))
        print(f"Saved {kind} embeddings to {out_path}")

    if args.cluster > 0:
        from hippie_tpu_torch.ops import clustering

        if args.cluster_method == "gmm":
            assign, _, _, _, ll = clustering.gmm(joint, args.cluster, seed=args.seed)
            detail = f"log-likelihood={float(ll):.4f}"
        else:
            assign, _, inertia = clustering.kmeans(joint, args.cluster, seed=args.seed)
            detail = f"inertia={float(inertia):.4f}"
        out_path = os.path.join(args.output_dir, f"{args.dataset}_joint_clusters.csv")
        write_csv(out_path, ["cluster", "label"], zip(assign.cpu().numpy(), labels))
        print(f"Saved {args.cluster_method} clusters (k={args.cluster}, {detail}) to {out_path}")

    save_plots(args, kinds, lab_codes, labels)
    print("Inference completed successfully!")


if __name__ == "__main__":
    main()
