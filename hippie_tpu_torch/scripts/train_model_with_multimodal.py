"""Unimodal-or-multimodal 3-stage training CLI of the PyTorch/CUDA port.

    python -m hippie_tpu_torch.scripts.train_model_with_multimodal --model-type multimodal \
        --loss-backend pallas --block-backend pallas

The flags of the JAX package's scripts/train_model_with_multimodal.py: the
port's train_model.py flags (``--device`` among them) plus
``--model-type {unimodal,multimodal}``, ``--mod1-weight``, ``--mod2-weight``
and ``--stage1-joint-ckpt``. ``--model-type multimodal`` trains one joint
two-encoder, two-decoder cVAE on paired (waveform, ISI) batches
(train/pipeline.py:run_multimodal_pipeline) and writes
pretraining_<ds>_joint_embeddings.csv, <ds>_joint_knn.csv,
<ds>_joint_embeddings.csv and the <ds>_joint_model[_supervised].ckpt files.
"""

from __future__ import annotations

from hippie_tpu_torch.scripts.train_model import build_parser, run


def build_multimodal_parser():
    parser = build_parser()
    parser.prog = "python -m hippie_tpu_torch.scripts.train_model_with_multimodal"
    parser.set_defaults(project="HIPPIE")
    parser.add_argument(
        "--model-type", type=str, choices=["unimodal", "multimodal"], default="unimodal",
        help="Whether to use separate models for each modality or a joint model",
    )
    parser.add_argument("--mod1-weight", type=float, default=1.0,
                        help="Weight for the waveform modality loss in multimodal model")
    parser.add_argument("--mod2-weight", type=float, default=1.0,
                        help="Weight for the ISI modality loss in multimodal model")
    parser.add_argument("--stage1-joint-ckpt", type=str, default=None,
                        help="seed the joint model from this Lightning stage-1 ckpt and skip its "
                             "pretrain fit; geometry must match --z_dim")
    return parser


def main(argv=None):
    args = build_multimodal_parser().parse_args(argv)
    return run(args, model_type=args.model_type)


if __name__ == "__main__":
    main()
