"""A model's geometry read from its checkpoint, the model rebuilt from it,
and the deployable embedding artifact.

Counterpart of hippie_tpu/export.py. The checkpoint half
(``infer_unimodal_config``, ``infer_multimodal_config``,
``load_model_from_ckpt``) is one policy for every entry point that loads a
Lightning ``.ckpt`` (the inference CLI, the server, k-fold, the pipelines'
stage-1 seams). The geometry comes from the state_dict's own weight shapes,
so it works for the port's checkpoints, the JAX package's and the torch
reference's alike.

The artifact half (``export_embedder``, ``save_artifact``, ``load_artifact``,
``export_from_checkpoint``) serializes the eval-mode, z-scored embedding
forward (evaluate/embeddings.py, class conditioning zeroed) so that a fresh
process can serve it with no model code and no checkpoint parsing. The
container is the JAX package's: a zip holding ``manifest.json`` (geometry,
modality, export metadata, ``torch_version`` where JAX writes
``jax_version``) and the program, here ``model.pt2``, a ``torch.export``
ExportedProgram saved with ``torch.export.save``:

  - its batch dimension is symbolic (``torch.export.Dim``), so one artifact
    serves every request size;
  - the decoder, which the embedding does not read, is removed from the
    graph; its weights stay in the file;
  - it is traced where the model is and stored with its weights on the CPU;
    ``load_artifact`` moves it to the device asked for
    (``torch.export.passes.move_to_device_pass``), which must be one of the
    manifest's ``platforms`` (``cpu`` and/or ``cuda``, the port's
    counterpart of the JAX default ``cpu,tpu``);
  - matmul precision is process state in torch, not part of the graph, so
    ``load_artifact`` applies the manifest's ``precision`` around the
    program: ``"highest"`` runs in full float32 (``nn.functional.full_fp32``,
    the parity contract), ``"default"`` lets cuDNN and cuBLAS use TF32;
  - ``load_artifact``'s call pads the rows to the JAX row buckets and runs
    each bucket as one CUDA graph on the card (``ArtifactCall``,
    evaluate/eval_graph.py), captured under that precision on the bucket's
    first call and replayed after.

A JAX artifact (``model.shlo``, which needs JAX to run) and another
``format_version`` raise a ``ValueError`` that says why.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import warnings
import zipfile
from typing import Optional, Tuple, Union

import torch

from hippie_tpu_torch.evaluate import eval_graph
from hippie_tpu_torch.evaluate.embeddings import zscore_rows
from hippie_tpu_torch.models import cvae
from hippie_tpu_torch.nn.functional import full_fp32
from hippie_tpu_torch.train import checkpoint as ckpt_mod
from hippie_tpu_torch.train import loop

FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")  # devices an artifact of the port can name and run on
PRECISIONS = ("highest", "default")


def _block_counts(state_dict: dict, encoder: str) -> tuple:
    """Blocks per stage from the ``model.<encoder>.layer{i}.{j}.`` key indices."""
    return tuple(len({int(k.split(".")[3]) for k in state_dict
                      if k.startswith(f"model.{encoder}.layer{li}.")}) for li in (1, 2, 3, 4))


def _embeddings(state_dict: dict):
    """(z_dim, num_classes, class_hidden_dim, num_sources)."""
    num_classes, h = (int(x) for x in state_dict["model.class_embedding.weight"].shape)
    return (int(state_dict["model.z_mean.weight"].shape[0]), num_classes, h,
            int(state_dict["model.source_embedding.weight"].shape[0]))


def infer_unimodal_config(state_dict: dict) -> cvae.CVAEConfig:
    """The geometry of a unimodal cVAE from a Lightning state_dict's shapes:
    z_mean [z, z]; the class and source embeddings [n, h]; decoder.linear_out
    [output_size, 64]; the block counts from the encoder's key indices."""
    z_dim, num_classes, h, num_sources = _embeddings(state_dict)
    return cvae.CVAEConfig(
        z_dim=z_dim, output_size=int(state_dict["model.decoder.linear_out.weight"].shape[0]),
        class_hidden_dim=h, num_sources=num_sources, num_classes=num_classes,
        num_blocks=_block_counts(state_dict, "encoder"))


def infer_multimodal_config(state_dict: dict) -> cvae.MultiModalConfig:
    """The geometry of a joint MultiModalCVAE checkpoint (model.py:350-395)."""
    z_dim, num_classes, h, num_sources = _embeddings(state_dict)
    return cvae.MultiModalConfig(
        z_dim=z_dim,
        output_size_wave=int(state_dict["model.decoder_mod1.linear_out.weight"].shape[0]),
        output_size_isi=int(state_dict["model.decoder_mod2.linear_out.weight"].shape[0]),
        class_hidden_dim=h, num_sources=num_sources, num_classes=num_classes,
        num_blocks=_block_counts(state_dict, "encoder_mod1"))


def load_model_from_ckpt(path_or_payload: Union[str, dict], *, multimodal: Optional[bool] = None,
                         fallback_config=None, device="cuda") -> Tuple[torch.nn.Module, tuple]:
    """A ``.ckpt`` (a path or its loaded payload) as ``(model, config)``, the
    model on ``device`` in eval mode.

    The geometry is inferred from the state_dict's shapes; when the keys do
    not allow that, ``fallback_config`` is used, or a ValueError raised if
    none was given. ``multimodal=None`` detects a joint checkpoint from its
    ``model.encoder_mod1.`` keys. The weights load with
    ``checkpoint.load_model_state`` (a class embedding of another class
    count, or none, keeps the model's fresh one, quirk Q10; any other
    mismatch raises, where the JAX loader keeps its initial values).
    """
    payload = (path_or_payload if isinstance(path_or_payload, dict)
               else ckpt_mod.load_lightning_ckpt(path_or_payload))
    sd = payload["state_dict"]
    if multimodal is None:
        multimodal = any(k.startswith("model.encoder_mod1.") for k in sd)
    try:
        cfg = infer_multimodal_config(sd) if multimodal else infer_unimodal_config(sd)
    except (KeyError, ValueError, IndexError) as e:
        if fallback_config is None:
            raise ValueError(
                f"could not infer model geometry from the checkpoint's "
                f"state_dict keys ({e!r}); the checkpoint does not follow "
                f"the reference layout — pass explicit geometry"
            ) from e
        cfg = fallback_config
    init = cvae.multimodal_cvae_init if multimodal else cvae.unimodal_cvae_init
    model = init(cfg, loop.key_generator(0), device=device)
    state = ckpt_mod.model_state_from_ckpt(payload)
    # without its class embedding (the reference's inference heal removes
    # it) the model keeps its fresh one
    drop = () if "class_embedding.weight" in state else ("class_embedding",)
    ckpt_mod.load_model_state(model, state, drop=drop)
    return model.eval(), cfg


# ---------------------------------------------------------------------------
# The deployable embedding artifact
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def matmul_precision(precision: str):
    """``"highest"``: convolutions and matmuls in full float32 on the card
    (``full_fp32``); ``"default"``: TF32 allowed in both. No effect on the
    CPU. Restores the previous settings on exit."""
    if precision == "highest":
        with full_fp32():
            yield
        return
    if precision != "default":
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class _Embedder(torch.nn.Module):
    """The z-scored ``encoded`` of an eval-mode model without class
    conditioning: (data, source) -> [N, z], or (wave, isi, source) for the
    joint model."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *arrays):
        return zscore_rows(self.model(*arrays)[0])


def _embedder(model: torch.nn.Module) -> torch.nn.Module:
    """An eval-mode copy of ``model`` wrapped as ``_Embedder`` (the caller's
    model is not touched)."""
    return _Embedder(copy.deepcopy(model)).eval()


def _check_platforms(platforms) -> tuple:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms {list(platforms)}: an artifact of the port runs on {list(PLATFORMS)} "
                         "(a TPU artifact is the JAX package's, scripts/export_model.py)")
    return platforms


def export_embedder(model: torch.nn.Module, *, input_len: Optional[int] = None,
                    input_lens: Optional[Tuple[int, int]] = None,
                    platforms: Tuple[str, ...] = PLATFORMS, precision: str = "highest") -> bytes:
    """The serialized z-scored embedding forward of ``model`` (a UnimodalCVAE
    with ``input_len``, a MultiModalCVAE with ``input_lens`` = (wave, isi)),
    traced on the model's device with a symbolic batch and stored with its
    weights on the CPU. ``platforms`` and ``precision`` are checked here and
    go into the manifest (``save_artifact``)."""
    _check_platforms(platforms)
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    device = next(model.parameters()).device
    lens = tuple(input_lens) if input_lens is not None else (input_len,)
    # two rows: torch.export specializes a dimension traced at size 1
    args = tuple(torch.zeros(2, n, device=device) for n in lens) + (
        torch.zeros(2, dtype=torch.long, device=device),)
    batch = torch.export.Dim("b", min=1)
    with torch.no_grad():
        ep = torch.export.export(_embedder(model), args,
                                 dynamic_shapes=(tuple({0: batch} for _ in args),))
    ep.graph.eliminate_dead_code()  # the decoder: nothing of the embedding reads it
    ep.graph_module.recompile()
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, "cpu")
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_artifact(path: str, blob: bytes, manifest: dict) -> None:
    manifest = dict(manifest, format_version=FORMAT_VERSION)
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        zf.writestr("model.pt2", blob)


def load_artifact(path: str, device="cuda") -> Tuple["ArtifactCall", dict]:
    """-> (callable, manifest). The callable (``ArtifactCall``) maps (data,
    source), or (wave, isi, source) for a joint artifact, numpy arrays or
    tensors, to the z-scored [N, z] embeddings as a tensor on ``device``,
    running the exported program there under the manifest's precision, as
    one CUDA graph per row bucket on the card."""
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json").decode())
        fv = manifest.get("format_version")
        if fv != FORMAT_VERSION:
            raise ValueError(
                f"artifact {path} has format_version {fv!r}; this build reads "
                f"version {FORMAT_VERSION}. Re-export the model with this "
                "version of hippie_tpu_torch.")
        names = zf.namelist()
        if "model.pt2" not in names:
            if "model.shlo" in names:
                raise ValueError(
                    f"artifact {path} is the JAX package's StableHLO export (model.shlo), which "
                    "needs JAX to run; re-export the checkpoint with python -m "
                    "hippie_tpu_torch.scripts.export_model")
            raise ValueError(f"artifact {path} holds no model.pt2 ({names})")
        blob = zf.read("model.pt2")
    kind = torch.device(device).type
    if kind not in manifest.get("platforms", ()):
        raise ValueError(f"artifact {path} was exported for {manifest.get('platforms')}, not {kind}; "
                         f"re-export it with --platforms including {kind}")
    if manifest.get("torch_version") not in (None, torch.__version__):
        warnings.warn(f"artifact {path} was exported with torch {manifest['torch_version']}, "
                      f"loading under {torch.__version__}; torch.export guarantees limited "
                      "cross-version compatibility", stacklevel=2)
    ep = torch.export.load(io.BytesIO(blob))
    if kind != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, device)
    n_data = 2 if manifest.get("modality") == "multimodal" else 1
    return ArtifactCall(ep.module(), manifest.get("precision", "highest"), device, n_data), manifest


class ArtifactCall(eval_graph.BucketedCall):
    """load_artifact's callable: (data, source), or (wave, isi, source),
    numpy arrays or tensors, -> the z-scored [N, z] embeddings as a tensor
    on the device. The rows are padded to ``eval_graph.bucket_rows`` and
    each bucket is one EvalGraph: on the card a CUDA graph of the exported
    program, captured under the manifest's precision on the bucket's first
    call and replayed after (``space`` counts both); off the card the same
    program eagerly. ``embed`` is the program on device tensors of any row
    count, eagerly, under the precision: the body of these graphs and of the
    server's (scripts/serve_embeddings.py)."""

    def __init__(self, module: torch.nn.Module, precision: str, device, n_data: int):
        self.module, self.precision = module, precision
        super().__init__(self.embed, (torch.float32,) * n_data + (torch.long,), eval_graph.GraphSpace(device))

    def embed(self, *tensors) -> torch.Tensor:
        *data, source = tensors
        with torch.no_grad(), matmul_precision(self.precision):
            return self.module(*(d.float() for d in data), source.long())


def export_from_checkpoint(ckpt_path: str, out_path: str, *,
                           platforms: Tuple[str, ...] = PLATFORMS, precision: str = "highest",
                           device="cuda") -> dict:
    """Lightning .ckpt -> deployable artifact, traced on ``device``; returns
    the manifest. The geometry is inferred from the checkpoint's own tensor
    shapes (``load_model_from_ckpt``)."""
    model, cfg_m = load_model_from_ckpt(ckpt_path, device=device)
    if isinstance(cfg_m, cvae.MultiModalConfig):
        blob = export_embedder(model, input_lens=(cfg_m.output_size_wave, cfg_m.output_size_isi),
                               platforms=platforms, precision=precision)
        geometry = {"modality": "multimodal",
                    "input_lens": [cfg_m.output_size_wave, cfg_m.output_size_isi]}
    else:
        blob = export_embedder(model, input_len=cfg_m.output_size, platforms=platforms,
                               precision=precision)
        geometry = {"modality": "unimodal", "input_len": cfg_m.output_size}
    manifest = {
        **geometry,
        "z_dim": cfg_m.z_dim,
        "num_sources": cfg_m.num_sources,
        "num_classes": cfg_m.num_classes,
        "num_blocks": list(cfg_m.num_blocks),
        "platforms": list(platforms),
        "precision": precision,
        "source_checkpoint": ckpt_path,
        "torch_version": torch.__version__,
    }
    save_artifact(out_path, blob, manifest)
    return manifest
