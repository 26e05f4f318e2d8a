"""The joint (wave + ISI) 3-stage pipeline, ``run_pipeline``, the stage-1
seams and the multimodal CLI: hippie_tpu_torch against the JAX package.

One ``run_pipeline(model_type="multimodal", device="cpu")`` on the repo's
datasets/ at num_blocks=(1, 1, 1, 1), batch 64 (32 in stage 3), one batch
per stage, runs all three stages. Its outputs are held to hippie_tpu's: the
file names and ``results`` keys of hippie_tpu/train/pipeline.py:1297-1334;
each CSV byte for byte equal to what the JAX export helpers write for the
arrays the port exported; the .ckpt keys equal to ``to_torch_state_dict``'s
of the JAX joint model and its AdamW state in ``adamw_state_to_torch``'s
layout over ``parameter_key_order``; ``<ds>_joint_embeddings.csv`` within
1e-5 of the JAX ``embed_multimodal`` on the supervised checkpoint's weights
carried across (the same float32 forward on both sides, as
tests/test_torch_multimodal.py's embed test). The stage-1 seams load no
pool, seed the tracker's best and stage 3, and refuse another geometry;
``run_pipeline`` raises the JAX messages for a seam given to the wrong
pipeline. The multimodal CLI's option strings are the JAX CLI's plus
``--device``.
"""

import csv
import importlib.util
import math
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from hippie_tpu.data import registry as jreg
from hippie_tpu.evaluate import embeddings as jemb
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops import preprocess as jpre
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import pipeline as jpipe
from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import train_model as tcli
from hippie_tpu_torch.scripts import train_model_with_multimodal as tmmcli
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import pipeline as tpipe

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA_ROOT = str(REPO / "datasets")
DS = "cellexplorer-celltype"
BLOCKS = (1, 1, 1, 1)
SMALL = dict(num_blocks=BLOCKS, batch_size=64, supervised_batch_size=32, limit_train_batches=1,
             limit_val_batches=1, device="cpu", data_root=DATA_ROOT, verbose=False)
# hippie_tpu/train/pipeline.py:1297-1334 and :1330
RESULT_KEYS = {"label_encoder", "neighbor_options", "balanced_accuracy", "best", "paths",
               "num_class_labels", "checkpoints", "supervised_checkpoints", "label_val",
               "label_train", "timings"}
OUTPUTS = {f"pretraining_{DS}_joint_embeddings.csv", f"{DS}_joint_knn.csv", f"{DS}_joint_embeddings.csv"}
CKPTS = {f"{DS}_joint_model.ckpt", f"{DS}_joint_model_supervised.ckpt"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's joint pipeline, with every export's arguments recorded."""
    out = tmp_path_factory.mktemp("pipeline_mm")
    calls = []
    mp = pytest.MonkeyPatch()
    for name in ("export_pretraining_embeddings", "export_knn_csv", "export_embeddings_csv"):
        fn = getattr(tpipe, name)
        mp.setattr(tpipe, name, lambda *a, _fn=fn, _name=name: calls.append((_name, a[1:])) or _fn(*a))
    cfg = tpipe.PipelineConfig(model_type="multimodal", output_dir=str(out / "out"),
                               checkpoint_dir=str(out / "ckpt"), **SMALL)
    trackers = {}
    try:
        results = tpipe.run_pipeline(cfg, trackers=trackers)
    finally:
        mp.undo()
    return cfg, results, trackers, calls


def test_joint_pipeline_results(run):
    cfg, results, trackers, _ = run
    assert set(results) == RESULT_KEYS
    assert results["neighbor_options"] == list(range(5, 20))
    assert results["label_encoder"].classes_.tolist() == ["PV", "Pyra", "SST", "VIP"]
    assert results["num_class_labels"] == 4
    assert len(results["label_train"]) == 313 and len(results["label_val"]) == 79
    assert set(results["balanced_accuracy"]) == set(results["best"]) == {"joint"}
    accs = results["balanced_accuracy"]["joint"]
    assert len(accs) == 15 and np.isfinite(accs).all()
    best = results["best"]["joint"]
    assert best["confusion_matrix"].shape == (4, 4) and best["confusion_matrix"].sum() == 79
    assert best["balanced_accuracy"] == max(accs) and best["k"] in range(5, 20)
    assert set(results["timings"]) == {"load_pool", "pretrain_joint", "finetune_joint",
                                       "supervised_joint", "ckpt_save"}
    assert set(trackers) == {"joint", "joint_supervised"}
    assert all(math.isfinite(t.best_val) for t in trackers.values())


def test_joint_pipeline_writes_the_jax_file_set(run):
    cfg, results, _, _ = run
    assert set(os.listdir(cfg.output_dir)) == OUTPUTS
    assert set(os.listdir(cfg.checkpoint_dir)) == CKPTS
    assert results["checkpoints"] == {"joint": os.path.join(cfg.checkpoint_dir, f"{DS}_joint_model.ckpt")}
    assert results["supervised_checkpoints"] == {
        "joint": os.path.join(cfg.checkpoint_dir, f"{DS}_joint_model_supervised.ckpt")}
    paths = dict(results["paths"])
    assert list(paths.pop("pretraining_embeddings")) == ["joint"]
    assert set(paths) == {"joint_knn", "joint_embeddings"}
    assert {os.path.basename(p) for p in paths.values()} == OUTPUTS - {
        f"pretraining_{DS}_joint_embeddings.csv"}


def test_joint_pipeline_csvs_equal_the_jax_helpers_bytes(run, tmp_path):
    """Each CSV the port wrote, byte for byte, against hippie_tpu's pandas
    export helpers given the same arrays. Stage 2 embeds the fine-tune val
    split (392 - 39 rows) with the best model."""
    cfg, _, _, calls = run
    jcfg = jpipe.PipelineConfig(dataset=DS, output_dir=str(tmp_path))
    assert sorted(name for name, _ in calls) == [
        "export_embeddings_csv", "export_knn_csv", "export_pretraining_embeddings"]
    for name, args in calls:
        ref = getattr(jpipe, name)(jcfg, *args)
        if name == "export_pretraining_embeddings":
            assert list(args[0]) == ["joint"] and len(args[0]["joint"]) == 392 - int(0.1 * 392)
            ref = ref["joint"]
        got = os.path.join(cfg.output_dir, os.path.basename(ref))
        assert pathlib.Path(got).read_bytes() == pathlib.Path(ref).read_bytes(), got


def _jax_templates(num_classes):
    """Zeros of the JAX joint model's (params, state) in its init's key order,
    without running it."""
    seen = []
    cfg = jcvae.MultiModalConfig(z_dim=5, num_sources=5, num_classes=num_classes, num_blocks=BLOCKS)
    jax.eval_shape(lambda: seen.append(jcvae.multimodal_cvae_init(jax.random.PRNGKey(0), cfg)))

    def zeros(t):
        return {k: zeros(v) for k, v in t.items()} if isinstance(t, dict) else np.zeros(t.shape, t.dtype)

    return [zeros(t) for t in seen[0]]


def test_joint_ckpts_have_the_jax_layout(run):
    """Each .ckpt: the keys of the JAX joint model's to_torch_state_dict (5
    classes in stages 1-2, 4 in stage 3), one AdamW state per parameter in
    the JAX parameter_key_order, each moment the shape of its parameter; and
    it reloads into the port equal to its tracker's best snapshot."""
    cfg, _, trackers, _ = run
    for key, tracker in trackers.items():
        params, bn = _jax_templates(4 if key == "joint_supervised" else 5)
        ck = tckpt.load_lightning_ckpt(tracker.path)
        assert list(ck["state_dict"]) == list(jckpt.to_torch_state_dict(params, bn))
        (opt,) = ck["optimizer_states"]
        order = jckpt.parameter_key_order(params, bn)
        assert list(opt["state"]) == list(range(len(order)))
        assert opt["param_groups"][0]["params"] == list(range(len(order)))
        assert opt["param_groups"][0]["lr"] in ((cfg.learning_rate, cfg.learning_rate / 10)
                                                if key == "joint" else (cfg.learning_rate / 10,))
        for i, k in enumerate(order):
            e = opt["state"][i]
            assert isinstance(e["step"], np.ndarray) and e["step"].dtype == np.float32
            assert e["exp_avg"].shape == tuple(ck["state_dict"]["model." + k].shape), k
        sd = tckpt.model_state_from_ckpt(ck)
        for k, v in tracker.best_state_dict.items():
            assert torch.equal(sd[k], v), k


def _read_embeddings(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray([[float(v) for v in r[1:-1]] for r in rows[1:]], np.float32)


def test_joint_embeddings_csv_matches_jax_embed(run):
    """<ds>_joint_embeddings.csv against the JAX embed_multimodal of the
    supervised checkpoint's weights on the JAX package's own loading and
    preprocessing, class-conditioned like the reference (atol 1e-5)."""
    cfg, results, trackers, _ = run
    header, got = _read_embeddings(os.path.join(cfg.output_dir, f"{DS}_joint_embeddings.csv"))
    assert header == [""] + [str(j) for j in range(5)] + ["label"]
    ck = tckpt.load_lightning_ckpt(trackers["joint_supervised"].path)
    params, bn, _, skipped = jckpt.from_torch_state_dict(ck["state_dict"], *_jax_templates(4))
    assert not skipped
    wf, isi = jreg.load_raw(DATA_ROOT, DS)
    wave, isi_p = jpre.preprocess_pair(wf, isi)
    labels, _ = jreg.load_supervised_labels(DATA_ROOT, DS)
    source = np.full(len(wf), jreg.DATASET_SOURCE_IDS[DS], np.int32)
    ref = np.asarray(jemb.embed_multimodal(params, bn, wave, isi_p, source, labels.astype(np.int32)))
    assert got.shape == ref.shape == (392, 5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model_type,seam", [("multimodal", "stage1_wave_ckpt"),
                                             ("multimodal", "stage1_time_ckpt"),
                                             ("unimodal", "stage1_joint_ckpt")])
def test_run_pipeline_refuses_a_seam_of_the_other_pipeline(model_type, seam):
    msgs = []
    for pipe in (tpipe, jpipe):
        with pytest.raises(ValueError) as e:
            pipe.run_pipeline(pipe.PipelineConfig(model_type=model_type, **{seam: "x.ckpt"}))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("UNIMODAL" if model_type == "multimodal" else "MULTIMODAL") in msgs[0]


def _stage1_file(tmp_path, name: str, z: int = 5) -> str:
    """A stage-1 checkpoint of the pipeline's geometry (or another z_dim)."""
    gen = torch.Generator().manual_seed({"wave": 1, "time": 2, "joint": 3}[name])
    if name == "joint":
        model = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(z_dim=z, num_blocks=BLOCKS), gen,
                                           device="cpu")
    else:
        model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=z, output_size=50 if name == "wave" else 100,
                                                          num_blocks=BLOCKS), gen, device="cpu")
    path = str(tmp_path / f"stage1_{name}_z{z}.ckpt")
    tckpt.save_lightning_ckpt(path, model.state_dict())
    return path


@pytest.fixture
def no_pool(monkeypatch):
    def refuse(cfg):
        raise AssertionError("the pretraining pool was loaded")

    monkeypatch.setattr(tpipe, "load_pretrain_pool", refuse)


def test_unimodal_seams_skip_the_pool_and_seed_stage_3(tmp_path, no_pool):
    """Both stage-1 checkpoints: no pool and no stage-1 fit; without a
    fine-tune the loaded weights stay the trackers' best (best_val inf, no
    stage-1 file written) and seed stage 3, whose honest embeddings (no
    class conditioning, no supervised epoch) are the loaded models'."""
    paths = {m: _stage1_file(tmp_path, m) for m in ("wave", "time")}
    cfg = tpipe.PipelineConfig(output_dir=str(tmp_path / "out"), checkpoint_dir=str(tmp_path / "ckpt"),
                               stage1_wave_ckpt=paths["wave"], stage1_time_ckpt=paths["time"],
                               finetune_without_labels=False, supervised_max_epochs=0, honest_eval=True,
                               **SMALL)
    trackers = {}
    results = tpipe.run_pipeline(cfg, trackers=trackers)
    assert {"load_stage1_wave", "load_stage1_time"} <= set(results["timings"])
    assert not {"load_pool", "pretrain_wave", "pretrain_time"} & set(results["timings"])
    assert not os.path.exists(results["checkpoints"]["wave"])
    wf, isi = tpipe.registry.load_raw(DATA_ROOT, DS)
    wave, isi_p = tpipe.preprocess.preprocess_pair(wf, isi, device="cpu")
    source = torch.full((len(wf),), 3, dtype=torch.long)
    for m, kind, data in (("wave", "waveform", wave), ("time", "isi", isi_p)):
        loaded = tckpt.model_state_from_ckpt(tckpt.load_lightning_ckpt(paths[m]))
        tk = trackers[m]
        assert tk.best_val == math.inf
        assert all(torch.equal(tk.best_state_dict[k], v) for k, v in loaded.items())
        model = tcvae.unimodal_cvae_init(tpipe.model_config(cfg, m, 5), torch.Generator(), device="cpu")
        model.load_state_dict(loaded)
        _, got = _read_embeddings(os.path.join(cfg.output_dir, f"{DS}_{kind}_embeddings.csv"))
        np.testing.assert_array_equal(got, temb.embed_unimodal(model, data, source).numpy())


def test_joint_seam_skips_the_pool_and_stage_2_takes_over(tmp_path, no_pool):
    """The joint checkpoint: no pool and no stage-1 fit; the fine-tune's
    first val loss improves on the loaded weights' inf and is written."""
    path = _stage1_file(tmp_path, "joint")
    cfg = tpipe.PipelineConfig(model_type="multimodal", output_dir=str(tmp_path / "out"),
                               checkpoint_dir=str(tmp_path / "ckpt"), stage1_joint_ckpt=path,
                               supervised_max_epochs=0, **SMALL)
    trackers = {}
    results = tpipe.run_pipeline(cfg, trackers=trackers)
    assert set(results["timings"]) == {"load_stage1_joint", "finetune_joint", "supervised_joint",
                                       "ckpt_save"}
    tk = trackers["joint"]
    assert math.isfinite(tk.best_val)
    sd = tckpt.model_state_from_ckpt(tckpt.load_lightning_ckpt(tk.path))
    assert all(torch.equal(sd[k], v) for k, v in tk.best_state_dict.items())
    loaded = tckpt.model_state_from_ckpt(tckpt.load_lightning_ckpt(path))
    assert not torch.equal(sd["z_mean.weight"], loaded["z_mean.weight"])  # fine-tuned from it
    assert set(os.listdir(cfg.output_dir)) == OUTPUTS


@pytest.mark.parametrize("bad", ["wave", "time", "joint"])
def test_a_seam_of_another_geometry_raises(tmp_path, no_pool, bad):
    kw = ({"model_type": "multimodal", "stage1_joint_ckpt": _stage1_file(tmp_path, "joint", z=4)}
          if bad == "joint" else
          {f"stage1_{m}_ckpt": _stage1_file(tmp_path, m, z=4 if m == bad else 5) for m in ("wave", "time")})
    cfg = tpipe.PipelineConfig(output_dir=str(tmp_path / "out"), checkpoint_dir=str(tmp_path / "ckpt"),
                               **kw, **SMALL)
    with pytest.raises(ValueError, match=f"--stage1-{bad}-ckpt geometry .* does not match"):
        tpipe.run_pipeline(cfg)


def _jax_multimodal_parser():
    """The parser scripts/train_model_with_multimodal.py builds in main()."""
    spec = importlib.util.spec_from_file_location("jax_train_model_with_multimodal",
                                                  REPO / "scripts" / "train_model_with_multimodal.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen, build = [], mod.build_parser
    mod.build_parser = lambda: seen.append(build()) or seen[-1]
    mod.run = lambda args, model_type: None
    argv, sys.argv = sys.argv, ["train_model_with_multimodal.py"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return seen[0]


def test_multimodal_cli_options_are_the_jax_clis_plus_device():
    ref = {a.dest: a for a in _jax_multimodal_parser()._actions}
    got = {a.dest: a for a in tmmcli.build_multimodal_parser()._actions}
    assert sorted(o for a in got.values() for o in a.option_strings) == sorted(
        [o for a in ref.values() for o in a.option_strings] + ["--device"])
    assert got["device"].default == "cuda"
    for dest, a in ref.items():
        if dest in ("help", "aot_dir", "fit_loop"):  # one fit loop, no AOT cache
            continue
        assert got[dest].default == a.default, dest
        assert got[dest].choices == a.choices, dest
    assert tmmcli.build_multimodal_parser().parse_args([]).project == "HIPPIE"


def test_multimodal_cli_flags_reach_the_config(monkeypatch):
    args = tmmcli.build_multimodal_parser().parse_args(
        ["--model-type", "multimodal", "--beta", "0.5", "--mod1-weight", "2", "--mod2-weight", "0.25",
         "--stage1-joint-ckpt", "j.ckpt", "--device", "cpu", "--loss-backend", "pallas"])
    cfg = tcli.config_from_args(args, args.model_type)
    assert (cfg.model_type, cfg.beta, cfg.mod1_weight, cfg.mod2_weight) == ("multimodal", 0.5, 2.0, 0.25)
    assert (cfg.stage1_joint_ckpt, cfg.device, cfg.loss_backend) == ("j.ckpt", "cpu", "pallas")
    seen = []
    monkeypatch.setattr(tpipe, "run_pipeline", lambda cfg: seen.append(cfg) or {
        "best": {}, "label_encoder": tpipe.registry.LabelEncoder.fit([0])})
    tmmcli.main(["--model-type", "multimodal", "--device", "cpu", "--beta", "2"])
    tcli.run(tcli.build_parser().parse_args(["--stage1-wave-ckpt", "w", "--stage1-time-ckpt", "t",
                                             "--beta", "3"]))
    assert [(c.model_type, c.beta) for c in seen] == [("multimodal", 2.0), ("unimodal", 3.0)]
    assert (seen[1].stage1_wave_ckpt, seen[1].stage1_time_ckpt, seen[1].stage1_joint_ckpt) == ("w", "t", None)
