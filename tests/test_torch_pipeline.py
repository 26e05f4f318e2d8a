"""The unimodal 3-stage pipeline and its CLI: hippie_tpu_torch against the
JAX package's file contract.

One ``run_unimodal_pipeline(device="cpu")`` on the repo's datasets/ at
num_blocks=(1, 1, 1, 1), one batch per stage (limit_train_batches and
limit_val_batches 1), runs all three stages for both models. Its outputs are
held to hippie_tpu's: the set of file names; each CSV byte for byte equal to
what the JAX export helpers write for the arrays the port exported (the
port's helpers are wrapped to record them); the .ckpt keys equal to
``to_torch_state_dict``'s and the AdamW state in ``adamw_state_to_torch``'s
layout; the ``results`` keys. The CLI's option strings are the JAX CLI's plus
``--device``. ``get_embeddings`` is held to the JAX function from the same
weights (atol 1e-5, as tests/test_torch_train.py's embed forward).
"""

import importlib.util
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from hippie_tpu.evaluate import embeddings as jemb
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu.train import pipeline as jpipe
from hippie_tpu_torch.data import registry as treg
from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import train_model as tcli
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import pipeline as tpipe

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA_ROOT = str(REPO / "datasets")
DS = "cellexplorer-celltype"
BLOCKS = (1, 1, 1, 1)
RESULT_KEYS = {"label_encoder", "neighbor_options", "balanced_accuracy", "best", "paths",
               "num_class_labels", "checkpoints", "supervised_checkpoints", "label_val",
               "label_train", "timings"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's pipeline, with every export's arguments recorded."""
    out = tmp_path_factory.mktemp("pipeline")
    calls = []
    mp = pytest.MonkeyPatch()
    for name in ("export_pretraining_embeddings", "export_knn_csv", "export_embeddings_csv"):
        fn = getattr(tpipe, name)
        mp.setattr(tpipe, name, lambda *a, _fn=fn, _name=name: calls.append((_name, a[1:])) or _fn(*a))
    cfg = tpipe.PipelineConfig(num_blocks=BLOCKS, limit_train_batches=1, limit_val_batches=1,
                               device="cpu", data_root=DATA_ROOT, output_dir=str(out / "out"),
                               checkpoint_dir=str(out / "ckpt"), verbose=False)
    trackers = {}
    try:
        results = tpipe.run_unimodal_pipeline(cfg, trackers=trackers)
    finally:
        mp.undo()
    return cfg, results, trackers, calls, out


def test_pipeline_results(run):
    cfg, results, trackers, _, _ = run
    assert set(results) == RESULT_KEYS
    assert results["neighbor_options"] == list(range(5, 20))
    assert results["label_encoder"].classes_.tolist() == ["PV", "Pyra", "SST", "VIP"]
    assert results["num_class_labels"] == 4
    assert len(results["label_train"]) == 313 and len(results["label_val"]) == 79
    accs = [a for kind in ("waveform", "isi", "joint") for a in results["balanced_accuracy"][kind]]
    assert len(accs) == 45 and np.isfinite(accs).all()
    for kind, best in results["best"].items():
        assert best["confusion_matrix"].shape == (4, 4)
        assert best["confusion_matrix"].sum() == 79 and best["k"] in range(5, 20)
    for stage in ("pretrain", "finetune", "supervised"):
        for m in ("wave", "time"):
            assert results["timings"][f"{stage}_{m}"] > 0
    assert set(trackers) == {"wave", "time", "wave_supervised", "time_supervised"}


def test_pipeline_writes_the_jax_file_set(run):
    cfg, results, _, _, _ = run
    kinds = ("waveform", "isi", "joint")
    want = ({f"pretraining_{DS}_{k}_embeddings.csv" for k in kinds}
            | {f"{DS}_{k}_{what}.csv" for k in kinds for what in ("knn", "embeddings")})
    assert set(os.listdir(cfg.output_dir)) == want
    assert set(os.listdir(cfg.checkpoint_dir)) == {f"{DS}_{m}_model{s}.ckpt" for m in ("wave", "time")
                                                   for s in ("", "_supervised")}
    assert results["checkpoints"] == {m: os.path.join(cfg.checkpoint_dir, f"{DS}_{m}_model.ckpt")
                                      for m in ("wave", "time")}
    assert {os.path.basename(p) for p in results["supervised_checkpoints"].values()} == {
        f"{DS}_wave_model_supervised.ckpt", f"{DS}_time_model_supervised.ckpt"}
    paths = dict(results["paths"])
    assert set(paths.pop("pretraining_embeddings")) == set(kinds)
    assert {os.path.basename(p) for p in paths.values()} == want - {
        f"pretraining_{DS}_{k}_embeddings.csv" for k in kinds}


def test_pipeline_csvs_equal_the_jax_helpers_bytes(run, tmp_path):
    """Every CSV the port wrote, byte for byte, against hippie_tpu's pandas
    export helpers given the same arrays."""
    cfg, results, _, calls, _ = run
    jcfg = jpipe.PipelineConfig(dataset=DS, output_dir=str(tmp_path))
    assert sorted(name for name, _ in calls) == ["export_embeddings_csv"] * 3 + ["export_knn_csv"] * 3 + [
        "export_pretraining_embeddings"]
    compared = 0
    for name, args in calls:
        ref = getattr(jpipe, name)(jcfg, *args)
        if name == "export_pretraining_embeddings":
            pairs = [(os.path.join(cfg.output_dir, os.path.basename(p)), p) for p in ref.values()]
            assert {len(a) for a in args[0].values()} == {int(0.1 * 392)}
        else:
            pairs = [(os.path.join(cfg.output_dir, os.path.basename(ref)), ref)]
        for got, want in pairs:
            assert pathlib.Path(got).read_bytes() == pathlib.Path(want).read_bytes(), got
            compared += 1
    assert compared == 9


def _zeros_like_template(t):
    if isinstance(t, dict):
        return {k: _zeros_like_template(v) for k, v in t.items()}
    return np.zeros(t.shape, t.dtype)


def _jax_template(num_classes):
    seen = []
    cfg = jcvae.CVAEConfig(z_dim=5, output_size=50, class_hidden_dim=5, num_sources=5,
                           num_classes=num_classes, num_blocks=BLOCKS)
    jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), cfg)))
    return [_zeros_like_template(t) for t in seen[0]]


def test_pipeline_ckpts_have_the_jax_layout(run):
    """Each .ckpt: the keys of to_torch_state_dict (5 classes in stages 1-2,
    the training split's 4 in stage 3), one AdamW state per parameter in
    parameter_key_order, the JAX param group; and it reloads into the port
    equal to its tracker's best snapshot."""
    cfg, results, trackers, _, _ = run
    for key, tracker in trackers.items():
        params, bn = _jax_template(4 if "supervised" in key else 5)
        ck = tckpt.load_lightning_ckpt(tracker.path)
        assert list(ck["state_dict"]) == list(jckpt.to_torch_state_dict(params, bn))
        (opt,) = ck["optimizer_states"]
        n = len(jckpt.parameter_key_order(params, bn))
        assert list(opt["state"]) == list(range(n))
        assert opt["param_groups"][0]["params"] == list(range(n))
        assert opt["param_groups"][0]["lr"] in (cfg.learning_rate, cfg.learning_rate / 10)
        assert opt["param_groups"][0]["weight_decay"] == cfg.weight_decay
        for i, k in enumerate(jckpt.parameter_key_order(params, bn)):
            e = opt["state"][i]
            assert isinstance(e["step"], np.ndarray) and e["step"].dtype == np.float32
            assert e["exp_avg"].shape == tuple(ck["state_dict"]["model." + k].shape), k
        sd = tckpt.model_state_from_ckpt(ck)
        for k, v in tracker.best_state_dict.items():
            assert torch.equal(sd[k], v), k


def test_get_embeddings_matches_jax():
    cfg = tcvae.CVAEConfig(z_dim=4, output_size=50, num_sources=5, num_classes=5, num_blocks=BLOCKS)
    wave_m = tcvae.unimodal_cvae_init(cfg, torch.Generator().manual_seed(1), device="cpu")
    time_m = tcvae.unimodal_cvae_init(cfg._replace(output_size=100), torch.Generator().manual_seed(2),
                                      device="cpu")
    r = np.random.default_rng(0)
    wave = r.normal(size=(30, 50)).astype(np.float32)
    isi = r.normal(size=(30, 100)).astype(np.float32)
    source = np.full(30, 3, np.int32)
    labels = r.integers(0, 5, size=30).astype(np.int32)

    def tree(model, out):
        seen = []
        jcfg = jcvae.CVAEConfig(z_dim=4, output_size=out, num_sources=5, num_classes=5, num_blocks=BLOCKS)
        jax.eval_shape(lambda: seen.append(jcvae.unimodal_cvae_init(jax.random.PRNGKey(0), jcfg)))
        return jckpt.from_torch_state_dict(model.state_dict(), *seen[0], prefix="")[:2]

    for cls in (None, labels):
        ref = jemb.get_embeddings(tree(wave_m, 50), tree(time_m, 100), wave, isi, source,
                                  None if cls is None else cls)
        got = temb.get_embeddings(wave_m, time_m, torch.from_numpy(wave), torch.from_numpy(isi),
                                  torch.from_numpy(source).long(),
                                  None if cls is None else torch.from_numpy(cls).long())
        for a, b in zip(got, ref):
            assert isinstance(a, np.ndarray) and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        assert got[2].shape == (30, 8)


def test_seed_from_best_keeps_a_fresh_class_embedding():
    """Quirk Q10: every tensor from the best snapshot but the class
    embedding, whose class count changed; the snapshot is not aliased."""
    cfg = tcvae.CVAEConfig(z_dim=4, num_sources=5, num_classes=5, num_blocks=BLOCKS)
    best = {k: v.clone() for k, v in tcvae.unimodal_cvae_init(
        cfg, torch.Generator().manual_seed(1), device="cpu").state_dict().items()}
    model = tcvae.unimodal_cvae_init(cfg._replace(num_classes=3), torch.Generator().manual_seed(2),
                                     device="cpu")
    fresh = model.class_embedding.weight.detach().clone()
    tpipe.seed_from_best(model, best)
    assert torch.equal(model.class_embedding.weight, fresh)
    for k, v in model.state_dict().items():
        if not k.startswith("class_embedding"):
            assert torch.equal(v, best[k]), k
    with torch.no_grad():
        model.encoder.conv1.weight.add_(1.0)
    assert not torch.equal(model.encoder.conv1.weight, best["encoder.conv1.weight"])


def _jax_parser():
    spec = importlib.util.spec_from_file_location("jax_train_model", REPO / "scripts" / "train_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def test_cli_options_are_the_jax_clis_plus_device():
    ref = {a.dest: a for a in _jax_parser()._actions}
    got = {a.dest: a for a in tcli.build_parser()._actions}
    assert sorted(o for a in got.values() for o in a.option_strings) == sorted(
        [o for a in ref.values() for o in a.option_strings] + ["--device"])
    assert got["device"].default == "cuda"
    # the same defaults and choices, but where the port has one fit loop and no AOT cache
    for dest, a in ref.items():
        if dest in ("help", "aot_dir", "fit_loop"):
            continue
        assert got[dest].default == a.default, dest
        assert got[dest].choices == a.choices, dest
    assert got["fit_loop"].choices == ("host",) and got["fit_loop"].default == "host"
    assert got["aot_dir"].default is None


def test_cli_builds_the_pipeline_config():
    args = tcli.build_parser().parse_args(
        ["--device", "cpu", "--z_dim", "10", "--loss-backend", "pallas", "--block-backend", "pallas",
         "--limit-train-batches", "2", "--finetune-without-labels", "False"])
    cfg = tcli.config_from_args(args)
    assert (cfg.device, cfg.z_dim, cfg.loss_backend, cfg.block_backend) == ("cpu", 10, "pallas", "pallas")
    assert cfg.limit_train_batches == 2.0 and cfg.finetune_without_labels is False
    assert cfg.num_blocks == (2, 2, 2, 2)


@pytest.mark.parametrize("argv", [["--resume"], ["--dp-devices", "2"], ["--fsdp"], ["--aot-dir", "x"],
                                  ["--profile-dir", "x"], ["--dp-devices", "2", "--fsdp"],
                                  ["--progress-every", "0"], ["--wandb", "--resume"],
                                  ["--profile-dir", "x", "--discover-datasets"], ["--discover-datasets"],
                                  ["--progress-every", "5"], ["--log-every-step"],
                                  ["--block-backend", "fused"], ["--block-backend", "bf16"], ["--wandb"]])
def test_cli_raises_on_options_not_ported(argv):
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item"):
        tcli.config_from_args(tcli.build_parser().parse_args(argv))


def test_confusion_matrix_pngs_are_skipped_without_plotting(monkeypatch, capsys, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_seaborn(name, *a, **k):
        if name == "seaborn":
            raise ImportError("No module named 'seaborn'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_seaborn)
    results = {"label_encoder": treg.LabelEncoder.fit(["a", "b"]),
               "best": {"waveform": {"confusion_matrix": np.eye(2, dtype=np.int64), "k": 5}}}
    tcli.save_confmats(results, DS, str(tmp_path))
    assert capsys.readouterr().out.count("skipped") == 1
    assert list(tmp_path.iterdir()) == []
