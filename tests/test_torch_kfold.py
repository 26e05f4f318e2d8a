"""k-fold evaluation (hippie_tpu_torch/evaluate/kfolds.py,
scripts/kfold_eval.py) on the CPU at num_blocks=(1, 1, 1, 1), z=4.

The folds equal the JAX package's; the CSV writer gives pandas' bytes for
the same rows; the port's embed-once CLI prints the JAX CLI's results and
writes its files byte for byte when both embed alike; the refit CLI with
--fold-parallel gives the sequential refits' embeddings bit for bit, fold
by fold, and ROADMAP Queue 3's decisions 1 and 2 hold: a replica of the
replica-plan fit stops at its own patience with its own best, and each
fold's supervised stream oversamples to its own majority class.
"""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hippie_tpu.evaluate import kfolds as jkfolds
from hippie_tpu_torch.data import registry, synth
from hippie_tpu_torch.data.sampling import balanced_indices
from hippie_tpu_torch.evaluate import kfolds as tkfolds
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import kfold_eval as tkf
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import ensemble as tens
from hippie_tpu_torch.train import optim as toptim
from hippie_tpu_torch.train import step as tstep

torch.set_num_threads(1)

NB = (1, 1, 1, 1)


@pytest.fixture(autouse=True)
def _registries():
    """kfold_eval registers a custom dataset in both packages' registries
    (discover_datasets): restore them, so later tests in the process build
    models with the built-in source count."""
    from hippie_tpu.data import registry as jregistry

    saved = [(m, dict(m.DATASET_SOURCE_IDS), m.NUM_SOURCES) for m in (registry, jregistry)]
    yield
    for m, ids, n in saved:
        m.DATASET_SOURCE_IDS.clear()
        m.DATASET_SOURCE_IDS.update(ids)
        m.NUM_SOURCES = n


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """A 48-row, 3-class dataset and dual and joint checkpoints (z=4)."""
    tmp = tmp_path_factory.mktemp("kfold")
    root = str(tmp / "data")
    synth.make_dataset(root, "kf-rig", n=48, num_classes=3, seed=3)
    ckpts = {}
    for name, out, seed in (("wave", 50, 0), ("time", 100, 1)):
        m = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=4, output_size=out, num_sources=3, num_classes=3,
                                                      num_blocks=NB), torch.Generator().manual_seed(seed),
                                     device="cpu")
        ckpts[name] = str(tmp / f"{name}.ckpt")
        tckpt.save_lightning_ckpt(ckpts[name], m.state_dict())
    mj = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(z_dim=4, num_sources=3, num_classes=3, num_blocks=NB),
                                    torch.Generator().manual_seed(2), device="cpu")
    ckpts["joint"] = str(tmp / "joint.ckpt")
    tckpt.save_lightning_ckpt(ckpts["joint"], mj.state_dict())
    return tmp, root, ckpts


@pytest.mark.parametrize("n,classes,splits,seed", [(200, 4, 10, 42), (48, 3, 5, 7), (31, 2, 3, 0), (10, 5, 10, 42)])
def test_folds_equal_jax(n, classes, splits, seed):
    labels = np.random.default_rng(n).integers(0, classes, size=n)
    got = tkfolds.stratified_kfold_indices(labels, splits, seed=seed)
    want = jkfolds.stratified_kfold_indices(labels, splits, seed=seed)
    assert len(got) == len(want) == splits
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("celltypes", [False, True])
def test_generate_kfolds_equals_jax(rig, celltypes, tmp_path):
    _, root, _ = rig
    if celltypes:  # the reference's celltypes.csv, an index column and string labels
        root = str(tmp_path)
        synth.make_dataset(root, "kf-rig", n=48, num_classes=3, seed=3)
        names = np.random.default_rng(0).choice(["pyr", "int", "unk"], size=48)
        pd.DataFrame({"celltype": names}).to_csv(os.path.join(root, "kf-rig", "celltypes.csv"))
    got = tkfolds.generate_kfolds("kf-rig", data_root=root, n_splits=4)
    want = jkfolds.generate_kfolds("kf-rig", data_root=root, n_splits=4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g[:6], w[:6]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g[6].classes_, w[6].classes_)


def test_discover_datasets_equals_jax(tmp_path):
    """Pins of registry.json first, then the unknown directories in sorted
    order, persisted; the same ids and the same file as the JAX registry."""
    from hippie_tpu.data import registry as jregistry

    for side in ("jax", "port"):
        root = tmp_path / side
        for name in ("zeta-rig", "alpha-rig", "cellexplorer-celltype"):
            synth.make_dataset(str(root), name, n=4)
        (root / "registry.json").write_text('{"zeta-rig": 9, "absent-rig": 7}')
    got = registry.discover_datasets(str(tmp_path / "port"))
    want = jregistry.discover_datasets(str(tmp_path / "jax"))
    assert got == want == ["absent-rig", "alpha-rig", "zeta-rig"]
    assert {n: registry.DATASET_SOURCE_IDS[n] for n in got} == {n: jregistry.DATASET_SOURCE_IDS[n] for n in got}
    assert registry.NUM_SOURCES == jregistry.NUM_SOURCES == 11
    assert (tmp_path / "port" / "registry.json").read_text() == (tmp_path / "jax" / "registry.json").read_text()
    assert registry.discover_datasets(str(tmp_path / "port")) == []
    with pytest.raises(ValueError, match="conflicting"):
        registry.register_dataset("alpha-rig", 1)


def test_rows_csv_is_pandas_bytes(tmp_path):
    r = np.random.default_rng(0)
    rows = [{"mode": m, "kind": k, "k": kk, "mean_balanced_accuracy": float(r.random()),
             "std_balanced_accuracy": float(r.random()) if kk != 7 else 0.0, "folds": 5}
            for m in ("embed_once", "refit") for k in ("waveform", "joint") for kk in tkf.KS]
    rows[3]["mean_balanced_accuracy"] = 1.0
    rows[4]["mean_balanced_accuracy"] = 1 / 3
    fold_rows = [{"mode": "refit", "kind": "isi", "k": 5, "fold": f, "balanced_accuracy": float(a)}
                 for f, a in enumerate(r.random(5))]
    for rs in (rows, fold_rows):
        tkf.write_rows_csv(str(tmp_path / "port.csv"), rs)
        pd.DataFrame(rs).to_csv(tmp_path / "jax.csv", index=False)
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def _jax_cli():
    spec = importlib.util.spec_from_file_location("kfold_eval_jax", "scripts/kfold_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_embed_once_cli_writes_the_jax_files(rig, monkeypatch, capsys):
    """Both CLIs on the same checkpoints, with the same embeddings (drawn with
    numpy per modality, in place of each package's embed call: two
    frameworks' float32 embeddings of these untrained models sit within
    rounding of KNN ties): the same printed results and byte-equal CSVs."""
    import hippie_tpu.evaluate.embeddings as jemb

    tmp, root, ckpts = rig
    labels = registry.load_supervised_labels(root, "kf-rig")[0]
    r = np.random.default_rng(4)
    fixed = {w: (r.normal(size=(48, 4)) + 1.5 * np.eye(4)[labels]).astype(np.float32)
             for w in (50, 100)}
    monkeypatch.setattr(tkf, "_embed", lambda model, arrays, source: fixed[arrays[0].shape[1]])
    monkeypatch.setattr(jemb, "embed_unimodal", lambda p, s, data, source: fixed[data.shape[1]])
    flags = ["--dataset", "kf-rig", "--data-root", root, "--wave-checkpoint", ckpts["wave"],
             "--time-checkpoint", ckpts["time"], "--folds", "4"]
    tkf.main(flags + ["--output-dir", str(tmp / "port"), "--device", "cpu"])
    port_said = capsys.readouterr().out
    _jax_cli().main(flags + ["--output-dir", str(tmp / "jax"), "--aot-dir", ""])
    jax_said = capsys.readouterr().out
    assert "z_dim=4" in port_said and "4 folds" in port_said
    assert port_said.splitlines()[:-1] == jax_said.splitlines()[:-1]  # all but the saved path
    for name in ("kf-rig_kfold_knn.csv", "kf-rig_kfold_knn_folds.csv"):
        assert (tmp / "port" / name).read_bytes() == (tmp / "jax" / name).read_bytes()
    assert len(pd.read_csv(tmp / "port" / "kf-rig_kfold_knn.csv")) == 3 * len(tkf.KS)


@pytest.mark.parametrize("mode", ["dual", "joint"])
def test_fold_parallel_equals_sequential(rig, mode):
    """--refit with --fold-parallel (groups of 2) against the sequential
    refits, fold by fold, bit for bit, with a supervised stage."""
    tmp, root, ckpts = rig
    flags = (["--wave-checkpoint", ckpts["wave"], "--time-checkpoint", ckpts["time"]] if mode == "dual"
             else ["--joint-checkpoint", ckpts["joint"]])
    base = ["--dataset", "kf-rig", "--data-root", root, "--folds", "3", "--refit", "--refit-epochs", "1",
            "--refit-supervised-epochs", "1", "--refit-batch-size", "40", "--refit-patience", "1",
            "--refit-lr", "3e-3", "--device", "cpu", *flags]
    seq = tkf.main(base + ["--output-dir", str(tmp / f"seq_{mode}")])
    par = tkf.main(base + ["--output-dir", str(tmp / f"par_{mode}"), "--fold-parallel",
                           "--fold-parallel-max-replicas", "2"])
    assert sorted(seq["refit"]) == sorted(par["refit"])
    for kind in seq["refit"]:
        assert len(seq["refit"][kind]) == 3
        for a, b in zip(seq["refit"][kind], par["refit"][kind]):
            np.testing.assert_array_equal(a, b)
    for name in ("kf-rig_kfold_knn.csv", "kf-rig_kfold_knn_folds.csv"):
        assert (tmp / f"seq_{mode}" / name).read_bytes() == (tmp / f"par_{mode}" / name).read_bytes()


def test_queue3_decision1_best_gated_by_own_stop():
    """Replica-plan fit: a replica that stopped at its patience trains and
    validates no more, so a better validation loss after its stop cannot
    become its best (the JAX device_fit_replica_plans would take epoch 2 for
    replica 0 here), while the other replica trains on."""
    val = {0: [1.0, 2.0, 0.5, 0.25], 1: [2.0, 1.5, 1.0, 0.75]}
    seen, evals = [], {0: 0, 1: 0}
    states = []
    for _ in range(2):
        model = torch.nn.Linear(2, 1)
        states.append(tstep.TrainState(model, toptim.make_optimizer(model.parameters(), 1e-3)))

    def train_epoch(sts, data, source, class_, idx, mask, generators=None):
        seen.append(int(idx[0][0]))
        return sts, tstep.Metrics(*[torch.ones(1, 1)] * 3)

    def eval_epoch(models, data, source, class_, idx, mask, generators=None):
        r = int(idx[0][0])
        v = torch.tensor([[val[r][evals[r]]]])
        evals[r] += 1
        return tstep.Metrics(v, v, v)

    plan = np.arange(2).reshape(2, 1, 1)
    res = tens.host_fit_replica_plans(
        states, epoch_fns=(train_epoch, eval_epoch), arrays=(torch.zeros(2, 1),), source=torch.zeros(2),
        class_=None, train_idx=plan, train_mask=np.ones((2, 1, 1)), val_idx=plan, val_mask=np.ones((2, 1, 1)),
        max_epochs=4, early_stopping_patience=1, seeds=[1, 2])
    assert seen == [0, 0, 1, 1, 1, 1]
    assert res.best_epoch.tolist() == [0, 3] and res.best_val_loss.tolist() == [1.0, 0.75]
    assert res.epochs_run == 4 and np.isnan(res.val_losses[2][0]) and res.val_losses[2][1] == 1.0


def test_queue3_decision2_each_fold_oversamples_to_its_own_majority(rig, monkeypatch):
    """The supervised streams the --fold-parallel refit trains on are, fold
    by fold, the sequential refit's balanced streams (each fold's own
    majority count), not the JAX fold-parallel path's global-majority
    streams."""
    from hippie_tpu_torch.train import pipeline as tpipe

    tmp, root, ckpts = rig
    captured = []
    real = tpipe.fit_multimodal_stage

    def capture(**kw):
        captured.append(kw)
        return real(**kw)

    monkeypatch.setattr(tpipe, "fit_multimodal_stage", capture)
    args = tkf.build_parser().parse_args([
        "--dataset", "kf-rig", "--data-root", root, "--folds", "3", "--refit", "--refit-epochs", "1",
        "--refit-supervised-epochs", "1", "--refit-batch-size", "64", "--device", "cpu", "--fold-parallel",
        "--joint-checkpoint", ckpts["joint"]])
    labels = registry.load_supervised_labels(root, "kf-rig")[0]
    folds = tkfolds.stratified_kfold_indices(labels, 3, seed=42)
    from hippie_tpu_torch import export as texport

    model0, cfgm = texport.load_model_from_ckpt(ckpts["joint"], device="cpu")
    wf, isi = (torch.from_numpy(np.asarray(a)) for a in
               (np.random.default_rng(0).normal(size=(48, 50)), np.random.default_rng(1).normal(size=(48, 100))))
    out = tkf._refit_fold_embeddings(args, (wf.float(), isi.float()), torch.zeros(48, dtype=torch.long),
                                     labels, folds, model0, cfgm, "joint")
    assert len(out) == 3 and len(captured) == 6
    sup = [kw["fixed_train_stream"] for kw in captured if kw.get("fixed_train_stream") is not None]
    splits = tkf._fold_splits(args, folds)
    own = [tr[balanced_indices(labels[tr], seed=42)] for tr, _ in splits]
    target = max(np.bincount(labels[tr]).max() for tr, _ in splits)
    jax_streams = [tr[balanced_indices(labels[tr], seed=42, target_count=target)] for tr, _ in splits]
    assert [len(s) for s in own] != [len(s) for s in jax_streams]  # the majorities differ at this data
    assert len(sup) == 3
    for stream, want in zip(sup, own):
        np.testing.assert_array_equal(stream, want)
