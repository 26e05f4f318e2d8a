"""The port's lr_sweep CLI (hippie_tpu_torch/scripts/lr_sweep.py) end to end
on the CPU at K=2, one epoch, num_blocks=(1, 1, 1, 1), z=4: its final JSON
line has the JAX CLI's keys, its exported winners seed both pipelines'
stage-1 seams, ``--export-all`` writes every replica and warns for one that
never improved (ROADMAP Queue 3, decision 3), and its options are the JAX
CLI's plus ``--device``.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from hippie_tpu_torch import export as texport
from hippie_tpu_torch.data import synth
from hippie_tpu_torch.scripts import lr_sweep
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.train import pipeline as tpipe

torch.set_num_threads(1)

DS = "cellexplorer-celltype"
SMALL = ["--num-blocks", "1,1,1,1", "--z-dim", "4", "--max-epochs", "1", "--pool", "self", "--device", "cpu"]
# the keys of the JAX CLI's final JSON line (scripts/lr_sweep.py)
JSON_KEYS = ["dataset", "modality", "mode", "configs", "lrs", "best_val_loss", "best_epoch", "epochs_run",
             "winner", "winner_lr", "exported", "exported_all"]


@pytest.fixture(autouse=True)
def _free_tmp_path(tmp_path):
    """Remove what the test wrote: its checkpoints are tens of MB each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep") / "data"
    synth.make_dataset(str(root), DS, n=48, num_classes=3, seed=0)
    return str(root)


def _sweep(capsys, argv):
    assert lr_sweep.main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out.strip().splitlines()[-1]), out


def test_winners_feed_the_stage1_seams(root, tmp_path, capsys):
    winners = {}
    for modality in ("wave", "time", "joint"):
        path = str(tmp_path / f"winner_{modality}.ckpt")
        rec, out = _sweep(capsys, ["--dataset", DS, "--data-root", root, "--modality", modality,
                                   "--lrs", "1e-3,3e-3", "--export-winner", path, "--batch-size", "16", *SMALL])
        assert list(rec) == JSON_KEYS
        assert rec["configs"] == ["lr=0.001", "lr=0.003"] and rec["epochs_run"] == 1
        assert rec["exported"] == path and rec["exported_all"] is None
        assert rec["winner_lr"] == rec["lrs"][int(np.argmin(rec["best_val_loss"]))]
        assert f"exported winner ({rec['winner']}) -> {path}" in out
        payload = tckpt.load_lightning_ckpt(path)
        assert payload["epoch"] == 0 and payload["hyper_parameters"]["sweep"] == rec["configs"]
        assert payload["hyper_parameters"]["lr"] == rec["winner_lr"]
        winners[modality] = path
    # the training CLIs' flags put the winners in these fields
    from hippie_tpu_torch.scripts import train_model

    flags = train_model.config_from_args(train_model.build_parser().parse_args(
        ["--stage1-wave-ckpt", winners["wave"], "--stage1-time-ckpt", winners["time"]]))
    assert (flags.stage1_wave_ckpt, flags.stage1_time_ckpt) == (winners["wave"], winners["time"])
    common = dict(z_dim=4, dataset=DS, data_root=root, batch_size=16, supervised_batch_size=16,
                  pretrain_max_epochs=7, num_blocks=(1, 1, 1, 1), verbose=False, device="cpu")
    uni = tpipe.run_pipeline(tpipe.PipelineConfig(
        **common, output_dir=str(tmp_path / "uni"), checkpoint_dir=str(tmp_path / "uni_ck"),
        stage1_wave_ckpt=winners["wave"], stage1_time_ckpt=winners["time"]))
    assert "load_pool" not in uni["timings"] and "pretrain_wave" not in uni["timings"]
    assert "load_stage1_wave" in uni["timings"] and "load_stage1_time" in uni["timings"]
    joint = tpipe.run_pipeline(tpipe.PipelineConfig(
        **common, model_type="multimodal", output_dir=str(tmp_path / "joint"),
        checkpoint_dir=str(tmp_path / "joint_ck"), stage1_joint_ckpt=winners["joint"]))
    assert "load_stage1_joint" in joint["timings"] and "pretrain_joint" not in joint["timings"]
    for results in (uni, joint):
        assert all(0.0 <= b["balanced_accuracy"] <= 1.0 for b in results["best"].values())


def test_export_all_warns_for_a_replica_that_never_improved(root, tmp_path, capsys):
    """lr 1e30 wrecks the replica's weights in its one step: its validation
    loss is never finite, so its best epoch stays -1. It is exported all the
    same, as the JAX CLI does, with one warning line (decision 3)."""
    prefix = str(tmp_path / "cand_")
    rec, out = _sweep(capsys, ["--dataset", DS, "--data-root", root, "--lrs", "1e-3,1e30",
                               "--export-all", prefix, "--batch-size", "64", *SMALL])
    assert rec["best_epoch"] == [0, -1] and not np.isfinite(rec["best_val_loss"][1])
    assert rec["exported_all"] == [f"{prefix}0.ckpt", f"{prefix}1.ckpt"] and rec["winner"] == "lr=0.001"
    warnings = [x for x in out.splitlines() if x.startswith("WARNING")]
    assert warnings == [f"WARNING: replica 1 (lr=1e+30) never improved on its validation loss (best epoch -1); "
                        f"{prefix}1.ckpt holds its weights after epoch 0"]
    for k, path in enumerate(rec["exported_all"]):
        payload = tckpt.load_lightning_ckpt(path)
        assert payload["epoch"] == rec["best_epoch"][k] and payload["hyper_parameters"]["config"] == rec["configs"][k]
        model, cfg = texport.load_model_from_ckpt(path, device="cpu")
        assert cfg.z_dim == 4


def test_seeds_mode_gives_distinct_replicas(root, tmp_path, capsys):
    prefix = str(tmp_path / "seed_")
    rec, _ = _sweep(capsys, ["--dataset", DS, "--data-root", root, "--mode", "seeds", "--n-seeds", "2",
                             "--lr", "2e-3", "--export-all", prefix, "--batch-size", "16", *SMALL])
    assert rec["configs"] == ["seed[0] lr=0.002", "seed[1] lr=0.002"] and rec["lrs"] == [2e-3, 2e-3]
    a, b = (tckpt.load_lightning_ckpt(f"{prefix}{k}.ckpt")["state_dict"]["model.z_mean.weight"] for k in (0, 1))
    assert not torch.equal(a, b)


@pytest.mark.parametrize("argv,match", [(["--aot-dir", "a"], "a")])
def test_unported_flags_raise_naming_the_roadmap_item(argv, match, root, tmp_path, capsys, monkeypatch):
    """The flag that raised until its port, ``--aot-dir``, has the JAX
    default and sets the kernel-library directory of the sweep."""
    from hippie_tpu_torch.ops import _build

    assert lr_sweep.build_parser().get_default("aot_dir") == os.path.join(
        os.path.expanduser("~"), ".cache", "hippie_tpu_aot")
    monkeypatch.setattr(_build, "_default_dir", None)
    monkeypatch.chdir(tmp_path)
    _sweep(capsys, ["--dataset", DS, "--data-root", root, *argv, "--batch-size", "16", *SMALL])
    assert _build.default_dir() == match


@pytest.mark.parametrize("argv", [["--progress-every", "2"], ["--resume-dir", "r"]])
def test_resume_and_progress_flags_run(root, tmp_path, capsys, monkeypatch, argv):
    """The two flags that raised until the port had them: a two-epoch sweep
    with ``--progress-every 2`` prints one progress line, with
    ``--resume-dir r`` it leaves its last two epochs' state in ``r``."""
    monkeypatch.chdir(tmp_path)
    rec, out = _sweep(capsys, ["--dataset", DS, "--data-root", root, "--lrs", "1e-3,3e-3", "--batch-size", "16",
                               *SMALL, "--max-epochs", "2", *argv])
    assert rec["epochs_run"] == 2 and len(rec["best_val_loss"]) == 2
    progress = [x for x in out.splitlines() if x.startswith("ensemble progress: epoch")]
    if argv[0] == "--progress-every":
        assert [x.split(",")[0] for x in progress] == ["ensemble progress: epoch 2/2"]
    else:
        assert progress == [] and sorted(p.name for p in (tmp_path / "r").iterdir()) == [
            "epoch_000000.pt", "epoch_000001.pt"]


def test_options_are_jax_plus_device():
    spec = importlib.util.spec_from_file_location("lr_sweep_jax", "scripts/lr_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def options(parser):
        return {o for a in parser._actions for o in a.option_strings if o.startswith("--")} - {"--help"}

    assert options(lr_sweep.build_parser()) == options(mod.build_parser()) | {"--device"}
    # the JAX default, the device loop, and the host loop
    got = {a.dest: a for a in lr_sweep.build_parser()._actions}["fit_loop"]
    assert (got.choices, got.default) == (("device", "host"), "device")
    assert lr_sweep.build_parser().parse_args(["--dataset", DS, "--fit-loop", "device"]).fit_loop == "device"
