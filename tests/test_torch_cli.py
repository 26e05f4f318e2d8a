"""The rest of the training CLI: the ``hippie-tpu-torch`` dispatcher
(hippie_tpu_torch/cli.py), sweep_targets, profile_train_step, and the
training CLI's ``--profile-dir``, ``--wandb`` and ``--discover-datasets``,
on the CPU at a small size (num_blocks=(1, 1, 1, 1), z=4, one batch per
stage, synthetic datasets).

The dispatcher exits 0 on help, 1 on ``bench`` without a CUDA device (no
fallback to the CPU) and 2 on an unknown command; its ``synth`` writes the
JAX package's bytes.
sweep_targets prints one record per target and the aggregate, and returns 1
when a target fails. profile_train_step prints its JSON line. One training
run with ``--discover-datasets --profile-dir D --wandb`` on a custom target
writes a trace into D, logs nothing anywhere without the wandb package, and
registers the target with the id (and the registry.json bytes) the JAX
registry gives.
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import pytest
import torch

from hippie_tpu_torch import cli
from hippie_tpu_torch.data import registry, synth
from hippie_tpu_torch.scripts import profile_train_step, sweep_targets
from hippie_tpu_torch.scripts import train_model as tcli
from hippie_tpu_torch.utils import wandb_shim

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--z_dim", "4", "--batch-size", "16", "--supervised-batch-size", "16",
         "--limit-train-batches", "1", "--limit-val-batches", "1"]
OUTPUTS = 9  # the unimodal pipeline's CSVs (the confusion-matrix PNGs come with matplotlib)


@pytest.fixture(autouse=True)
def _free_tmp_path(tmp_path):
    """Remove what the test wrote: its checkpoints are tens of MB each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _saved_registries():
    from hippie_tpu.data import registry as jregistry

    return [(m, dict(m.DATASET_SOURCE_IDS), m.NUM_SOURCES) for m in (registry, jregistry)]


def _restore(saved):
    for m, ids, n in saved:
        m.DATASET_SOURCE_IDS.clear()
        m.DATASET_SOURCE_IDS.update(ids)
        m.NUM_SOURCES = n


@pytest.fixture(autouse=True)
def _registries():
    """discover_datasets registers datasets in both packages' registries:
    restore them, so later tests in the process see the built-in ones."""
    saved = _saved_registries()
    yield
    _restore(saved)


def _small(mp):
    """The training CLI builds the pipeline at num_blocks=(1, 1, 1, 1) (the
    CLI, as the JAX one, has no depth flag)."""
    orig = tcli.config_from_args
    mp.setattr(tcli, "config_from_args",
               lambda *a, **k: dataclasses.replace(orig(*a, **k), num_blocks=(1, 1, 1, 1)))


@pytest.mark.parametrize("argv,rc,said", [([], 0, "usage: hippie-tpu-torch"), (["--help"], 0, "lr-sweep"),
                                          (["bench"], 1, "no CUDA device"),
                                          (["nope"], 2, "unknown command: nope")])
def test_dispatcher_exit_codes(argv, rc, said, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # bench without a card
    assert cli.main(argv) == rc
    out = capsys.readouterr()
    assert said in out.out + out.err


def test_synth_writes_the_jax_bytes(tmp_path, capsys):
    from hippie_tpu.data import synth as jsynth

    assert cli.main(["synth", "--data-root", str(tmp_path / "port"), "--name", "rig", "--n", "20",
                     "--with-metadata"]) == 0
    assert "wrote synthetic dataset" in capsys.readouterr().out
    jsynth.make_dataset(str(tmp_path / "jax"), "rig", n=20, with_metadata=True)
    names = sorted(os.listdir(tmp_path / "jax" / "rig"))
    assert names == sorted(os.listdir(tmp_path / "port" / "rig")) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / "rig" / name).read_bytes() == (tmp_path / "jax" / "rig" / name).read_bytes()


@pytest.mark.parametrize("targets,rc", [("cellexplorer-celltype,neonatal-mouse-brain-slice", 0),
                                        ("neonatal-mouse-brain-slice,no-such-dataset", 1)])
def test_sweep_targets(tmp_path, monkeypatch, capsys, targets, rc):
    root = tmp_path / "data"
    synth.make_dataset(str(root), "cellexplorer-celltype", n=48, num_classes=3, seed=0)
    synth.make_dataset(str(root), "neonatal-mouse-brain-slice", n=40, wave_width=49, num_classes=2, seed=1)
    _small(monkeypatch)
    assert sweep_targets.main(["--datasets", targets, "--data-root", str(root), "--output-dir",
                               str(tmp_path / "out"), "--checkpoint-dir", str(tmp_path / "ck"), *SMALL]) == rc
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    names = targets.split(",")
    assert [r["dataset"] for r in lines[:-1]] == names
    for r in lines[:-1]:
        assert r["ok"] == (r["dataset"] != "no-such-dataset")
        if r["ok"]:
            assert set(r["best_balanced_accuracy"]) == {"waveform", "isi", "joint"}
        else:
            assert r["error"]
    assert lines[-1] == {"metric": "sweep_targets", "targets": 2, "ok": 2 - rc,
                         "total_wall_s": lines[-1]["total_wall_s"]}


def test_profile_train_step_on_the_cpu(capsys):
    assert profile_train_step.main(["--device", "cpu", "--batch", "4", "--iters", "1", "--conv-iters", "1",
                                    "--block-backend", "fused"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["device"], rec["batch"], rec["block_backend"], rec["loss_backend"]) == ("cpu", 4, "fused", "xla")
    parts = rec["ms"]
    assert {"full train step", "fwd+bwd (no optimizer)", "forward only (train mode)", "optimizer only",
            "encoder fwd (train mode)", "decoder fwd (train mode)", "encoder fwd+bwd", "decoder fwd+bwd",
            "enc l4 conv 512x512 L4 dw", "enc l1 conv 64x64 L25 [bf16]"} <= set(parts)
    assert "graphed train step (device fit loop)" in parts
    assert len(parts) == 9 + 8 + 10 and all(v > 0 for v in parts.values())


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``hippie-tpu-torch train --discover-datasets --profile-dir D --wandb``
    on a target the registry lacks; the registries as the run left them are
    recorded, then restored."""
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "data"
    synth.make_dataset(str(root), "zz-rig", n=48, num_classes=3, seed=4)
    synth.make_dataset(str(root), "cellexplorer-celltype", n=40, num_classes=3, seed=5)
    saved = _saved_registries()
    mp = pytest.MonkeyPatch()
    _small(mp)
    try:
        rc = cli.main(["train", "--dataset", "zz-rig", "--data-root", str(root), "--discover-datasets",
                       "--profile-dir", str(tmp / "trace"), "--wandb", "--output-dir", str(tmp / "out"),
                       "--checkpoint-dir", str(tmp / "ck"), *SMALL])
        ids = dict(registry.DATASET_SOURCE_IDS)
    finally:
        mp.undo()
        _restore(saved)
    yield rc, tmp, ids
    shutil.rmtree(tmp, ignore_errors=True)


def test_profile_dir_writes_a_trace(cli_run):
    rc, tmp, _ = cli_run
    assert rc == 0
    traces = os.listdir(tmp / "trace")
    assert len(traces) == 1 and traces[0].startswith("trace_") and traces[0].endswith(".json")
    events = json.loads((tmp / "trace" / traces[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::conv1d" for e in events)


def test_wandb_without_wandb_is_a_no_op(cli_run):
    rc, tmp, _ = cli_run
    assert importlib.util.find_spec("wandb") is None  # the scenario: no wandb package here
    assert rc == 0 and not wandb_shim.is_enabled()
    assert len([p for p in os.listdir(tmp / "out") if p.endswith(".csv")]) == OUTPUTS
    assert not any("wandb" in p for _, dirs, files in os.walk(tmp) for p in dirs + files)


def test_discover_datasets_registers_the_jax_ids(cli_run, tmp_path):
    from hippie_tpu.data import registry as jregistry

    rc, tmp, ids = cli_run
    assert rc == 0 and "zz-rig" in ids and "zz-rig" not in registry.DATASET_SOURCE_IDS
    jroot = tmp_path / "data"
    shutil.copytree(tmp / "data", jroot, ignore=shutil.ignore_patterns("registry.json"))
    assert jregistry.discover_datasets(str(jroot)) == ["zz-rig"]
    assert ids["zz-rig"] == jregistry.DATASET_SOURCE_IDS["zz-rig"]
    assert (tmp / "data" / "registry.json").read_bytes() == (jroot / "registry.json").read_bytes()
    csvs = [p for p in os.listdir(tmp / "out") if p.endswith(".csv")]
    assert len(csvs) == OUTPUTS and all(p.startswith(("pretraining_zz-rig_", "zz-rig_")) for p in csvs)


@pytest.mark.parametrize("argv,fields", [
    ([], {"fit_loop": "device", "progress_every": None, "log_every_step": False}),
    (["--fit-loop", "host"], {"fit_loop": "host", "progress_every": None, "log_every_step": False}),
    (["--progress-every", "0", "--log-every-step"], {"fit_loop": "device", "progress_every": 0,
                                                      "log_every_step": True}),
    (["--progress-every", "5"], {"fit_loop": "device", "progress_every": 5, "log_every_step": False})])
def test_fit_loop_flags_reach_the_config(argv, fields):
    """The device fit loop's flags parse as the JAX CLI's and reach the
    config, with ``--aot-dir`` at the JAX default (since its port, no flag
    of the JAX CLI is left unported)."""
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(["--device", "cpu", *argv]))
    assert {k: getattr(cfg, k) for k in fields} == fields
    assert cfg.aot_dir == os.path.join(os.path.expanduser("~"), ".cache", "hippie_tpu_aot")


def test_both_fit_loops_write_the_same_files(tmp_path, monkeypatch):
    """The training CLI with ``--fit-loop device --progress-every 1
    --log-every-step`` and with ``--fit-loop host``: the same .ckpt and CSV
    bytes, the same epoch records in the log file, and one step record per
    executed train batch after them with the device loop."""
    root = tmp_path / "data"
    synth.make_dataset(str(root), "cellexplorer-celltype", n=48, num_classes=3, seed=0)
    synth.make_dataset(str(root), "neonatal-mouse-brain-slice", n=40, num_classes=2, seed=1)  # the pool
    _small(monkeypatch)
    runs = {}
    for name, flags in (("device", ["--progress-every", "1", "--log-every-step"]),
                        ("host", ["--fit-loop", "host"])):
        out = tmp_path / name
        # the same directory name in both runs: torch.save writes the file's name into the zip
        ck = tmp_path / "ck"
        tcli.run(tcli.build_parser().parse_args([
            "--dataset", "cellexplorer-celltype", "--data-root", str(root), "--output-dir", str(out),
            "--checkpoint-dir", str(ck), "--log-file", str(out / "log.jsonl"), *SMALL, *flags]))
        files = {p: (ck / p).read_bytes() for p in sorted(os.listdir(ck)) if p.endswith(".ckpt")}
        files.update({p: (out / p).read_bytes() for p in sorted(os.listdir(out)) if p.endswith(".csv")})
        recs = [json.loads(x) for x in (out / "log.jsonl").read_text().splitlines()]
        for r in recs:
            r.pop("ts")
        runs[name] = files, recs
        shutil.rmtree(ck)
    (dev_files, dev_recs), (host_files, host_recs) = runs["device"], runs["host"]
    assert len(dev_files) == 4 + OUTPUTS and dev_files == host_files
    steps = [r for r in dev_recs if "train_loss_step" in r]
    assert [r for r in dev_recs if "train_loss_step" not in r] == host_recs and steps
