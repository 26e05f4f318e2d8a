"""The harness is driven by data: a configuration, a traffic mix, a cell's
limits and a per-layer metric written into a copy of the folder as new
files are found by their names, with no file edited; so are a new kind of
traffic (its runner) and a new end-to-end metric, which run through
``run.py`` in the copy; every cell's control
flow runs as a CPU rehearsal (``--device cpu``, the tiny sizes of the files'
``rehearsal`` sections); a run without a card prints no result."""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

import pytest

from perfbench.harness.common import Cell, load_json

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": tempfile.gettempdir(), "PYTHONDONTWRITEBYTECODE": "1"}


def _digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "perfbench")
    d = tmp_path / "perfbench"
    cfg = load_json(d / "configs" / "hippie_wave.json")
    cfg["name"] = "hippie_wave_z16"
    cfg["model"]["z_dim"] = 16
    (d / "configs" / "hippie_wave_z16.json").write_text(json.dumps(cfg))
    mix = load_json(d / "traffic" / "stage1_epochs.json")
    mix["batch"] = 256
    (d / "traffic" / "half_batch_epochs.json").write_text(json.dumps(mix))
    (d / "limits" / "wave_z16_train.json").write_text(json.dumps({"loss_gap": 0.5}))
    (d / "metrics" / "steps_per_s.train.py").write_text(
        "def read(run):\n    return run['window_steps'] / run['window_s'] if run.get('window_s') else None\n")
    bench = load_json(tmp_path / "BENCHMARK.json")
    bench["configs"].append({"name": "hippie_wave_z16", "source": "https://example.org", "reduced": [],
                             "file": "perfbench/configs/hippie_wave_z16.json", "why": "a test"})
    bench["workloads"].append({"name": "wave_z16_train", "config": "hippie_wave_z16", "traffic": "half_batch_epochs",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_per_s.train", "unit": "steps/s", "better": "higher",
                               "source": "host_clock", "layer": "model step", "moves": "train_samples_per_s",
                               "workloads": ["wave_z16_train"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("wave_z16_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = Cell("wave_z16_train", root=tmp_path)
    assert cell.config["model"]["z_dim"] == 16 and cell.traffic["batch"] == 256
    assert cell.limits == {"loss_gap": 0.5}
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"train_samples_per_s", "setup_s"}
    assert [m["name"] for m in cell.metrics("per_layer")] == ["steps_per_s.train"]
    assert cell.reader("steps_per_s.train")({"window_steps": 10, "window_s": 2.0}) == 5.0
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed


NEW_KIND = '''
"""A kind of traffic that only counts: for the test that a new kind is found by name."""
FAULTS = ("wrong",)


def run(ctx):
    n = int(ctx.cell.traffic["items"])
    got = n + (1 if ctx.fault == "wrong" else 0)
    return {"numbers": {"count_gap": float(abs(got - n))}, "control": None, "attempted": n, "failed": 0,
            "found": [], "device": None,
            "run": {"setup_s": 0.5, "window_s": 2.0, "items": got, "prof": None}}
'''


def test_a_new_kind_and_end_to_end_metric_run_from_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "perfbench")
    d = tmp_path / "perfbench"
    (d / "traffic" / "counting.py").write_text(NEW_KIND)
    (d / "traffic" / "count_ten.json").write_text(json.dumps({"kind": "counting", "items": 10}))
    (d / "limits" / "wave_count.json").write_text(json.dumps({"count_gap": 0.0}))
    (d / "metrics" / "items_per_s.py").write_text("def read(run):\n    return run['items'] / run['window_s']\n")
    bench = load_json(tmp_path / "BENCHMARK.json")
    bench["workloads"].append({"name": "wave_count", "config": "hippie_wave", "traffic": "count_ten", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].insert(0, {"name": "items_per_s", "unit": "items/s", "better": "higher", "bound": 0.05,
                                   "source": "host_clock", "workloads": ["wave_count"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "hippie_tpu_torch").symlink_to(ROOT / "hippie_tpu_torch")
    env = dict(ENV, PYTHONPATH=str(tmp_path))
    lines = {}
    for fault in (None, "wrong"):
        extra = ["--fault", fault] if fault else []
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "wave_count", "--seed", "3",
                            "--seconds", "1", "--device", "cpu", *extra], cwd=tmp_path, capture_output=True,
                           text=True, timeout=300, env=env)
        assert p.returncode == 0, p.stderr[-3000:]
        lines[fault] = json.loads(p.stdout.strip().splitlines()[-1])
    assert lines[None]["correct"] is True and lines[None]["attempted"] == 10
    assert lines["wrong"]["correct"] is False
    cell = Cell("wave_count", root=tmp_path)
    assert cell.reader("items_per_s")({"items": 10, "window_s": 2.0}) == 5.0
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed


def _run(*args, timeout=600):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout, env=ENV)


@pytest.mark.parametrize("workload", [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]])
def test_every_cell_rehearses_on_the_cpu(workload):
    p = _run("--workload", workload, "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "1",
             "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["rehearsal"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is True, line["compared"]  # a sound run passes the limits the faults fail
    assert "metrics" not in line and "device" not in line  # no device metric without a card
    assert list(line)[-1] == "compared"
    assert set(line["compared"]) == set(Cell(workload).limits)
    assert p.stderr.strip().splitlines()[-1].startswith("compared ")


def test_without_a_card_no_result(tmp_path):
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = _run("--workload", "wave_train", "--seed", "1", "--seconds", "1", "--trace", "0", timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "wave_train", "--seed", "1", "--seconds",
                        "1", "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=120, env=ENV)
    assert p.returncode != 0 and p.stdout.strip() == ""
