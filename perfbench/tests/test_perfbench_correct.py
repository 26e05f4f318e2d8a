"""``correct`` comes out false when it should.

- The faults: each cell's run with its timed path broken underneath
  (``--fault``: a training step that leaves its state unchanged, half of
  each batch left out with the mean over the rest; an embedding altered
  where it is produced, half of a group's rows left out), rehearsed on the
  CPU: the comparison with the reference fails.
- The control: the plain reference computed one precision below the
  configuration's, in the program's place (``--control 1``), fails at least
  one of the cell's limits. On the CPU at the rehearsal's size; on the card
  (marked ``cuda``) at the cell's own size and load on three seeds:
  ``python -m pytest --noconftest -q perfbench/tests -m cuda``.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

from perfbench.harness.common import Cell, load_json

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": tempfile.gettempdir(), "PYTHONDONTWRITEBYTECODE": "1"}
WORKLOADS = load_json(ROOT / "BENCHMARK.json")["workloads"]
CASES = [(w["name"], f) for w in WORKLOADS for f in Cell(w["name"]).runner().FAULTS]


def _line(*args, timeout=900):
    p = subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout, env=ENV)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not math.isfinite(numbers[k]) or numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    line = _line("--workload", workload, "--seed", "7", "--seconds", "1", "--device", "cpu", "--fault", fault)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("workload", [w["name"] for w in WORKLOADS])
def test_the_control_is_not_correct_on_the_cpu(workload):
    line = _line("--workload", workload, "--seed", "8", "--seconds", "1", "--device", "cpu", "--control", "1")
    assert _fails(line["control"], Cell(workload).limits), line["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in WORKLOADS])
def test_the_control_is_not_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's own size")
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        # a short window at the cell's own load: it answers as many requests as the check compares
        line = _line("--workload", workload, "--seed", str(seed), "--seconds", "3", "--control", "1")
        assert line["correct"] is True, line["compared"]
        assert _fails(line["control"], Cell(workload).limits), line["control"]
