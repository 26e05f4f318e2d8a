"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Each check takes the top-level name
of every loaded module (the part before the first dot) and compares it
whole: ``hippie_tpu_torch`` is the program and passes, though its name
begins with ``hippie_tpu``."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from perfbench.harness import common

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

HARNESS = """
import perfbench.run, perfbench.harness.readers
from hippie_tpu_torch.train import device_fit, optim, step
from hippie_tpu_torch.ops import preprocess
from hippie_tpu_torch.scripts import serve_embeddings
from hippie_tpu_torch.evaluate import eval_graph, embeddings
from hippie_tpu_torch import export
from hippie_tpu_torch.models import cvae
from perfbench.harness.common import Cell
for w in Cell("wave_train").bench["workloads"]:
    cell = Cell(w["name"])
    cell.runner()
    for m in cell.bench["per_layer"] + cell.bench["end_to_end"]:
        cell.reader(m["name"])
"""
REFERENCE = """
import perfbench.reference.cvae, perfbench.reference.train, perfbench.reference.preprocess
import perfbench.reference.compare, perfbench.reference.numerics
import perfbench.yardstick.flops, perfbench.yardstick.bounds, perfbench.yardstick.peaks
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "HOME": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _loaded(HARNESS)
    assert not names & set(common.FORBIDDEN), names & set(common.FORBIDDEN)
    assert "hippie_tpu_torch" in names  # the program, whose name only begins with hippie_tpu


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded(REFERENCE)
    assert not names & (set(common.FORBIDDEN) | {"hippie_tpu_torch"})


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hippie_tpu_torch.fake", object())
    assert "hippie_tpu" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hippie_tpu.fake", object())
    assert "hippie_tpu" in common.forbidden_modules()


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_names_a_forbidden_module():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts or "cache" in path.parts:
            continue
        names = _imports(path)
        assert not names & set(common.FORBIDDEN), (path, names)
        if path.parent.name in ("reference", "yardstick"):
            assert "hippie_tpu_torch" not in names, path
