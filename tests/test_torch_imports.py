"""The port stands alone: no module of hippie_tpu_torch (its scripts
included), and neither chip_smoke.py nor kernel_split.py, imports jax,
orbax, hippie_tpu, pandas or sklearn (the machine with the card has none of
them)."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "hippie_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "kernel_split.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "hippie_tpu", "pandas", "sklearn")


def test_the_scripts_are_covered():
    """Every CLI of the port is among FILES (its scripts/ are globbed)."""
    scripts = {p.name for p in FILES if p.parent.name == "scripts"}
    assert {"export_model.py", "bench_artifact.py", "lr_sweep.py", "kfold_eval.py", "serve_embeddings.py",
            "train_model.py", "sweep_targets.py", "profile_train_step.py", "bench.py"} <= scripts


def test_the_resume_and_cli_modules_are_covered():
    """The console entry point, the resume format, the wandb shim and the
    eval graphs are among FILES, by name."""
    names = {str(p.relative_to(PKG)) for p in FILES if PKG in p.parents}
    assert {"cli.py", "train/resume.py", "utils/wandb_shim.py", "scripts/sweep_targets.py",
            "scripts/profile_train_step.py", "evaluate/eval_graph.py"} <= names


def _module_names():
    return [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PKG.rglob("*.py"))
    ]


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_module_names()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
