"""The kernel-library cache of the port (hippie_tpu_torch/ops/_build.py),
the counterpart of hippie_tpu/utils/aot.py behind ``--aot-dir``.

No CUDA toolkit is needed: a stub shared library built with the host C
compiler stands in for a kernel library, and a fake ``nvcc`` (a script that
copies the stub to its ``-o`` path and counts its calls) for the compiler.
Checked: the key (one byte of a ``.cu``, of a ``.cuh`` or of the flags
changes it), the directory order, a filled directory loading with no
``nvcc`` to be found, a missing library with no ``nvcc`` raising with the
directory and the key, the pruning of other keys and of dead writers'
temporary files, two processes building an entry once, and
``PipelineConfig.aot_dir`` reaching a spawned gloo rank. The CLIs' flag
against the JAX CLIs' (name and default) is the one case that imports JAX.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from hippie_tpu_torch.ops import _build
from hippie_tpu_torch.parallel import mesh as pmesh
from hippie_tpu_torch.train.pipeline import PipelineConfig

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

FAKE_NVCC = """#!{python}
import pathlib, shutil, sys, time
if "--version" in sys.argv:
    print("Cuda compilation tools, fake nvcc of tests/test_torch_aot.py")
    sys.exit(0)
with open({calls!r}, "a") as f:
    f.write(sys.argv[-1] + "\\n")
time.sleep({sleep})
shutil.copy({stub!r}, sys.argv[sys.argv.index("-o") + 1])
"""


@pytest.fixture
def stub(tmp_path_factory):
    """A shared library built by the host C compiler: stub_answer() == 42."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a host C compiler for the stub library")
    d = tmp_path_factory.mktemp("stub")
    (d / "stub.c").write_text("int stub_answer(void) { return 42; }\n")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(d / "stub.so"), str(d / "stub.c")], check=True)
    return d / "stub.so"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache root and package build directory; the module's process
    state (default directory, loaded libraries, pruned directories) reset."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "pkg_build" / "kernels")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_pruned", set())
    monkeypatch.setattr(_build, "_default_dir", None)
    return tmp_path / "aot"


def fake_nvcc(tmp_path, stub, sleep=0.0) -> tuple:
    """(the fake nvcc's path, the file that lists one line per call)."""
    calls = tmp_path / "nvcc_calls.txt"
    script = tmp_path / "fake_nvcc"
    script.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls), sleep=sleep, stub=str(stub)))
    script.chmod(0o755)
    return str(script), calls


def no_nvcc():
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA toolkit is needed")


@pytest.mark.parametrize("what", ["cu", "cuh", "flags"])
def test_key_changes_with_one_byte(tmp_path, monkeypatch, what):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.key(n) for n in _build.sources()}
    if what == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1] + ("-Xptxas=-w",))
    else:
        path = csrc / ("vae_sums.cu" if what == "cu" else "block_common.cuh")
        text = bytearray(path.read_bytes())
        text[-1:] = b" " if text[-1:] != b" " else b"\n"
        path.write_bytes(bytes(text))
    after = {n: _build.key(n) for n in _build.sources()}
    changed = {n for n in before if before[n] != after[n]}
    # a .cuh and the flags are in every key; a .cu only in its own
    assert changed == ({"vae_sums"} if what == "cu" else set(before))
    assert _build.so_path("vae_sums").name == f"vae_sums-{after['vae_sums'][:12]}.so"


def test_directory_order(cache, stub, monkeypatch):
    assert _build.kernel_dirs() == [_build.BUILD_DIR]
    _build.set_default_dir(str(cache))
    assert _build.default_dir() == str(cache)
    assert _build.kernel_dirs() == [cache / "torch_kernels", _build.BUILD_DIR]
    name = f"vae_sums-{_build.key('vae_sums')[:12]}.so"
    assert _build.so_path("vae_sums") == cache / "torch_kernels" / name  # where it would be built
    _build.BUILD_DIR.mkdir(parents=True)
    shutil.copy(stub, _build.BUILD_DIR / name)
    assert _build.so_path("vae_sums") == _build.BUILD_DIR / name  # found in the second
    (cache / "torch_kernels").mkdir(parents=True)
    shutil.copy(stub, cache / "torch_kernels" / name)
    assert _build.so_path("vae_sums") == cache / "torch_kernels" / name  # the first wins
    _build.set_default_dir("")  # --aot-dir "": no cache
    assert _build.default_dir() is None and _build.kernel_dirs() == [_build.BUILD_DIR]


def test_filled_directory_loads_without_nvcc(cache, stub, monkeypatch):
    kdir = cache / "torch_kernels"
    kdir.mkdir(parents=True)
    for n in _build.sources():
        shutil.copy(stub, kdir / f"{n}-{_build.key(n)[:12]}.so")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.set_default_dir(str(cache))
    assert _build.build() == {n: 0.0 for n in _build.sources()}
    for n in _build.sources():
        assert _build.load(n).stub_answer() == 42
    assert not _build.BUILD_DIR.exists()  # nothing made beside the package


def test_missing_library_without_nvcc_raises_with_directory_and_key(cache, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.set_default_dir(str(cache))
    with pytest.raises(RuntimeError) as err:
        _build.load("vae_sums")
    msg = str(err.value)
    assert "nvcc not found" in msg and _build.key("vae_sums") in msg
    assert str(cache / "torch_kernels") in msg and str(_build.BUILD_DIR) in msg


def test_stale_entries_pruned_and_missing_built(cache, stub, tmp_path, monkeypatch):
    kdir = cache / "torch_kernels"
    kdir.mkdir(parents=True)
    current = _build.key("vae_sums")[:12]
    stale = [kdir / f"vae_sums-0123456789ab{ext}" for ext in (".so", ".json", ".lock", ".tmp77")]
    dead_tmp = kdir / f"vae_sums-{current}.tmp99"  # its entry's lock is free: the writer is gone
    live_tmp = kdir / f"enc_block-{_build.key('enc_block')[:12]}.tmp98"
    foreign = [kdir / "prog_abc_def.jexec", kdir / "notes.txt"]  # not the port's
    for p in (*stale, dead_tmp, live_tmp, *foreign):
        p.write_bytes(b"x")
    nvcc, calls = fake_nvcc(tmp_path, stub)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    _build.set_default_dir(str(cache))
    with _build._entry_lock(kdir / f"enc_block-{_build.key('enc_block')[:12]}.lock"):  # a live writer
        secs = _build.build(["vae_sums"])
    assert secs["vae_sums"] > 0.0
    assert not any(p.exists() for p in (*stale, dead_tmp))
    assert live_tmp.exists() and all(p.exists() for p in foreign)
    assert calls.read_text().splitlines() == [str(_build.CSRC / "vae_sums.cu")]
    so = kdir / f"vae_sums-{current}.so"
    assert _build.load("vae_sums").stub_answer() == 42 and _build.so_path("vae_sums") == so
    manifest = json.loads(so.with_suffix(".json").read_text())
    assert manifest["key"] == _build.key("vae_sums") and manifest["flags"] == list(_build.NVCC_FLAGS)
    assert manifest["nvcc"].startswith("Cuda compilation tools") and manifest["build_seconds"] > 0
    assert _build.build(["vae_sums"]) == {"vae_sums": 0.0}  # built once
    assert len(calls.read_text().splitlines()) == 1


def test_two_processes_build_an_entry_once(cache, stub, tmp_path):
    nvcc, calls = fake_nvcc(tmp_path, stub, sleep=1.0)
    code = textwrap.dedent(f"""
        import json, pathlib
        from hippie_tpu_torch.ops import _build
        _build.BUILD_DIR = pathlib.Path({str(tmp_path / 'pkg_build')!r})
        _build._nvcc = lambda: {nvcc!r}
        _build.set_default_dir({str(cache)!r})
        secs = _build.build(["vae_sums"])
        print(json.dumps({{"secs": secs, "answer": _build.load("vae_sums").stub_answer()}}))
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [json.loads(p.communicate(timeout=120)[0].strip().splitlines()[-1]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(calls.read_text().splitlines()) == 1
    assert sorted(o["secs"]["vae_sums"] > 0.0 for o in outs) == [False, True]
    assert [o["answer"] for o in outs] == [42, 42]


def _kernel_dir_in_rank(mesh, cfg):
    """run_pipeline in a rank with the pipeline's body replaced: the kernel
    directories the rank would load from."""
    from hippie_tpu_torch.train import pipeline

    pipeline._run_unimodal_pipeline = lambda cfg, trackers: {
        "rank": mesh.rank, "dirs": [str(d) for d in _build.kernel_dirs()]}
    return pipeline.run_pipeline(cfg)


def test_pipeline_config_aot_dir_reaches_a_spawned_gloo_rank(cache, tmp_path):
    cfg = PipelineConfig(aot_dir=str(cache), dp_devices=2, device="cpu", verbose=False,
                         output_dir=str(tmp_path / "out"), checkpoint_dir=str(tmp_path / "ck"))
    got = pmesh.launch(_kernel_dir_in_rank, 2, cfg, device="cpu")
    assert [g["rank"] for g in got] == [0, 1]
    for g in got:
        assert g["dirs"][0] == str(cache / "torch_kernels")


@pytest.mark.parametrize("name", ["train_model", "lr_sweep", "kfold_eval", "serve_embeddings"])
def test_cli_flag_takes_the_jax_default(name):
    """Each port CLI that the JAX package gives --aot-dir has it, with the
    JAX default; "" is no cache (PipelineConfig.aot_dir None)."""
    import importlib
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_{name}_aot", REPO / "scripts" / f"{name}.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    port_cli = importlib.import_module(f"hippie_tpu_torch.scripts.{name}")
    want = os.path.join(os.path.expanduser("~"), ".cache", "hippie_tpu_aot")
    assert jax_cli.build_parser().get_default("aot_dir") == want
    assert port_cli.build_parser().get_default("aot_dir") == want
    if name == "train_model":
        p = port_cli.build_parser()
        assert port_cli.config_from_args(p.parse_args(["--device", "cpu", "--aot-dir", ""])).aot_dir is None
        assert port_cli.config_from_args(p.parse_args(["--device", "cpu"])).aot_dir == want
