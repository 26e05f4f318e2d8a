"""The inference CLI (hippie_tpu_torch/scripts/inference_from_trained_model.py)
against the JAX package's scripts/inference_from_trained_model.py.

Both CLIs run on the same JAX-written checkpoints of a non-default geometry
(z=4, 7 sources, 3 classes, blocks (1, 1, 1, 1)) given without geometry
flags, dual wave/time and joint, on a synthetic dataset with integer labels
(in an order of first appearance that is not sorted, so ``label_name`` maps
label 0 to another label's value, the JAX CLI's indexing; and labels past
the number of names, where it falls back to the labels), string labels, and
none. The files each writes: the same names; each CSV's header and its
``label`` and ``label_name`` columns equal; the embeddings within 1e-5 (the
same eval-mode float32 forward, as tests/test_torch_multimodal.py's embed
test); the clusters the same rows and labels, each cluster id below k (the
packages draw their seeds from different generators). The port's PNGs come
from the same PCA projection when umap-learn is absent.
"""

import csv
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from hippie_tpu.models import cvae as jcvae
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu_torch.data import synth
from hippie_tpu_torch.data.registry import write_csv
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import inference_from_trained_model as tinf

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
GEOMETRY = dict(z_dim=4, class_hidden_dim=5, num_sources=7, num_classes=3, num_blocks=(1, 1, 1, 1))
N = 24


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_inference_cli",
                                                  REPO / "scripts" / "inference_from_trained_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _templates(init, cfg):
    seen = []
    jax.eval_shape(lambda: seen.append(init(jax.random.PRNGKey(0), cfg)))

    def zeros(t):
        return {k: zeros(v) for k, v in t.items()} if isinstance(t, dict) else np.zeros(t.shape, t.dtype)

    return [zeros(t) for t in seen[0]]


def _jax_file(root, name: str, seed: int) -> str:
    """A .ckpt written by hippie_tpu's save_lightning_ckpt."""
    gen = torch.Generator().manual_seed(seed)
    if name == "joint":
        model = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(**GEOMETRY), gen, device="cpu")
        templates = _templates(jcvae.multimodal_cvae_init, jcvae.MultiModalConfig(**GEOMETRY))
    else:
        cfg = dict(GEOMETRY, output_size=50 if name == "wave" else 100)
        model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(**cfg), gen, device="cpu")
        templates = _templates(jcvae.unimodal_cvae_init, jcvae.CVAEConfig(**cfg))
    params, bn, _, skipped = jckpt.from_torch_state_dict(model.state_dict(), *templates, prefix="")
    assert not skipped
    path = str(root / f"{name}.ckpt")
    jckpt.save_lightning_ckpt(path, params, bn)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference_ckpts")
    return {name: _jax_file(root, name, seed) for seed, name in enumerate(("wave", "time", "joint"))}


LABELS = {"int": (2, 0, 1), "int_past_names": (7, 5, 6), "str": ("pyramidal", "interneuron", "granule")}


def _dataset(root, labels):
    """The synthetic dataset "rig", with a metadata label column cycling
    through LABELS[labels] (with a second column), or no metadata."""
    synth.make_dataset(str(root), "rig", n=N, seed=5)
    if labels in LABELS:
        write_csv(str(root / "rig" / "metadata.csv"), ["label", "depth"],
                  ([LABELS[labels][i % 3], i] for i in range(N)))
    return str(root)


def _table(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


CASES = [("dual", "int", "kmeans"), ("joint", "str", "gmm"), ("dual", "none", None),
         ("joint", "int_past_names", "kmeans")]


@pytest.mark.parametrize("mode,labels,cluster", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_inference_cli_matches_the_jax_cli(tmp_path, ckpts, capsys, mode, labels, cluster):
    root = _dataset(tmp_path / "data", labels)
    argv = ["--dataset", "rig", "--data-root", root]
    argv += (["--joint-checkpoint", ckpts["joint"]] if mode == "joint" else
             ["--wave-checkpoint", ckpts["wave"], "--time-checkpoint", ckpts["time"]])
    if cluster:
        argv += ["--cluster", "3", "--cluster-method", cluster]
    out = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    tinf.main(argv + ["--output-dir", str(out["port"]), "--device", "cpu"])
    said = capsys.readouterr().out
    assert "z_dim=4, num_sources=7, num_blocks=[1, 1, 1, 1]" in said and "were skipped" not in said
    assert "Inference completed successfully!" in said
    _jax_cli().main(argv + ["--output-dir", str(out["jax"])])
    capsys.readouterr()
    names = {p.name for p in out["jax"].iterdir()}
    assert {p.name for p in out["port"].iterdir()} == names
    kinds = ["joint"] if mode == "joint" else ["waveform", "isi", "joint"]
    assert {f"rig_{k}_embeddings.csv" for k in kinds} <= names
    assert ("rig_joint_clusters.csv" in names) == bool(cluster)
    for name in sorted(names):
        if not name.endswith(".csv"):
            continue
        (h, rows), (href, ref) = (_table(out[side] / name) for side in ("port", "jax"))
        assert h == href and len(rows) == len(ref) == N, name
        if name.endswith("_clusters.csv"):
            assert h == ["cluster", "label"]
            assert [r[1] for r in rows] == [r[1] for r in ref]
            assert {int(r[0]) for r in rows} <= {0, 1, 2}
            continue
        assert h[-2:] == ["label", "label_name"]
        assert [r[-2:] for r in rows] == [r[-2:] for r in ref], name
        got = np.asarray([[float(v) for v in r[:-2]] for r in rows])
        want = np.asarray([[float(v) for v in r[:-2]] for r in ref])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)


def test_cli_options_are_the_jax_clis_plus_device():
    ref = {a.dest: a for a in _jax_cli().build_parser()._actions}
    got = {a.dest: a for a in tinf.build_parser()._actions}
    assert sorted(o for a in got.values() for o in a.option_strings) == sorted(
        [o for a in ref.values() for o in a.option_strings] + ["--device"])
    assert got["device"].default == "cuda"
    for dest, a in ref.items():
        assert (got[dest].default, got[dest].choices) == (a.default, a.choices), dest


def test_a_load_failure_prints_the_jax_message_and_exits_with_1(tmp_path, capsys):
    root = _dataset(tmp_path / "data", "int")
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    argv = ["--dataset", "rig", "--data-root", root, "--joint-checkpoint", str(bad)]
    said = []
    for main, extra in ((tinf.main, ["--device", "cpu"]), (_jax_cli().main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--output-dir", str(tmp_path / "out")] + extra)
        assert e.value.code == 1
        said.append([line for line in capsys.readouterr().out.splitlines() if line.startswith("Error")])
    assert len(said[0]) == len(said[1]) == 1 and said[0][0].startswith("Error loading models: ")


def test_plots_are_skipped_without_matplotlib(monkeypatch, capsys, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    args = tinf.build_parser().parse_args(["--output-dir", str(tmp_path)])
    codes = np.arange(N) % 3
    tinf.save_plots(args, [("joint", np.ones((N, 4), np.float32))], codes, codes)
    assert capsys.readouterr().out.count("skipped") == 1
    assert list(tmp_path.iterdir()) == []
