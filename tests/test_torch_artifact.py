"""The port's deployable embedding artifact (hippie_tpu_torch/export.py,
scripts/export_model.py, scripts/bench_artifact.py, the server's
--*-artifact backends) on the CPU at num_blocks=(1, 1, 1, 1), z=4.

Limits: an artifact's reply against the model called directly
(evaluate/embeddings.py) 1e-6 at 1, 3 and 64 rows (the same float32 ops in
the same order; measured 0); against the JAX package's artifact of the same
weights (JAX init, carried into the port by ``state_dict_from_jax``) 1e-5,
two frameworks' float32 forwards through the z-scoring
(tests/test_torch_serving.py holds replies of the two servers to 1e-4);
the server's artifact backends against its checkpoint backends 1e-6.
"""

import json
import re
import shutil
import zipfile

import jax
import numpy as np
import pytest
import torch

from hippie_tpu import export as jexport
from hippie_tpu.models import cvae as jcvae
from hippie_tpu_torch import export as texport
from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.scripts import bench_artifact, export_model
from hippie_tpu_torch.scripts import serve_embeddings as tse
from hippie_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

Z = 4
NB = (1, 1, 1, 1)


@pytest.fixture(autouse=True)
def _free_tmp_path(tmp_path):
    """Remove what the test wrote: its checkpoints are tens of MB each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_init(init, cfg, seed):
    return jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Unimodal (wave) and joint models with JAX-initialized weights carried
    into the port by state_dict_from_jax, their checkpoints and artifacts."""
    from hippie_tpu_torch.models import cvae as tcvae

    tmp = tmp_path_factory.mktemp("artifact")
    out = {}
    for name, jinit, jcfg, tinit, tcfg in (
            ("wave", jcvae.unimodal_cvae_init, jcvae.CVAEConfig(z_dim=Z, output_size=50, num_blocks=NB),
             tcvae.unimodal_cvae_init, tcvae.CVAEConfig(z_dim=Z, output_size=50, num_blocks=NB)),
            ("joint", jcvae.multimodal_cvae_init, jcvae.MultiModalConfig(z_dim=Z, num_blocks=NB),
             tcvae.multimodal_cvae_init, tcvae.MultiModalConfig(z_dim=Z, num_blocks=NB))):
        params, bn = _jax_init(jinit, jcfg, 7)
        model = tinit(tcfg, torch.Generator().manual_seed(0), device="cpu")
        model.load_state_dict(tckpt.state_dict_from_jax(params, bn))
        ckpt = str(tmp / f"{name}.ckpt")
        tckpt.save_lightning_ckpt(ckpt, model.state_dict())
        art = str(tmp / f"{name}.hippie")
        manifest = texport.export_from_checkpoint(ckpt, art, device="cpu")
        out[name] = {"model": model.eval(), "ckpt": ckpt, "artifact": art, "manifest": manifest}
    # the time slot's model: another unimodal one, at the ISI length
    tmodel = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=Z, output_size=100, num_blocks=NB),
                                      torch.Generator().manual_seed(1), device="cpu")
    ckpt = str(tmp / "time.ckpt")
    tckpt.save_lightning_ckpt(ckpt, tmodel.state_dict())
    art = str(tmp / "time.hippie")
    out["time"] = {"model": tmodel.eval(), "ckpt": ckpt, "artifact": art,
                   "manifest": texport.export_from_checkpoint(ckpt, art, device="cpu")}
    out["dir"] = tmp
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _rows(name, n, seed=0):
    r = np.random.default_rng(seed + n)
    src = r.integers(0, 5, size=n).astype(np.int32)
    if name == "joint":
        return r.normal(size=(n, 50)).astype(np.float32), r.normal(size=(n, 100)).astype(np.float32), src
    return r.normal(size=(n, 50 if name == "wave" else 100)).astype(np.float32), src


def _direct(entry, name, arrays):
    t = [torch.from_numpy(a) for a in arrays]
    t[-1] = t[-1].long()
    if name == "joint":
        return temb.embed_multimodal(entry["model"], *t).numpy()
    return temb.embed_unimodal(entry["model"], *t).numpy()


@pytest.mark.parametrize("name", ["wave", "joint"])
def test_round_trip_equals_the_direct_call(models, name):
    call, manifest = texport.load_artifact(models[name]["artifact"], device="cpu")
    assert manifest == {**models[name]["manifest"], "format_version": texport.FORMAT_VERSION}
    for n in (1, 3, 64):
        arrays = _rows(name, n)
        got = call(*arrays)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu" and got.shape == (n, Z)
        np.testing.assert_allclose(got.numpy(), _direct(models[name], name, arrays), rtol=0, atol=1e-6)


def test_artifact_is_a_zip_with_a_symbolic_batch(models):
    with zipfile.ZipFile(models["wave"]["artifact"]) as zf:
        assert sorted(zf.namelist()) == ["manifest.json", "model.pt2"]
        import io

        ep = torch.export.load(io.BytesIO(zf.read("model.pt2")))
    batch = [n.meta["val"].shape[0] for n in ep.graph.nodes if n.op == "placeholder"
             and n.name in ep.graph_signature.user_inputs]
    assert len(batch) == 2 and all(isinstance(b, torch.SymInt) for b in batch)
    # the decoder is gone from the graph: nothing reads its weights
    decoder = [n for n in ep.graph.nodes if n.op == "placeholder" and "decoder" in n.name]
    assert decoder and not any(n.users for n in decoder)


@pytest.mark.parametrize("name", ["wave", "joint"])
def test_matches_the_jax_artifact_of_the_same_weights(models, name, tmp_path):
    jpath = str(tmp_path / f"{name}_jax.hippie")
    jmanifest = jexport.export_from_checkpoint(models[name]["ckpt"], jpath, platforms=("cpu",))
    jcall, _ = jexport.load_artifact(jpath)
    call, manifest = texport.load_artifact(models[name]["artifact"], device="cpu")
    # the manifest's keys are JAX's, with torch_version for jax_version
    assert list(manifest) == [k.replace("jax_version", "torch_version") for k in
                              json.loads(zipfile.ZipFile(jpath).read("manifest.json"))]
    assert {k: v for k, v in manifest.items() if k not in ("platforms", "torch_version", "format_version")} == {
        k: v for k, v in jmanifest.items() if k not in ("platforms", "jax_version")}
    for n in (1, 3, 64):
        arrays = _rows(name, n, seed=5)
        np.testing.assert_allclose(call(*arrays).numpy(), np.asarray(jcall(*arrays)), rtol=0, atol=1e-5)


def test_bad_artifacts_raise(models, tmp_path):
    with zipfile.ZipFile(models["wave"]["artifact"]) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        blob = zf.read("model.pt2")
    old = tmp_path / "v2.hippie"
    with zipfile.ZipFile(old, "w") as zf:
        zf.writestr("manifest.json", json.dumps(dict(manifest, format_version=2)))
        zf.writestr("model.pt2", blob)
    with pytest.raises(ValueError, match="format_version 2.*reads version 1"):
        texport.load_artifact(str(old), device="cpu")
    shlo = tmp_path / "jax.hippie"
    with zipfile.ZipFile(shlo, "w") as zf:
        zf.writestr("manifest.json", json.dumps({**manifest, "format_version": 1, "jax_version": "0.4"}))
        zf.writestr("model.shlo", b"\0")
    with pytest.raises(ValueError, match="StableHLO.*needs JAX"):
        texport.load_artifact(str(shlo), device="cpu")
    cuda_only = tmp_path / "cuda_only.hippie"
    texport.save_artifact(str(cuda_only), blob, dict(manifest, platforms=["cuda"]))
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not cpu"):
        texport.load_artifact(str(cuda_only), device="cpu")
    for platforms in (("cpu", "tpu"), ()):
        with pytest.raises(ValueError, match="runs on"):
            texport.export_embedder(models["wave"]["model"], input_len=50, platforms=platforms)
    with pytest.raises(ValueError, match="precision"):
        texport.export_embedder(models["wave"]["model"], input_len=50, precision="bf16")


def test_default_precision_artifact_on_the_cpu(models, tmp_path):
    """'default' allows TF32 on the card and changes nothing on the CPU; the
    context restores the switches."""
    path = str(tmp_path / "tf32.hippie")
    export_model.main(["--checkpoint", models["wave"]["ckpt"], "--output", path, "--precision", "default",
                       "--device", "cpu"])
    call, manifest = texport.load_artifact(path, device="cpu")
    assert manifest["precision"] == "default"
    arrays = _rows("wave", 8)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    np.testing.assert_array_equal(call(*arrays).numpy(), texport.load_artifact(
        models["wave"]["artifact"], device="cpu")[0](*arrays).numpy())
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved


def test_server_artifact_backends_reply_as_the_checkpoint_backends(models):
    r = np.random.default_rng(3)
    wf, isi = r.normal(size=(9, 41)).astype(np.float32), np.abs(r.normal(size=(9, 91))).astype(np.float32)
    ck = tse.EmbeddingService(models["wave"]["ckpt"], models["time"]["ckpt"], z_dim=Z, device="cpu")
    art = tse.EmbeddingService(wave_artifact=models["wave"]["artifact"],
                               time_artifact=models["time"]["artifact"], z_dim=10, device="cpu")
    mixed = tse.EmbeddingService(time_ckpt=models["time"]["ckpt"], wave_artifact=models["wave"]["artifact"],
                                 z_dim=10, device="cpu")
    assert (art.mode, art.z_dim, art.num_sources) == ("dual", Z, 5)
    want = ck.embed(wf, isi, 2, False)
    for service in (art, mixed):
        got = service.embed(wf, isi, 2, False)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    jck = tse.EmbeddingService(joint_ckpt=models["joint"]["ckpt"], z_dim=Z, device="cpu")
    jart = tse.EmbeddingService(joint_artifact=models["joint"]["artifact"], z_dim=10, device="cpu")
    assert jart.mode == "joint" and jart.z_dim == Z
    np.testing.assert_allclose(jart.embed(wf, isi, 1, True)[2], jck.embed(wf, isi, 1, True)[2],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw,match", [
    (dict(wave_artifact="time", time_artifact="time"), "expects input length 100"),
    (dict(wave_artifact="joint", time_artifact="time"), "not a unimodal export"),
    (dict(joint_artifact="wave"), "not a multimodal export"),
    (dict(joint_artifact="joint", wave_artifact="wave"), "exclusive"),
])
def test_server_refuses_the_wrong_artifact(models, kw, match):
    with pytest.raises(ValueError, match=match):
        tse.EmbeddingService(z_dim=Z, device="cpu", **{k: models[v]["artifact"] for k, v in kw.items()})


def test_bucketed_artifact_call_pads_and_cuts():
    """An artifact's call (export.ArtifactCall, an eval_graph.BucketedCall)
    runs its program on the rows padded to the bucket and cuts the reply
    back."""
    from hippie_tpu_torch.evaluate import eval_graph

    seen = []

    def call(*arrays):
        seen.append(tuple(a.shape for a in arrays))
        return arrays[0][:, :2] * 2

    run = eval_graph.BucketedCall(call, (torch.float32, torch.long), eval_graph.GraphSpace("cpu"))
    x = torch.arange(10.0).reshape(5, 2)
    out = run(x, torch.zeros(5, dtype=torch.long))
    assert seen == [((512, 2), (512,))]
    assert torch.equal(out, x * 2)


def test_cli_export_and_bench(models, tmp_path, capsys):
    path = str(tmp_path / "cli.hippie")
    export_model.main(["--checkpoint", models["time"]["ckpt"], "--output", path, "--device", "cpu",
                       "--platforms", "cpu"])
    said = capsys.readouterr().out
    assert "exported" in said and "'torch_version'" in said
    records = bench_artifact.main(["--artifact", path, "--rows", "2,5", "--iters", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "card: cpu"
    assert [json.loads(x) for x in lines[1:]] == records
    assert [r["rows"] for r in records] == [2, 5]
    for r in records:
        assert set(r) == {"device", "rows", "cold_ms", "warm_ms", "rows_per_sec", "z_dim", "modality"}
        assert r["device"] == "cpu" and r["z_dim"] == Z and r["modality"] == "unimodal" and r["warm_ms"] > 0


def _jax_options(path: str) -> set:
    """The option strings of a JAX script's add_argument calls."""
    return set(re.findall(r"add_argument\(\s*\"(--[a-z0-9-_]+)\"", open(path).read()))


def _options(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings if o.startswith("--")} - {"--help"}


@pytest.mark.parametrize("port,jax_script", [(export_model.build_parser, "scripts/export_model.py"),
                                             (bench_artifact.build_parser, "scripts/bench_artifact.py")])
def test_cli_options_are_jax_plus_device(port, jax_script):
    assert _options(port()) == _jax_options(jax_script) | {"--device"}
