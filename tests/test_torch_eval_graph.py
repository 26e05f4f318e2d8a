"""The server's per-bucket programs (hippie_tpu_torch/evaluate/eval_graph.py)
on the CPU, where they run eagerly over the same buffers as the card's CUDA
graphs.

- ``preprocess_pair_padded`` with the true widths as 0-d tensors (what a
  graph reads) equals the Python-int call bit for bit, and
  ``preprocess_pair_exact`` equals ``preprocess_pair``.
- One ``EmbeddingGraph`` key serves several raw widths, each run bit for
  bit ``preprocess_pair_padded`` plus ``embed_unimodal`` /
  ``embed_multimodal``; and within 1e-5 (the serving tests' tolerance) of
  the JAX ``preprocess_pair_padded`` plus ``embed_unimodal`` /
  ``embed_multimodal`` on weights carried across with
  ``state_dict_from_jax``.
- The server's capture and replay counts, and the artifact's per-bucket
  calls.

Small models (num_blocks=(1, 1, 1, 1), z=4); the card's check that a
replay equals the eager run bit for bit is in tests/test_torch_cuda_kernels.py.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hippie_tpu.evaluate import embeddings as jemb
from hippie_tpu.models import cvae as jcvae
from hippie_tpu.ops import preprocess as jpre
from hippie_tpu.ops import resample as jres
from hippie_tpu.train import checkpoint as jckpt
from hippie_tpu_torch import export as texport
from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.evaluate import eval_graph
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.ops import preprocess as tpre
from hippie_tpu_torch.scripts import serve_embeddings as tse
from hippie_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

Z = 4
W_CAP, I_CAP = 256, 512
WIDTHS = [(41, 91), (46, 100), (120, 333), (256, 512)]


@pytest.fixture(autouse=True)
def _free_tmp_path(tmp_path):
    """Remove what the test wrote: its checkpoints are MBs each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _raw(n: int, widths, seed: int = 0):
    """Raw rows of the given widths, zero-padded to the caps."""
    w, i = widths
    r = np.random.default_rng(seed + w)
    wf = np.zeros((n, W_CAP), np.float32)
    isi = np.zeros((n, I_CAP), np.float32)
    wf[:, :w] = r.normal(size=(n, w))
    isi[:, :i] = np.abs(r.normal(size=(n, i)))
    return wf, isi


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("widths", WIDTHS)
def test_tensor_widths_equal_int_widths(normalize, widths):
    wf, isi = (torch.from_numpy(a) for a in _raw(9, widths))
    w, i = widths
    mats = (tpre.device_interp_matrix(w, 50, W_CAP, "cpu"), tpre.device_interp_matrix(i, 100, I_CAP, "cpu"))
    want = tpre.preprocess_pair_padded(wf, isi, *mats, w, i, normalize=normalize)
    widths_t = torch.tensor([w, i])
    got = tpre.preprocess_pair_padded(wf, isi, *mats, widths_t[0], widths_t[1], normalize=normalize)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


@pytest.mark.parametrize("normalize", [False, True])
def test_exact_preprocessing_is_preprocess_pair(normalize):
    r = np.random.default_rng(2)
    wf, isi = r.normal(size=(7, 300)).astype(np.float32), np.abs(r.normal(size=(7, 91))).astype(np.float32)
    mats = (tpre.device_interp_matrix(300, 50, 300, "cpu"), tpre.device_interp_matrix(91, 100, 91, "cpu"))
    got = tpre.preprocess_pair_exact(torch.from_numpy(wf), torch.from_numpy(isi), *mats, normalize=normalize)
    want = tpre.preprocess_pair(wf, isi, normalize=normalize, device="cpu")
    for g, e in zip(got, want):
        assert torch.equal(g, e)


def _init_shapes(init, cfg):
    """An init's (params, state) shapes in its own key order, without
    running it (jax.eval_shape's output would sort the dicts' keys)."""
    seen = []
    jax.eval_shape(lambda: seen.append(init(jax.random.PRNGKey(0), cfg)))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(map(shapes, t))
        return jax.ShapeDtypeStruct(t.shape, t.dtype)

    return shapes(seen[0])


def _numpy_tree(tree):
    return {k: _numpy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


@pytest.fixture(scope="module")
def weights():
    """{name: (JAX params, JAX state, port model)}: JAX trees from seeded
    port models, and the port models loaded back from the trees with
    state_dict_from_jax."""
    out = {}
    for name, cfg_t, cfg_j, init, seed in (
            ("wave", tcvae.CVAEConfig(z_dim=Z, output_size=50, num_blocks=(1, 1, 1, 1)),
             jcvae.CVAEConfig(z_dim=Z, output_size=50, num_blocks=(1, 1, 1, 1)), jcvae.unimodal_cvae_init, 1),
            ("time", tcvae.CVAEConfig(z_dim=Z, output_size=100, num_blocks=(1, 1, 1, 1)),
             jcvae.CVAEConfig(z_dim=Z, output_size=100, num_blocks=(1, 1, 1, 1)), jcvae.unimodal_cvae_init, 2),
            ("joint", tcvae.MultiModalConfig(z_dim=Z, num_blocks=(1, 1, 1, 1)),
             jcvae.MultiModalConfig(z_dim=Z, num_blocks=(1, 1, 1, 1)), jcvae.multimodal_cvae_init, 3)):
        make = tcvae.multimodal_cvae_init if name == "joint" else tcvae.unimodal_cvae_init
        seeded = make(cfg_t, torch.Generator().manual_seed(seed), device="cpu")
        params, bn, _, skipped = jckpt.from_torch_state_dict(seeded.state_dict(), *_init_shapes(init, cfg_j),
                                                             prefix="")
        assert not skipped
        model = make(cfg_t, torch.Generator().manual_seed(99), device="cpu")
        model.load_state_dict(tckpt.state_dict_from_jax(_numpy_tree(params), _numpy_tree(bn)), strict=True)
        out[name] = (params, bn, model.eval())
    return out


def _embed_fn(weights, joint: bool):
    if joint:
        return lambda wave, isi, src: temb.embed_multimodal(weights["joint"][2], wave, isi, src)
    return lambda wave, isi, src: torch.cat([temb.embed_unimodal(weights["wave"][2], wave, src),
                                             temb.embed_unimodal(weights["time"][2], isi, src)], dim=1)


def _run(g, wf, isi, src, widths):
    g.host(0)[...] = wf
    g.host(1)[...] = isi
    g.host(2)[...] = src
    g.set_widths(*widths)
    g.upload()
    return g.fetch(g(), len(wf))


@pytest.mark.parametrize("joint", [False, True])
def test_one_key_serves_several_widths(weights, joint):
    """One padded key of 64 rows, three raw widths and normalize off; each
    run equals the plain preprocessing and embedding bit for bit and the
    JAX functions on the same weights within 1e-5."""
    space = eval_graph.GraphSpace("cpu")
    g = eval_graph.EmbeddingGraph(_embed_fn(weights, joint), 64, W_CAP, I_CAP, normalize=False, padded=True,
                                  space=space)
    src = np.random.default_rng(7).integers(0, 5, size=64)
    for widths in WIDTHS[:3]:
        wf, isi = _raw(64, widths, seed=3)
        got = _run(g, wf, isi, src, widths)
        w, i = widths
        wave, isi_p = tpre.preprocess_pair_padded(
            torch.from_numpy(wf), torch.from_numpy(isi), tpre.device_interp_matrix(w, 50, W_CAP, "cpu"),
            tpre.device_interp_matrix(i, 100, I_CAP, "cpu"), w, i)
        plain = _embed_fn(weights, joint)(wave, isi_p, torch.from_numpy(src)).numpy()
        np.testing.assert_array_equal(got, plain)
        jw, ji = jpre.preprocess_pair_padded(jnp.asarray(wf), jnp.asarray(isi),
                                             jnp.asarray(jres.padded_interp_matrix(w, 50, W_CAP)),
                                             jnp.asarray(jres.padded_interp_matrix(i, 100, I_CAP)),
                                             jnp.int32(w), jnp.int32(i))
        jsrc = jnp.asarray(src, jnp.int32)
        if joint:
            want = np.asarray(jemb.embed_multimodal(*weights["joint"][:2], jw, ji, jsrc))
        else:
            want = np.hstack([np.asarray(jemb.embed_unimodal(*weights["wave"][:2], jw, jsrc)),
                              np.asarray(jemb.embed_unimodal(*weights["time"][:2], ji, jsrc))])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (space.captures, space.replays, g.runs) == (1, 3, 3)


def test_exact_key_runs_preprocess_pair(weights):
    """A key wider than the caps: its own widths, preprocess_pair's bits."""
    space = eval_graph.GraphSpace("cpu")
    g = eval_graph.EmbeddingGraph(_embed_fn(weights, False), 64, 300, 91, normalize=True, padded=False,
                                  space=space)
    r = np.random.default_rng(4)
    wf, isi = r.normal(size=(64, 300)).astype(np.float32), np.abs(r.normal(size=(64, 91))).astype(np.float32)
    src = np.zeros(64, np.int64)
    got = _run(g, wf, isi, src, (300, 91))
    wave, isi_p = tpre.preprocess_pair(wf, isi, normalize=True, device="cpu")
    np.testing.assert_array_equal(got, _embed_fn(weights, False)(wave, isi_p, torch.from_numpy(src)).numpy())


@pytest.fixture(scope="module")
def service(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_graph")
    paths = {}
    for name in ("wave", "time"):
        paths[name] = str(tmp / f"{name}.ckpt")
        tckpt.save_lightning_ckpt(paths[name], weights[name][2].state_dict())
    yield tse.EmbeddingService(paths["wave"], paths["time"], z_dim=Z, device="cpu")
    shutil.rmtree(tmp, ignore_errors=True)


def test_server_counts_captures_and_replays(service):
    """The ladder captures its bucket; requests of any width under the
    caps replay it; a new key (a width past the caps, normalize) captures
    once. Every dispatch is one replay."""
    service.warmup([512])
    assert (service.graph_captures, service.graph_replays) == (1, 1)
    r = np.random.default_rng(5)
    for w, i in ((41, 91), (200, 400)):
        service.embed(r.normal(size=(64, w)).astype(np.float32), np.abs(r.normal(size=(64, i))).astype(np.float32),
                      1, False)
    assert (service.graph_captures, service.graph_replays) == (1, 3)
    wf, isi = r.normal(size=(3, 300)).astype(np.float32), np.abs(r.normal(size=(3, 91))).astype(np.float32)
    service.embed(wf, isi, 0, False)  # exact widths: a key of its own
    service.embed(wf[:, :41], isi, 0, True)  # normalize: a key of its own
    assert (service.graph_captures, service.graph_replays) == (3, 5)
    assert service.device_dispatches == service.graph_replays
    assert set(service._graphs) == {(512, False, None), (512, False, (300, 91)), (512, True, None)}


def test_run_group_eager_equals_the_program(service):
    """The eager path of _run_group (the card's checks' reference) replies
    as the program, and moves no count."""
    r = np.random.default_rng(6)
    items = [tse._Item(r.normal(size=(n, 41)).astype(np.float32), np.abs(r.normal(size=(n, 91))).astype(np.float32),
                       s, False) for n, s in ((5, 0), (7, 3))]
    service._run_group(items)
    run = [it.out[2] for it in items]
    counts = (service.graph_captures, service.graph_replays, service.device_dispatches)
    again = [tse._Item(it.wf, it.isi, it.source, False) for it in items]
    service._run_group(again, eager=True)
    for a, b in zip(again, run):
        np.testing.assert_array_equal(a.out[2], b)
    assert (service.graph_captures, service.graph_replays, service.device_dispatches) == counts


def test_artifact_call_runs_one_program_per_bucket(weights, tmp_path):
    """load_artifact's call: one program per row bucket (1 and 415 rows
    share 512), its eager twin bit-equal, each reply within 1e-5 of the
    JAX embed_unimodal of the same weights."""
    ckpt = str(tmp_path / "wave.ckpt")
    tckpt.save_lightning_ckpt(ckpt, weights["wave"][2].state_dict())
    art = str(tmp_path / "wave.hippie")
    texport.export_from_checkpoint(ckpt, art, device="cpu")
    call, _ = texport.load_artifact(art, device="cpu")
    r = np.random.default_rng(8)
    for n in (1, 415):
        x, s = r.normal(size=(n, 50)).astype(np.float32), r.integers(0, 5, size=n)
        got = call(x, s)
        assert got.shape == (n, Z)
        assert torch.equal(got, call.eager(x, s))
        want = np.asarray(jemb.embed_unimodal(*weights["wave"][:2], jnp.asarray(x), jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert (call.space.captures, call.space.replays) == (1, 2)
    assert sorted(call.graphs) == [(512, (50,), ())]
