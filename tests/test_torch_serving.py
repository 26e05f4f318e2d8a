"""The port's embedding server (hippie_tpu_torch/scripts/serve_embeddings.py)
and load-test client, on the CPU (``device="cpu"``, port 0), mirroring
tests/test_serving.py on checkpoints written here at num_blocks=(1, 1, 1, 1).

Against the JAX package: ``padded_interp_matrix`` bit for bit;
``preprocess_pair_padded`` within 1e-5 (the sums' order differs), with and
without ``normalize``, at three raw widths under the caps; one ``embed``
reply within 1e-4 of the JAX ``EmbeddingService.embed`` on the same
checkpoints (float32 forwards of two frameworks through the z-scoring).
Coalesced and concurrent replies equal serial ones at rtol 1e-5 / atol 1e-6
(tests/test_serving.py:164-190).
"""

import http.client
import io
import json
import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from hippie_tpu_torch.evaluate import embeddings as temb
from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.ops import preprocess as tpre
from hippie_tpu_torch.ops import resample as tres
from hippie_tpu_torch.scripts import serve_embeddings as tse
from hippie_tpu_torch.scripts import serving_load_test as tload
from hippie_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

Z = 4


def _write_ckpt(path, model):
    tckpt.save_lightning_ckpt(str(path), model.state_dict())
    return str(path)


def _unimodal(out: int, seed: int):
    return tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=Z, output_size=out, num_blocks=(1, 1, 1, 1)),
                                    torch.Generator().manual_seed(seed), device="cpu").eval()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    return {name: _write_ckpt(tmp / f"{name}.ckpt", _unimodal(out, out))
            for name, out in (("wave", 50), ("time", 100))}


@contextlib.contextmanager
def _http(service):
    httpd = tse.EmbeddingHTTPServer(("127.0.0.1", 0), tse.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def server(ckpts):
    service = tse.EmbeddingService(ckpts["wave"], ckpts["time"], z_dim=Z, device="cpu")
    with _http(service) as addr:
        yield addr, service


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request(method, path, body=json.dumps(body) if body else None,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _rows(r, n, w=46, i=80):
    return r.normal(size=(n, w)).astype(np.float32), np.abs(r.normal(size=(n, i))).astype(np.float32)


def test_healthz(server):
    addr, _ = server
    status, payload = _request(addr, "GET", "/healthz")
    assert status == 200 and payload == {"status": "ok", "z_dim": Z, "mode": "dual", "num_sources": 5}


def test_embed_roundtrip_equals_the_models_called_directly(server, ckpts):
    addr, service = server
    wf, isi = _rows(np.random.default_rng(0), 5)
    status, payload = _request(addr, "POST", "/embed",
                               {"waveforms": wf.tolist(), "isi_dists": isi.tolist(), "source": 2})
    assert status == 200
    assert np.asarray(payload["waveform"]).shape == (5, Z) and np.asarray(payload["joint"]).shape == (5, 2 * Z)
    w, i, j, _ = service.embed(wf, isi, 2, False)
    np.testing.assert_allclose(np.asarray(payload["joint"]), j, rtol=1e-5, atol=1e-6)
    # the checkpoints' models called directly on preprocess_pair of the same rows
    from hippie_tpu_torch import export

    wave, isi_p = tpre.preprocess_pair(wf, isi, device="cpu")
    src = torch.full((5,), 2, dtype=torch.long)
    mw, _ = export.load_model_from_ckpt(ckpts["wave"], device="cpu")
    mt, _ = export.load_model_from_ckpt(ckpts["time"], device="cpu")
    np.testing.assert_allclose(w, temb.embed_unimodal(mw, wave, src).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(i, temb.embed_unimodal(mt, isi_p, src).numpy(), rtol=1e-5, atol=1e-5)


def test_embed_bad_requests(server):
    addr, _ = server
    status, payload = _request(addr, "POST", "/embed", {"waveforms": [[1, 2]]})
    assert status == 400 and "isi_dists" in payload["error"]
    status, _ = _request(addr, "POST", "/embed", {"waveforms": [[1, 2]], "isi_dists": [[1], [2]]})
    assert status == 400
    status, _ = _request(addr, "GET", "/nope")
    assert status == 404
    status, payload = _request(addr, "POST", "/embed",
                               {"waveforms": [[1, 2]], "isi_dists": [[1, 2]], "source": 999})
    assert status == 400 and "source" in payload["error"]


def test_worker_error_surfaces_as_500(server):
    addr, service = server
    saved = dict(service._embed_fns)

    def boom(*a, **kw):
        raise RuntimeError("injected device failure")

    try:
        service._embed_fns = {k: boom for k in saved}
        status, payload = _request(addr, "POST", "/embed",
                                   {"waveforms": [[1.0, 2.0]], "isi_dists": [[1.0, 2.0]]})
        assert status == 500 and "injected device failure" in payload["error"]
    finally:
        service._embed_fns = saved
    status, _ = _request(addr, "POST", "/embed", {"waveforms": [[1.0, 2.0]], "isi_dists": [[1.0, 2.0]]})
    assert status == 200


def test_coalesced_group_matches_serial(server):
    _, service = server
    r = np.random.default_rng(3)
    items = [tse._Item(*_rows(r, n), src, False) for n, src in ((3, 0), (5, 2), (2, 1))]
    before = service.device_dispatches
    service._run_group(list(items))
    assert service.device_dispatches == before + 1
    for it in items:
        assert it.event.is_set() and it.err is None
        w, i, j, _ = it.out
        sw, si, sj, _ = service.embed(it.wf, it.isi, it.source, it.normalize)
        np.testing.assert_allclose(j, sj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(w, sw, rtol=1e-5, atol=1e-6)


def test_concurrent_clients(server):
    addr, service = server
    r = np.random.default_rng(4)
    inputs = [_rows(r, 4) for _ in range(6)]
    results = [None] * len(inputs)

    def client(k):
        wf, isi = inputs[k]
        results[k] = _request(addr, "POST", "/embed", {"waveforms": wf.tolist(), "isi_dists": isi.tolist()})

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # each reply against its rows served in one group (equal to serial, above)
    items = [tse._Item(wf, isi, 0, False) for wf, isi in inputs]
    service._run_group(items)
    for (status, payload), it in zip(results, items):
        assert status == 200
        np.testing.assert_allclose(np.asarray(payload["joint"]), it.out[2], rtol=1e-5, atol=1e-6)
    status, stats = _request(addr, "GET", "/stats")
    assert status == 200 and stats["requests"] >= len(inputs) and stats["device_dispatches"] >= 1
    assert "p50_latency_ms" in stats and "p99_latency_ms" in stats


def test_load_test_client_reports_the_stats_delta(server):
    addr, _ = server
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        res = tload.main(["--url", f"http://{addr[0]}:{addr[1]}", "--clients", "3", "--requests", "2",
                          "--rows", "8"])
    assert json.loads(said.getvalue()) == res
    assert res["requests"] == 6 and res["mode"] == "dual" and res["rows_per_request"] == 8
    assert 1 <= res["device_dispatches"] <= 6 and res["client_p99_ms"] >= res["client_p50_ms"] > 0


def test_joint_service_from_checkpoint(tmp_path):
    model = tcvae.multimodal_cvae_init(tcvae.MultiModalConfig(z_dim=Z, num_blocks=(1, 1, 1, 1)),
                                       torch.Generator().manual_seed(9), device="cpu").eval()
    ckpt = _write_ckpt(tmp_path / "joint.ckpt", model)
    service = tse.EmbeddingService(z_dim=99, joint_ckpt=ckpt, device="cpu")
    assert service.mode == "joint" and service.z_dim == Z
    wf, isi = _rows(np.random.default_rng(5), 5)
    w, i, j, _ = service.embed(wf, isi, 1, False)
    assert w is None and i is None and j.shape == (5, Z)
    wave, isi_p = tpre.preprocess_pair(wf, isi, device="cpu")
    want = temb.embed_multimodal(model, wave, isi_p, torch.ones(5, dtype=torch.long)).numpy()
    np.testing.assert_allclose(j, want, rtol=1e-5, atol=1e-5)
    with _http(service) as addr:
        status, payload = _request(addr, "POST", "/embed",
                                   {"waveforms": wf.tolist(), "isi_dists": isi.tolist(), "source": 1})
        assert status == 200 and "waveform" not in payload and "isi" not in payload
        np.testing.assert_allclose(np.asarray(payload["joint"]), want, rtol=1e-4, atol=1e-5)
        status, health = _request(addr, "GET", "/healthz")
        assert health["mode"] == "joint"
    with pytest.raises(ValueError, match="exclusive"):
        tse.EmbeddingService(ckpt, None, z_dim=Z, joint_ckpt=ckpt, device="cpu")


def test_chunk_to_warm_buckets(server):
    _, service = server

    def items(rows_list):
        return [tse._Item(np.zeros((r, 46), np.float32), np.zeros((r, 80), np.float32), 0, False)
                for r in rows_list]

    saved = service._max_bucket
    try:
        service._max_bucket = 0
        assert [len(c) for c in service._chunk_to_warm_buckets(items([64] * 16))] == [1] * 16
        service._max_bucket = 512
        chunks = service._chunk_to_warm_buckets(items([64] * 16))
        assert [sum(len(it.wf) for it in c) for c in chunks] == [512, 512]
        chunks = service._chunk_to_warm_buckets(items([700, 64]))
        assert [sum(len(it.wf) for it in c) for c in chunks] == [700, 64]
        chunks = service._chunk_to_warm_buckets(items([64, 64]))
        assert [sum(len(it.wf) for it in c) for c in chunks] == [128]
    finally:
        service._max_bucket = saved


def test_warmup_ladder(server):
    _, service = server
    saved = service._max_bucket
    before = service.requests
    try:
        service._max_bucket = 0
        service.warmup([512, 600, 1024])  # 600 buckets to 1024: deduplicated
        assert service._max_bucket == 1024
        assert service.requests - before == 2
        service.warmup(0)  # the legacy int form, 0 = no-op
        assert service.requests - before == 2
    finally:
        service._max_bucket = max(saved, service._max_bucket)


def test_warmup_widths_respect_caps(server):
    _, service = server
    b = service._bucket_rows(64)
    assert b == 512
    seen = []
    orig_embed = service.embed
    saved = (service.max_wave_width, service.max_isi_width)
    service.embed = lambda wf, isi, src, norm: seen.append((wf.shape, isi.shape))
    try:
        service.max_wave_width, service.max_isi_width = 40, 80
        service.warmup([64])
        assert seen == [((b, 40), (b, 80))]
        seen.clear()
        service.max_wave_width, service.max_isi_width = 256, 512
        service.warmup([64])
        assert seen == [((b, 46), (b, 100))]
    finally:
        service.embed = orig_embed
        service.max_wave_width, service.max_isi_width = saved


def test_warmup_async_interleaves_with_live_requests(server):
    _, service = server
    started, done = threading.Event(), threading.Event()

    def warm():
        started.set()
        service.warmup([512])
        done.set()

    t = threading.Thread(target=warm)
    t.start()
    started.wait(5)
    wf, isi = _rows(np.random.default_rng(5), 3, i=100)
    _, _, j, _ = service.embed(wf, isi, 0, False)
    assert j.shape == (3, 2 * Z)
    t.join(60)
    assert done.is_set()


def test_live_path_and_warmup_share_bucket_rule(server, monkeypatch):
    _, service = server
    calls = []
    real = type(service)._bucket_rows

    def recording(n):
        b = real(n)
        calls.append((n, b))
        return b

    monkeypatch.setattr(type(service), "_bucket_rows", staticmethod(recording))
    wf, isi = _rows(np.random.default_rng(3), 5, i=100)
    service.embed(wf, isi, 0, False)
    live = [b for (n, b) in calls if n == 5]
    assert live
    calls.clear()
    orig_embed = service.embed
    service.embed = lambda *a: None
    try:
        service.warmup([5])
        warm = [b for (n, b) in calls if n == 5]
        assert warm and warm[0] == live[0]
    finally:
        service.embed = orig_embed


def test_widths_beyond_the_caps_take_the_exact_path(server):
    """A raw width above its cap is preprocessed at its own width, with the
    same embeddings as the padded path would give under a larger cap."""
    _, service = server
    wf, isi = _rows(np.random.default_rng(12), 4, w=300, i=90)
    _, _, j, _ = service.embed(wf, isi, 0, True)
    saved = service.max_wave_width
    try:
        service.max_wave_width = 512
        _, _, j_padded, _ = service.embed(wf, isi, 0, True)
    finally:
        service.max_wave_width = saved
    np.testing.assert_allclose(j, j_padded, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("argv", [["--wave-artifact", "a.hippie"], ["--time-artifact", "b.hippie"],
                                  ["--joint-artifact", "j.hippie"]])
def test_artifact_flags_raise_naming_the_roadmap_item(argv, tmp_path, ckpts):
    """Each --*-artifact flag reaches export.load_artifact, which refuses a
    JAX StableHLO artifact (model.shlo) and says why (the time slot's after
    a wave checkpoint, which its slot is read before). The backends'
    replies are tests/test_torch_artifact.py's."""
    import zipfile

    path = tmp_path / argv[1]
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format_version": 1, "modality": "unimodal",
                                                 "platforms": ["cpu", "tpu"], "jax_version": "0.4"}))
        zf.writestr("model.shlo", b"\0")
    with pytest.raises(ValueError, match="StableHLO export .model.shlo., which needs JAX"):
        wave = ["--wave-checkpoint", ckpts["wave"]] if argv[0] == "--time-artifact" else []
        tse.main(wave + [argv[0], str(path), "--device", "cpu"])


def test_aot_dir_raises():
    with pytest.raises(ValueError, match="--aot-dir.*no port target"):
        tse.main(["--aot-dir", "x", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_len,out_len,cap", [(41, 50, 256), (46, 50, 46), (91, 100, 512),
                                                (128, 100, 512), (7, 50, 8)])
def test_padded_interp_matrix_is_the_jax_one(in_len, out_len, cap):
    from hippie_tpu.ops import resample as jres

    got = tres.padded_interp_matrix(in_len, out_len, cap)
    want = jres.padded_interp_matrix(in_len, out_len, cap)
    assert got.dtype == want.dtype == np.float32 and got.shape == (cap, out_len)
    np.testing.assert_array_equal(got, want)
    for mod in (tres, jres):
        with pytest.raises(ValueError, match="exceeds padded width cap"):
            mod.padded_interp_matrix(cap + 1, out_len, cap)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("widths", [(41, 91), (46, 80), (120, 333)])
def test_preprocess_pair_padded_matches_jax(normalize, widths):
    import jax.numpy as jnp

    from hippie_tpu.ops import preprocess as jpre
    from hippie_tpu.ops import resample as jres

    w_raw, i_raw = widths
    r = np.random.default_rng(w_raw)
    wf = np.zeros((6, 256), np.float32)
    isi = np.zeros((6, 512), np.float32)
    wf[:, :w_raw] = r.normal(size=(6, w_raw))
    isi[:, :i_raw] = np.abs(r.normal(size=(6, i_raw)))
    want = jpre.preprocess_pair_padded(
        jnp.asarray(wf), jnp.asarray(isi), jnp.asarray(jres.padded_interp_matrix(w_raw, 50, 256)),
        jnp.asarray(jres.padded_interp_matrix(i_raw, 100, 512)), jnp.int32(w_raw), jnp.int32(i_raw),
        normalize=normalize)
    got = tpre.preprocess_pair_padded(
        torch.from_numpy(wf), torch.from_numpy(isi), tpre.device_interp_matrix(w_raw, 50, 256, "cpu"),
        tpre.device_interp_matrix(i_raw, 100, 512, "cpu"), w_raw, i_raw, normalize=normalize)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # and the exact-width preprocessing of the unpadded rows
    exact = tpre.preprocess_pair(wf[:, :w_raw], isi[:, :i_raw], normalize=normalize, device="cpu")
    for g, e in zip(got, exact):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-5, atol=1e-5)


def test_embed_reply_matches_the_jax_service(ckpts):
    sys.path.insert(0, "scripts")
    import serve_embeddings as jse

    jservice = jse.EmbeddingService(ckpts["wave"], ckpts["time"], z_dim=Z)
    service = tse.EmbeddingService(ckpts["wave"], ckpts["time"], z_dim=Z, device="cpu")
    wf, isi = _rows(np.random.default_rng(13), 7, w=41, i=91)
    jw, ji, jj, _ = jservice.embed(wf, isi, 3, False)
    w, i, j, _ = service.embed(wf, isi, 3, False)
    np.testing.assert_allclose(j, np.asarray(jj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-4, atol=1e-4)
