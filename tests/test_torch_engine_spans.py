"""The embedding engine's spans and counters
(hippie_tpu_torch/scripts/serve_embeddings.py with a
hippie_tpu_torch/utils/profiling.py ``Spans`` recorder), on the CPU, on
unimodal checkpoints written here at num_blocks=(1, 1, 1, 1) as in
tests/test_torch_serving.py. No JAX: the spans have no JAX counterpart.
"""

import linecache
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hippie_tpu_torch.models import cvae as tcvae
from hippie_tpu_torch.scripts import serve_embeddings as tse
from hippie_tpu_torch.train import checkpoint as tckpt
from hippie_tpu_torch.utils.profiling import Phases, Span, Spans

torch.set_num_threads(1)

Z = 4
PHASES = ("engine.gather", "engine.stage", "engine.upload", "engine.run", "engine.capture", "engine.fetch",
          "engine.reply")
OLD_STATS = ("mode", "requests", "rows_embedded", "device_dispatches", "coalesced_requests", "mean_latency_ms",
             "p50_latency_ms", "p99_latency_ms")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    out = {}
    for name, size in (("wave", 50), ("time", 100)):
        model = tcvae.unimodal_cvae_init(tcvae.CVAEConfig(z_dim=Z, output_size=size, num_blocks=(1, 1, 1, 1)),
                                         torch.Generator().manual_seed(size), device="cpu").eval()
        out[name] = str(tmp / f"{name}.ckpt")
        tckpt.save_lightning_ckpt(out[name], model.state_dict())
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _service(ckpts, spans=None, **kw):
    """A service on the CPU; ``spans`` set as its recorder while the worker
    waits on the empty queue (traced from its first take on)."""
    svc = tse.EmbeddingService(ckpts["wave"], ckpts["time"], z_dim=Z, device="cpu", **kw)
    svc.spans = spans
    return svc


def _rows(r, n, w=46, i=80):
    return r.normal(size=(n, w)).astype(np.float32), np.abs(r.normal(size=(n, i))).astype(np.float32)


def _settle(rec, dispatches, timeout=60.0):
    """Until ``rec`` holds that many dispatches: the worker records a
    dispatch's span after it has woken its waiters."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if [s.name for s in rec.spans()].count("engine.dispatch") == dispatches:
            return
        time.sleep(0.01)
    raise AssertionError("the worker did not finish recording")


def _wait_on_the_queue(svc, timeout=60.0):
    """Until the dispatch worker is blocked on the empty queue."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        f = sys._current_frames().get(svc._worker.ident)
        if f is not None and "self._queue.get()" in linecache.getline(f.f_code.co_filename, f.f_lineno):
            return
        time.sleep(0.01)
    raise AssertionError("the worker did not return to the queue")


def _concurrent(svc, inputs, blocked):
    """``inputs`` embedded from one thread each while the worker is held in
    a run, so that they are taken together in one batch."""
    threads = [threading.Thread(target=svc.embed, args=(wf, isi, 0, False)) for wf, isi in inputs]

    def enqueue():
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while svc._queue.qsize() < len(inputs) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert svc._queue.qsize() == len(inputs)

    _held(svc, blocked, enqueue)
    for t in threads:
        t.join(120)
        assert not t.is_alive()


def _held(svc, blocked, enqueue):
    """Runs ``enqueue()`` while the worker is held in the run of the request
    ``blocked``, so that what it enqueues is taken in one batch."""
    release, entered = threading.Event(), threading.Event()
    inner = svc._embed_fns["wave"]

    def held(data, src):
        if not release.is_set():
            entered.set()
            assert release.wait(60)
        return inner(data, src)

    svc._embed_fns["wave"] = held
    try:
        first = threading.Thread(target=svc.embed, args=(*blocked, 0, False))
        first.start()
        assert entered.wait(60)
        enqueue()
        release.set()
        first.join(120)
        assert not first.is_alive()
    finally:
        svc._embed_fns["wave"] = inner


@pytest.fixture(scope="module")
def traced(ckpts):
    """A traced engine after sequential requests and one coalesced batch of
    two width keys: (service, spans)."""
    svc = _service(ckpts, spans=Spans())
    r = np.random.default_rng(0)
    for n in (3, 7, 600):
        svc.embed(*_rows(r, n), 1, False)
    _concurrent(svc, [_rows(r, 4), _rows(r, 5), _rows(r, 6, w=52)], _rows(r, 2))
    _settle(svc.spans, svc.device_dispatches)
    return svc, svc.spans.spans()


def test_spans_ring_keeps_the_newest():
    rec = Spans(maxlen=4)
    for k in range(10):
        rec.add(f"s{k}", k, k + 1, id=k)
    got = rec.spans()
    assert [s.name for s in got] == ["s6", "s7", "s8", "s9"]
    assert got[-1] == Span("s9", 9, 10, threading.get_ident(), 9, 0)


def test_spans_ids_are_distinct_across_threads():
    rec, ids = Spans(), [[] for _ in range(8)]

    def take(k):
        ids[k].extend(rec.new_id() for _ in range(500))

    threads = [threading.Thread(target=take, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    flat = [i for row in ids for i in row]
    assert len(set(flat)) == len(flat) == 4000 and min(flat) >= 1


def test_phases_laps_tile_from_the_start():
    rec = Spans()
    p = Phases(rec, time.perf_counter_ns(), parent=7)
    t0 = p.t
    ends = [p.lap(name) for name in ("a", "b", "c")]
    got = rec.spans()
    assert [s.name for s in got] == ["a", "b", "c"] and all(s.parent == 7 for s in got)
    assert got[0].start_ns == t0 and [s.end_ns for s in got] == ends
    assert all(a.end_ns == b.start_ns for a, b in zip(got, got[1:]))


def test_dispatch_phases_are_ordered_nested_and_on_the_worker(traced):
    svc, spans = traced
    worker = svc._worker.ident
    dispatches = [s for s in spans if s.name == "engine.dispatch"]
    assert len(dispatches) == svc.device_dispatches == 6
    for d in dispatches:
        kids = sorted((s for s in spans if s.parent == d.id and s.name in PHASES), key=lambda s: s.start_ns)
        names = [s.name for s in kids]
        assert names[:3] == ["engine.gather", "engine.stage", "engine.upload"]
        assert names[3] in ("engine.run", "engine.capture") and names[4:] == ["engine.fetch", "engine.reply"]
        assert d.thread == worker and all(s.thread == worker for s in kids)
        assert kids[0].start_ns == d.start_ns and kids[-1].end_ns == d.end_ns
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
    # the coalesced batch: two dispatches (one per width key), back to back
    assert dispatches[-2].end_ns == dispatches[-1].start_ns


def test_worker_phases_tile_its_time(traced):
    svc, spans = traced
    worker = svc._worker.ident
    phases = sorted((s for s in spans if s.thread == worker and s.name in PHASES + ("engine.idle",)),
                    key=lambda s: s.start_ns)
    # the recorder was set while the worker waited: its first take is traced from the take
    assert phases[0].name == "engine.gather" and phases[-1].name == "engine.reply"
    assert all(s.end_ns >= s.start_ns for s in phases)
    assert all(a.end_ns == b.start_ns for a, b in zip(phases, phases[1:]))
    # the dispatches and the idle spans tile it too
    outer = sorted((s for s in spans if s.name in ("engine.dispatch", "engine.idle")), key=lambda s: s.start_ns)
    assert all(a.end_ns == b.start_ns for a, b in zip(outer, outer[1:]))
    assert outer[-1].end_ns == phases[-1].end_ns


def test_queue_spans_belong_to_the_dispatch_that_took_them(traced):
    svc, spans = traced
    worker = svc._worker.ident
    dispatches = {s.id: s for s in spans if s.name == "engine.dispatch"}
    waits = [s for s in spans if s.name == "engine.queue"]
    assert len(waits) == svc.requests == 7
    for w in waits:
        d = dispatches[w.parent]
        assert w.thread == worker and w.id == 0 and w.start_ns <= w.end_ns
        # taken inside its dispatch's gather
        gather = next(s for s in spans if s.parent == d.id and s.name == "engine.gather")
        assert gather.start_ns <= w.end_ns <= gather.end_ns
    # the batch's three requests were taken by the first of its two dispatches
    batch = list(dispatches.values())[-2:]
    assert [w.parent for w in waits].count(batch[0].id) == 3
    assert batch[1].id not in {w.parent for w in waits}
    assert sorted(svc._queue_waits) == sorted((w.end_ns - w.start_ns) / 1e9 for w in waits)


def test_later_group_is_chunked_at_the_cap_its_turn_finds(ckpts):
    """A take's groups are chunked in turn: a group whose run raises the cap
    (an oversized request) lets the next group coalesce up to it."""
    svc = _service(ckpts, spans=Spans())
    r = np.random.default_rng(6)
    svc.embed(*_rows(r, 2), 0, False)  # cap 512
    assert svc._max_bucket == 512
    big = tse._Item(*_rows(r, 600), 0, False)  # one key, bucket 1024: raises the cap
    small = [tse._Item(*_rows(r, 300, w=52), 0, False) for _ in range(3)]  # another key, 900 rows

    def enqueue():
        for it in (big, *small):
            svc._queue.put(it)

    _held(svc, _rows(r, 2), enqueue)
    for it in (big, *small):
        assert it.event.wait(120) and it.err is None
    _settle(svc.spans, svc.device_dispatches)
    # the blocked one, the big one, then the three small ones in one bucket-1024 dispatch
    assert (svc.device_dispatches, svc.coalesced_requests, svc._max_bucket) == (4, 3, 1024)
    assert (svc.dispatched_rows, svc.bucket_rows) == (2 + 2 + 600 + 900, 512 + 512 + 1024 + 1024)
    dispatches = [s for s in svc.spans.spans() if s.name == "engine.dispatch"]
    assert dispatches[-2].end_ns == dispatches[-1].start_ns


def test_first_run_of_a_key_is_a_capture_timed_once(ckpts):
    said = []
    svc = _service(ckpts, Spans(), log=said.append)
    r = np.random.default_rng(1)
    svc.embed(*_rows(r, 5), 0, False)
    svc.embed(*_rows(r, 6), 0, False)
    _settle(svc.spans, svc.device_dispatches)
    runs = [s for s in svc.spans.spans() if s.name in ("engine.run", "engine.capture")]
    assert [s.name for s in runs] == ["engine.capture", "engine.run"] and len(said) == 1
    assert f" in {(runs[0].end_ns - runs[0].start_ns) / 1e9:.2f} s;" in said[0]


def test_no_recorder_records_nothing(ckpts, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span site ran without a recorder")

    monkeypatch.setattr(tse, "Phases", refuse)
    monkeypatch.setattr(Spans, "add", refuse)
    monkeypatch.setattr(Spans, "new_id", refuse)
    svc = _service(ckpts)
    assert svc.spans is None
    r = np.random.default_rng(2)
    _concurrent(svc, [_rows(r, 4), _rows(r, 3, w=52)], _rows(r, 2))
    svc.embed(*_rows(r, 9), 0, False)
    assert svc.requests == 4 and svc.device_dispatches == 4


def test_recorder_taken_away_closes_only_the_open_idle_span(ckpts):
    rec = Spans()
    svc = _service(ckpts, spans=rec)
    r = np.random.default_rng(3)
    svc.embed(*_rows(r, 5), 0, False)
    _settle(rec, 1)
    _wait_on_the_queue(svc)
    svc.spans = None
    n = len(rec.spans())
    svc.embed(*_rows(r, 6), 0, False)
    svc.embed(*_rows(r, 7), 0, False)
    after = rec.spans()
    assert [s.name for s in after[n:]] == ["engine.idle"]  # the wait that was open when it was taken away
    assert after[n].start_ns == max(s.end_ns for s in after[:n] if s.name == "engine.dispatch")
    # set again while the worker waits on the empty queue: traced from the next request on
    _wait_on_the_queue(svc)
    svc.spans = again = Spans()
    svc.embed(*_rows(r, 8), 0, False)
    _settle(again, 1)
    phases = [s.name for s in again.spans() if s.name in PHASES + ("engine.idle",)]
    assert phases[0] == "engine.gather" and "engine.idle" not in phases
    assert len(rec.spans()) == len(after)


def test_bucket_and_dispatched_rows_count_a_known_sequence(ckpts):
    svc = _service(ckpts)
    r = np.random.default_rng(4)
    for n in (3, 600, 5, 512, 513):  # buckets 512, 1024, 512, 512, 1024
        svc.embed(*_rows(r, n), 0, False)
    assert (svc.dispatched_rows, svc.bucket_rows) == (1633, 3584)
    items = [tse._Item(*_rows(r, n), 0, False) for n in (4, 6)]
    svc._run_group(items)  # one coalesced group: bucket 512
    svc._run_group([tse._Item(*_rows(r, 9), 0, False)], eager=True)  # the eager check counts nothing
    assert (svc.dispatched_rows, svc.bucket_rows, svc.device_dispatches) == (1643, 4096, 6)
    stats = svc.stats()
    assert (stats["dispatched_rows"], stats["bucket_rows"]) == (1643, 4096)
    assert stats["pad_share"] == round(1 - 1643 / 4096, 4)


def test_stats_keeps_its_keys_and_adds_the_engine_counters(ckpts):
    svc = _service(ckpts)
    fresh = svc.stats()
    assert fresh == {"mode": "dual", "requests": 0, "rows_embedded": 0, "device_dispatches": 0,
                     "coalesced_requests": 0, "mean_latency_ms": 0.0, "p50_latency_ms": 0.0, "p99_latency_ms": 0.0,
                     "bucket_rows": 0, "dispatched_rows": 0, "pad_share": 0.0, "p50_queue_ms": 0.0,
                     "p99_queue_ms": 0.0}
    r = np.random.default_rng(5)
    lat = [svc.embed(*_rows(r, n), 0, False)[3] for n in (3, 4)]
    stats = svc.stats()
    assert list(stats)[:len(OLD_STATS)] == list(OLD_STATS)
    assert stats["requests"] == 2 and stats["rows_embedded"] == 7 and stats["device_dispatches"] == 2
    assert stats["mean_latency_ms"] == round(1000 * sum(lat) / 2, 3)
    assert stats["p99_latency_ms"] == round(float(np.percentile(lat, 99)) * 1000, 3)
    assert 0.0 <= stats["p50_queue_ms"] <= stats["p99_queue_ms"] <= stats["p99_latency_ms"]
    assert len(svc._queue_waits) == 2
