"""Embedding-serving HTTP service of the PyTorch/CUDA port.

    python -m hippie_tpu_torch.scripts.serve_embeddings --wave-checkpoint a.ckpt \
        --time-checkpoint b.ckpt --port 8477
    python -m hippie_tpu_torch.scripts.serve_embeddings --joint-checkpoint j.ckpt

Counterpart of the JAX package's scripts/serve_embeddings.py. Model
backends, as there:

  --wave-checkpoint/--time-checkpoint   dual unimodal Lightning ckpts
  --wave-artifact/--time-artifact       exported artifacts (scripts/export_model.py)
  --joint-checkpoint / --joint-artifact the MultiModalCVAE joint model

A checkpoint is loaded once (geometry from the checkpoint,
export.load_model_from_ckpt), an artifact once (export.load_artifact: no
model code, the manifest's geometry); either stays on the device. A slot
takes its checkpoint or its artifact, and the dual slots may mix them.
stdlib HTTP:

  GET  /healthz  -> {"status": "ok", "z_dim", "mode", "num_sources"}
  GET  /stats    -> request counters, latency and queue-wait aggregates
                    (p50/p99), the rows dispatched and the row buckets they
                    padded to (``pad_share``: 1 - rows / bucket rows)
  POST /embed    -> body {"waveforms": [[...]], "isi_dists": [[...]],
                          "source": int (optional, default 0),
                          "normalize": bool (optional, default false)}
                    dual mode reply  {"waveform": [[z]], "isi": [[z]], "joint": [[2z]]}
                    joint mode reply {"joint": [[z]]}

All device work runs on ONE dispatch worker thread; HTTP threads enqueue and
wait. Requests that arrive while a batch is in flight and agree on their raw
widths and ``normalize`` are coalesced into one device call and the results
split per request. Rows are padded to the JAX server's row buckets (powers
of two from 512; ``_bucket_rows``), so a warmed bucket is the bucket a live
request pads to and a burst is cut into groups no larger than the largest
warm bucket. Raw widths up to ``--max-wave-width`` / ``--max-isi-width`` go
through one width-agnostic preprocessing (rows zero-padded to the caps, the
resample coefficients and the true widths device buffers;
ops/preprocess.py).

Each group runs as one CUDA graph, the counterpart of the JAX server's one
compiled program per row bucket (evaluate/eval_graph.py EmbeddingGraph):
the preprocessing, the model forward(s) in eval mode in full float32, the
z-scoring and, in dual mode, both models and the concatenation, captured
once per key (row bucket, ``normalize``, padded to the caps or, for wider
rows, the raw widths) and replayed for every later group of that key. A
group's rows go into pinned staging buffers, one copy per input into the
key's buffers, one replay, one copy of the embeddings back. The
``--warmup-buckets`` ladder captures its buckets at start, as the JAX
ladder compiles them; a request whose key has no graph yet captures one on
the dispatch worker, as the JAX server compiles a new bucket. Captures
happen on that thread only and are printed; ``graph_captures`` and
``graph_replays`` count them (``/stats`` keeps the JAX server's keys). Off
the card the same programs run eagerly (the CPU tests).

With a ``utils.profiling.Spans`` recorder in the ``spans`` attribute (set
while no request is in flight; ``None``, the default, records nothing) the
dispatch worker records the engine's phases on ``time.perf_counter_ns()``.
Its time is tiled by ``engine.idle`` (blocked on the empty queue) and the
phases of each dispatch: ``engine.gather`` (taking what is queued and
grouping it, in a take's first dispatch; chunking the group), ``engine.stage``
(zero-filling the pinned staging buffers, copying the rows in, the widths),
``engine.upload``, ``engine.run`` (a replay) or ``engine.capture`` (the
key's first run), ``engine.fetch`` (the copy back, waited for) and
``engine.reply`` (the split and the waiters woken), each the child of its
``engine.dispatch`` span. Each request's ``engine.queue`` (enqueued to taken
by the worker) is the child of the dispatch whose gather took it.

An artifact's program (``ArtifactCall.embed``) runs on the same padded row
buckets as a checkpoint's models, inside the same graphs, under its
manifest's precision. A JAX StableHLO artifact (``model.shlo``)
raises: it needs JAX. ``--aot-dir`` takes the JAX flag's default and
meaning (``''``: none) and only sets where the port's CUDA kernel libraries
would be found (ops/_build.py): the server's eval path launches no
hand-written kernel. The server runs on ``cuda`` unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from hippie_tpu_torch.ops import _build
from hippie_tpu_torch.utils.profiling import Phases


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m hippie_tpu_torch.scripts.serve_embeddings")
    parser.add_argument("--z_dim", type=int, default=10,
                        help="fallback when geometry cannot be inferred from the model file")
    parser.add_argument("--wave-checkpoint", type=str, default=None)
    parser.add_argument("--time-checkpoint", type=str, default=None)
    parser.add_argument("--wave-artifact", type=str, default=None,
                        help="exported artifact (python -m hippie_tpu_torch.scripts.export_model) "
                             "instead of --wave-checkpoint: no model code, no checkpoint parsing")
    parser.add_argument("--time-artifact", type=str, default=None)
    parser.add_argument("--joint-checkpoint", type=str, default=None,
                        help="serve a MultiModalCVAE joint checkpoint (reply has 'joint' "
                             "embeddings only)")
    parser.add_argument("--joint-artifact", type=str, default=None,
                        help="exported multimodal artifact")
    parser.add_argument("--num-sources", type=int, default=5)
    parser.add_argument("--num-classes", type=int, default=5)
    parser.add_argument("--aot-dir", type=str,
                        default=_build.CLI_DEFAULT_DIR,
                        help="kernel-library cache shared with the training CLIs ('' disables); "
                             "it only sets where the CUDA kernels would be found: the server's "
                             "eval path launches no hand-written kernel")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8477, help="0 binds a free port")
    parser.add_argument("--warmup-buckets", type=str, default="512,1024,2048,4096",
                        help="comma-separated ladder of row buckets run once at startup; the "
                             "largest is the coalescer's cap. '' disables the ladder")
    parser.add_argument("--warmup-rows", type=int, default=None,
                        help="legacy single-bucket warmup: >0 adds that bucket to the ladder; "
                             "0 disables ALL warmup (including the ladder)")
    parser.add_argument("--max-wave-width", type=int, default=256,
                        help="raw waveform width cap of the width-agnostic preprocessing; "
                             "wider requests take the exact-width path. 0 disables")
    parser.add_argument("--max-isi-width", type=int, default=512,
                        help="raw ISI width cap (see --max-wave-width)")
    parser.add_argument("--warmup-async", action="store_true",
                        help="bind the port and serve at once; the ladder runs on a background "
                             "thread through the same dispatch queue")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the models and preprocessing run (default cuda)")
    return parser


def _bucket_rows(n: int) -> int:
    """THE row-bucket rule (eval_graph.bucket_rows, the JAX
    evaluate/embeddings._bucket): the next power of two >= n, at least 512.
    Shared by the live path (_run_group), the coalescer's cap
    (_chunk_to_warm_buckets) and warmup()."""
    from hippie_tpu_torch.evaluate import eval_graph

    return eval_graph.bucket_rows(n)


class _Item:
    __slots__ = ("wf", "isi", "source", "normalize", "event", "out", "err", "t0", "taken")

    def __init__(self, wf, isi, source, normalize):
        self.wf = wf
        self.isi = isi
        self.source = source
        self.normalize = normalize
        self.event = threading.Event()
        self.out = None
        self.err = None
        self.t0 = time.perf_counter_ns()  # enqueued
        self.taken = None  # perf_counter_ns() when the dispatch worker took it off the queue

    def key(self):
        # requests are row-concatenable iff widths and the (group-applied)
        # normalize flag agree; source is per row, not keyed
        return (self.wf.shape[1], self.isi.shape[1], bool(self.normalize))


class EmbeddingService:
    """The model-backed embedding engine shared by all server threads. All
    device work runs on ONE dispatch worker thread; pending compatible
    requests are coalesced into one device call (see the module docstring)."""

    def __init__(self, wave_ckpt=None, time_ckpt=None, *, z_dim: int, num_sources: int = 5,
                 num_classes: int = 5, wave_artifact=None, time_artifact=None, joint_ckpt=None,
                 joint_artifact=None, max_wave_width: int = 256, max_isi_width: int = 512,
                 device: str = "cuda", log=None):
        from hippie_tpu_torch import export
        from hippie_tpu_torch.evaluate import embeddings as emb
        from hippie_tpu_torch.evaluate import eval_graph
        from hippie_tpu_torch.models import cvae

        self._lock = threading.Lock()
        self.device = device
        self.z_dim = z_dim
        self.max_wave_width = int(max_wave_width)
        self.max_isi_width = int(max_isi_width)
        self.requests = 0
        self.rows_embedded = 0
        self.total_latency = 0.0
        self.coalesced_requests = 0  # served as part of a multi-request batch
        self.device_dispatches = 0
        self.dispatched_rows = 0  # real rows of the device calls
        self.bucket_rows = 0  # the row buckets they padded to
        self._latencies = collections.deque(maxlen=8192)
        self._queue_waits = collections.deque(maxlen=8192)
        # a utils.profiling.Spans recorder, or None (module docstring)
        self.spans = None
        # one EmbeddingGraph per key, all in one space (module docstring);
        # ``log`` reports each capture
        self._graphs: dict = {}
        self._space = eval_graph.GraphSpace(device)
        self._log = log

        if (joint_ckpt or joint_artifact) and (wave_ckpt or time_ckpt or wave_artifact or time_artifact):
            raise ValueError("--joint-* is exclusive with the wave/time model flags")
        self.mode = "joint" if (joint_ckpt or joint_artifact) else "dual"
        self._embed_fns = {}
        # the models' source-embedding size: an out-of-range source is a 400
        self.num_sources: int = num_sources
        if self.mode == "joint" and joint_artifact is not None:
            call, manifest = export.load_artifact(joint_artifact, device=device)
            if manifest.get("modality") != "multimodal":
                raise ValueError(f"--joint-artifact {joint_artifact} is not a multimodal export "
                                 f"(modality={manifest.get('modality')!r})")
            self.z_dim = int(manifest.get("z_dim", self.z_dim))
            self.num_sources = int(manifest.get("num_sources", num_sources))
            self._embed_fns["joint"] = call.embed
        elif self.mode == "joint":
            model, cfg = export.load_model_from_ckpt(joint_ckpt, multimodal=True, device=device)
            self.z_dim, self.num_sources = cfg.z_dim, cfg.num_sources
            self._embed_fns["joint"] = lambda wave, isi, src, m=model: emb.embed_multimodal(
                m, wave, isi, src)
        else:
            for name, ckpt, artifact in (("wave", wave_ckpt, wave_artifact),
                                         ("time", time_ckpt, time_artifact)):
                if artifact is not None:
                    call, manifest = export.load_artifact(artifact, device=device)
                    if manifest.get("modality") not in (None, "unimodal"):
                        raise ValueError(
                            f"--{name}-artifact {artifact} is not a unimodal export "
                            f"(modality={manifest.get('modality')!r}); serve multimodal artifacts "
                            f"with --joint-artifact")
                    want_len = 50 if name == "wave" else 100
                    got_len = manifest.get("input_len")
                    if got_len is not None and int(got_len) != want_len:
                        raise ValueError(
                            f"--{name}-artifact {artifact} expects input length {got_len}, but the "
                            f"{name} slot feeds resampled length {want_len}: wrong modality's artifact?")
                    self.z_dim = int(manifest.get("z_dim", self.z_dim))
                    self.num_sources = int(manifest.get("num_sources", num_sources))
                    self._embed_fns[name] = call.embed
                    continue
                if ckpt is None:
                    raise ValueError(f"provide --{name}-checkpoint or --{name}-artifact")
                fallback = cvae.CVAEConfig(z_dim=z_dim, output_size=50 if name == "wave" else 100,
                                           class_hidden_dim=5, num_sources=num_sources,
                                           num_classes=num_classes)
                model, cfg = export.load_model_from_ckpt(ckpt, multimodal=False,
                                                         fallback_config=fallback, device=device)
                self.z_dim, self.num_sources = cfg.z_dim, cfg.num_sources
                self._embed_fns[name] = lambda data, src, m=model: emb.embed_unimodal(m, data, src)

        self._queue: "queue.SimpleQueue[_Item]" = queue.SimpleQueue()
        # The largest row bucket served so far: coalesced groups are capped
        # at it, so a burst cannot form a bucket the card has never run.
        # Grows when a single oversized request forces a larger bucket.
        self._max_bucket = 0
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    _bucket_rows = staticmethod(_bucket_rows)

    @property
    def graph_captures(self) -> int:
        """The keys' programs captured (off the card: first run)."""
        return self._space.captures

    @property
    def graph_replays(self) -> int:
        """The groups run through a key's program (one per dispatch)."""
        return self._space.replays

    # ------------------------------------------------------------------
    # Dispatch worker
    # ------------------------------------------------------------------

    def _drain(self):
        t_end = None  # where the last traced dispatch ended
        while True:
            spans = self.spans
            t_wait = (t_end or time.perf_counter_ns()) if spans is not None else 0
            first = self._queue.get()
            first.taken = t = time.perf_counter_ns()
            if spans is not None:
                spans.add("engine.idle", t_wait, t)
            spans = self.spans  # a recorder set while the queue was empty traces from here
            batch = [first]
            while True:  # coalesce whatever arrived while we were busy
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                item.taken = time.perf_counter_ns()
                batch.append(item)
            groups: dict = {}
            for item in batch:
                groups.setdefault(item.key(), []).append(item)
            phases = None
            if spans is not None:
                phases = Phases(spans, t, spans.new_id())
                for item in batch:
                    spans.add("engine.queue", item.t0, item.taken, parent=phases.parent)
            for items in groups.values():
                # chunked after the groups before it ran: a run may raise the cap
                for chunk in self._chunk_to_warm_buckets(items):
                    if phases is not None:
                        phases.lap("engine.gather")
                    try:
                        self._run_group(chunk, phases=phases)
                    except BaseException as e:  # reported to every waiter not yet served
                        for it in chunk:
                            # only this thread sets events: a set one was served
                            if not it.event.is_set():
                                it.err = e
                                it.event.set()
                        if phases is not None:
                            phases.lap("engine.reply")
                    if phases is not None:  # the dispatch: from the end of the last (or the take) to its reply
                        spans.add("engine.dispatch", t, phases.t, id=phases.parent)
                        t, phases.parent = phases.t, spans.new_id()
            t_end = None if phases is None else phases.t

    def _chunk_to_warm_buckets(self, items):
        """Split a coalesced group so each chunk pads to a bucket no larger
        than the largest served one. A request larger than every such bucket
        runs alone (and raises the cap)."""
        cap = self._max_bucket
        if cap <= 0:  # nothing served yet (--warmup-rows 0): each request alone
            return [[it] for it in items]
        chunks, cur, cur_rows = [], [], 0
        for it in items:
            c = len(it.wf)
            if cur and self._bucket_rows(cur_rows + c) > cap:
                chunks.append(cur)
                cur, cur_rows = [], 0
            cur.append(it)
            cur_rows += c
        if cur:
            chunks.append(cur)
        return chunks

    def _embed(self, wave, isi, src):
        """The model part of every key's program: [rows, z] joint, or the
        two unimodal embeddings side by side [rows, 2z]."""
        import torch

        if self.mode == "joint":
            return self._embed_fns["joint"](wave, isi, src)
        return torch.cat([self._embed_fns["wave"](wave, src), self._embed_fns["time"](isi, src)], dim=1)

    def _graph(self, key):
        from hippie_tpu_torch.evaluate import eval_graph

        b, normalize, widths = key
        padded = widths is None
        w_cols, i_cols = (self.max_wave_width, self.max_isi_width) if padded else widths
        return eval_graph.EmbeddingGraph(self._embed, b, w_cols, i_cols, normalize=normalize,
                                         padded=padded, space=self._space)

    def _run_group(self, items, eager: bool = False, phases=None):
        """ONE device call for a group of row-concatenable requests: the
        padded rows staged and copied in, one run of the key's program (a
        replay on the card; the first of a key captures it), one copy of the
        embeddings back. ``eager``: the same program without its graph, for
        the checks that hold a replay to it (no count moves). ``phases``:
        the dispatch worker's ``Phases`` when it is traced (module
        docstring)."""
        counts = [len(it.wf) for it in items]
        b = self._bucket_rows(sum(counts))
        w_raw, i_raw = items[0].wf.shape[1], items[0].isi.shape[1]
        padded = 0 < w_raw <= self.max_wave_width and 0 < i_raw <= self.max_isi_width
        key = (b, bool(items[0].normalize), None if padded else (w_raw, i_raw))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._graph(key)
        wf_p, isi_p, src_p = g.host(0), g.host(1), g.host(2)
        wf_p[...] = 0.0
        isi_p[...] = 0.0
        src_p[...] = 0
        off = 0
        for it, c in zip(items, counts):
            wf_p[off:off + c, :w_raw] = it.wf
            isi_p[off:off + c, :i_raw] = it.isi
            src_p[off:off + c] = int(it.source)
            off += c
        g.set_widths(w_raw, i_raw)
        if phases is not None:
            phases.lap("engine.stage")
        g.upload()
        capture = g.runs == 0 and not eager
        t0 = phases.lap("engine.upload") if phases is not None else time.perf_counter_ns()
        out = g.eager() if eager else g()
        t1 = (phases.lap("engine.capture" if capture else "engine.run") if phases is not None
              else time.perf_counter_ns())
        if capture and self._log is not None:
            shape = "padded to the width caps" if padded else f"raw widths {w_raw}/{i_raw}"
            self._log(f"captured the program of bucket {b} rows ({shape}, normalize={key[1]}) in "
                      f"{(t1 - t0) / 1e9:.2f} s; {self.graph_captures} captured")
        both = g.fetch(out, off)
        if phases is not None:
            phases.lap("engine.fetch")
        if self.mode == "joint":
            w_all = i_all = None
            j = both
        else:
            z = both.shape[1] // 2
            w_all, i_all, j = both[:, :z], both[:, z:], both
        now = time.perf_counter_ns()
        with self._lock:
            if not eager:
                self.device_dispatches += 1
                self.dispatched_rows += off
                self.bucket_rows += b
                self._max_bucket = max(self._max_bucket, b)
                if len(items) > 1:
                    self.coalesced_requests += len(items)
                self._queue_waits.extend((it.taken - it.t0) / 1e9 for it in items if it.taken is not None)
        off = 0
        for it, c in zip(items, counts):
            sl = slice(off, off + c)
            it.out = (None if w_all is None else w_all[sl], None if i_all is None else i_all[sl],
                      j[sl], (now - it.t0) / 1e9)
            off += c
            it.event.set()
        if phases is not None:
            phases.lap("engine.reply")

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def warmup(self, rows):
        """Run the given row bucket(s) once: one int or a ladder of them,
        each bucketed by ``_bucket_rows`` (the live path's rule; duplicates
        skipped). Afterwards ``_max_bucket`` is the ladder's top, so the
        coalescer groups bursts up to that many rows into one device call.
        The rows' widths stay under the caps, so the warmup takes the padded
        path live requests take."""
        if isinstance(rows, int):
            rows = [rows]
        w_w = min(46, self.max_wave_width) if self.max_wave_width > 0 else 46
        w_i = min(100, self.max_isi_width) if self.max_isi_width > 0 else 100
        done = set()
        for r in sorted(int(x) for x in rows):
            b = self._bucket_rows(r) if r > 0 else 0
            if b <= 0 or b in done:
                continue
            done.add(b)
            self.embed(np.zeros((b, w_w), np.float32), np.zeros((b, w_i), np.float32), 0, False)

    def embed(self, waveforms: np.ndarray, isi_dists: np.ndarray, source: int, normalize: bool):
        """Enqueue one request and wait; returns (wave, isi, joint, seconds)
        as numpy (wave and isi None in joint mode)."""
        item = _Item(np.asarray(waveforms, np.float32), np.asarray(isi_dists, np.float32),
                     source, normalize)
        self._queue.put(item)
        item.event.wait()
        if item.err is not None:
            raise item.err
        w, i, j, dt = item.out
        with self._lock:
            self.requests += 1
            self.rows_embedded += len(j)
            self.total_latency += dt
            self._latencies.append(dt)
        return w, i, j, dt

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            waits = np.asarray(self._queue_waits, np.float64)
            return {
                "mode": self.mode,
                "requests": self.requests,
                "rows_embedded": self.rows_embedded,
                "device_dispatches": self.device_dispatches,
                "coalesced_requests": self.coalesced_requests,
                "mean_latency_ms": round(1000 * self.total_latency / max(self.requests, 1), 3),
                "p50_latency_ms": round(float(np.percentile(lat, 50)) * 1000, 3) if lat.size else 0.0,
                "p99_latency_ms": round(float(np.percentile(lat, 99)) * 1000, 3) if lat.size else 0.0,
                "bucket_rows": self.bucket_rows,
                "dispatched_rows": self.dispatched_rows,
                "pad_share": round(1.0 - self.dispatched_rows / self.bucket_rows, 4) if self.bucket_rows else 0.0,
                "p50_queue_ms": round(float(np.percentile(waits, 50)) * 1000, 3) if waits.size else 0.0,
                "p99_queue_ms": round(float(np.percentile(waits, 99)) * 1000, 3) if waits.size else 0.0,
            }


def make_handler(service: EmbeddingService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "z_dim": service.z_dim, "mode": service.mode,
                                  "num_sources": service.num_sources})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/embed":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                wf = np.asarray(payload["waveforms"], np.float32)
                isi = np.asarray(payload["isi_dists"], np.float32)
                if wf.ndim != 2 or isi.ndim != 2 or len(wf) != len(isi) or len(wf) == 0:
                    raise ValueError(f"waveforms/isi_dists must be equal-length 2-D arrays, "
                                     f"got {wf.shape} and {isi.shape}")
                source = int(payload.get("source", 0))
                if not 0 <= source < service.num_sources:
                    raise ValueError(f"source {source} out of range for this model "
                                     f"(num_sources={service.num_sources})")
                normalize = bool(payload.get("normalize", False))
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                w, i, j, dt = service.embed(wf, isi, source, normalize)
            except BaseException as e:
                # a worker-side failure is a JSON 500, not a dropped socket
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            out = {"joint": np.asarray(j).tolist(), "latency_ms": round(dt * 1000, 3)}
            if w is not None:
                out["waveform"] = np.asarray(w).tolist()
                out["isi"] = np.asarray(i).tolist()
            self._reply(200, out)

    return Handler


class EmbeddingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for client bursts
    (the stdlib's 5 resets the excess connections of a 16-client burst)."""

    request_queue_size = 128
    daemon_threads = True


def main(argv=None):
    args = build_parser().parse_args(argv)
    _build.set_default_dir(args.aot_dir or None)
    service = EmbeddingService(
        args.wave_checkpoint, args.time_checkpoint, z_dim=args.z_dim, num_sources=args.num_sources,
        num_classes=args.num_classes, wave_artifact=args.wave_artifact,
        time_artifact=args.time_artifact, joint_ckpt=args.joint_checkpoint,
        joint_artifact=args.joint_artifact, max_wave_width=args.max_wave_width,
        max_isi_width=args.max_isi_width, device=args.device, log=lambda msg: print(msg, flush=True))
    ladder = ([int(x) for x in args.warmup_buckets.split(",") if x.strip()]
              if args.warmup_buckets else [])
    if args.warmup_rows is not None:  # legacy flag: 0 disables everything, >0 adds its bucket
        ladder = ladder + [args.warmup_rows] if args.warmup_rows > 0 else []

    def run_warmup():
        print(f"warming up buckets {sorted(set(ladder))}...", flush=True)
        t0 = time.perf_counter()
        service.warmup(ladder)
        print(f"warmup ladder done in {time.perf_counter() - t0:.1f} s", flush=True)

    if ladder and not args.warmup_async:
        run_warmup()
    server = EmbeddingHTTPServer((args.host, args.port), make_handler(service))
    if ladder and args.warmup_async:
        threading.Thread(target=run_warmup, daemon=True).start()
    host, port = server.server_address[:2]
    print(f"serving {service.mode} embeddings on http://{host}:{port} (POST /embed)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
