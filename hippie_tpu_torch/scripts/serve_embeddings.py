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
  GET  /stats    -> request counters and latency aggregates (p50/p99)
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
warm bucket. Eager torch compiles nothing, but the rule bounds the shapes
the card sees and keeps ``/stats`` meaning what it means there. Raw widths
up to ``--max-wave-width`` / ``--max-isi-width`` go through one
width-agnostic preprocessing (rows zero-padded to the caps, the resample
coefficients a device tensor per width; ops/preprocess.py).

An artifact is called on the same padded row buckets as a checkpoint
(``_bucketed_artifact_call``). A JAX StableHLO artifact (``model.shlo``)
raises: it needs JAX. ``--aot-dir`` (the JAX compiled-program cache) has no
port target and raises. The server runs on ``cuda`` unless ``--device cpu``
is given.
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
    parser.add_argument("--aot-dir", type=str, default=None,
                        help="the JAX server's compiled-program cache: no port target (raises "
                             "when given)")
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


def _bucket_rows(n: int, minimum: int = 512) -> int:
    """THE row-bucket rule (the JAX evaluate/embeddings._bucket): the next
    power of two >= n, at least 512. Shared by the live path (_run_group),
    the coalescer's cap (_chunk_to_warm_buckets) and warmup()."""
    b = minimum
    while b < n:
        b *= 2
    return b


class _Item:
    __slots__ = ("wf", "isi", "source", "normalize", "event", "out", "err", "t0")

    def __init__(self, wf, isi, source, normalize):
        self.wf = wf
        self.isi = isi
        self.source = source
        self.normalize = normalize
        self.event = threading.Event()
        self.out = None
        self.err = None
        self.t0 = time.perf_counter()

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
                 device: str = "cuda"):
        from hippie_tpu_torch import export
        from hippie_tpu_torch.evaluate import embeddings as emb
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
        self._latencies = collections.deque(maxlen=8192)

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
            self._embed_fns["joint"] = self._bucketed_artifact_call(call)
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
                    self._embed_fns[name] = self._bucketed_artifact_call(call)
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

    @classmethod
    def _bucketed_artifact_call(cls, call):
        """An artifact's call on ``_bucket_rows`` rows: the inputs padded
        with zero rows, the reply cut back. Eval mode, so a padded row cannot
        move a real one. ``_run_group`` already hands it bucketed rows; a
        direct caller's rows go through the same rule."""
        import torch

        def run(*arrays):
            n = arrays[0].shape[0]
            b = cls._bucket_rows(n)
            padded = [torch.cat([a, a.new_zeros((b - n,) + tuple(a.shape[1:]))]) if b > n else a
                      for a in arrays]
            return call(*padded)[:n]

        return run

    # ------------------------------------------------------------------
    # Dispatch worker
    # ------------------------------------------------------------------

    def _drain(self):
        while True:
            first = self._queue.get()
            batch = [first]
            while True:  # coalesce whatever arrived while we were busy
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            groups: dict = {}
            for item in batch:
                groups.setdefault(item.key(), []).append(item)
            for items in groups.values():
                for chunk in self._chunk_to_warm_buckets(items):
                    try:
                        self._run_group(chunk)
                    except BaseException as e:  # reported to every waiter not yet served
                        for it in chunk:
                            # only this thread sets events: a set one was served
                            if not it.event.is_set():
                                it.err = e
                                it.event.set()

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

    def _run_group(self, items):
        """ONE device call for a group of row-concatenable requests: one
        upload of the padded rows, the preprocessing and the model(s), one
        download of the embeddings."""
        import torch

        from hippie_tpu_torch.ops import preprocess

        counts = [len(it.wf) for it in items]
        b = self._bucket_rows(sum(counts))
        w_raw, i_raw = items[0].wf.shape[1], items[0].isi.shape[1]
        padded = 0 < w_raw <= self.max_wave_width and 0 < i_raw <= self.max_isi_width
        w_cols = self.max_wave_width if padded else w_raw
        i_cols = self.max_isi_width if padded else i_raw
        wf_p = np.zeros((b, w_cols), np.float32)
        isi_p = np.zeros((b, i_cols), np.float32)
        src_p = np.zeros((b,), np.int64)
        off = 0
        for it, c in zip(items, counts):
            wf_p[off:off + c, :w_raw] = it.wf
            isi_p[off:off + c, :i_raw] = it.isi
            src_p[off:off + c] = int(it.source)
            off += c
        normalize = items[0].normalize
        dev = self.device
        wf_t, isi_t, src = (torch.from_numpy(a).to(dev) for a in (wf_p, isi_p, src_p))
        if padded:
            wave, isi = preprocess.preprocess_pair_padded(
                wf_t, isi_t, preprocess.device_interp_matrix(w_raw, preprocess.WAVE_LEN, w_cols, dev),
                preprocess.device_interp_matrix(i_raw, preprocess.ISI_LEN, i_cols, dev),
                w_raw, i_raw, normalize=normalize)
        else:
            wave, isi = preprocess.preprocess_pair(wf_t, isi_t, normalize=normalize, device=dev)
        if self.mode == "joint":
            j = self._embed_fns["joint"](wave, isi, src).cpu().numpy()
            w_all = i_all = None
        else:
            # both models dispatched before one download of both results
            both = torch.cat([self._embed_fns["wave"](wave, src),
                              self._embed_fns["time"](isi, src)], dim=1).cpu().numpy()
            z = both.shape[1] // 2
            w_all, i_all, j = both[:, :z], both[:, z:], both
        off = 0
        now = time.perf_counter()
        with self._lock:
            self.device_dispatches += 1
            self._max_bucket = max(self._max_bucket, b)
            if len(items) > 1:
                self.coalesced_requests += len(items)
        for it, c in zip(items, counts):
            sl = slice(off, off + c)
            it.out = (None if w_all is None else w_all[sl], None if i_all is None else i_all[sl],
                      j[sl], now - it.t0)
            off += c
            it.event.set()

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
            return {
                "mode": self.mode,
                "requests": self.requests,
                "rows_embedded": self.rows_embedded,
                "device_dispatches": self.device_dispatches,
                "coalesced_requests": self.coalesced_requests,
                "mean_latency_ms": round(1000 * self.total_latency / max(self.requests, 1), 3),
                "p50_latency_ms": round(float(np.percentile(lat, 50)) * 1000, 3) if lat.size else 0.0,
                "p99_latency_ms": round(float(np.percentile(lat, 99)) * 1000, 3) if lat.size else 0.0,
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
    if args.aot_dir is not None:
        raise ValueError("--aot-dir: the JAX server's compiled-program cache has no port target "
                         "(eager torch compiles nothing)")
    service = EmbeddingService(
        args.wave_checkpoint, args.time_checkpoint, z_dim=args.z_dim, num_sources=args.num_sources,
        num_classes=args.num_classes, wave_artifact=args.wave_artifact,
        time_artifact=args.time_artifact, joint_ckpt=args.joint_checkpoint,
        joint_artifact=args.joint_artifact, max_wave_width=args.max_wave_width,
        max_isi_width=args.max_isi_width, device=args.device)
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
