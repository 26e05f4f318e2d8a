"""Client-side load test for the embedding server.

    python -m hippie_tpu_torch.scripts.serve_embeddings --wave-checkpoint a.ckpt \
        --time-checkpoint b.ckpt --port 8477 &
    python -m hippie_tpu_torch.scripts.serving_load_test --clients 16 --requests 20 --rows 64

The port's copy of the JAX package's scripts/serving_load_test.py (stdlib and
numpy only; either package's server): N concurrent client threads x M POST
/embed requests of R raw rows each, reporting the client-observed throughput
and latency percentiles and the server's own /stats delta (device
dispatches, coalesced requests) as one JSON line. ``main`` also returns that
record.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--url", default="http://127.0.0.1:8477")
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=20, help="requests per client")
    p.add_argument("--rows", type=int, default=64, help="rows per request")
    p.add_argument("--wave-width", type=int, default=41,
                   help="raw waveform width (server resamples to 50 on device)")
    p.add_argument("--isi-width", type=int, default=91,
                   help="raw ISI width (server resamples to 100 on device)")
    p.add_argument("--timeout", type=float, default=120.0, help="per-request timeout (s)")
    return p


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def main(argv=None):
    args = build_parser().parse_args(argv)

    health = _get(args.url + "/healthz")
    mode = health.get("mode", "?")
    stats0 = _get(args.url + "/stats")

    lat = [[] for _ in range(args.clients)]
    errors = []
    barrier = threading.Barrier(args.clients)

    def client(ci: int):
        # distinct per-client rows; the reply row count must match OURS even
        # when the server coalesced us with other clients' rows. One numpy
        # Generator per thread — a shared Generator is not thread-safe and
        # concurrent draws could corrupt/duplicate rows across clients.
        rng = np.random.default_rng(ci)
        wf = rng.normal(size=(args.rows, args.wave_width)).astype(np.float32)
        isi = np.abs(rng.normal(size=(args.rows, args.isi_width))).astype(np.float32)
        body = json.dumps({"waveforms": wf.tolist(), "isi_dists": isi.tolist()}).encode()
        req = urllib.request.Request(
            args.url + "/embed", data=body,
            headers={"Content-Type": "application/json"})
        barrier.wait()
        for _ in range(args.requests):
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=args.timeout) as r:
                    out = json.loads(r.read())
            except Exception as e:  # noqa: BLE001 — record, don't crash the thread
                errors.append(f"client {ci}: {e!r}")
                return
            lat[ci].append(time.perf_counter() - t0)
            key = "joint" if "joint" in out else "waveform"
            if len(out[key]) != args.rows:
                errors.append(f"client {ci}: got {len(out[key])} rows, sent {args.rows}")
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    if errors:
        for e in errors[:10]:
            print("ERROR:", e, file=sys.stderr)
        sys.exit(1)

    stats1 = _get(args.url + "/stats")
    all_lat = np.asarray([x for c in lat for x in c], np.float64)
    n_req = all_lat.size
    res = {
        "mode": mode,
        "clients": args.clients,
        "requests": n_req,
        "rows_per_request": args.rows,
        "wall_s": round(wall, 3),
        "req_per_s": round(n_req / wall, 1),
        "rows_per_s": round(n_req * args.rows / wall, 1),
        "client_p50_ms": round(float(np.percentile(all_lat, 50)) * 1e3, 1),
        "client_p99_ms": round(float(np.percentile(all_lat, 99)) * 1e3, 1),
        "client_max_ms": round(float(all_lat.max()) * 1e3, 1),
        "device_dispatches": stats1["device_dispatches"] - stats0["device_dispatches"],
        "coalesced_requests": stats1["coalesced_requests"] - stats0["coalesced_requests"],
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
