"""The ``embed_clients`` kind: client threads in a closed loop against the
server's engine, ``scripts/serve_embeddings.py:EmbeddingService`` in joint
mode (its dispatch worker, coalescing, row buckets and one replayed CUDA
graph per key, ``evaluate/eval_graph.py``), without HTTP.

The mix (``perfbench/traffic/<name>.json``) gives ``datasets`` (name:
source id), ``clients``, ``requests_per_client``, the ``rows`` per request
(``log_uniform`` or ``uniform`` between ``min`` and ``max``), the row
buckets to warm (``warm_buckets``: a list, or ``request_sizes``: each
bucket the requests form), and the check's ``check_requests`` and
``check_block_rows``. Client ``c`` draws from dataset ``c mod
len(datasets)`` at that dataset's raw widths. Each client's request sizes
are the same stratified set for every seed (the quantiles ``(i + 0.5) / n``
of the ``rows`` distribution), in a seeded order; each request's rows are
drawn with replacement by the seed. A client cycles through its requests
until the window closes.

Set-up makes the weights from ``--seed``, writes them as a checkpoint into
the temporary directory, starts the engine on it (and removes the file),
and warms every key this traffic uses: each of its datasets' raw widths at
each row bucket the traffic can form. In the window each client times each
of its requests from the call to the reply. After the window every issued
request has been answered or has failed; the plain reference embeds a
seeded sample of the replies' raw rows (the longest request among them)
and the largest gap decides ``correct``.

``--trace 1`` profiles a steady sub-window (from a third of the window,
for at most 2 s) of the card's activity; its device events are clipped to
the sub-window, and its idle gaps are named by what the clients were doing.
The profiler starts and stops only while no request is in flight: the
clients wait at a gate until it has (CUPTI switched on or off while the
engine's worker replays a graph can hang the process). The sub-window
opens ``SETTLE_S`` after the gate reopens and closes before it shuts, so
neither wait lies in it; a traced window holds both waits, the end-to-end
metrics' untraced windows none. A watchdog ends a run whose window and
check have not finished ``WATCHDOG_S`` after the window's end, with every
thread's stack on stderr and no result.
"""

from __future__ import annotations

import faulthandler
import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench.harness import common, data, weights
from perfbench.harness.common import resolve, rng
from perfbench.harness.trace import profile, read_trace
from perfbench.reference import cvae as ref_cvae
from perfbench.reference import preprocess as ref_pre
from perfbench.reference.compare import embed_gap
from perfbench.reference.numerics import Numerics, full_float32
from perfbench.yardstick import flops

FAULTS = ("altered", "half_rows")
JOIN_S = 120.0
SETTLE_S = 0.5
WATCHDOG_S = 240.0


def stratified_sizes(dist: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["kind"] == "log_uniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["kind"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown size distribution {dist['kind']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


class Request:
    __slots__ = ("client", "index", "set_index", "rows")

    def __init__(self, client, index, set_index, rows):
        self.client, self.index, self.set_index, self.rows = client, index, set_index, rows


class EmbedClients:
    """Each client's requests, from ``--seed``."""

    def __init__(self, spec: dict, seed: int, set_sizes: list):
        self.clients = int(spec["clients"])
        n = int(spec["requests_per_client"])
        sizes = stratified_sizes(spec["rows"], n)
        self.requests = []
        for c in range(self.clients):
            s = c % len(set_sizes)
            order = rng(seed, 20, c).permutation(n)
            r = rng(seed, 21, c)
            self.requests.append([Request(c, i, s, r.integers(0, set_sizes[s], size=int(sizes[j])))
                                  for i, j in enumerate(order)])


class Gate:
    """Lets the clients' requests through; ``shut()`` stops new ones and
    returns once none is in flight, ``reopen()`` lets them through again."""

    def __init__(self):
        self._cv = threading.Condition()
        self._open, self._in_flight = True, 0

    def enter(self):
        with self._cv:
            self._cv.wait_for(lambda: self._open)
            self._in_flight += 1

    def leave(self):
        with self._cv:
            self._in_flight -= 1
            self._cv.notify_all()

    def shut(self):
        with self._cv:
            self._open = False
            self._cv.wait_for(lambda: self._in_flight == 0)

    def reopen(self):
        with self._cv:
            self._open = True
            self._cv.notify_all()


def _arch(ctx) -> ref_cvae.Arch:
    cfg = dict(ctx.cell.config)
    if ctx.rehearsal:
        cfg["model"] = {**cfg["model"], **cfg.get("rehearsal", {}).get("model", {})}
    return ref_cvae.Arch.from_config(cfg)


def _service(arch, sd, dev, fault):
    from hippie_tpu_torch.scripts.serve_embeddings import EmbeddingService

    fd, path = tempfile.mkstemp(suffix=".ckpt")
    os.close(fd)
    try:
        torch.save({"state_dict": {"model." + k: v.detach().cpu() for k, v in sd.items()}, "optimizer_states": [],
                    "epoch": 0, "global_step": 0, "pytorch-lightning_version": "2.0.0", "hyper_parameters": {}},
                   path)
        svc = EmbeddingService(joint_ckpt=path, z_dim=arch.z_dim, num_sources=arch.num_sources,
                               num_classes=arch.num_classes, device=str(dev))
    finally:
        os.unlink(path)
    if fault is not None:
        inner = svc._embed_fns["joint"]

        def broken(wave, isi, src):
            out = inner(wave, isi, src)
            if fault == "altered":  # one answer altered where it is produced
                out[0, 0] += 1.0
            else:  # half of the rows left out
                out[1::2] = 0.0
            return out

        svc._embed_fns["joint"] = broken
    return svc


def run(ctx) -> dict:
    dev = ctx.device
    arch = _arch(ctx)
    spec = resolve(ctx.cell.traffic, ctx.rehearsal)
    sets = data.load_sets(spec["datasets"])
    traffic = EmbedClients(spec, ctx.seed, [len(s.wf) for s in sets])
    sd = weights.make_state_dict(arch, ctx.seed, dev)
    svc = _service(arch, sd, dev, ctx.fault)

    # warm every key of this traffic: its raw widths at each bucket it can form
    if spec["warm_buckets"] == "request_sizes":
        buckets = sorted({svc._bucket_rows(len(r.rows)) for reqs in traffic.requests for r in reqs})
    else:
        buckets = sorted({svc._bucket_rows(int(b)) for b in spec["warm_buckets"]})
    used = sorted({r.set_index for reqs in traffic.requests for r in reqs[:1]})
    widths = sorted({(sets[i].wf.shape[1], sets[i].isi.shape[1]) for i in used})
    for b in buckets:
        for w, i in widths:
            svc.embed(np.zeros((b, w), np.float32), np.zeros((b, i), np.float32), 0, False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    records = [[] for _ in range(traffic.clients)]
    go, stop, gate = threading.Event(), threading.Event(), Gate()

    def client(c):
        reqs, out, k = traffic.requests[c], records[c], 0
        go.wait()
        while not stop.is_set():
            r = reqs[k % len(reqs)]
            k += 1
            s = sets[r.set_index]
            wf, isi = s.wf[r.rows], s.isi[r.rows]
            gate.enter()
            try:
                if stop.is_set():
                    break
                t0 = time.perf_counter()
                try:
                    j, err = svc.embed(wf, isi, s.source, False)[2], None
                except Exception as e:  # a failed request counts as failed and as a miss
                    j, err = None, f"{type(e).__name__}: {e}"
                out.append((r, t0, time.perf_counter(), j, err))
            finally:
                gate.leave()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(traffic.clients)]
    for t in threads:
        t.start()
    setup_s = time.time() - ctx.t_start
    counters0 = (svc.requests, svc.device_dispatches)
    t_open = time.perf_counter()
    faulthandler.dump_traceback_later(ctx.seconds + WATCHDOG_S, exit=True)
    go.set()
    prof = None
    if ctx.trace:
        time.sleep(ctx.seconds / 3)
        sub = min(2.0, ctx.seconds / 3)
        box = {}

        def hold():
            gate.reopen()
            time.sleep(SETTLE_S)
            box["clocks0"] = _clocks()
            time.sleep(sub)
            box["clocks1"] = _clocks()
            gate.shut()

        gate.shut()
        raw = profile(hold, host=False)  # the card's activity only: see trace.profile
        gate.reopen()
        prof = {"raw": raw, **box}
    time.sleep(max(0.0, t_open + ctx.seconds - time.perf_counter()))
    stop.set()
    t_close = time.perf_counter()
    counters1 = (svc.requests, svc.device_dispatches)
    for t in threads:
        t.join(JOIN_S)
    hung = sum(t.is_alive() for t in threads)
    window_s = t_close - t_open
    if prof is not None:
        prof.update(_read(prof.pop("raw"), prof.pop("clocks0"), prof.pop("clocks1"), records))

    issued = [rec for out in records for rec in out if rec[1] < t_close]
    failed = [rec for rec in issued if rec[4] is not None] + [None] * hung
    lat = np.array([rec[2] - rec[1] if rec[4] is None else np.inf for rec in issued] + [np.inf] * hung)
    rows_done = sum(len(rec[0].rows) for rec in issued if rec[4] is None and rec[2] <= t_close)
    found = common.forbidden_modules()
    device_info = common.card(dev) if dev.type == "cuda" else None
    for rec in failed[:3]:
        if rec is not None:
            common.log(f"request failed: {rec[4]}")

    # the plain reference on a seeded sample of the answered requests, the longest among them
    t_ref = time.perf_counter()
    answered = [rec for rec in issued if rec[4] is None]
    numbers, control = _reference(ctx, arch, spec, sets, sd, dev, answered)
    common.log(f"reference {time.perf_counter() - t_ref:.1f} s; set-up {setup_s:.2f} s; window {window_s:.3f} s, "
               f"{len(issued)} requests, {rows_done} rows, {len(failed)} failed; engine captures "
               f"{svc.graph_captures}, replays {svc.graph_replays}")
    faulthandler.cancel_dump_traceback_later()
    dreq, ddisp = counters1[0] - counters0[0], counters1[1] - counters0[1]
    run_info = {"setup_s": setup_s, "window_s": window_s, "rows_done": rows_done, "latencies_s": lat,
                "requests": dreq, "dispatches": ddisp, "prof": prof, "embed_flops_per_row": flops.embed_flops(arch, 1)}
    return {"numbers": numbers, "control": control, "attempted": len(issued), "failed": len(failed), "found": found,
            "device": device_info, "run": run_info}


def _clocks() -> dict:
    return {"perf": time.perf_counter_ns(), "monotonic": time.monotonic_ns(), "wall": time.time_ns()}


def _read(raw, c0: dict, c1: dict, records) -> dict:
    """The traced sub-window: its trace, its span, the device's busy time
    within it, and its idle gaps named by what the clients were doing then.
    The profiler's clock is the host clock whose span holds the device
    events; the device intervals are clipped to the span on that clock, so
    work from before the sub-window's start or after its end, which the
    profiler also records, counts in neither. A gap is named by whether some
    request was in flight (the engine's host path held the card idle) or
    none (the clients' own work)."""
    trace = read_trace(raw)
    out = {"trace": trace, "span_s": (c1["perf"] - c0["perf"]) / 1e9, "busy_s": 0.0, "gaps": []}
    if not trace.device:
        return out
    mid = sorted(e.start for e in trace.device)[len(trace.device) // 2]
    clock = next((c for c in ("monotonic", "wall", "perf") if c0[c] <= mid <= c1[c]), None)
    if clock is None:  # no host clock holds the device's events: no idle share
        common.log("the trace's clock matches no host clock: no idle share")
        out.update(busy_s=trace.busy_ns() / 1e9, gaps=trace.idle_gaps())
        return out
    span = (c0[clock], c1[clock])
    out["busy_s"] = trace.busy_ns(span) / 1e9
    out["clipped"] = True
    offset = c0[clock] - c0["perf"]
    spans = sorted((int(r[1] * 1e9), int(r[2] * 1e9)) for recs in records for r in recs)

    def namer(ns: int) -> str:
        t = ns - offset
        busy = sum(1 for a, b in spans if a <= t < b)
        return "requests in flight, card idle: the engine's host path" if busy else "no request in flight"

    out["gaps"] = trace.idle_gaps(span=span, namer=namer)
    return out


def _reference(ctx, arch, spec, sets, sd, dev, answered) -> tuple:
    if not answered:
        return {"embed_gap": float("inf")}, None
    r = common.rng(ctx.seed, 30)
    n = min(int(spec["check_requests"]), len(answered))
    longest = max(range(len(answered)), key=lambda i: len(answered[i][0].rows))
    pick = sorted({longest, *r.choice(len(answered), size=n - 1, replace=False).tolist()})
    replies, refs, lows = [], [], []
    with full_float32():
        for i in pick:
            req, _, _, reply, _ = answered[i]
            s = sets[req.set_index]
            src = torch.full((len(req.rows),), s.source, dtype=torch.long, device=dev)
            for lo in range(0, len(req.rows), spec["check_block_rows"]):
                rows = req.rows[lo:lo + spec["check_block_rows"]]
                inputs = ref_pre.preprocess(s.wf[rows], s.isi[rows], dev)
                refs.append(ref_cvae.embed(sd, arch, inputs, src[:len(rows)], Numerics("float32")).cpu().numpy())
                replies.append(reply[lo:lo + len(rows)])
                if ctx.control:
                    lows.append(ref_cvae.embed(sd, arch, inputs, src[:len(rows)], Numerics("tf32")).cpu().numpy())
    numbers = {"embed_gap": embed_gap(replies, refs)}
    control = {"embed_gap": embed_gap(lows, refs)} if ctx.control else None
    common.log(f"compared {len(pick)} requests, {sum(len(x) for x in refs)} rows")
    return numbers, control
