"""What every cell's run shares: finding a cell's files by name, seeds, the
card's identity, the forbidden-import check and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; each is found by its name alone:
``perfbench/configs/<config>.json``, ``perfbench/traffic/<traffic>.json``
(a mix's parameters, data only), ``perfbench/traffic/<kind>.py`` (the
generator and runner of the mix's ``kind``: ``FAULTS`` and
``run(ctx) -> dict``), ``perfbench/limits/<workload>.json`` (the limits of
the numbers that decide ``correct``) and ``perfbench/metrics/<metric>.py``
(every metric's reader, end-to-end and per-layer: ``read(run) -> float or
None`` over what the runner counted). A later change adds a cell, a
configuration, a mix, a kind of traffic or a metric by adding such files
and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "hippie_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and limits."""

    def __init__(self, name: str, root: pathlib.Path = ROOT):
        self.bench = load_json(root / "BENCHMARK.json")
        bench_dir = root / "perfbench"
        by_name = {w["name"]: w for w in self.bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json; one of {sorted(by_name)}")
        self.name = name
        self.workload = by_name[name]
        entry = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")
        self.bench_dir = bench_dir

    def metrics(self, kind: str) -> list:
        """The end-to-end or per-layer metric entries this cell reports."""
        return [m for m in self.bench[kind] if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric: str):
        """The ``read(run) -> float or None`` of a metric."""
        return _load(self.bench_dir / "metrics" / f"{metric}.py", "metric", metric).read

    def runner(self):
        """The module of the traffic mix's ``kind``: ``FAULTS``, ``run(ctx)``."""
        kind = self.traffic["kind"]
        path = self.bench_dir / "traffic" / f"{kind}.py"
        if not path.is_file():
            raise SystemExit(f"perfbench: no runner {path.name} for the traffic kind {kind!r}")
        return _load(path, "traffic", kind)


def _load(path: pathlib.Path, group: str, name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_{group}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(spec: dict, rehearsal: bool) -> dict:
    """A mix's parameters; for a CPU rehearsal with its ``rehearsal`` overrides."""
    out = {k: v for k, v in spec.items() if k != "rehearsal"}
    if rehearsal:
        out.update(spec.get("rehearsal", {}))
    return out


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one stream of the run (``path`` names the stream),
    from the run's ``--seed`` of any size."""
    entropy = [int(seed) % (1 << 64)] + [int(p) for p in path]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def process_start() -> float:
    """The process's start on the wall clock (``time.time()``), from
    ``/proc``; the interpreter's start-up and imports count as set-up."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def set_cache_dirs():
    """Every build and kernel cache of the program at a fixed path inside the
    checkout, so that only a checkout's first run builds."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def card(device) -> dict:
    """The result line's ``device``: the card's name as torch gives it, and
    its power limit (nvidia-smi) for the log."""
    import torch

    name = torch.cuda.get_device_name(device)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        power = limit[device.index or 0] if limit else "unknown"
    except (OSError, subprocess.SubprocessError):
        power = "unknown"
    return {"platform": "gpu", "kind": name, "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)), "power_limit": power}


def log(msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, compared)``: each number beside its limit; a number over
    its limit, or one that is not finite, is not correct."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        compared[name] = {"value": value if value is None or math.isfinite(value) else str(value), "limit": limit}
    return ok, compared


def emit(line: dict, compared: dict):
    """The compared numbers as the last lines of stderr, then the result line
    (``compared`` its last key) as the last line of stdout."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
    line = dict(line)
    line["compared"] = compared
    print(json.dumps(line), flush=True)
