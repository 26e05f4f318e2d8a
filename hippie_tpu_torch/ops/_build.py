"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``build/kernels/<name>-<hash>.so`` beside the package; the
hash covers the sources and the flags, so an edited kernel is never shadowed
by a stale build. Libraries load with ``ctypes``; the callers declare the
argument types. Nothing here runs at import time, and nothing is fetched: the
CUDA toolkit on the machine with the card is all it needs. ``count_launch``
is the wrappers' launch counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc output (ptxas register/spill report) per source


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA toolkit is needed")
    return found


def so_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet.

    One ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for a library already on disk); raises with the compiler's
    output if any build fails.
    """
    names = list(sources() if names is None else names)
    todo = {n: so_path(n) for n in names if not so_path(n).exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, so)  # atomic: concurrent builds race safely
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(so_path(name)))
        return lib


def count_launch(table: dict, name: str):
    """One more launch of ``name``'s kernel in ``table``, unless the current
    stream is being captured into a CUDA graph: a capture records the
    kernel and launches nothing, and the graph's replays launch it without
    the wrapper (torch.profiler counts those)."""
    import torch

    if not torch.cuda.is_current_stream_capturing():
        table[name] += 1
