"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, ``<name>-<key>.so``; the key is the sha256 of the source,
of every ``.cuh`` and of ``NVCC_FLAGS`` (which name sm_90a), so an edited
kernel is never shadowed by a stale build. Libraries load with ``ctypes``;
the callers declare the argument types. Nothing here runs at import time,
and nothing is fetched.

Where the libraries live is the port's counterpart of hippie_tpu's
compiled-program cache (hippie_tpu/utils/aot.py): ``set_default_dir(D)``
(the pipeline's ``aot_dir``, the CLIs' ``--aot-dir``) puts them in
``D/torch_kernels/``; without it, or after ``set_default_dir(None)``, in
``build/kernels/`` beside the package. A library is looked for in that
order, and one that is found loads without looking for ``nvcc``, so a
directory filled on a machine with the CUDA toolkit serves a card without
one. A missing library is built into the first directory, once across
processes: each entry has a lock file (``fcntl.flock``, released by the OS
when its holder dies), and a process that finds the lock held waits and then
loads what the holder built. Beside each library a manifest
(``<name>-<key>.json``) records the nvcc version, the flags, the key and the
build seconds; nothing reads it back. Once per process and directory, the
other keys' entries of the package's sources and the temporary files of
writers that are gone are deleted. hippie_tpu's own cache writes
``prog_*`` files at the root of the same directory and prunes only those
and its ``.tmp.`` files, so the two packages can share it.

``count_launch`` is the wrappers' launch counter.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SUBDIR = "torch_kernels"  # the port's part of an --aot-dir
CLI_DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache", "hippie_tpu_aot")  # the JAX CLIs' --aot-dir
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.RLock()
_loaded: Dict[str, ctypes.CDLL] = {}  # source name -> its loaded library
_pruned: set = set()  # directories pruned by this process
_default_dir: Optional[str] = None
build_logs: Dict[str, str] = {}  # nvcc output (ptxas register/spill report) per source


def set_default_dir(path: Optional[str]) -> None:
    """The process's cache root (hippie_tpu.utils.aot.set_default_dir): the
    libraries go in ``path/torch_kernels``; None or "": ``build/kernels/``."""
    global _default_dir
    _default_dir = os.fspath(path) if path else None


def default_dir() -> Optional[str]:
    return _default_dir


def kernel_dirs() -> List[pathlib.Path]:
    """The directories a library is looked for in, in order; a missing one
    is built into the first."""
    if _default_dir is None:
        return [BUILD_DIR]
    return [pathlib.Path(_default_dir).expanduser() / SUBDIR, BUILD_DIR]


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA toolkit is needed")
    return found


def key(name: str) -> str:
    """sha256 of the flags, csrc/<name>.cu and every csrc/*.cuh."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()


def so_path(name: str) -> pathlib.Path:
    """Where the library of csrc/<name>.cu is: the first directory of
    ``kernel_dirs`` that holds it, else where it would be built."""
    file = f"{name}-{key(name)[:12]}.so"
    dirs = kernel_dirs()
    return next((d / file for d in dirs if (d / file).exists()), dirs[0] / file)


_ENTRY = re.compile(r"^(?P<name>.+)-(?P<key>[0-9a-f]{12})(?P<ext>\.so|\.json|\.lock|\.tmp\d+)$")


def _prune(directory: pathlib.Path):
    """Once per process: delete the entries of the package's sources under
    another key (an edited source's), and temporary files whose entry no
    process is building (its lock is free)."""
    if directory in _pruned:
        return
    _pruned.add(directory)
    try:
        files = list(directory.iterdir())
    except OSError:
        return
    current = {n: key(n)[:12] for n in sources()}
    for p in files:
        m = _ENTRY.match(p.name)
        if m is None or m["name"] not in current:
            continue
        stale = m["key"] != current[m["name"]]
        with contextlib.suppress(OSError):  # a directory this process cannot write
            if not stale and m["ext"].startswith(".tmp"):
                with _entry_lock(directory / f"{m['name']}-{m['key']}.lock", block=False) as free:
                    stale = free
            if stale:
                p.unlink()


@contextlib.contextmanager
def _entry_lock(path: pathlib.Path, block: bool = True):
    """Hold the flock of ``path``; yields False when ``block`` is False and
    another process holds it."""
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | (0 if block else fcntl.LOCK_NB))
        except BlockingIOError:
            yield False
            return
        yield True
    finally:
        os.close(fd)  # releases the lock


def _writable_dir() -> pathlib.Path:
    """The first directory of ``kernel_dirs`` that can be written (made if
    missing), as hippie_tpu's cache runs uncached when its directory is
    unusable; one warning for each that cannot."""
    import warnings

    for d in kernel_dirs():
        try:
            d.mkdir(parents=True, exist_ok=True)
            if os.access(d, os.W_OK):
                return d
        except OSError:
            pass
        warnings.warn(f"kernel directory {d} cannot be written; building elsewhere")
    raise RuntimeError("no kernel directory can be written: " + ", ".join(map(str, kernel_dirs())))


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip()
    return out.splitlines()[-1] if out else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that no directory of
    ``kernel_dirs`` holds yet, into its first.

    One ``nvcc`` per source, all started together, each under its entry's
    lock; an entry another process is building is waited for. Returns the
    seconds each build took (0.0 for a library already there); raises with
    the compiler's output if any build fails, and naming the directory and
    key if a library is missing and there is no ``nvcc``.
    """
    names = list(sources() if names is None else names)
    secs = {n: 0.0 for n in names}
    with _lock:
        for d in kernel_dirs():
            _prune(d)
        todo = [n for n in names if not so_path(n).exists()]
        if not todo:
            return secs
        out_dir = _writable_dir()
        with contextlib.ExitStack() as locks:
            held, waiting = [], []
            for n in todo:  # the free entries first, so their builds start together
                got = locks.enter_context(_entry_lock(out_dir / f"{n}-{key(n)[:12]}.lock", block=False))
                (held if got else waiting).append(n)
            for n in waiting:  # another process builds these: wait, then build what it did not
                locks.enter_context(_entry_lock(out_dir / f"{n}-{key(n)[:12]}.lock"))
                held.append(n)
            _compile([n for n in held if not so_path(n).exists()], out_dir, secs)
    return secs


def _compile(names: List[str], out_dir: pathlib.Path, secs: Dict[str, float]):
    """Run nvcc on each of ``names`` into ``out_dir``, all at once, with the
    entries' locks held by the caller."""
    if not names:
        return
    try:
        nvcc = _nvcc()
    except RuntimeError as e:
        missing = ", ".join(f"{n}-{key(n)[:12]}.so (key {key(n)})" for n in names)
        raise RuntimeError(f"{e}; no built library {missing} in "
                           + " or ".join(str(d) for d in kernel_dirs())) from None
    version = _nvcc_version(nvcc)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        so = out_dir / f"{name}-{key(name)[:12]}.so"
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        log = tempfile.TemporaryFile("w+")  # a file, not a pipe: polled processes never block on output
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True), log, tmp, so)
    failed = []
    while procs:
        for name, (proc, log, tmp, so) in list(procs.items()):
            if proc.poll() is None:
                continue
            secs[name] = time.perf_counter() - t0
            del procs[name]
            log.seek(0)
            build_logs[name] = out = log.read()
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, so)
                manifest = {"source": f"{name}.cu", "key": key(name), "nvcc": version,
                            "flags": list(NVCC_FLAGS), "build_seconds": secs[name]}
                tmp_json = so.with_suffix(f".tmp{os.getpid()}")
                tmp_json.write_text(json.dumps(manifest, indent=1) + "\n")
                os.replace(tmp_json, so.with_suffix(".json"))
            else:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        if procs:
            time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


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
