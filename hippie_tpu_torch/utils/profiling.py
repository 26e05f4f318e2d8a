"""Wall time per pipeline stage, a profiler trace of a run, and the
program's own spans.

Counterpart of hippie_tpu/utils/profiling.py: each ``with
timer.stage(name)`` adds its wall time to ``timings[name]``; ``trace(dir)``
records the block with torch.profiler (the JAX package's jax.profiler
trace) and writes a Chrome trace into ``dir``, viewable in Perfetto or
chrome://tracing. ``Spans`` (no JAX counterpart) keeps named intervals of
the program's phases in memory, on ``time.perf_counter_ns()``, for the
caller to read when it is done.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional


@contextlib.contextmanager
def trace(trace_dir: Optional[str], device="cuda"):
    """torch.profiler over the block when a directory is given, a no-op
    otherwise. Host activity always, the card's kernels and copies too when
    ``device`` is a CUDA device. The trace, ``trace_<pid>_<time>.json``, is
    written when the block ends, also when it raises."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.timings.values())
        return json.dumps({**{k: round(v, 3) for k, v in self.timings.items()},
                           "total_s": round(total, 3)})


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int  # threading.get_ident() of the thread that recorded it
    id: int  # the request or dispatch the span belongs to (0: none)
    parent: int  # the id of the span that caused it, such as a phase's dispatch (0: none)


class Spans:
    """A bounded in-memory record of spans: the newest ``maxlen`` are kept,
    nothing is written anywhere. ``new_id()`` hands out the ids that tie a
    request's or a dispatch's spans together; ``add`` and ``new_id`` may be
    called from any thread."""

    def __init__(self, maxlen: int = 1 << 18):
        self._spans: collections.deque = collections.deque(maxlen=maxlen)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, name: str, start_ns: int, end_ns: int, id: int = 0, parent: int = 0):
        span = Span(name, start_ns, end_ns, threading.get_ident(), id, parent)
        with self._lock:
            self._spans.append(span)

    def spans(self) -> List[Span]:
        """The spans kept, in the order they were recorded."""
        with self._lock:
            return list(self._spans)


class Phases:
    """One thread's consecutive phases as spans in ``spans``: ``lap(name)``
    records ``name`` from the end of the previous lap (or ``t_ns``) to now,
    so the laps tile the thread's time; ``parent`` is the enclosing span's
    id."""

    __slots__ = ("spans", "t", "parent")

    def __init__(self, spans: Spans, t_ns: int, parent: int = 0):
        self.spans, self.t, self.parent = spans, t_ns, parent

    def lap(self, name: str) -> int:
        t = time.perf_counter_ns()
        self.spans.add(name, self.t, t, parent=self.parent)
        self.t = t
        return t
