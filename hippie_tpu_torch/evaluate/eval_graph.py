"""The port's per-bucket eval programs: CUDA graphs over static buffers.

Counterpart of the JAX package's compiled embedding programs: the jitted
embed forwards of hippie_tpu/evaluate/embeddings.py, whose rows are padded
to power-of-two buckets (``_bucket``) so that each bucket has one
executable, and the serving programs of scripts/serve_embeddings.py, one
per row bucket, which serve every raw width up to the caps. Eager torch
compiles nothing; on the card the counterpart of such a program is a CUDA
graph. An ``EvalGraph`` holds static buffers for one key (a row bucket and
what else shapes the program) and a function of them. On its first call
on the card it runs the function once eagerly on its space's capture
stream (the warm-up: the library handles and workspaces, the convolutions'
algorithms), captures it, and replays the graph for that call and every
later one. Inputs are copied into the buffers before a call (from pinned
staging buffers, one host-to-device copy per input); the output is a
buffer of the graph that the next replay overwrites.

A ``GraphSpace`` is where a family of graphs runs: one capture stream and
one memory pool for all of them (the graphs of a space never replay
concurrently: a server replays from its one dispatch worker, the other
users hold a lock), and the counts of captures and replays. The capture
runs with ``capture_error_mode="thread_local"``: the server captures on its
dispatch worker while its HTTP threads run, and a process that embeds the
server or the artifact may use the card from other threads; a CUDA call
of another thread neither fails the capture nor lands in it (the graph
holds only the capturing thread's work on the capture stream).
``torch.backends.cudnn.benchmark`` must be off (the port never turns it
on): the warm-up and the capture must pick the same convolution
algorithms, and an eager call of the same function the same ones, which
is what makes a replay equal the eager call bit for bit.

Off the card there are no graphs: the same function over the same buffers
runs eagerly on every call (the CPU tests), and the counts count those
runs as the card would count captures and replays. On the card an
EvalGraph captures or raises: it never falls back to eager calls.
``eager()`` runs the function on the buffers without the graph, for the
checks that hold a replay to it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hippie_tpu_torch.ops import preprocess


def bucket_rows(n: int, minimum: int = 512) -> int:
    """THE row-bucket rule (the JAX evaluate/embeddings._bucket): the next
    power of two >= n, at least 512."""
    b = minimum
    while b < n:
        b *= 2
    return b


class GraphSpace:
    """The capture stream, the memory pool and the counts of a family of
    EvalGraphs on ``device`` (off the card: the counts only)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures = self.replays = 0
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None

    @contextlib.contextmanager
    def on_stream(self):
        """The capture stream current inside, started after the caller's
        stream's work, which waits for it on leaving (off the card:
        nothing)."""
        if not self.on_card:
            yield
            return
        outer = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(outer)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            outer.wait_stream(self.stream)

    def capture(self, fn: Callable):
        """(graph, result) of ``fn()`` captured on the capture stream, under
        no_grad. The caller has run ``fn`` eagerly on that stream first."""
        if torch.backends.cudnn.benchmark:
            raise RuntimeError("torch.backends.cudnn.benchmark is on: a capture could pick other convolution "
                               "algorithms than its eager warm-up; turn it off")
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                               capture_error_mode="thread_local"):
            out = fn()
        self.captures += 1
        return graph, out


class EvalGraph:
    """``fn(*buffers) -> Tensor`` over static buffers on the space's device,
    and on the card its CUDA graph (module note). The first ``staged``
    buffers are inputs from the host: ``host(i)`` is the numpy array to
    write input i into (pinned on the card, the buffer itself off it), and
    ``upload()`` copies them in. ``__call__`` runs the program (the first
    call on the card captures it) and returns its output; ``fetch(out,
    rows)`` brings the first ``rows`` rows of an output to the host."""

    def __init__(self, fn: Callable, buffers: Sequence[torch.Tensor], space: GraphSpace, staged: int = 0):
        self.fn, self.buffers, self.space = fn, tuple(buffers), space
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.runs = 0
        self._host = [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) if space.on_card else b
                      for b in self.buffers[:staged]]
        self._host_out: Optional[torch.Tensor] = None

    def host(self, i: int) -> np.ndarray:
        return self._host[i].numpy()

    def upload(self):
        """One copy per staged input, from pinned memory on the card (the
        caller waits for the call's output before it writes the staging
        buffers again: fetch does)."""
        if self.space.on_card:
            for h, b in zip(self._host, self.buffers):
                b.copy_(h, non_blocking=True)

    def eager(self) -> torch.Tensor:
        """The function on the buffers, without the graph (a new tensor)."""
        with torch.no_grad():
            return self.fn(*self.buffers)

    def __call__(self) -> torch.Tensor:
        space = self.space
        if not space.on_card:
            if self.runs == 0:
                space.captures += 1
            self.out = self.eager()
        else:
            if self.graph is None:
                with space.on_stream():
                    self.eager()  # the warm-up, on the capture stream
                    self.graph, self.out = space.capture(self.eager)
            self.graph.replay()
        self.runs += 1
        space.replays += 1
        return self.out

    def fetch(self, out: torch.Tensor, rows: int) -> np.ndarray:
        """The first ``rows`` rows of ``out`` as a numpy array the caller
        owns: on the card one copy into a pinned buffer, waited for."""
        if not self.space.on_card:
            return out[:rows].numpy().copy()
        if self._host_out is None or self._host_out.shape != out.shape:
            self._host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        self._host_out[:rows].copy_(out[:rows], non_blocking=True)
        torch.cuda.current_stream(self.space.device).synchronize()
        return self._host_out[:rows].numpy().copy()


class EmbeddingGraph(EvalGraph):
    """The server's program for one key: raw rows ``[rows, wave_cols]`` and
    ``[rows, isi_cols]``, ``source [rows]`` and the true widths ``[2]``
    (staged from the host), the resample coefficients ``[wave_cols, 50]``
    and ``[isi_cols, 100]``, and ``embed(wave, isi, source)``, the model
    forward(s) with the z-scoring and, for two models, the concatenation.
    ``padded``: the rows are zero-padded to the width caps
    (preprocess_pair_padded, the widths as device scalars, so one graph
    serves every width up to the caps); else they have the key's own widths
    (preprocess_pair_exact)."""

    def __init__(self, embed: Callable, rows: int, wave_cols: int, isi_cols: int, *, normalize: bool,
                 padded: bool, space: GraphSpace):
        dev = space.device
        buffers = (torch.zeros(rows, wave_cols, device=dev), torch.zeros(rows, isi_cols, device=dev),
                   torch.zeros(rows, dtype=torch.long, device=dev), torch.zeros(2, dtype=torch.long, device=dev),
                   torch.zeros(wave_cols, preprocess.WAVE_LEN, device=dev),
                   torch.zeros(isi_cols, preprocess.ISI_LEN, device=dev))

        def fn(wf, isi, src, widths, r_wf, r_isi):
            if padded:
                wave, isi_p = preprocess.preprocess_pair_padded(wf, isi, r_wf, r_isi, widths[0], widths[1],
                                                                normalize=normalize)
            else:
                wave, isi_p = preprocess.preprocess_pair_exact(wf, isi, r_wf, r_isi, normalize=normalize)
            return embed(wave, isi_p, src)

        super().__init__(fn, buffers, space, staged=4)
        self.widths = None

    def set_widths(self, wave_width: int, isi_width: int):
        """The true widths of the next call: staged for upload, and the
        coefficients of these widths copied in on the device when they
        changed."""
        self.host(3)[:] = (wave_width, isi_width)
        if self.widths != (wave_width, isi_width):
            dev = str(self.space.device)
            for buf, width, out_len in ((self.buffers[4], wave_width, preprocess.WAVE_LEN),
                                        (self.buffers[5], isi_width, preprocess.ISI_LEN)):
                buf.copy_(preprocess.device_interp_matrix(width, out_len, buf.shape[0], dev))
            self.widths = (wave_width, isi_width)


class BucketedCall:
    """``fn(*tensors) -> [rows, ...]`` on the rows of numpy arrays or
    tensors, run as one EvalGraph per row bucket (``bucket_rows``): the
    inputs copied into the bucket's buffers (``dtypes``, zero rows past
    them), the reply cut back to the rows as a tensor of its own on the
    device. One call at a time (a lock). An artifact's call
    (export.load_artifact) is one."""

    def __init__(self, fn: Callable, dtypes: Sequence[torch.dtype], space: GraphSpace):
        self.fn, self.dtypes, self.space = fn, tuple(dtypes), space
        self.graphs: dict = {}
        self._lock = threading.Lock()

    def _load(self, arrays) -> tuple:
        tensors = [torch.as_tensor(a) for a in arrays]
        n = int(tensors[0].shape[0])
        b = bucket_rows(n)
        key = (b,) + tuple(tuple(t.shape[1:]) for t in tensors)
        g = self.graphs.get(key)
        if g is None:
            bufs = [torch.zeros((b,) + tuple(t.shape[1:]), dtype=dt, device=self.space.device)
                    for t, dt in zip(tensors, self.dtypes)]
            g = self.graphs[key] = EvalGraph(self.fn, bufs, self.space)
        for buf, t in zip(g.buffers, tensors):
            buf[:n].copy_(t)
            buf[n:].zero_()
        return g, n

    def __call__(self, *arrays) -> torch.Tensor:
        with self._lock:
            g, n = self._load(arrays)
            return g()[:n].clone()

    def eager(self, *arrays) -> torch.Tensor:
        """The same call without the graph (the checks' reference)."""
        with self._lock:
            g, n = self._load(arrays)
            return g.eager()[:n].clone()
