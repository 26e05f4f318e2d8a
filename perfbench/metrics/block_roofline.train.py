"""block_roofline.train: the profiled epoch's least time of its fused block
calls (perfbench/yardstick/bounds.py: each block's forward and backward of
the published architecture at the batch's rows, summed over a step, times
the epoch's steps) as a % of the device time of the block kernels. A block
kernel is a device kernel whose name, without template arguments, is that
of a ``__global__`` function defined in the files the block entry points
are built from (harness/readers.py: BLOCK_SOURCES). No such kernel in the
trace: no reading."""

from perfbench.harness.readers import base_name, global_names


def read(run):
    prof = run.get("prof")
    if not prof:
        return None
    names = global_names()
    ns = sum(e.end - e.start for e in prof["trace"].device if base_name(e.name) in names)
    if ns <= 0:
        return None
    return 100.0 * run["block_step_ms"] * run["nb"] / (ns / 1e6)
