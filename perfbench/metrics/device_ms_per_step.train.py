"""device_ms_per_step.train: the card's busy time (the union of its kernels'
and copies' intervals) in the profiled train epoch, over its steps: the
device's own time per step, steady where the window's rate is not (the
host's launches of the step's graph can hold the card idle)."""


def read(run):
    prof = run.get("prof")
    if not prof or not prof["trace"].device:
        return None
    return prof["trace"].busy_ns() / 1e6 / run["nb"]
