"""launches_per_step.train: the device kernels and copies of the profiled
train epoch (its replays, the plan's copy, the row counter's reset and the
metrics' fetch) over its steps."""


def read(run):
    prof = run.get("prof")
    if not prof or not prof["trace"].device:
        return None
    return len(prof["trace"].device) / run["nb"]
