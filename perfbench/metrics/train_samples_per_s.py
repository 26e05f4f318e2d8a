"""train_samples_per_s: the real (unmasked) rows trained in the window, over
its seconds; the window ends on an epoch's fetch, which waits for the card."""


def read(run):
    if not run.get("window_s") or "samples" not in run:
        return None
    return run["samples"] / run["window_s"]
