"""embed_rows_per_s: the rows whose embeddings reached their client before
the window closed, over the window's seconds."""


def read(run):
    if not run.get("window_s") or "rows_done" not in run:
        return None
    return run["rows_done"] / run["window_s"]
