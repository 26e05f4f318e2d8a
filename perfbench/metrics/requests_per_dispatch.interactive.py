"""requests_per_dispatch.interactive: the engine's requests over its device
dispatches (EmbeddingService's counters) across the window: how many
requests one coalesced group serves."""


def read(run):
    if not run.get("dispatches"):
        return None
    return run["requests"] / run["dispatches"]
