"""setup_s: from the process's start (``/proc``) to the window's opening:
the imports, the raw rows, the weights, the program's build and warm-up."""


def read(run):
    return run.get("setup_s")
