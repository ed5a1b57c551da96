"""Output tokens generated in the window over the window's seconds."""
from portbench import measure


def read(run):
    if run.kind != "serve":
        return None
    t0, t1 = run.window
    return measure.window_tokens(run) / (t1 - t0)
