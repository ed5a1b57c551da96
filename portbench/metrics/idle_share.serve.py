"""1 - the union of the device's activity over the profiled window, in %."""
from portbench import measure


def read(run):
    if run.kind != "serve":
        return None
    busy = measure.busy_seconds(run)
    if busy is None:
        return None
    t0, t1 = run.trace_window
    return 100.0 * (1.0 - busy / (t1 - t0))
