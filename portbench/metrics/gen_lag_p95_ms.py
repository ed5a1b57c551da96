"""p95 over the requests due in the window of how late the load generator
handed each to ``add_request`` after it was due, in milliseconds."""
from portbench import measure


def read(run):
    if run.kind != "serve" or run.mix["loop"] != "open":
        return None
    v = measure.p95(s.sent - s.due for s in measure.arrivals(run))
    return None if v is None else v * 1e3
