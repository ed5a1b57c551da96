"""p95 over every gap between consecutive output tokens of one request,
both inside the window, in milliseconds."""
from portbench import measure


def read(run):
    if run.kind != "serve":
        return None
    v = measure.p95(measure.itls(run))
    return None if v is None else v * 1e3
