"""p95 over every request that arrived in the window of the time from when
it was due (open loop) or sent (closed loop) to its first token; one still
unserved at the window's end counts at its age then."""
from portbench import measure


def read(run):
    if run.kind != "serve":
        return None
    return measure.p95(measure.ttfts(run))
