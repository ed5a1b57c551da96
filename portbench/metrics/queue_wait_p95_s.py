"""p95 of the engine's queue wait, from a request's enqueue to its
``admitted`` event (the program's ``obs`` request events), over the
requests enqueued in the window; one not admitted by the window's end
counts at its age then."""
from portbench import measure


def read(run):
    if run.kind != "serve" or not run.req_events:
        return None
    t0, t1 = run.window
    enq, adm = {}, {}
    for name, rid, t in run.req_events:
        if name == "enqueue":
            enq[rid] = t
        elif name == "admitted" and rid not in adm:
            adm[rid] = t
    waits = [min(adm.get(rid, t1), t1) - t for rid, t in enq.items()
             if t0 <= t < t1]
    return measure.p95(waits)
