"""Device time of a decode step: the device's busy time (the union of its
intervals) from each ``decode`` span's start to the end of the
``decode.consume`` span that follows it, averaged over the profiled window's
decode steps, in milliseconds."""
from portbench import measure
from portbench.trace import Busy


def read(run):
    if run.device is None or not run.device.ok:
        return None
    disp = measure.spans(run, "decode", run.trace_window)
    cons = measure.spans(run, "decode.consume", run.trace_window)
    if not disp or len(disp) != len(cons):
        return None
    busy = Busy((s, e) for _, s, e in run.device.events)
    total = sum(busy.seconds(d[0], c[1]) for d, c in zip(disp, cons))
    return total / len(disp) * 1e3
