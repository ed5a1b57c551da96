"""Prefill model FLOPs of the window over the summed ``prefill`` span time
at the bf16 peak, in %."""
from portbench import hw, measure


def read(run):
    sp = measure.spans(run, "prefill")
    secs = sum(e - s for s, e, _ in sp)
    pre, _ = measure.serve_model_flops(run)
    if not secs or not pre:
        return None
    return 100.0 * pre / (secs * hw.PEAK_FLOPS)
