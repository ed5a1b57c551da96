"""Model FLOPs of the window's prefills and decode steps over the window
at the bf16 peak, in %: per prompt its tokens through the stack, causal
attention and one logit row; per decode row the stack, its attended keys
and one logit row."""
from portbench import hw, measure


def read(run):
    if run.kind != "serve":
        return None
    pre, dec = measure.serve_model_flops(run)
    t0, t1 = run.window
    return 100.0 * (pre + dec) / ((t1 - t0) * hw.PEAK_FLOPS) or None
