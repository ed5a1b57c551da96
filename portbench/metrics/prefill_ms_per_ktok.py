"""Summed ``prefill`` span time over the padded prompt tokens those spans
prefilled, per thousand tokens."""
from portbench import measure


def read(run):
    sp = measure.spans(run, "prefill")
    toks = sum(a.get("batch", 0) * a.get("padded", 0) for _, _, a in sp)
    if not toks:
        return None
    return sum(e - s for s, e, _ in sp) * 1e3 / toks * 1e3
