"""Summed device interval of the measured window's ``prefill`` spans (their
``device_us`` edges) over the padded prompt tokens they prefilled, in
milliseconds per thousand tokens: the device's side of
``prefill_ms_per_ktok``."""
from portbench import measure


def read(run):
    sp = [a for _, _, a in measure.spans(run, "prefill") if "device_us" in a]
    toks = sum(a.get("batch", 0) * a.get("padded", 0) for a in sp)
    if not toks:
        return None
    dev_us = sum(a["device_us"][1] - a["device_us"][0] for a in sp)
    return dev_us * 1e-3 / toks * 1e3
