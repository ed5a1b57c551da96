"""Mean device idle between consecutive ``decode`` spans of the measured
window, in milliseconds: from one step's device end to the next step's
device start (the host's time between them: the token download, the
scheduler, the next dispatch), leaving out pairs with a ``prefill`` or
``prefill.chunk`` span between them."""
from portbench import measure


def read(run):
    dec = sorted(measure.spans(run, "decode"), key=lambda sp: sp[0])
    pre = [s for name in ("prefill", "prefill.chunk")
           for s, _, _ in measure.spans(run, name)]
    gaps = []
    for (s0, _, a0), (s1, _, a1) in zip(dec, dec[1:]):
        if ("device_us" in a0 and "device_us" in a1
                and not any(s0 < p < s1 for p in pre)):
            gaps.append(s1 + a1["device_us"][0] * 1e-6
                        - (s0 + a0["device_us"][1] * 1e-6))
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
