"""What a train step's device interval holds besides its three phases, in
milliseconds: from one ``train.optimizer`` span's device end to the next,
less the device intervals of the ``train.forward``, ``train.backward`` and
``train.optimizer`` spans that started between them, averaged over the
measured window's steps (the batch's making and the device's idle waiting
for the host)."""
from portbench import measure

PHASES = ("train.forward", "train.backward", "train.optimizer")


def _device(run, name):
    return [(s + a["device_us"][0] * 1e-6, s + a["device_us"][1] * 1e-6)
            for s, _, a in measure.spans(run, name) if "device_us" in a]


def read(run):
    ends = sorted(e for _, e in _device(run, "train.optimizer"))
    phases = [iv for name in PHASES for iv in _device(run, name)]
    gaps = [hi - lo - sum(e - s for s, e in phases if lo <= s < hi)
            for lo, hi in zip(ends, ends[1:])]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None
