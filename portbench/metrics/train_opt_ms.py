"""Device time of the train step's optimizer phase per step, in milliseconds:
the summed device intervals of the measured window's ``train.optimizer``
spans (their ``device_us`` edges) over the window's ``train.optimizer``
spans."""
from portbench import measure


def read(run):
    dur = [a["device_us"][1] - a["device_us"][0]
           for _, _, a in measure.spans(run, "train.optimizer")
           if "device_us" in a]
    steps = len(measure.spans(run, "train.optimizer"))
    return sum(dur) * 1e-3 / steps if dur and steps else None
