"""Mean device interval of the measured window's ``decode`` spans, in
milliseconds: from when the stream reached a decode step's upload to when
its replay finished (each span's ``device_us`` edges)."""
from portbench import measure


def read(run):
    dur = [a["device_us"][1] - a["device_us"][0]
           for _, _, a in measure.spans(run, "decode") if "device_us" in a]
    return sum(dur) / len(dur) * 1e-3 if dur else None
