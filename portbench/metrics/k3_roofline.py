"""Kernel 3 in the decode graph: the least time of its launches over the
device time of its two CUDA kernels, in %.  A replay's launches attend the
decode rows of that step; their work counts only the live pages (each row's
attended keys, rounded up to whole pages), read once."""
from portbench import flops, hw, measure


def read(run):
    if run.recorder is None or run.kind != "serve":
        return None
    per_step = [L.shape for L in run.recorder.graph if L.kernel == "k3"]
    if not per_step or any(L.kernel == "k3" for L in run.recorder.eager):
        return None
    bound = 0.0
    for st in measure.window_steps(run, run.trace_window):
        if not st.decode_rows:
            continue
        for s in per_step:
            bound += hw.roofline_s(*flops.paged_work(
                st.decode_rows, s["Hkv"], s["rep"], s["hd"], s["hdv"],
                s["ps"], s["elem"]))
    return measure.share(bound, measure.device_seconds(run, "k3"))
