"""Kernel 1 in a training window, both paths: the least time of its
launches (the f32 product's 2 M N K, or each operand once) over the device
time of its CUDA kernels, in %."""
from portbench import measure


def read(run):
    if run.kind != "train":
        return None
    bound = measure.launch_bound(run, "k1", measure.k1_work)
    dev = [measure.device_seconds(run, k) for k in ("k1_path_s", "k1_path_w")]
    return measure.share(bound, sum(d for d in dev if d) or None)
