"""Kernel 1 on path S: the least time its window's launches could take
(the f32 product's 2 M N K at the bf16 peak, or each operand once at the
memory peak, whichever is larger, launch by launch) over the device time of
its CUDA kernels, in %."""
from portbench import measure


def read(run):
    bound = measure.launch_bound(run, "k1", measure.k1_work, path="s")
    return measure.share(bound, measure.device_seconds(run, "k1_path_s"))
