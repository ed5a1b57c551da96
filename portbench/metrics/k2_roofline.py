"""Kernel 2: the least time of its window's launches (QK^T and P.V over
the attended pairs at the bf16 peak, or q, k, v and the output once at the
memory peak) over the device time of its CUDA kernel, in %."""
from portbench import flops, measure


def _work(s):
    return flops.attention_work(s["B"], s["S"], s["T"], s["H"], s["Hkv"],
                                s["hd"], s["hdv"], s["causal"], s["window"])


def read(run):
    bound = measure.launch_bound(run, "k2", _work)
    return measure.share(bound, measure.device_seconds(run, "k2"))
