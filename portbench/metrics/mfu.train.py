"""6 N D plus attention of the window's training steps over the window at
the bf16 peak, in %."""
from portbench import flops, hw


def read(run):
    if run.kind != "train" or not run.train_steps:
        return None
    t0, t1 = run.window
    f = len(run.train_steps) * flops.train_flops(
        run.conf, run.mix["batch"], run.mix["seq"])
    return 100.0 * f / ((t1 - t0) * hw.PEAK_FLOPS)
