"""Process start to the window's start: imports, the kernels' build or
load, weights, the engine or the optimizer state, warm-up."""


def read(run):
    return run.setup_s
