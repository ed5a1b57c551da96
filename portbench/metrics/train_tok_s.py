"""Tokens of every training step in the window over the window, which ends
on a step boundary."""


def read(run):
    if run.kind != "train" or not run.train_steps:
        return None
    t0, t1 = run.window
    return sum(n for _, n in run.train_steps) / (t1 - t0)
