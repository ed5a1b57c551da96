"""Mean over the window's engine steps of the ``engine.step`` span's
``occupancy``: the slots holding a request."""
from portbench import measure


def read(run):
    sp = measure.spans(run, "engine.step")
    occ = [a["occupancy"] for _, _, a in sp if "occupancy" in a]
    return sum(occ) / len(occ) if occ else None
