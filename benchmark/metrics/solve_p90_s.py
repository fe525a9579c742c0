"""The 90th percentile, by nearest rank, of the wall times of all the
window's solves (each from the call to ``solve`` until it returns,
after the card is synchronised)."""

import math

PROBES = ()


def read(run):
    walls = sorted(s["wall_s"] for s in run.solves)
    if not walls:
        return None
    return walls[math.ceil(0.9 * len(walls)) - 1]
