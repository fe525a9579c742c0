"""Scalar LPs per solve (the Benson driver's ``Stats.lps``), the mean
over the window's solves."""

PROBES = ()


def read(run):
    lps = [s["lps"] for s in run.solves if s["ok"]]
    return sum(lps) / len(lps) if lps else None
