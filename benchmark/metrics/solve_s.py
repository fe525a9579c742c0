"""Seconds per solve: the window's seconds (from the start of its first
solve to the end of its last) over the solves completed in it."""

PROBES = ()


def read(run):
    done = sum(1 for s in run.solves if s["ok"])
    return run.window_s / done if done else None
