"""The card's idle share of the traced window, in %: 1 minus the union
of the intervals in which an operation ran on the card (from the
profiler's trace) over the window's length."""

PROBES = ()


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
