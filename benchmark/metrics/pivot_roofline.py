"""The device pivot step's share of its roofline, in %: over every call
of the tableau pivot loop in the traced solves (those of the attempt
that the device trace kept), the least time of its steps
(``roofline.pivot_step_least_s`` on the LP's unpadded tableau, times
the steps the call ran) over the seconds in which the card ran an
operation inside the call's host interval (from the device trace; the
card's idle gaps between replays are the host's, and left out).
Padding lowers it."""

from benchmark.device_trace import busy_within
from benchmark.roofline import pivot_step_least_s

PROBES = ("pivot_clock",)


def read(run):
    if not run.trace:
        return None
    w0, w1 = run.trace["window"]
    loops = [loop for loop in run.probes["pivot_clock"].loops
             if w0 <= loop[-2] and loop[-1] <= w1]
    if not loops:
        return None
    spent = busy_within(run.trace["ops"], [(t0, t1) for *_, t0, t1 in loops])
    least = sum(steps * pivot_step_least_s(B, M, N, dtype)
                for B, M, N, dtype, steps, _, _ in loops)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
