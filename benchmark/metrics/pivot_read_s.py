"""Seconds per solve the host spent blocked on the pivot loop's status
read: the program's ``pivot.read`` spans over the window's solves.
Absent where the program records no such span."""

PROBES = ("program_spans",)


def read(run):
    s = run.probes["program_spans"].seconds
    return s["pivot.read"] / len(run.solves) if "pivot.read" in s else None
