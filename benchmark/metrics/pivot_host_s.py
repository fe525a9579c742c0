"""Seconds per solve in the pivot loop outside its status reads: the
program's ``pivot`` spans less their ``pivot.read`` children, over the
window's solves.  A read leaves the card nothing queued, so on the card
this is the host's work (graph lookup, copies in and out, launches)
while the card waits for it.  Absent where the program records no
``pivot`` span."""

PROBES = ("program_spans",)


def read(run):
    s = run.probes["program_spans"].seconds
    return s["pivot.host"] / len(run.solves) if "pivot" in s else None
