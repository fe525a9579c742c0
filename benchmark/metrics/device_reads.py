"""Blocking device-to-host reads the LP layer made per solve: the
growth of the program's ``device_reads`` counter over the window's
solves.  Absent where the program has no such counter."""

PROBES = ("program_spans",)


def read(run):
    d = run.probes["program_spans"].delta
    return (d["device_reads"] / len(run.solves) if "device_reads" in d
            else None)
