"""The share, in %, of the tableau entries the pivot loops stepped over
the window that belong to a real LP still pivoting: 100 x the growth of
the program's ``useful_cells`` counter (iterations x M x (M + N) of each
real LP) over that of ``stepped_cells`` (steps x Bp x Mp x NTp of each
loop).  Batch and shape padding, the steps of LPs already finished and
the steps past the last finish lower it.  Absent where the program has
no such counters or stepped nothing."""

PROBES = ("program_spans",)


def read(run):
    d = run.probes["program_spans"].delta
    if not d.get("stepped_cells"):
        return None
    return 100.0 * d["useful_cells"] / d["stepped_cells"]
