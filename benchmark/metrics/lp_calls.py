"""LP batches the Benson loop sent to the LP layer per solve: the
growth of the program's ``lp_calls`` counter (outermost
``_TemplateBase._run`` calls) over the window's solves.  Absent where
the program has no such counter."""

PROBES = ("program_spans",)


def read(run):
    d = run.probes["program_spans"].delta
    return d["lp_calls"] / len(run.solves) if "lp_calls" in d else None
