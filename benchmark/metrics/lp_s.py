"""Seconds per solve in the LP layer: the ``lp`` spans (every
``_TemplateBase._run`` call, synchronised at both ends) over the
window's solves."""

PROBES = ("layer_spans",)


def read(run):
    p = run.probes["layer_spans"]
    return p.seconds["lp"] / len(run.solves) if p.calls["lp"] else None
