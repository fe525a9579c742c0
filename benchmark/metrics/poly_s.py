"""Seconds per solve in the polytope engine: the ``poly`` spans (the
``PolytopePair`` calls of ``algs/phases.py`` and ``algs/driver.py``)
over the window's solves."""

PROBES = ("layer_spans",)


def read(run):
    p = run.probes["layer_spans"]
    return p.seconds["poly"] / len(run.solves) if p.calls["poly"] else None
