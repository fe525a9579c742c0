"""CUDA graphs the LP graph cache (``lp/segments.py``) captured during
the window: the growth of ``segments.CAPTURES``.  Each is a capture the
warm-up did not make, or an eviction from the pool made again."""

PROBES = ("segment_counters",)


def read(run):
    return run.probes["segment_counters"].delta.get("captures")
