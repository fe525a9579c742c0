"""One reader per metric of BENCHMARK.json, in ``<metric name>.py``.

A reader defines ``read(run)`` and returns the metric's value, or None
where the run holds nothing to read (the harness then leaves the metric
out of the result line; a share of a roofline or a peak is never 0 for
want of data).  ``PROBES`` names the instruments (``probes/<name>.py``)
that a per-layer reader needs in the traced run.  ``run`` holds:
``solves`` (one dict per window solve: wall_s, ok, lps, rounds),
``window_s``, ``setup_s``, ``probes`` (name -> probe), ``trace`` (the
reduced device trace of the solves after the window, its operations and
its window on the host's clock under ``ops`` and ``window``; None off
the card, and where the trace came back incomplete)."""
