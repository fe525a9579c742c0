"""Spans around the entries of two layers of the port, by the benchmark:

* ``lp``: every ``algs/templates.py::_TemplateBase._run`` call (the LP
  layer: the router and the simplex, dual simplex, revised and IPM
  routes), in the window synchronised with the card at both ends, so
  its seconds are the LP layer's whole time, host and device;
* ``poly``: every call ``algs/phases.py`` and ``algs/driver.py`` make into the
  polytope engine (``poly/polytope.py::PolytopePair``: add_vertex,
  initial_approx, update_adjacency, chop, normalize_directions, swap,
  check; host code, native/poly_engine.cpp underneath).

A call inside another of its own layer counts once, in the outer span.
Under the device trace the spans synchronise nothing and only keep
their host intervals, with which the trace labels the card's idle
gaps."""

import contextlib
import time

from benchmark.probes import BaseProbe

POLY_METHODS = ("add_vertex", "initial_approx", "update_adjacency",
                "chop", "normalize_directions", "swap", "check")


class Probe(BaseProbe):
    def __init__(self):
        self.seconds = {"lp": 0.0, "poly": 0.0}
        self.calls = {"lp": 0, "poly": 0}
        self._depth = {"lp": 0, "poly": 0}
        self._on = False
        self._traced = False
        self._kept = {"lp": [], "poly": []}
        self._stack = contextlib.ExitStack()

    def _wrap(self, layer, sync):
        import torch

        cuda = torch.cuda.is_available()

        def make(real):
            def span(*args, **kwargs):
                if self._depth[layer]:
                    return real(*args, **kwargs)
                self._depth[layer] += 1
                synced = sync and cuda and not self._traced
                if synced:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return real(*args, **kwargs)
                finally:
                    if synced:
                        torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    self._depth[layer] -= 1
                    if self._on:
                        self.seconds[layer] += t1 - t0
                        self.calls[layer] += 1
                    if self._traced:
                        self._kept[layer].append((t0, t1))
            return span
        return make

    def install(self):
        from benchmark.probes import patched
        from bensolve_tpu_torch.algs import templates
        from bensolve_tpu_torch.poly import polytope

        self._stack.enter_context(patched(
            templates._TemplateBase, "_run", self._wrap("lp", True)))
        for name in POLY_METHODS:
            self._stack.enter_context(patched(
                polytope.PolytopePair, name, self._wrap("poly", False)))

    def start(self):
        self._on = True

    def stop(self):
        self._on = False

    def trace(self, on: bool):
        self._traced = on

    def intervals(self) -> dict:
        return dict(self._kept)

    def remove(self):
        self._stack.close()
