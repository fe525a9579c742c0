"""The program's own spans and counters (``bensolve_tpu_torch/spans.py``),
read over the window: ``delta`` holds what its counters (lp_calls,
device_reads, stepped_cells, useful_cells) grew by, ``seconds`` the
seconds of its spans by name, and "pivot.host" those of the ``pivot``
spans outside their ``pivot.read`` children.  Under the device trace it
records again, and ``intervals()`` gives the ``pivot`` and
``pivot.read`` spans as "prog.pivot" and "prog.pivot.read".

It wraps nothing.  A program without the module, or without a name the
probe reads there, leaves it inert: ``delta`` and ``seconds`` stay
empty, its readers return None and their metrics are left out of the
line."""

import collections
import sys

from benchmark.probes import BaseProbe

NEEDS = ("counts", "start", "stop", "clear", "collect")
LABELS = {"pivot": "prog.pivot", "pivot.read": "prog.pivot.read"}


def _program():
    """The program's spans module, or None where it has none."""
    try:
        from bensolve_tpu_torch import spans
    except ImportError:
        return None
    return spans if all(hasattr(spans, n) for n in NEEDS) else None


class Probe(BaseProbe):
    def __init__(self):
        self.spans = _program()
        self.delta = {}
        self.seconds = {}
        self._at_start = {}
        self._kept = {}

    def start(self):
        if self.spans is None:
            return
        self._at_start = self.spans.counts()
        self.spans.start()

    def stop(self):
        if self.spans is None:
            return
        self.spans.stop()
        now = self.spans.counts()
        self.delta = {k: now[k] - v for k, v in self._at_start.items()}
        kept = self.spans.collect()
        self.spans.clear()
        seconds = collections.Counter()
        pivots = {s.id for s in kept if s.name == "pivot"}
        for s in kept:
            seconds[s.name] += s.end - s.start
            if s.name == "pivot.read" and s.parent in pivots:
                seconds["pivot.host"] -= s.end - s.start
        seconds["pivot.host"] += seconds["pivot"]
        self.seconds = dict(seconds)
        print("# program spans over the window (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(self.seconds.items())),
            file=sys.stderr, flush=True)

    def trace(self, on: bool):
        if self.spans is None:
            return
        if on:
            self.spans.start()
            return
        self.spans.stop()
        kept = self.spans.collect()
        self.spans.clear()
        self._kept = {label: [(s.start, s.end) for s in kept
                              if s.name == name]
                      for name, label in LABELS.items()}

    def intervals(self) -> dict:
        return dict(self._kept)
