"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over a
few solves after the measured window, reduced to the device's busy
seconds (the union of every operation's interval on the card), the
traced window's length, the device operations that took most time, and
the idle gaps split by the span the host was in (the ``pivot_clock``
probe's "pivot", the pivot loop's host side between its replays; the
``layer_spans`` probe's "lp", the rest of the LP layer, and "poly";
"solve" is the Benson loop's own host work outside those; "between" is
outside any solve).  The probes synchronise nothing while the trace
runs, and every operation is kept on the host's clock (``ops``), for
the readers that take the card's time inside a host interval."""

from __future__ import annotations

import collections
import time

LABELS = ("pivot", "poly", "lp", "solve")
# characters of a kernel's name kept in the breakdown (C++ template
# names run to thousands)
NAME = 160


def merged(intervals) -> list:
    """(start, end) intervals merged into disjoint runs, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> tuple[float, list]:
    """Seconds covered by (start, end) intervals, and the gaps between
    their merged runs."""
    runs = merged(intervals)
    gaps = [(a[1], b[0]) for a, b in zip(runs, runs[1:])]
    return sum(e - s for s, e in runs), gaps


def busy_within(ops, spans) -> float:
    """Seconds in which an operation of ``ops`` ((name, start, end))
    ran on the card inside the (start, end) ``spans``, which do not
    overlap one another."""
    import bisect

    runs = merged([(s, e) for _, s, e in ops])
    starts = [s for s, _ in runs]
    total = 0.0
    for a, b in spans:
        for s, e in runs[max(0, bisect.bisect_right(starts, a) - 1):
                         bisect.bisect_left(starts, b)]:
            total += max(0.0, min(e, b) - max(s, a))
    return total


def split_gap(gap, spans: dict) -> dict:
    """The seconds of an idle gap under each host span, the inner ones
    (LABELS' order) first; what no span covers is "between"."""
    left, out = [gap], collections.Counter()
    for name in LABELS:
        for s, e in spans.get(name, ()):
            rest = []
            for a, b in left:
                lo, hi = max(a, s), min(b, e)
                if lo < hi:
                    out[name] += hi - lo
                    rest += [(a, lo)] if a < lo else []
                    rest += [(hi, b)] if hi < b else []
                else:
                    rest.append((a, b))
            left = rest
    out["between"] += sum(b - a for a, b in left)
    return out


def reduce(device_ops, host_spans, window) -> dict:
    """``device_ops``: (name, start_s, end_s) of every operation on the
    card; ``host_spans``: {label: [(start_s, end_s)]}; ``window``:
    (start_s, end_s) of the traced solves.  Returns busy_s, window_s and
    the breakdown's two lists (at most 10 entries each)."""
    w0, w1 = window
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in device_ops
           if e > w0 and s < w1]
    busy, gaps = union_length([(s, e) for _, s, e in ops])
    if ops:
        first = min(s for _, s, _ in ops)
        last = max(e for _, _, e in ops)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    by_op = collections.Counter()
    for n, s, e in ops:
        by_op[n] += e - s
    idle = collections.Counter()
    for s, e in gaps:
        if e > s:
            idle.update(split_gap((s, e), host_spans))
    return dict(busy_s=busy, window_s=w1 - w0,
                device_ops=[[n[:NAME], v] for n, v in by_op.most_common(10)],
                idle_gaps=[[n, v] for n, v in idle.most_common(10) if v > 0])


class DeviceTrace:
    """torch.profiler with the card's activity only (CUPTI: kernels,
    copies, sets; no host op is recorded, so the host runs at its own
    speed) around the traced solves.  The host's spans are taken on the
    host's clock; a marker kernel (``torch.cuda._sleep``, "spin_kernel")
    launched at a known host time just after a synchronise ties the two
    clocks together."""

    MARKER = "spin_kernel"

    def __init__(self):
        self.prof = None
        self.marks = []

    def _mark(self):
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()

    def stop(self):
        self._mark()
        self.prof.stop()

    def result(self, host_spans: dict, window) -> dict:
        """Reduce the trace.  ``host_spans`` {label: [(start, end)]} and
        ``window`` (start, end) are on the host's perf_counter clock, as
        are the operations the result keeps under ``ops``."""
        device_ops, marks = [], []
        for ev in self.prof.profiler.kineto_results.events():
            if not _on_device(ev) or _annotation(ev):
                continue
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if self.MARKER in ev.name():
                marks.append(s)
            else:
                device_ops.append((ev.name(), s, e))
        if len(marks) != len(self.marks):
            names = sorted({n for n, _, _ in device_ops})[:20]
            raise RuntimeError(f"the device trace holds {len(marks)} marker "
                               f"kernels, {len(self.marks)} were launched; "
                               f"{len(device_ops)} operations: {names}")
        marks.sort()
        offset = marks[0] - self.marks[0]
        drift = (marks[-1] - self.marks[-1]) - offset
        ops = [(n, s - offset, e - offset) for n, s, e in device_ops]
        out = reduce(ops, host_spans, window)
        out["clock_drift_s"] = drift
        out["ops"] = ops
        return out


def _on_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1] == "CUDA"


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else ev.name().startswith("bench:")
