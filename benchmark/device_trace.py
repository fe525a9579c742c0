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
the readers that take the card's time inside a host interval.

The profiler can lose records, and misplace them.  kineto drops every
record whose time, on the card's clock as CUPTI maps it onto the
host's, falls outside the session's start and stop, and counts it
("Out-of-range" in its log); past its buffer limit CUPTI stops
collecting ("CUPTI stopped early"); CUPTI drops what it has no buffer
for.  The mapping runs off by up to milliseconds near a session's
edges, so the records closest to either go first.  In a process that has run a session before, a new session's
first records go out of range, one more in each later session, and its
mapping can move by tens of milliseconds within it.  So each attempt at
the traced solves is one session, complete only where nothing of it was
lost or misplaced: GUARD_S of idle card after the start; FILL fillers,
which go out of range in place of the solves' records; the start
marker; the solves; the end marker; GUARD_S of idle card before the
stop.  The two markers tie the card's clock to the host's and must agree
on it (CLOCK_TOL); kineto must count no record out of range past the
fillers and none stopped early, and CUPTI none dropped.  The first
complete attempt is reduced; where none is, the trace gives no number.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import sys
import tempfile
import time

LABELS = ("pivot", "poly", "lp", "solve")
# characters of a kernel's name kept in the breakdown (C++ template
# names run to thousands)
NAME = 160
# the marker kernel (torch.cuda._sleep), its spin in clock cycles at the
# start of a session and at its end, and a length between the two that
# tells them apart (1000 cycles run about 1.4 us, 20000 about 11 us)
MARKER = "spin_kernel"
SPIN = (1000, 20000)
SPLIT_S = 5e-6
# kernels launched before the start marker, to go out of range in place
# of the solves' records (11 went in the 4th session of one process;
# NVIDIA H100 80GB HBM3, torch 2.11.0+cu128)
FILL = 64
# seconds of idle card between the profiler's start and the fillers, and
# between the end marker and the stop: more than the mapping of the
# card's clock was seen to run off at a session's edges (56 ms, in a
# session after the first)
GUARD_S = 0.1
# the most by which the two markers may disagree on the offset between
# the card's clock and the host's, as a share of the host time between
# them: a process's first session drifted by 1e-4 to 8e-4 (0.2-1.4 ms
# over an ex10 or ex11 trace, 0.3 ms over 15 s of a tall VLP's); later
# ones moved by 2e-3 to 6e-2
CLOCK_TOL = 1e-3
# attempts at the traced solves until one is complete, and the host
# seconds they may take together, as far as the next can be foreseen
ATTEMPTS = 4
BUDGET_S = 150.0
# kineto's summary of the records it processed; its log level must be
# INFO (1) or lower for it to be written (run.py sets it in traced runs)
COUNTS = re.compile(r"Record counts: ([^\n]*)")


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


def split_gaps(gaps, spans: dict) -> collections.Counter:
    """The seconds of the idle ``gaps`` (disjoint (start, end)) under
    each host span, the inner ones (LABELS' order) first; what no span
    covers is "between".  One sweep over the sorted gaps and spans of
    each label, so millions of gaps (a traced solve of millions of
    operations) take seconds."""
    left = [(a, b) for a, b in merged(gaps) if b > a]
    out = collections.Counter()
    for name in LABELS:
        cover = merged(spans.get(name, ()))
        rest, j = [], 0
        for a, b in left:
            while j < len(cover) and cover[j][1] <= a:
                j += 1
            cur, k = a, j
            while k < len(cover) and cover[k][0] < b:
                lo, hi = max(cur, cover[k][0]), min(b, cover[k][1])
                if lo > cur:
                    rest.append((cur, lo))
                if hi > lo:
                    out[name] += hi - lo
                cur = max(cur, hi)
                k += 1
            if cur < b:
                rest.append((cur, b))
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
    idle = split_gaps(gaps, host_spans)
    return dict(busy_s=busy, window_s=w1 - w0,
                device_ops=[[n[:NAME], v] for n, v in by_op.most_common(10)],
                idle_gaps=[[n, v] for n, v in idle.most_common(10) if v > 0])


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def kineto_counts(text: str) -> dict | None:
    """kineto's count of the records it kept out of a session's trace,
    from its log: {"out of range": n, "stopped early": n}; None where the
    log holds no such summary."""
    found = COUNTS.findall(text)
    if not found:
        return None
    fields = {k.strip(): int(v)
              for k, v in re.findall(r"([^,=]+?)\s*=\s*(\d+)", found[-1])}
    if "Out-of-range" not in fields or "CUPTI stopped early?" not in fields:
        return None
    return {"out of range": fields["Out-of-range"],
            "stopped early": fields["CUPTI stopped early?"]}


def piece(events, launched, window, lost, filled=0) -> dict:
    """One attempt at the traced solves, one profiler session, judged.
    ``events``: (name, start_s, end_s) of every operation on the card, on
    the card's clock as the profiler gives it, the markers and fillers
    among them; ``launched``: the host times (perf_counter) at which the
    start and the end marker were launched; ``window``: (start, end) of
    the solves on the host's clock; ``lost``: the records the profiler
    reports lost, by kind, or None where kineto gave no count;
    ``filled``: the fillers launched before the start marker, whose loss
    is no loss.  A complete piece holds its operations on the host's
    clock under ``ops``."""
    marks = [[s for n, s, e in events
              if MARKER in n and (e - s < SPLIT_S) == first]
             for first in (True, False)]
    ops = [(n, s, e) for n, s, e in events if MARKER not in n]
    fillers_lost = None
    if len(marks[0]) == 1:
        kept = [op for op in ops if op[1] >= marks[0][0]]
        fillers_lost = filled - (len(ops) - len(kept))
        ops = kept
        if lost is not None:
            lost = dict(lost, **{
                "out of range": lost["out of range"] - fillers_lost})
    problems = (["kineto gave no count of lost records"] if lost is None
                else [f"{v} records lost ({k})" for k, v in lost.items()
                      if v])
    problems += [f"{len(m)} {edge} markers, not 1"
                 for m, edge in zip(marks, ("start", "end")) if len(m) != 1]
    drift = None
    if all(len(m) == 1 for m in marks):
        offset = marks[0][0] - launched[0]
        drift = (marks[1][0] - launched[1]) - offset
        if abs(drift) > CLOCK_TOL * (launched[1] - launched[0]):
            problems.append(f"the clocks moved {drift:.2e} s apart")
    out = dict(window=window, n_ops=len(ops), lost=lost, drift=drift,
               fillers_lost=fillers_lost, problems=problems,
               complete=not problems)
    if out["complete"]:
        out["ops"] = [(n, s - offset, e - offset) for n, s, e in ops]
    return out


class DeviceTrace:
    """torch.profiler with the card's activity only (CUPTI: kernels,
    copies, sets; no host op is recorded, so the host runs at its own
    speed) around the traced solves, one session per attempt (``start``,
    the solves, ``stop``) until one is complete.  The host's spans are
    taken on the host's clock; a marker kernel (``torch.cuda._sleep``,
    SPIN) launched at a known host time just after a synchronise, at
    each end of the solves, ties the two clocks together."""

    def __init__(self):
        self.pieces = []
        self.spent_s = 0.0      # host seconds the attempts took
        self._prof = None
        self._launched = []
        self._log = ""
        self._began = 0.0

    def wants(self) -> bool:
        """Whether to make another attempt: none is complete, ATTEMPTS
        allow one more, and one more of the same length keeps the trace
        within BUDGET_S."""
        n = len(self.pieces)
        return (not any(p["complete"] for p in self.pieces)
                and n < ATTEMPTS
                and (n == 0 or self.spent_s * (n + 1) / n <= BUDGET_S))

    def _mark(self, cycles: int):
        import torch

        torch.cuda.synchronize()
        self._launched.append(time.perf_counter())
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._began = time.perf_counter()
        _cupti_dropped()   # reads, and so clears, what came before
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._launched = []
        self._log = _captured(self._prof.start)
        time.sleep(GUARD_S)
        buf = torch.empty(1, device="cuda")
        for _ in range(FILL):
            buf.zero_()
        self._mark(SPIN[0])

    def stop(self, window):
        """Ends the attempt whose solves took ``window`` (start, end) on
        the host's clock, and judges it."""
        self._mark(SPIN[1])
        time.sleep(GUARD_S)
        self._log += _captured(self._prof.stop)
        events = []
        for ev in self._prof.profiler.kineto_results.events():
            if _on_device(ev) and not _annotation(ev):
                s = ev.start_ns() * 1e-9
                events.append((ev.name(), s, s + ev.duration_ns() * 1e-9))
        self._prof = None
        lost = kineto_counts(self._log)
        dropped = _cupti_dropped()
        if lost is not None and dropped is not None:
            lost["CUPTI dropped"] = dropped
        p = piece(events, self._launched, window, lost, FILL)
        self.pieces.append(p)
        self.spent_s += time.perf_counter() - self._began
        drift = "not read" if p["drift"] is None else f"{p['drift']:.2e} s"
        log(f"# device trace, attempt {len(self.pieces)}: {p['n_ops']} "
            f"operations kept over {window[1] - window[0]:.3f} s, records "
            "lost: " + (", ".join(f"{k} {v}" for k, v in p["lost"].items())
                        if p["lost"] is not None else "not counted")
            + f"; fillers lost {p['fillers_lost']} of {FILL}; clock drift "
            + f"{drift}: " + ("complete" if p["complete"] else
                              "incomplete (" + "; ".join(p["problems"])
                              + ")"))

    def result(self, host_spans: dict) -> dict | None:
        """The first complete attempt reduced, with ``host_spans``
        {label: [(start, end)]} on the host's perf_counter clock, as are
        the operations the result keeps under ``ops`` and its
        ``window``; None where no attempt is complete."""
        kept = next((p for p in self.pieces if p["complete"]), None)
        log(f"# device trace: {len(self.pieces)} attempt(s) in "
            f"{self.spent_s:.1f} s, {int(kept is not None)} kept, "
            f"{sum(not p['complete'] for p in self.pieces)} incomplete"
            + ("" if kept else "; none complete, so nothing of the trace "
               "is reported (device_idle, pivot_roofline, busy_s, "
               "window_s, the breakdown)"))
        if kept is None:
            return None
        out = reduce(kept["ops"], host_spans, kept["window"])
        out["ops"], out["window"] = kept["ops"], kept["window"]
        return out


def _captured(fn) -> str:
    """fn(), with what is written to file descriptor 2 meanwhile (kineto
    logs there) kept out of the run's standard error: its text."""
    libc = ctypes.CDLL(None)
    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            fn()
        finally:
            sys.stderr.flush()
            libc.fflush(None)
            os.dup2(saved, 2)
            os.close(saved)
        tmp.seek(0)
        return tmp.read().decode(errors="replace")


def _cupti_dropped() -> int | None:
    """Records CUPTI dropped for want of buffer space since the last
    call; None where the process has no libcupti loaded."""
    for name in ("libcupti.so", "libcupti.so.13", "libcupti.so.12",
                 "libcupti.so.11.8"):
        try:
            lib = ctypes.CDLL(name, mode=os.RTLD_NOLOAD)
        except OSError:
            continue
        f = lib.cuptiActivityGetNumDroppedRecords
        f.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                      ctypes.POINTER(ctypes.c_size_t)]
        f.restype = ctypes.c_int
        n = ctypes.c_size_t(0)
        return n.value if f(None, 0, ctypes.byref(n)) == 0 else None
    return None


def _on_device(ev) -> bool:
    return str(ev.device_type()).split(".")[-1] == "CUDA"


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else ev.name().startswith("bench:")
