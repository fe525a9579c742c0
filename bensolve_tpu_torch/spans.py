"""Spans and counters of a solve: where its host time goes, how often
the LP layer waits on the card, and how much of what the card steps is
a real LP's work.

Spans.  A span is a named interval of one thread on the host's
``time.perf_counter()`` clock (the clock a device trace's marker ties
the card's operations to), with its own id, its parent's id, the id of
the solve it belongs to and a few attributes:

* ``solve``: ``algs/driver.py::solve`` (its id is the solve id); q, m, n
* ``phase``: phase0, phase1_primal/dual, phase2_primal/dual and
  direction_preimages (``algs/phases.py``); phase
* ``round``: one round of the primal or the dual Benson loop; round,
  candidates
* ``lp``: an outermost ``algs/templates.py::_TemplateBase._run`` call;
  B, M, N, route (tableau, dual, revised, ipm or kernel) and reads (the
  blocking device reads inside it)
* ``pivot``: one tableau pivot loop (``lp/simplex.py::_run_segmented``,
  replayed graphs or eager steps); Bp, Mp, NTp, steps, segments
* ``pivot.read``: the pivot loop's blocking status read before each
  segment and after the last (``simplex._Loop.next``); with the read,
  the card has run every segment queued before it
* ``poly``: an outermost call of a ``poly/polytope.py::PolytopePair``
  method the Benson loop makes (add_vertex, initial_approx,
  update_adjacency, chop, normalize_directions, swap, check); method

Spans are kept only while recording is on (``recording()``, or
``start()`` and ``stop()``); ``collect()`` returns them and
``summary()`` adds them up per solve and phase.  Off, a span site costs
one test of ``ON``: it allocates nothing and synchronises nothing.  The
parent of a span is the innermost span open on its thread; a mesh's
shard threads take their parent from the thread that started them
(``current()`` and ``within()``).  A span left open when its parent
closes (an exception, an early return) ends with its parent.

Counters, plain integers counted whether or not spans are recorded
(``counts()``):

* ``lp_calls``: outermost ``_TemplateBase._run`` calls;
* ``device_reads``: blocking device-to-host reads the LP layer makes,
  counted where they are made (``read()``), on the CPU as on the card;
* ``stepped_cells``: tableau entries the pivot loops stepped, steps x
  Bp x Mp x NTp a loop (padding and finished LPs included);
* ``useful_cells``: of those, the ones of a real LP still pivoting, the
  sum over its LPs of iterations x M x (M + N), from the iteration
  counts already on the host when the results are read.

The pivot loops' step counts are ``lp/segments.py``'s counters
(``GRAPH_STEPS``, ``EAGER_STEPS``)."""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time

ON = False

LP_CALLS = 0
DEVICE_READS = 0
STEPPED_CELLS = 0
USEFUL_CELLS = 0

_COUNT_LOCK = threading.Lock()
_IDS = itertools.count(1)
_LOCAL = threading.local()
_KEPT: list = []


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    name: str
    start: float
    id: int
    parent: int | None
    solve: int | None
    attrs: dict
    end: float | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


def counts() -> dict:
    return dict(lp_calls=LP_CALLS, device_reads=DEVICE_READS,
                stepped_cells=STEPPED_CELLS, useful_cells=USEFUL_CELLS)


def count_lp_call() -> None:
    global LP_CALLS
    with _COUNT_LOCK:
        LP_CALLS += 1


def count_cells(stepped: int = 0, useful: int = 0) -> None:
    global STEPPED_CELLS, USEFUL_CELLS
    with _COUNT_LOCK:
        STEPPED_CELLS += stepped
        USEFUL_CELLS += useful


def read(x):
    """The tensor ``x`` on the host as a numpy array: a blocking
    device-to-host read, counted in ``device_reads``."""
    global DEVICE_READS
    with _COUNT_LOCK:
        DEVICE_READS += 1
    return x.cpu().numpy()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def current() -> Span | None:
    """This thread's innermost open span (None when recording is off)."""
    if not ON:
        return None
    stack = _stack()
    return stack[-1] if stack else getattr(_LOCAL, "base", None)


@contextlib.contextmanager
def within(parent: Span | None):
    """Spans this thread opens in the block take ``parent`` (another
    thread's ``current()``) as theirs while none of its own is open."""
    prev = getattr(_LOCAL, "base", None)
    _LOCAL.base = parent
    try:
        yield
    finally:
        _LOCAL.base = prev


def begin(name: str, **attrs) -> Span:
    """A span opened now on this thread; callers test ``ON`` first."""
    top = current()
    sid = next(_IDS)
    sp = Span(name, time.perf_counter(), sid,
              top.id if top is not None else None,
              sid if name == "solve" else (top.solve if top is not None
                                           else None), attrs)
    _stack().append(sp)
    return sp


def end(sp: Span | None, **attrs) -> None:
    """End ``sp`` (None or an ended span: nothing), and every span of
    this thread still open inside it, and keep them while recording."""
    if sp is None or sp.end is not None:
        return
    sp.attrs.update(attrs)
    now = time.perf_counter()
    stack = _stack()
    if sp in stack:
        while stack:
            top = stack.pop()
            top.end = now
            if ON:
                _KEPT.append(top)
            if top is sp:
                return
    sp.end = now
    if ON:
        _KEPT.append(sp)


def tag(**attrs) -> None:
    """Attributes for this thread's innermost open span, where it has
    none of that name yet (the lp span's route is the first route that
    took its batch); callers test ``ON`` first."""
    stack = _stack()
    if stack:
        for k, v in attrs.items():
            stack[-1].attrs.setdefault(k, v)


def traced(name: str, **attrs):
    """A decorator: every call of the function is a ``name`` span with
    ``attrs``, except a call inside a span of the same name on its
    thread, which belongs to the outer one."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            stack = _stack()
            if stack and stack[-1].name == name:
                return fn(*args, **kwargs)
            sp = begin(name, **attrs)
            try:
                return fn(*args, **kwargs)
            finally:
                end(sp)
        return run
    return wrap


def start() -> None:
    """Drop the spans kept so far and record from now on."""
    global ON
    _KEPT.clear()
    ON = True


def stop() -> None:
    """Record no more; what was recorded stays for ``collect()`` and
    ``summary()`` until ``start()`` or ``clear()``."""
    global ON
    ON = False


def clear() -> None:
    _KEPT.clear()


@contextlib.contextmanager
def recording():
    start()
    try:
        yield
    finally:
        stop()


def collect() -> list[Span]:
    """The spans ended while recording, in the order they started."""
    return sorted(_KEPT, key=lambda s: (s.start, s.id))


def summary() -> list[dict]:
    """One row per solve and phase, in the order they ran: the rounds,
    the LPs (the lp spans' B), lp_calls, the seconds in lp, pivot,
    pivot.read and poly spans, and the lp spans' device_reads.  A span
    outside every phase (the solve's epilogue) counts under phase "-"."""
    kept = collect()
    by_id = {s.id: s for s in kept}

    def phase_of(s):
        while s is not None and s.name != "phase":
            s = by_id.get(s.parent)
        return s.attrs["phase"] if s is not None else "-"

    rows = collections.OrderedDict()
    for s in kept:
        if s.name in ("solve", "phase"):
            continue
        key = (s.solve, phase_of(s))
        r = rows.setdefault(key, dict(
            solve=s.solve, phase=key[1], rounds=0, lps=0, lp_calls=0,
            lp_s=0.0, pivot_s=0.0, read_s=0.0, poly_s=0.0, device_reads=0))
        if s.name == "round":
            r["rounds"] += 1
        elif s.name == "lp":
            r["lps"] += s.attrs["B"]
            r["lp_calls"] += 1
            r["lp_s"] += s.seconds
            r["device_reads"] += s.attrs.get("reads", 0)
        elif s.name == "pivot":
            r["pivot_s"] += s.seconds
        elif s.name == "pivot.read":
            r["read_s"] += s.seconds
        elif s.name == "poly":
            r["poly_s"] += s.seconds
    return list(rows.values())
