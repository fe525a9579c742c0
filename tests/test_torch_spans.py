"""The port's spans and counters (bensolve_tpu_torch/spans.py) on
example11, on the CPU, with the pivot loops eager and through the graph
runner's stand-in (tests/torch_graph_standin.py), by either algorithm:

* the spans of one recorded solve nest as the program nests: every
  pivot.read in a pivot, every pivot in an lp, every lp in a round or a
  phase, up to one solve whose id they all carry;
* lp_calls counts the outermost _TemplateBase._run calls, the pivot
  spans' steps are what the loops' step counters grew by, each pivot
  loop reads its status once before each segment and once at its end,
  and 0 < useful_cells / stepped_cells <= 1;
* the summary adds up to the solve's own Stats;
* recording changes no answer bit, and while it is off no span is kept
  and the counters still count.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu_torch import examples, spans
from bensolve_tpu_torch.algs import templates
from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.vlp.options import Alg
from tests.torch_graph_standin import standing_in

# the spans each span may sit in
PARENTS = {"phase": {"solve", "phase"}, "round": {"phase"},
           "lp": {"round", "phase"}, "pivot": {"lp"},
           "pivot.read": {"pivot"}, "poly": {"solve", "phase", "round"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(alg: str):
    a = Alg.DUAL if alg == "dual" else Alg.PRIMAL
    return bt.solve(examples.example11(), bt.Options(
        device="cpu", write_files=False, alg_phase1=a, alg_phase2=a))


def _answer(r) -> list:
    return [r.primal_points, r.primal_directions, r.dual_points,
            r.dual_directions]


def _loop_steps() -> int:
    return sum(segments.BY_LOOP[k][f] for k in ("tableau", "dual")
               for f in ("graph_steps", "eager_steps"))


@pytest.mark.parametrize("loops", ["eager", "graphs"])
@pytest.mark.parametrize("alg", ["primal", "dual"])
def test_recorded_solve(monkeypatch, alg, loops):
    outer = [0]
    real = templates._TemplateBase._run

    def counted(self, *args, **kwargs):
        outer[0] += not kwargs.get("_chunked", False)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(templates._TemplateBase, "_run", counted)
    c0, steps0 = spans.counts(), _loop_steps()
    with standing_in() if loops == "graphs" else contextlib.nullcontext():
        with spans.recording():
            r = _solve(alg)
    c1 = spans.counts()
    delta = {k: c1[k] - c0[k] for k in c1}
    kept = spans.collect()
    by_id = {s.id: s for s in kept}
    solve = [s for s in kept if s.name == "solve"]
    assert r.status.name == "OPTIMAL" and len(solve) == 1
    assert {s.solve for s in kept} == {solve[0].id}
    for s in kept:
        assert s.start <= s.end
        if s.name != "solve":
            parent = by_id[s.parent]
            assert parent.name in PARENTS[s.name], (s, parent)
            assert parent.start <= s.start and s.end <= parent.end

    assert delta["lp_calls"] == outer[0] > 0
    assert sum(s.name == "lp" for s in kept) == outer[0]
    pivots = [s for s in kept if s.name == "pivot"]
    assert sum(s.attrs["steps"] for s in pivots) == _loop_steps() - steps0
    for p in pivots:
        reads = [s for s in kept if s.name == "pivot.read"
                 and s.parent == p.id]
        assert len(reads) == p.attrs["segments"] + 1
    assert 0 < delta["useful_cells"] <= delta["stepped_cells"]
    assert delta["stepped_cells"] == sum(
        s.attrs["steps"] * s.attrs["Bp"] * s.attrs["Mp"] * s.attrs["NTp"]
        for s in pivots)

    rows = spans.summary()
    assert sum(row["lps"] for row in rows) == r.stats.lps
    assert sum(row["rounds"] for row in rows) == r.stats.rounds
    assert sum(row["lp_calls"] for row in rows) == outer[0]
    assert sum(row["device_reads"] for row in rows) == delta["device_reads"]
    assert delta["device_reads"] > 10 * outer[0]
    route = "dual" if alg == "primal" else "tableau"
    assert route in {s.attrs["route"] for s in kept if s.name == "lp"}


@pytest.mark.parametrize("alg", ["primal", "dual"])
def test_recording_changes_no_answer(alg):
    spans.clear()
    c0 = spans.counts()
    off = _solve(alg)
    assert spans.collect() == [] and not spans.ON
    assert spans.counts()["lp_calls"] > c0["lp_calls"]
    with spans.recording():
        on = _solve(alg)
    assert spans.collect() and not spans.ON
    for a, b in zip(_answer(off), _answer(on)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_span_mechanics():
    """A span left open ends with its parent; a decorated call inside a
    span of its own name belongs to it; a thread under within() takes
    the given parent; off, nothing is kept."""
    @spans.traced("poly", method="f")
    def f(depth):
        return f(depth - 1) if depth else spans.current()

    with spans.recording():
        top = spans.begin("solve", q=1, m=1, n=1)
        inner = f(2)
        left_open = spans.begin("phase", phase="x")
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            _in_thread(top)))
        t.start()
        t.join()
        spans.end(top)
    kept = spans.collect()
    assert [s.name for s in kept] == ["solve", "poly", "phase", "round"]
    assert inner.name == "poly" and inner.attrs == {"method": "f"}
    assert left_open.end == top.end
    assert seen[0].parent == top.id and seen[0].solve == top.id
    assert spans.current() is None   # recording is off
    spans.clear()


def _in_thread(parent):
    with spans.within(parent):
        sp = spans.begin("round", round=1, candidates=1)
        spans.end(sp)
    return sp


def test_counters_and_spans_under_threads():
    """Threads that read, count and record at once (as a mesh's shard
    threads do) lose no count and no span."""
    import sys

    threads, calls = 16, 400
    c0 = spans.counts()
    one = torch.zeros(())

    def work():
        for _ in range(calls):
            sp = spans.begin("pivot.read")
            spans.read(one)
            spans.count_cells(stepped=3, useful=1)
            spans.count_lp_call()
            spans.end(sp)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    c1 = spans.counts()
    n = threads * calls
    assert {k: c1[k] - c0[k] for k in c1} == dict(
        lp_calls=n, device_reads=n, stepped_cells=3 * n, useful_cells=n)
    kept = spans.collect()
    assert len(kept) == n and len({s.id for s in kept}) == n
    assert all(s.parent is None for s in kept)
    spans.clear()
