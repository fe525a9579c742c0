"""The device trace, one profiler session per attempt, on synthetic event
lists: an attempt that lost a marker or records, or whose clock moved,
raises nothing, is reported incomplete and gives no number, so the
metrics that read the trace are left out; a complete one reduces as the
one session of the traced solves always did, whatever fillers it lost."""

import collections
import os
import time
import types

import numpy as np
import pytest

from benchmark import device_trace as dt
from benchmark import run as harness
from benchmark.roofline import pivot_step_least_s

HOST = {"lp": [(0.0, 4.0)], "poly": [(4.0, 6.0)], "solve": [(0.0, 8.0)]}
WINDOW = (0.0, 8.0)
OPS = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 6.0, 7.0)]
LAUNCHED = [-0.25, 8.25]     # host times at which the markers launched
OFFSET = 1000.0              # the card's clock ahead of the host's
CLEAN = {"out of range": 0, "stopped early": 0, "CUPTI dropped": 0}
# a pivot loop inside the window, the card busy 4 * least of it
LEAST = pivot_step_least_s(256, 350, 347, "float64")
LOOP = (256, 350, 347, "float64", 1, 1.0, 3.0)
LOG = ("INFO:2026-10-18 19:09:29 131:131 CuptiActivityProfiler.cpp:408] "
       "Record counts: Out-of-range = 3, Blocklisted runtime = 12823, "
       "Invalid ext correlations = 0, CPU GPU out-of-order = 390195, "
       "Unexpected CUDA events = 0, CUPTI stopped early? = 1\n")


def events(start=True, end=True, moved=0.0, fillers=0):
    """An attempt's events on the card's clock: OPS, the markers (their
    spins as the card runs them) and the fillers that came back."""
    out = [(n, s + OFFSET, e + OFFSET) for n, s, e in OPS]
    out += [("fill", LAUNCHED[0] + OFFSET - 1e-3,
             LAUNCHED[0] + OFFSET - 9e-4)] * fillers
    for keep, t, d, spin in ((start, LAUNCHED[0], 0.0, 1.4e-6),
                             (end, LAUNCHED[1], moved, 1.1e-5)):
        if keep:
            out.append((dt.MARKER, t + OFFSET + d, t + OFFSET + d + spin))
    return out


def metrics(trace):
    """The two metrics that read the trace, as run.py reads them."""
    run = types.SimpleNamespace(
        trace=trace,
        probes={"pivot_clock": types.SimpleNamespace(loops=[LOOP])})
    return {name: harness.module("metrics", name).read(run)
            for name in ("device_idle", "pivot_roofline")}


def test_clean_trace_reduces_as_before():
    trace = dt.DeviceTrace()
    trace.pieces.append(dt.piece(events(), LAUNCHED, WINDOW, dict(CLEAN)))
    assert trace.pieces[0]["complete"] and not trace.wants()
    out = trace.result(HOST)
    # the parent's reduction of the same operations and window
    before = dt.reduce(OPS, HOST, WINDOW)
    assert out["busy_s"] == pytest.approx(before["busy_s"]) == 3.0
    assert out["window_s"] == before["window_s"] == 8.0
    assert dict(out["idle_gaps"]) == pytest.approx(dict(before["idle_gaps"]))
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"lp": 2.0, "poly": 2.0, "solve": 1.0})
    assert out["window"] == WINDOW and out["ops"] == pytest.approx(OPS)
    m = metrics(out)
    assert m["device_idle"] == pytest.approx(62.5)
    assert m["pivot_roofline"] == pytest.approx(100 * LEAST / 2.0)


def test_lost_fillers_are_no_loss():
    """The fillers go out of range in place of the solves' records."""
    p = dt.piece(events(fillers=dt.FILL - 5), LAUNCHED, WINDOW,
                 dict(CLEAN, **{"out of range": 5}), dt.FILL)
    assert p["complete"] and p["fillers_lost"] == 5
    assert p["n_ops"] == len(OPS) and p["lost"]["out of range"] == 0
    assert p["ops"] == pytest.approx(OPS)


@pytest.mark.parametrize("case, kw, lost, says", [
    ("start marker lost", dict(start=False), CLEAN, "0 start markers"),
    ("end marker lost", dict(end=False), CLEAN, "0 end markers"),
    ("records dropped", {}, dict(CLEAN, **{"CUPTI dropped": 7}),
     "7 records lost (CUPTI dropped)"),
    ("records out of range", {}, dict(CLEAN, **{"out of range": 2}),
     "2 records lost (out of range)"),
    ("out of range past the fillers", dict(fillers=dt.FILL - 5),
     dict(CLEAN, **{"out of range": 6}), "1 records lost (out of range)"),
    ("collection stopped early", {}, dict(CLEAN, **{"stopped early": 1}),
     "1 records lost (stopped early)"),
    ("no count", {}, None, "no count"),
    ("clock moved", dict(moved=10 * dt.CLOCK_TOL * 8.5), CLEAN,
     "clocks moved"),
])
def test_incomplete_trace_gives_no_number(capsys, case, kw, lost, says):
    trace = dt.DeviceTrace()
    p = dt.piece(events(**kw), LAUNCHED, WINDOW,
                 None if lost is None else dict(lost),
                 dt.FILL if "fillers" in kw else 0)
    trace.pieces.append(p)
    assert not p["complete"] and "ops" not in p
    assert any(says in problem for problem in p["problems"])
    assert p["n_ops"] == len(OPS)
    assert trace.wants()
    assert trace.result(HOST) is None
    assert "none complete" in capsys.readouterr().err
    assert metrics(None) == {"device_idle": None, "pivot_roofline": None}


def test_a_small_drift_is_kept():
    """A first session's steady drift (about 2e-4 of its length) stays
    under CLOCK_TOL."""
    p = dt.piece(events(moved=2e-4 * 8.5), LAUNCHED, WINDOW, dict(CLEAN))
    assert p["complete"] and p["drift"] == pytest.approx(2e-4 * 8.5)


def test_attempts_until_one_is_complete():
    trace = dt.DeviceTrace()
    bad = dt.piece(events(start=False), LAUNCHED, (10.0, 18.0), dict(CLEAN))
    trace.pieces.append(bad)
    assert trace.wants()
    trace.pieces.append(dt.piece(events(), LAUNCHED, WINDOW, dict(CLEAN)))
    assert not trace.wants()
    out = trace.result(HOST)
    assert out["window"] == WINDOW and out["busy_s"] == pytest.approx(3.0)
    # a pivot loop of the incomplete attempt is not the kept one's
    run = types.SimpleNamespace(trace=out, probes={
        "pivot_clock": types.SimpleNamespace(
            loops=[LOOP, (256, 350, 347, "float64", 9, 11.0, 12.0)])})
    assert harness.module("metrics", "pivot_roofline").read(run) == (
        pytest.approx(100 * LEAST / 2.0))
    trace = dt.DeviceTrace()
    trace.pieces += [bad] * dt.ATTEMPTS
    assert not trace.wants() and trace.result(HOST) is None
    # no attempt is made that would run the trace past its budget
    trace = dt.DeviceTrace()
    trace.pieces.append(bad)
    trace.spent_s = 0.6 * dt.BUDGET_S
    assert not trace.wants()


def test_kineto_counts_read_from_its_log():
    assert dt.kineto_counts("STAGE: Warm Up\n" + LOG + "INFO: done\n") == {
        "out of range": 3, "stopped early": 1}
    assert dt.kineto_counts("INFO: Processed 70633 GPU records\n") is None


def test_log_captured_from_the_descriptor(capfd):
    text = dt._captured(lambda: os.write(2, LOG.encode()))
    assert dt.kineto_counts(text) == {"out of range": 3, "stopped early": 1}
    assert capfd.readouterr().err == ""


def _split_gap(gap, spans):
    """The parent's split of one gap, span by span: the reference."""
    left, out = [gap], collections.Counter()
    for name in dt.LABELS:
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


def test_split_gaps_as_gap_by_gap():
    """One sweep over all gaps gives what the split gap by gap gave, on
    spans that nest, overlap and repeat, and on a million gaps in
    seconds."""
    g = np.random.default_rng(5)
    edges = np.sort(g.uniform(0, 100, 600))
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2])]
    spans = {}
    for name, n, length in (("pivot", 40, 0.5), ("poly", 30, 2.0),
                            ("lp", 20, 4.0), ("solve", 3, 40.0)):
        starts = g.uniform(0, 100, n)
        spans[name] = [(s, s + g.uniform(0, length)) for s in starts]
    want = collections.Counter()
    for gap in gaps:
        want.update(_split_gap(gap, spans))
    got = dt.split_gaps(gaps, spans)
    assert set(got) == set(want)
    assert dict(got) == pytest.approx(dict(want), rel=1e-12, abs=1e-12)
    t = np.arange(2_000_000) * 1e-6
    many = list(zip(t[::2], t[::2] + 5e-7))
    t0 = time.perf_counter()
    out = dt.split_gaps(many, {"lp": [(0.0, 1.0)], "poly": [(0.5, 1.5)]})
    assert time.perf_counter() - t0 < 30
    assert sum(out.values()) == pytest.approx(0.5)
