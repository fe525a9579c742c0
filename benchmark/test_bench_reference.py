"""The plain reference, the relabelling, the trace's reduction and the
roofline arithmetic."""

import numpy as np
import pytest

from benchmark import roofline, traffic
from benchmark.device_trace import busy_within, merged, reduce, union_length
from benchmark.reference import vlp_images as ref
from benchmark.run import answer, options, problem


def _arrays(name):
    """The port's own example as the reference's arrays (the test's
    only use of the program's copy of the examples)."""
    from bensolve_tpu_torch import examples

    v = getattr(examples, name)()
    inst = dict(A=v.A, P=v.P, row_lb=v.rows.lb, row_ub=v.rows.ub,
                col_lb=v.cols.lb, col_ub=v.cols.ub)
    if v.gen is not None:
        inst["Y"] = v.gen
    if v.c is not None:
        inst["c"] = v.c
    return inst


def _solve(inst):
    from bensolve_tpu_torch import solve

    return answer(solve(problem(inst), options({}, "cpu")))


def _same_sets(a, b, tol=1e-9):
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert a.shape == b.shape
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    assert (d.min(axis=0) <= tol).all() and (d.min(axis=1) <= tol).all()


@pytest.mark.parametrize("name", ["example01", "example05", "example11"])
def test_relabelling_keeps_the_images(name):
    inst = _arrays(name)
    moved = traffic.relabel(inst, traffic.rng(2 ** 40 + 3, "window", 1),
                            ("variables", "rows"))
    assert not (np.array_equal(moved["A"], inst["A"])
                and np.array_equal(moved["P"], inst["P"]))
    a, b = _solve(inst), _solve(moved)
    for got, it in ((a, inst), (b, moved)):
        nums = ref.judge(it, got)
        assert nums["status"] == 0 and nums["count_diff"] == 0, nums
        assert max(nums["match_gap"], nums["facet_gap"],
                   nums["vertex_gap"]) < 1e-9, nums
    for k in ("V", "D", "W", "Dd"):
        _same_sets(a[k], b[k])
    X, Xm = ref.Feasible(inst), ref.Feasible(moved)
    Y, c = ref.cone_and_c(inst)
    for w in np.random.default_rng(0).random((8, Y.shape[1])):
        # a w in C*: nonnegative on every generator of C
        w = np.linalg.lstsq(Y.T, w, rcond=None)[0]
        if (Y.T @ w >= 0).all():
            assert X.support(w) == pytest.approx(Xm.support(w), abs=1e-9)


def test_reference_catches_wrong_answers():
    inst = _arrays("example11")
    good = _solve(inst)
    assert ref.judge(inst, good)["count_diff"] == 0
    dropped = dict(good, V=good["V"][1:])
    assert ref.judge(inst, dropped)["count_diff"] == 1
    moved = dict(good, V=good["V"] + np.eye(5)[0] * 1e-3)
    assert ref.judge(inst, moved)["match_gap"] > 1e-4
    W = good["W"].copy()
    W[0, -1] += 1e-3
    assert ref.judge(inst, dict(good, W=W))["facet_gap"] > 1e-4
    nums = ref.judge(inst, dict(good, status="INFEASIBLE"))
    assert nums["status"] == 1 and np.isinf(nums["facet_gap"])


def test_pool_order_and_streams():
    mix = {"relabel": ["variables", "rows"], "pool": 4}
    base = _arrays("example11")
    a = traffic.Traffic(mix, {}, base, 7)
    b = traffic.Traffic(mix, {}, base, 2 ** 33 + 5)
    window = [a.instance("window", i)["A"] for i in range(8)]
    assert all(not np.array_equal(window[i], window[i + 1])
               for i in range(7))
    assert np.array_equal(window[0], window[4])
    pool_b = [b.instance("window", i)["A"].tobytes() for i in range(4)]
    assert sorted(pool_b) == sorted(w.tobytes() for w in window[:4])
    warm = a.instance("warmup", 0)["A"].tobytes()
    assert warm not in pool_b
    assert warm == b.instance("warmup", 0)["A"].tobytes()
    # the published instance first, then the warm-up stream's own
    c = traffic.Traffic(dict(mix, warmup_published=True), {}, base, 7)
    assert np.array_equal(c.instance("warmup", 0)["A"], base["A"])
    assert c.instance("warmup", 1)["A"].tobytes() == warm


def test_union_and_idle_labels():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == (4, [(3, 5)])
    ops = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 6.0, 7.0)]
    host = {"lp": [(0.0, 4.0)], "poly": [(4.0, 6.0)], "solve": [(0.0, 8.0)]}
    out = reduce(ops, host, (0.0, 8.0))
    assert out["busy_s"] == 3.0 and out["window_s"] == 8.0
    assert out["device_ops"] == [["k1", 2.0], ["k2", 1.5]]
    assert dict(out["idle_gaps"]) == {"lp": 2.0, "poly": 2.0, "solve": 1.0}
    assert dict(reduce([], host, (0.0, 9.0))["idle_gaps"]) == {
        "lp": 4.0, "poly": 2.0, "solve": 2.0, "between": 1.0}


def test_busy_within_spans():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0), ("d", 6.0, 7.0)]
    assert merged([(s, e) for _, s, e in ops]) == [[0.0, 2.0], [3.0, 4.0],
                                                   [6.0, 7.0]]
    assert busy_within(ops, [(1.5, 3.5), (5.0, 8.0)]) == 2.0
    assert busy_within(ops, [(2.0, 3.0)]) == 0.0


def test_pivot_roofline_reads_the_card_inside_the_loops():
    import types

    from benchmark import run as harness

    reader = harness.module("metrics", "pivot_roofline")
    least = roofline.pivot_step_least_s(256, 350, 347, "float64")
    # 10 steps in a loop of 20 ms on the host, the card busy 20 * least
    # of it; the operation after the loop is not the loop's
    loops = [(256, 350, 347, "float64", 10, 0.0, 0.02)]
    ops = [("step", 0.001, 0.001 + 20 * least), ("other", 0.03, 0.04)]
    run = types.SimpleNamespace(
        probes={"pivot_clock": types.SimpleNamespace(loops=loops)},
        trace={"ops": ops, "window": (0.0, 0.05)})
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(types.SimpleNamespace(
        probes={"pivot_clock": types.SimpleNamespace(loops=loops)},
        trace=None)) is None


def test_pivot_step_bound():
    B, M, N = 256, 350, 347
    elems = B * M * (N + M)
    assert roofline.pivot_step_least_s(B, M, N, "float64") == pytest.approx(
        2 * elems * 8 / 3.35e12)
    # float32 moves half the bytes; both stay bound by the memory
    assert roofline.pivot_step_least_s(B, M, N, "float32") == pytest.approx(
        2 * elems * 4 / 3.35e12)
