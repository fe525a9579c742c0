"""The revised simplex's pivot loop as replayed CUDA graphs
(``revised._run`` through lp/segments.py) on the CPU, through the
stand-in for capture of tests/torch_graph_standin.py.  Required:

* (a) the graph runner's final state equal to the eager loop's
  (``revised._run`` on the CPU) bit for bit in all 16 fields of
  ``_RState``, and the returned step count equal, on the tall recipe of
  tests/test_revised.py at float64 and float32, on a run cut at 100
  steps (across the forced pricing pass at step 64), with
  REFACTOR_EVERY_F64 set to 24 in both runs (a refactorization off the
  16-step grid), and on a batch with one LP's xb set to inf and a basis
  row poisoned at the start (the ``bad & step % 16`` repair and the
  slack reset, ``resets`` > 0);
* (b) the two-stage perturbed solve (``_solve_revised_segmented`` with
  ``pert``) bit for bit the eager one, every stage's state and every
  output;
* (c) the solve equal to the JAX package's ``_solve_revised_segmented``
  (whose loop is the device program ``_revised_run_jit``) on the same
  numpy inputs: on the tall recipe status, iterations, basis and
  at_upper equal, objectives within 1e-12 relative (float64); on the P2
  batch of ``random_vlp(2, 25, 250)`` status, the bases as sets and
  the nonbasic at_upper equal, objectives within 1e-12 (its pivots part from the JAX
  package's at a near tie, see the test);
* (d) the cache: a second solve of the same key captures nothing new, a
  new A of the same shape gives that A's answer, and under a small
  budget the least recently used set is evicted and the results stay
  equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bensolve_tpu.lp import revised as jrv
from bensolve_tpu_torch.lp import revised as trv
from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.lp import simplex as tsx
from tests.test_revised import _random_instances
from tests.torch_graph_standin import bits, standing_in


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_cache():
    segments.clear()
    yield
    segments.clear()


def padded(args, dtype=np.float64):
    """The padded numpy arrays (A, A^T, c, lb, ub) of a batch, as
    solve_batch_revised builds them (unscaled)."""
    A, c, rlb, rub, clb, cub = args
    prep = tsx._prepare_A(np.asarray(A, dtype), dtype, "cpu")
    Bp = tsx._bucket_batch(np.shape(c)[0], prep.Mp)
    full_c, lb, ub = tsx._pad_batch_inputs(prep, c, rlb, rub, clb, cub, Bp,
                                           np.dtype(dtype))
    return (prep.host, np.ascontiguousarray(prep.host.T), full_c, lb, ub)


def tensors(arrays):
    return tuple(tsx._put(a, "cpu") for a in arrays)


def p2_batch(B, seed=0):
    """B P2 LPs of random_vlp(2, 25, 250) (its P2 template, the row
    bounds of random frontier vertices)."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template

    vlp = examples.random_vlp(q=2, m=25, n=250)
    q = vlp.q
    Z = np.eye(q) / (np.eye(q).T @ np.full(q, 1.0 / q))[None, :]
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS, device="cpu")
    V = np.random.default_rng(seed).random((B, q)) * 2.0 + 1.0
    return (t2.A_lp,) + tuple(t2.build_inputs(V @ t2.ZR))


def assert_same_rstate(a, b):
    for f in trv.RSTATE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(bits(x), bits(y)), f"{f} differs"


def clone_rstate(st):
    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in trv.RSTATE_FIELDS})


def both_loops(A, AT, c, lb, ub, st, cap):
    """revised._run from ``st`` eagerly and through the graph runner:
    ((state, step) eager, (state, step) graph, eager steps)."""
    every = trv._refactor_interval(A.shape[0], c.shape[1], c.dtype)
    segments.reset_counts()
    eager = trv._run(A, AT, c, lb, ub, clone_rstate(st), 0, cap, every)
    rv = segments.counts()["by_loop"]["revised"]
    assert rv["eager_steps"] > 0 and rv["replays"] == 0
    steps = rv["eager_steps"]
    segments.reset_counts()
    with standing_in() as si:
        graph = trv._run(A, AT, c, lb, ub, clone_rstate(st), 0, cap, every)
    rv = segments.counts()["by_loop"]["revised"]
    assert rv["eager_steps"] == 0 and rv["graph_steps"] == steps
    assert rv["replays"] == si.replays > 0
    assert rv["captures"] == si.captures > 0
    assert segments.EAGER_STEPS == 0 and segments.GRAPH_STEPS == steps
    return eager, graph, steps


@pytest.mark.parametrize("case", ["tall f64", "tall f32", "cut at 100",
                                  "every 24", "inf xb"])
def test_graph_loop_equals_eager_bit_for_bit(case, monkeypatch):
    dtype = np.float32 if case == "tall f32" else np.float64
    args = _random_instances(11, 48, 320, 4) if case in (
        "tall f32", "cut at 100") else _random_instances(1, 10, 50, 8)
    if case == "every 24":
        monkeypatch.setattr(trv, "REFACTOR_EVERY_F64", 24)
        args = _random_instances(11, 48, 320, 4)
    A, AT, c, lb, ub = tensors(padded(args, dtype))
    st = trv._initial_rstate(A, c, lb, ub)
    if case == "inf xb":
        st.xb[1, 2] = float("inf")
        st.Brows[1, 0, 0] = float("nan")    # its fresh LU fails: a reset
    cap = 100 if case == "cut at 100" else 10_000
    (est, estep), (gst, gstep), steps = both_loops(A, AT, c, lb, ub, st, cap)
    assert_same_rstate(est, gst)
    assert estep == gstep
    every = trv._refactor_interval(A.shape[0], c.shape[1], c.dtype)
    if case == "cut at 100":
        assert estep == steps == 100
        assert (est.status == tsx.RUNNING).any()
    else:
        assert (est.status != tsx.RUNNING).all()
        assert estep <= steps
    if case == "tall f32":
        assert every == 64 and estep > 2 * every
    if case == "every 24":
        # 24, or 4 M^2 / NT where that is larger: off the 16-step grid
        assert every < 64 and every % 16 != 0 and estep > 2 * every
    if case == "inf xb":
        assert est.resets.tolist()[1] >= 1 and est.resets.sum() >= 1
        assert est.status.tolist()[1] == tsx.OPTIMAL


def test_two_stage_perturbed_solve_bit_for_bit(monkeypatch):
    """_solve_revised_segmented with ``pert``: stage 1 on the relaxed
    bounds, _rebound, stage 2 on the exact ones; every stage's state,
    step and every output equal, eager against graphs."""
    arrays = padded(_random_instances(3, 8, 64, 8))
    lb1, ub1 = trv._perturbed_bounds(arrays[3], arrays[4], np.float64)
    A, AT, c, lb, ub = tensors(arrays)
    pert = tensors((lb1, ub1))
    runs = {"eager": [], "graph": []}
    real = trv._run

    def solve(mode):
        def recorded(*a):
            out = real(*a)
            runs[mode].append(out)
            return out

        monkeypatch.setattr(trv, "_run", recorded)
        try:
            return trv._solve_revised_segmented(A, AT, c, lb, ub, None, None,
                                                None, 5000, pert=pert)
        finally:
            monkeypatch.setattr(trv, "_run", real)

    eager = solve("eager")
    with standing_in():
        graph = solve("graph")
    assert len(runs["eager"]) == len(runs["graph"]) == 2
    for (a, sa), (b, sb) in zip(runs["eager"], runs["graph"]):
        assert_same_rstate(a, b)
        assert sa == sb
    assert runs["eager"][1][1] > runs["eager"][0][1] > 0
    for x, y in zip(eager, graph):
        assert torch.equal(bits(x), bits(y))
    assert (eager[0] == tsx.OPTIMAL).all()


@pytest.mark.parametrize("case", ["tall", "random_vlp(2, 25, 250) P2"])
def test_solve_equals_jax_revised_run(case):
    """On the tall recipe every pivot is the JAX package's.  On the P2
    batch the two packages' CPU products round differently from the
    first step (dred 2.2e-16 apart after step 0) and part at a near tie
    at step 7, eagerly as by graphs, so their pivot counts and the slot
    order of their bases differ; they end at the same optimal bases (as
    sets), with at_upper equal on the nonbasic variables (a basic
    variable's flag is stale and read by nothing) and objectives within
    1e-12."""
    args = (_random_instances(1, 10, 50, 8) if case == "tall"
            else p2_batch(8))
    arrays = padded(args)
    M, NT = arrays[0].shape[0], arrays[2].shape[1]
    assert NT >= 4 * M
    max_iter = 5000
    ref = jrv._solve_revised_segmented(*(jnp.asarray(a) for a in arrays),
                                       None, None, None, max_iter)
    ref = [np.asarray(o) for o in ref]
    segments.reset_counts()
    with standing_in():
        got = trv._solve_revised_segmented(*tensors(arrays), None, None,
                                           None, max_iter)
    assert segments.counts()["by_loop"]["revised"]["replays"] > 0
    got = [o.numpy() for o in got]
    np.testing.assert_array_equal(got[0], ref[0], "status")
    if case == "tall":
        for i, f in ((6, "iters"), (7, "basis"), (8, "at_upper")):
            np.testing.assert_array_equal(got[i], ref[i], f)
    else:
        np.testing.assert_array_equal(np.sort(got[7], axis=1),
                                      np.sort(ref[7], axis=1), "basis")
        nonbasic = np.ones(ref[8].shape, bool)
        np.put_along_axis(nonbasic, ref[7].astype(np.int64), False, axis=1)
        np.testing.assert_array_equal(got[8] & nonbasic, ref[8] & nonbasic,
                                      "at_upper")
    rel = np.abs(got[1] - ref[1]) / np.maximum(1.0, np.abs(ref[1]))
    assert rel.max() <= 1e-12, rel.max()
    assert (ref[0] == tsx.OPTIMAL).all() and ref[6].max() > 16


def solve(arrays, max_iter=5000):
    return trv._solve_revised_segmented(*tensors(arrays), None, None, None,
                                        max_iter)


def assert_outputs_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(bits(x), bits(y))


def test_cache_second_solve_and_new_matrix():
    """A second solve of the same key captures nothing and takes the
    same set; a new A of that shape replays the cached graphs against
    its own copy and gives its own answer."""
    one = padded(_random_instances(1, 10, 50, 8))
    two = padded(_random_instances(2, 10, 50, 8))
    assert one[0].shape == two[0].shape and not np.array_equal(one[0],
                                                               two[0])
    eager = [solve(one), solve(two)]
    with standing_in() as si:
        assert_outputs_equal(solve(one), eager[0])
        captured = si.captures
        assert captured > 0 and segments.cached_sets() == 1
        assert_outputs_equal(solve(one), eager[0])
        assert si.captures == captured
        assert_outputs_equal(solve(two), eager[1])
        assert si.captures == captured and segments.cached_sets() == 1
    assert not torch.equal(eager[0][1], eager[1][1])


def test_cache_eviction_under_a_small_budget(monkeypatch):
    """Two keys alternately under a budget that holds one set: each use
    evicts the other set (its graphs reset, its buffers dropped), and
    every result equals the eager one."""
    arrays = {B: padded(_random_instances(B, 10, 50, B)) for B in (4, 16)}
    eager = {B: solve(a) for B, a in arrays.items()}
    with standing_in() as si:
        solve(arrays[4])
        one = segments.cached_bytes()
        (gs,) = segments._SETS.values()
        assert one == segments._nbytes(gs._buffers()) > 0
        monkeypatch.setattr(tsx, "TABLEAU_BYTES_BUDGET", one + 1)
        for B in (16, 4, 16):
            (old,) = segments._SETS.values()
            assert_outputs_equal(solve(arrays[B]), eager[B])
            assert segments.cached_sets() == 1
            assert old.state is None and old.graphs == {}
        assert si.resets == si.captures - len(
            next(iter(segments._SETS.values())).graphs)
