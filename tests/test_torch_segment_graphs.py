"""The segment runner of lp/segments.py (the tableau pivot loops as
replayed CUDA graphs) on the CPU, through the stand-in for capture of
tests/torch_graph_standin.py.  Required:

* the final loop state equal to the eager loop's (simplex._run_segmented
  on the CPU) bit for bit, every field, on a P2 batch of example10
  (float64, cut at 150 pivots: the segments 1 to 64, then a tail), on a
  3-D batch, and on a dual chain started from a KeptState;
* the solves equal to the JAX package's, whose loops are the device
  programs _tableau_run_jit and _dual_run_jit driven by its
  _solve_tableau_segmented and _solve_dual_segmented, on the same numpy
  inputs: status, iterations, basis and at_upper equal, objectives
  within 1e-12 relative (float64);
* a tail of 37 pivots replays the graphs of 32, 4 and 1 steps;
* a second solve of the same key leaves the first solve's KeptState.W
  untouched;
* under a small budget the least recently used set is evicted, its
  graphs reset and its buffers dropped, and the results stay equal.
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import dual_simplex as jdx
from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu_torch.convert import kept_state_from_numpy
from bensolve_tpu_torch.lp import dual_simplex as tdx
from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.lp import simplex as tsx
from tests.test_ipm import random_lp
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


def assert_same_state(a, b):
    for f in segments.FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(bits(x), bits(y)), f"{f} differs"


def clone_state(st):
    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in segments.FIELDS})


def example10_p2(B, seed=0):
    """B P2 LPs of example10 (its P2 template, row bounds from random
    frontier vertices), as solve_batch takes them."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template

    vlp = examples.example10()
    q = vlp.q
    Z = np.eye(q) / (np.eye(q).T @ np.full(q, 1.0 / q))[None, :]
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS, device="cpu")
    V = np.random.default_rng(seed).random((B, q)) * 2.0 + 1.0
    return (t2.A_lp,) + tuple(t2.build_inputs(V @ t2.ZR))


def padded_start(args, dtype=np.float64):
    """(A, c, lb, ub, cold start state) of solve_batch's padded batch."""
    A, c, rlb, rub, clb, cub = args
    if np.ndim(A) == 3:
        B0, M, N = A.shape
        Mp, Np = tsx._bucket(M), tsx._bucket(N)
        Bp = tsx._bucket_batch(B0, Mp)
        A_p = np.zeros((Bp, Mp, Np), dtype)
        A_p[:B0, :M, :N] = A
        A_p[B0:, :M, :N] = A[0]
        dims = types.SimpleNamespace(M=M, N=N, Mp=Mp, Np=Np)
        A_t = tsx._put(A_p, "cpu")
    else:
        dims = tsx._prepare_A(A, dtype, "cpu")
        Bp = tsx._bucket_batch(np.shape(c)[0], dims.Mp)
        A_t = dims.dev
    full_c, lb, ub = tsx._pad_batch_inputs(dims, c, rlb, rub, clb, cub, Bp,
                                           np.dtype(dtype))
    c_t, lb_t, ub_t = (tsx._put(x, "cpu") for x in (full_c, lb, ub))
    return A_t, c_t, lb_t, ub_t, tsx._initial_state(A_t, c_t, lb_t, ub_t)


def batch_3d(seed, B=12, M=9, N=7):
    """Per-instance-matrix LPs (the 3-D path of config #5's rounds)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    rub = np.einsum("bmn,bn->bm", A, x0) + 0.5 + rng.random((B, M))
    return (A, rng.standard_normal((B, N)), np.full((B, M), -np.inf), rub,
            np.zeros((B, N)), np.full((B, N), 10.0))


def test_parts_are_the_binary_decomposition():
    assert segments._parts(37) == [32, 4, 1]
    assert segments._parts(64) == [64]
    assert segments._parts(1) == [1]
    assert segments._parts(127) == [64, 32, 16, 8, 4, 2, 1]
    assert segments._parts(0) == []


@pytest.mark.parametrize("case", ["example10 P2", "3-D"])
def test_primal_loop_equals_eager_bit_for_bit(case):
    """The runner's final state against the eager loop's, every field;
    example10's batch is cut at 150 pivots (segments 1, 2, ... 64, then
    23 = 16 + 4 + 2 + 1), the 3-D batch runs to its end."""
    if case == "3-D":
        args, max_iter = batch_3d(3), 10_000
    else:
        args, max_iter = example10_p2(8), 150
    A, c, lb, ub, st = padded_start(args)
    eager = tsx._run_segmented(tsx._step, A, c, lb, ub, clone_state(st),
                               max_iter)
    segments.reset_counts()
    with standing_in() as si:
        graph = tsx._run_segmented(tsx._step, A, c, lb, ub, clone_state(st),
                                   max_iter)
    assert_same_state(eager, graph)
    steps = segments.GRAPH_STEPS
    assert segments.EAGER_STEPS == 0 and steps > 0
    assert segments.CAPTURES == si.captures > 0
    assert segments.REPLAYS == si.replays
    if case == "example10 P2":
        assert steps == 150
        assert si.replays == 7 + 4
        assert (eager.status == tsx.RUNNING).any()        # cut short
    else:
        assert (eager.status == tsx.OPTIMAL).all()


def test_tail_of_37_replays_32_4_1():
    """Cut at 100 pivots: segments of 1, 2, ... 32 (63 steps), then a
    tail of 37, replayed as the graphs of 32, 4 and 1 steps."""
    A, c, lb, ub, st = padded_start(example10_p2(8, seed=1))
    calls = []

    def counted(*a):
        calls.append(1)
        return tsx._step(*a)

    per_replay = []
    with standing_in():
        inputs = (None, c, lb, ub)
        gs = segments._set_for(counted, "tableau", st, inputs, ("W",))
        gs.load(st, inputs)
        for n in (1, 2, 4, 8, 16, 32, 37):
            for k in segments._parts(n):
                graph = gs.graph(k)    # the first warms up: 2 steps
                before = len(calls)
                graph.replay()
                per_replay.append(len(calls) - before)
        graph = gs.unload(st)
    assert per_replay == [1, 2, 4, 8, 16, 32, 32, 4, 1]
    assert len(calls) == 100 + segments.WARMUP_STEPS
    # the warm-up ran on scratch buffers, and no capture stepped the state
    A, c, lb, ub, st = padded_start(example10_p2(8, seed=1))
    eager = tsx._run_segmented(tsx._step, A, c, lb, ub, st, 100)
    assert_same_state(eager, graph)


def test_dual_chain_from_kept_state_equals_eager_bit_for_bit():
    A, c, rlb, rub, clb, cub = random_lp(20, 24, 6, seed=9)
    cold = tsx.solve_batch(A, c, rlb, rub, clb, cub, device="cpu")
    _, kept = tdx.solve_batch_dual(
        A, c, rlb, rub * 0.99, clb, cub, start_basis=(cold.basis,
                                                      cold.at_upper),
        keep_state=True, device="cpu")
    assert kept is not None
    prep = tsx._prepare_A(A, np.float64, "cpu")
    Bp = tsx._bucket_batch(6, prep.Mp)
    perm = np.array([1, 0, 3, 2, 5, 4, 1, 1])[:Bp]
    full_c, lb, ub = tsx._pad_batch_inputs(prep, c[perm[:6]], rlb[perm[:6]],
                                           rub[perm[:6]] * 0.97,
                                           clb[perm[:6]], cub[perm[:6]], Bp,
                                           np.float64)
    c_t, lb_t, ub_t = (tsx._put(x, "cpu") for x in (full_c, lb, ub))

    def start():
        st = tsx._start_from_state(prep.dev, c_t, lb_t, ub_t, kept,
                                   torch.as_tensor(perm))
        return tdx._mark_dual_lost(prep.dev, c_t, lb_t, ub_t, st)

    eager = tsx._run_segmented(tdx._dstep, prep.dev, c_t, lb_t, ub_t,
                               start(), 1000)
    with standing_in():
        graph = tsx._run_segmented(tdx._dstep, prep.dev, c_t, lb_t, ub_t,
                                   start(), 1000)
    assert_same_state(eager, graph)
    assert int(eager.iters.max()) > 0


def assert_jax_equal(ref, got):
    for f in ("status", "iters", "basis", "at_upper"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    rel = np.abs(got.obj - ref.obj) / np.maximum(1.0, np.abs(ref.obj))
    assert rel.max() <= 1e-12, rel.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_primal_equals_jax_tableau_run(seed):
    """solve_batch through the runner against the JAX package's, whose
    pivot loop is _tableau_run_jit, cold and warm."""
    args = random_lp(12, 16, 10, seed=seed, eq_rows=2, fixed_cols=1,
                     free_cols=1)
    ref = jsx.solve_batch(*args)
    with standing_in():
        got = tsx.solve_batch(*args, device="cpu")
    assert segments.REPLAYS > 0
    assert_jax_equal(ref, got)
    ok = ref.status == jsx.OPTIMAL
    assert ok.any()
    warm = (ref.basis[ok][0], ref.at_upper[ok][0])
    args2 = args[:3] + (args[3] * 0.95,) + args[4:]
    ref = jsx.solve_batch(*args2, start_basis=warm)
    with standing_in():
        got = tsx.solve_batch(*args2, start_basis=warm, device="cpu")
    assert_jax_equal(ref, got)


def test_dual_equals_jax_dual_run():
    """solve_batch_dual through the runner against the JAX package's,
    whose pivot loop is _dual_run_jit: a warm start from a basis, then a
    chain from the JAX package's kept state."""
    A, c, rlb, rub, clb, cub = random_lp(20, 24, 6, seed=9)
    cold = jsx.solve_batch(A, c, rlb, rub, clb, cub)
    warm = (cold.basis, cold.at_upper)
    ref, jkept = jdx.solve_batch_dual(A, c, rlb, rub * 0.99, clb, cub,
                                      start_basis=warm, keep_state=True)
    with standing_in():
        got, _ = tdx.solve_batch_dual(A, c, rlb, rub * 0.99, clb, cub,
                                      start_basis=warm, keep_state=True,
                                      device="cpu")
    assert_jax_equal(ref, got)
    mine = kept_state_from_numpy(
        np.asarray(jkept.basis), np.asarray(jkept.in_basis),
        np.asarray(jkept.at_upper), np.asarray(jkept.W), jkept.age, "cpu")
    idx = np.array([1, 0, 3, 2, 5, 4])
    args = (A, c[idx], rlb[idx], rub[idx] * 0.97, clb[idx], cub[idx])
    ref = jdx.solve_batch_dual(*args, start_state=(jkept, idx))
    with standing_in():
        got = tdx.solve_batch_dual(*args, start_state=(mine, idx),
                                   device="cpu")
        assert segments.REPLAYS > 0
    assert_jax_equal(ref, got)


def test_second_solve_leaves_first_kept_state_untouched():
    A, c, rlb, rub, clb, cub = random_lp(20, 24, 6, seed=9)
    cold = tsx.solve_batch(A, c, rlb, rub, clb, cub, device="cpu")
    warm = (cold.basis, cold.at_upper)
    with standing_in():
        _, kept = tdx.solve_batch_dual(A, c, rlb, rub * 0.99, clb, cub,
                                       start_basis=warm, keep_state=True,
                                       device="cpu")
        assert kept is not None and segments.cached_sets() == 1
        W1 = kept.W.clone()
        (gs,) = segments._SETS.values()
        static = {b.data_ptr() for b in gs._buffers()}
        assert kept.W.data_ptr() not in static
        _, kept2 = tdx.solve_batch_dual(A, c, rlb, rub * 0.95, clb, cub,
                                        start_basis=warm, keep_state=True,
                                        device="cpu")
        assert segments.cached_sets() == 1       # the same key
        assert kept2 is not None
        assert not torch.equal(kept2.W, W1)
    assert torch.equal(bits(kept.W), bits(W1))


def test_eviction_under_a_small_budget(monkeypatch):
    """Two keys alternately under a budget that holds one set: each use
    evicts the other set (its graphs reset, its buffers dropped), and
    every result equals the eager loop's."""
    args = {B: random_lp(12, 16, B, seed=B) for B in (6, 12)}
    eager = {B: tsx.solve_batch(*a, device="cpu") for B, a in args.items()}
    with standing_in() as si:
        tsx.solve_batch(*args[6], device="cpu", max_chunk=256)
        one = segments.cached_bytes()
        monkeypatch.setattr(tsx, "TABLEAU_BYTES_BUDGET", one + 1)
        for B in (12, 6, 12):
            (old,) = segments._SETS.values()
            got = tsx.solve_batch(*args[B], device="cpu", max_chunk=256)
            assert segments.cached_sets() == 1
            assert old.state is None and old.graphs == {}
            for f in ("status", "iters", "basis", "at_upper", "obj"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(eager[B], f), f)
        assert si.resets == si.captures - len(
            next(iter(segments._SETS.values())).graphs)


def test_eager_loop_and_counts():
    """eager_loop() runs the loop eagerly where a backend exists, and the
    eager steps are counted."""
    args = random_lp(12, 16, 6, seed=4)
    segments.reset_counts()
    with standing_in():
        with segments.eager_loop():
            a = tsx.solve_batch(*args, device="cpu")
        assert segments.REPLAYS == 0 and segments.EAGER_STEPS > 0
        eager_steps = segments.EAGER_STEPS
        b = tsx.solve_batch(*args, device="cpu")
    assert segments.GRAPH_STEPS == eager_steps
    assert segments.counts()["captures"] == segments.CAPTURES > 0
    for f in ("status", "iters", "basis", "obj"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_threads_share_the_cache():
    """More threads than cores, a short switch interval: each solves its
    batch through the runner (two keys shared between threads) or, in
    eager_loop(), eagerly; every result equals the serial eager one and
    no step or replay count is lost."""
    import os
    import sys
    import threading

    n = (os.cpu_count() or 4) + 4
    batches = [random_lp(12, 16, 6 if i % 2 else 12, seed=i % 4)
               for i in range(n)]
    eager, steps = [], []
    for b in batches:
        segments.reset_counts()
        eager.append(tsx.solve_batch(*b, device="cpu"))
        steps.append(segments.EAGER_STEPS)
    results, errors = [None] * n, []

    def work(i):
        try:
            with (segments.eager_loop() if i % 3 == 0
                  else contextlib.nullcontext()):
                results[i] = tsx.solve_batch(*batches[i], device="cpu")
        except BaseException as e:     # noqa: BLE001  (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    segments.reset_counts()
    sys.setswitchinterval(1e-5)
    try:
        with standing_in() as si:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            assert segments.cached_sets() == 2
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    for got, ref in zip(results, eager):
        for f in ("status", "iters", "basis", "at_upper", "obj"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          f)
    assert segments.REPLAYS == si.replays > 0
    assert segments.CAPTURES == si.captures
    assert segments.EAGER_STEPS == sum(steps[i] for i in range(0, n, 3))
    assert segments.GRAPH_STEPS == sum(steps) - segments.EAGER_STEPS
