"""The interior-point segment as replayed CUDA graphs of ``_Core.step``
(``ipm._ipm_core`` through lp/segments.py, loop "ipm") on the CPU,
through the stand-in for capture of tests/torch_graph_standin.py.
Required:

* (a) the graph runner's carry equal to the eager loop's (``_ipm_core``
  on the CPU) bit for bit in all 16 entries at a cut where no instance
  finishes (``seg=5``), at float64 and float32 and with the trace
  history (17 entries); run to the end (``seg=60``) equal in every
  entry an output reads (status, it, z, y, zl, zu, the best iterate and
  score, resets): the graph runner reads its running flag one iteration
  late, so it runs one masked iteration past the stop, which changes
  only mu_prev and noimp (entries 8 and 9) of finished rows;
* (b) both within 1e-10 (5 iterations) and 1e-6 (60) of the JAX
  package's ``_ipm_seg_jit``, the tolerances of
  tests/test_torch_ipm.py::test_one_segment_of_the_iteration;
* (c) ``solve_batch_ipm``'s LPResult by graphs equal to the eager one,
  and ``ipm.LAST`` counting the iterations run past the JAX stop;
* (d) a second solve of the same shape with other c, l, u gives its own
  answer from the cached set (the tensors ``_Core`` derives from c, l,
  u are buffers of the set, copied in at every use);
* (e) compaction from B = 16 with a straggler: one graph set per rung of
  the batch's power-of-two ladder; BENSOLVE_IPM_TRACE=1 a set of its
  own;
* (f) masked iterations after every instance finished change carry[8]
  and carry[9] only;
* (g) the running-flag schedule (``ipm._advance``) and the memory pools
  counted against the cache's budget.
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import ipm as jipm
from bensolve_tpu_torch.lp import ipm as tipm
from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.lp import simplex as tsx
from tests.test_ipm import random_lp
from tests.test_torch_ipm import _assert_carries_close, _core_inputs
from tests.torch_graph_standin import bits, standing_in

# the carry entries no output reads once the instance has finished
MASKED_ONLY = (8, 9)


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


def core_tensors(seed=4, dtype=np.float64, **kw):
    A, c, l, u, split = _core_inputs(seed=seed, **kw)
    t = [torch.from_numpy(np.ascontiguousarray(a, dtype)) for a in
         (A, c, l, u)]
    return t + [torch.from_numpy(split)]


def cold_carry(t, trace=False):
    carry = tipm._ipm_init(t[1], t[2], t[3], t[0].shape[0])
    if trace:
        carry = carry + (torch.zeros((800, 7), dtype=torch.float32),)
    return carry


def both_cores(t, carry, seg, max_iter=800):
    """_ipm_core eagerly and through the graph runner from the same
    carry: ((carry, ran) eager, (carry, ran) graph)."""
    segments.reset_counts()
    eager = tipm._ipm_core(*t, carry, seg, max_iter)
    ipm_c = segments.counts()["by_loop"]["ipm"]
    assert ipm_c["eager_steps"] == eager[1] and ipm_c["replays"] == 0
    segments.reset_counts()
    with standing_in() as si:
        graph = tipm._ipm_core(*t, carry, seg, max_iter)
    ipm_c = segments.counts()["by_loop"]["ipm"]
    assert ipm_c["eager_steps"] == 0 and ipm_c["graph_steps"] == graph[1]
    assert ipm_c["replays"] == si.replays == graph[1] // tipm.PIECE
    assert ipm_c["captures"] == si.captures == si.emptied == 1
    return eager, graph


def assert_same(a, b, skip=()):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        if k in skip:
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(bits(x), bits(y)), f"carry[{k}] differs"


@pytest.mark.parametrize("case", ["f64", "f32", "trace", "no free columns"])
def test_graph_segment_equals_eager_bit_for_bit_at_seg5(case):
    dtype = np.float32 if case == "f32" else np.float64
    t = core_tensors(dtype=dtype,
                     free_cols=0 if case == "no free columns" else 2)
    carry = cold_carry(t, trace=case == "trace")
    (ec, eran), (gc, gran) = both_cores(t, carry, 5)
    assert eran == gran == 5
    assert (ec[6] < 0).all()            # nothing finished: no masked step
    assert_same(ec, gc)
    if case == "trace":
        assert len(gc) == 17 and gc[16][:5].abs().sum() > 0


def test_graph_segment_to_the_end_equals_eager_in_every_output():
    """seg=60 runs every instance to convergence: the eager loop stops
    where the JAX loop stops, the graph runner one iteration later (its
    flag is read one piece late); the extra iteration is masked."""
    t = core_tensors()
    carry = cold_carry(t)
    (ec, eran), (gc, gran) = both_cores(t, carry, 60)
    assert (ec[6] == tsx.OPTIMAL).all()
    assert eran == int(ec[7].max()) < 60
    assert gran == eran + tipm.PIECE
    assert_same(ec, gc, skip=MASKED_ONLY)
    # the masked iteration changed mu_prev or noimp of a finished row
    assert not (torch.equal(bits(ec[8]), bits(gc[8]))
                and torch.equal(ec[9], gc[9]))


@pytest.mark.parametrize("seg,tol", [(5, 1e-10), (60, 1e-6)])
def test_graph_and_eager_segments_match_jax(seg, tol):
    A, c, l, u, split = _core_inputs(seed=4)
    t = core_tensors()
    jc = jipm._ipm_init_jit(c, l, u, A.shape[0])
    jc = jipm._ipm_seg_jit(A, c, l, u, split.astype(np.int32), jc, seg, 800)
    (ec, _), (gc, _) = both_cores(t, cold_carry(t), seg)
    for got in (ec, gc):
        np.testing.assert_array_equal(got[6].numpy(), np.asarray(jc[6]))
        np.testing.assert_array_equal(got[7].numpy(), np.asarray(jc[7]))
        if seg == 5:
            _assert_carries_close(jc, got, tol)
        else:
            keep = [k for k in range(16) if k not in MASKED_ONLY]
            _assert_carries_close([jc[k] for k in keep],
                                  [got[k] for k in keep], tol)
    # the eager loop stops where the JAX loop stops: all 16 entries
    _assert_carries_close(jc, ec, tol)


def assert_results_equal(a, b):
    for f in ("status", "obj", "x", "s", "row_dual", "col_dual", "iters",
              "quality"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(
            x.view(np.int64) if x.dtype == np.float64 else x,
            y.view(np.int64) if y.dtype == np.float64 else y), f


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_batch_ipm_by_graphs_equals_eager(dtype):
    args = random_lp(24, 40, 4, seed=0, free_cols=2)
    args = tuple(np.asarray(a, dtype) for a in args)
    eager = tipm.solve_batch_ipm(*args, dtype=dtype, device="cpu")
    assert tipm.LAST["past_stop"] == 0
    with standing_in():
        graph = tipm.solve_batch_ipm(*args, dtype=dtype, device="cpu")
    assert_results_equal(eager, graph)
    assert (graph.status == tsx.OPTIMAL).all()
    # one masked iteration past the stop of the one segment that ended
    # with every instance finished
    assert tipm.LAST["past_stop"] == tipm.PIECE


def test_second_solve_of_the_same_shape_with_new_bounds():
    """Two solves of one shape with other c, l, u: the second replays the
    first's graph on its own copied-in c, l, u and derived tensors."""
    one = random_lp(24, 40, 4, seed=1)
    two = list(random_lp(24, 40, 4, seed=1))
    two[1] = np.random.default_rng(5).standard_normal(two[1].shape)
    two[3] = two[3] + 0.25              # row bounds
    two[5] = np.full_like(two[5], 4.0)  # column bounds, three of them
    two[5][:, :3] = np.inf              # infinite: other has_u, hu, nb
    eager = [tipm.solve_batch_ipm(*a, dtype=np.float64, device="cpu")
             for a in (one, two)]
    with standing_in() as si:
        first = tipm.solve_batch_ipm(*one, dtype=np.float64, device="cpu")
        captured = si.captures
        second = tipm.solve_batch_ipm(*two, dtype=np.float64, device="cpu")
        assert si.captures == captured and segments.cached_sets() == 1
    assert_results_equal(first, eager[0])
    assert_results_equal(second, eager[1])
    assert not np.allclose(eager[0].obj, eager[1].obj)


def test_compaction_ladder_gives_one_key_per_rung(monkeypatch):
    """tests/test_torch_ipm.py::test_compaction_with_a_straggler's recipe
    at B = 16 with 2-iteration segments (at 4 this batch goes from 16
    straight to 1): the batch shrinks along the power-of-two ladder,
    16, 8, 1, and each width it runs at is a graph set of its own; the
    result equals the eager solve's."""
    monkeypatch.setenv("BENSOLVE_IPM_SEG", "2")
    args = random_lp(24, 40, 16, seed=21, eq_rows=3)
    widths = []
    real = tipm._ipm_core

    def spy(A, c, *a):
        widths.append(c.shape[0])
        return real(A, c, *a)

    eager = tipm.solve_batch_ipm(*args, dtype=np.float64, device="cpu")
    monkeypatch.setattr(tipm, "_ipm_core", spy)
    with standing_in() as si:
        graph = tipm.solve_batch_ipm(*args, dtype=np.float64, device="cpu")
        keys = [k for k, gs in segments._SETS.items() if gs.loop == "ipm"]
        assert si.captures == len(keys)
    assert_results_equal(eager, graph)
    rungs = sorted(set(widths), reverse=True)
    assert rungs[0] == 16 and rungs[-1] == 1 and len(rungs) >= 3
    # the key's carry entries lead with z (B, K): one key per width
    assert sorted((k[2][0][0] for k in keys), reverse=True) == rungs


def test_trace_history_gets_a_key_of_its_own(monkeypatch):
    args = random_lp(12, 18, 4, seed=3)
    with standing_in():
        plain = tipm.solve_batch_ipm(*args, dtype=np.float64, device="cpu")
        monkeypatch.setenv("BENSOLVE_IPM_TRACE", "1")
        traced = tipm.solve_batch_ipm(*args, dtype=np.float64, device="cpu")
        keys = list(segments._SETS)
    assert len(keys) == 2
    assert sorted(len(k) for k in keys) == [2 + 16 + 13, 2 + 17 + 13]
    assert_results_equal(plain, traced)


def test_masked_iterations_change_only_mu_and_noimp():
    """From a carry in which every instance has finished, steps with the
    running flag False (the iterations queued past the JAX stop) leave
    every entry but carry[8] and carry[9] as they were, bit for bit."""
    t = core_tensors(free_cols=2)
    done, _ = tipm._ipm_core(*t, cold_carry(t, trace=True), 60, 800)
    assert (done[6] >= 0).all()
    core = tipm._Core(*t)
    carry = done
    for _ in range(3):
        carry = core.step(carry, torch.tensor(False))
    assert_same(done, carry, skip=MASKED_ONLY)
    # noimp counts on: mu_prev is recomputed from the unchanged iterate
    assert not torch.equal(done[9], carry[9])


@pytest.mark.parametrize("ahead,stop_after,want", [
    (0, 3, 3), (1, 3, 4), (1, 10, 10), (0, 0, 1)])
def test_flag_schedule(ahead, stop_after, want):
    """_advance over n = 10 one-iteration pieces: the flag turns False
    after ``stop_after`` iterations; the host reads it ``ahead`` pieces
    late, so the run ends ``ahead`` pieces past the stop (never past
    n)."""
    ran = []

    def advance(k):
        ran.append(k)

    def running():
        return torch.tensor(sum(ran) < stop_after)

    got = tipm._advance(advance, running, 10, 1, ahead, torch.device("cpu"))
    assert got == sum(ran) == want


def test_pools_count_against_the_budget(monkeypatch):
    """A capture's pool (what the device's reserved memory grew by) joins
    the static buffers in the cache's count; once it takes the cache
    past the budget the least recently used other set is evicted."""
    t4 = core_tensors(seed=4)
    t5 = core_tensors(seed=5)
    with standing_in() as si:
        tipm._ipm_core(*t4, cold_carry(t4), 2, 800)
        (gs4,) = segments._SETS.values()
        assert gs4.pool_bytes == 0 and segments.cached_bytes() == gs4.nbytes
        si.pool_per_capture = 1 << 30
        monkeypatch.setattr(tsx, "TABLEAU_BYTES_BUDGET", 2 * gs4.nbytes)
        # other bounds only: the same key, no capture
        tipm._ipm_core(*t5, cold_carry(t5), 2, 800)
        assert segments.cached_sets() == 1 and si.captures == 1
        # a float32 batch: a new key, whose pool takes the cache past
        # the budget and evicts the float64 set
        t32 = core_tensors(seed=4, dtype=np.float32)
        tipm._ipm_core(*t32, cold_carry(t32), 2, 800)
        (gs32,) = segments._SETS.values()
        assert gs32.pool_bytes == 1 << 30 and gs4.state is None
        assert segments.cached_pool_bytes() == 1 << 30
