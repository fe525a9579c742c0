"""Parity of the port's revised simplex (bensolve_tpu_torch.lp.revised)
with the JAX package's (bensolve_tpu.lp.revised) on the CPU.

The cases of tests/test_revised.py go through both packages.  Required
at float64: equal status and per-LP pivot counts; obj, x, row_dual and
col_dual within 1e-9.  At float32 (the long chain across several
refactorizations): equal status, obj within 1e-3, the tolerance
tests/test_revised.py holds that chain to against HiGHS.
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import revised as jrv
from bensolve_tpu_torch.lp import group_simplex, solve_batch_auto
from bensolve_tpu_torch.lp import revised as trv
from bensolve_tpu_torch.lp import simplex as tsx
from tests.test_revised import _random_instances
from tests.test_simplex import scipy_solve
from tests.test_torch_simplex import assert_parity


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(args, dtype=np.float64, **kw):
    ref = jrv.solve_batch_revised(*args, dtype=dtype, **kw)
    got = trv.solve_batch_revised(*args, dtype=dtype, device="cpu", **kw)
    return ref, got


@pytest.mark.parametrize("seed,M,N,B", [(0, 6, 30, 8), (1, 10, 50, 8),
                                        (2, 4, 40, 8), (3, 8, 24, 8),
                                        (6, 4, 40, 8)])
def test_random_cold(seed, M, N, B):
    args = _random_instances(seed, M, N, B)
    ref, got = both(args)
    assert_parity(ref, got, np.float64)
    for i in range(B):
        st, obj, _ = scipy_solve(*(a if k == 0 else a[i]
                                   for k, a in enumerate(args)))
        assert got.status[i] == st
        if st == tsx.OPTIMAL:
            np.testing.assert_allclose(got.obj[i], obj, rtol=1e-8, atol=1e-8)


def test_statuses_mixed():
    A = np.array([[1.0, 1.0], [1.0, -1.0]])
    c = np.array([[1.0, 1.0], [1.0, 1.0], [-1.0, -1.0]])
    rlb = np.array([[-np.inf] * 2, [3.0, 3.0], [-np.inf] * 2])
    rub = np.array([[2.0, 2.0], [np.inf] * 2, [np.inf] * 2])
    clb = np.zeros((3, 2))
    cub = np.array([[1.0, 1.0], [1.0, 1.0], [np.inf] * 2])
    ref, got = both((A, c, rlb, rub, clb, cub))
    assert list(got.status) == [tsx.OPTIMAL, tsx.INFEASIBLE, tsx.UNBOUNDED]
    assert_parity(ref, got, np.float64)


def test_long_pivot_chain_f32():
    args = _random_instances(11, 48, 320, 4)
    ref, got = both(args, np.float32)
    np.testing.assert_array_equal(got.status, ref.status)
    assert got.iters.max() > trv.REFACTOR_EVERY_F32
    np.testing.assert_allclose(got.obj, ref.obj, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mode", ["shared", "per_instance"])
def test_warm_starts(mode):
    """Shared: the batch restarts from one LP's optimal basis.  Per
    instance: each LP restarts from ITS OWN optimal basis and re-verifies
    optimality in zero pivots."""
    args = _random_instances(5 if mode == "shared" else 7, 8, 32, 8)
    cold = jrv.solve_batch_revised(*args)
    ok = cold.status == tsx.OPTIMAL
    i0 = int(np.flatnonzero(ok)[0])
    warm = ((cold.basis[i0], cold.at_upper[i0]) if mode == "shared"
            else (cold.basis, cold.at_upper))
    ref, got = both(args, start_basis=warm)
    assert_parity(ref, got, np.float64)
    np.testing.assert_allclose(got.obj[ok], cold.obj[ok], rtol=1e-9,
                               atol=1e-9)
    if mode == "per_instance":
        assert (got.iters[ok] == 0).all()


def test_chunked_per_instance_warm():
    args = _random_instances(8, 6, 24, 20)
    cold_ref, cold = both(args, max_chunk=8)
    assert_parity(cold_ref, cold, np.float64)
    warm = (cold.basis, cold.at_upper)
    ref, got = both(args, max_chunk=8, start_basis=warm)
    assert_parity(ref, got, np.float64)
    ok = cold.status == tsx.OPTIMAL
    assert ok.any() and (got.iters[ok] == 0).all()


def test_router_sends_tall_f32_to_revised(monkeypatch):
    """A tall float32 batch takes the revised route even when the
    kernel's route is forced; the tableau and the kernel stay untouched."""
    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    args = _random_instances(6, 4, 40, 8)
    calls, routed = trv.CALLS, group_simplex.ROUTED
    got = solve_batch_auto(*args, dtype=np.float32, device="cpu")
    assert trv.CALLS == calls + 1
    assert group_simplex.ROUTED == routed
    ref = jrv.solve_batch_revised(*args, dtype=np.float32)
    np.testing.assert_array_equal(got.status, ref.status)
    np.testing.assert_allclose(got.obj, ref.obj, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_perturbed_bounds_bit_equal(dtype):
    rng = np.random.default_rng(3)
    lb = rng.standard_normal((4, 40)).astype(dtype)
    ub = lb + rng.random((4, 40)).astype(dtype)
    lb[:, ::5] = -np.inf
    ub[:, ::7] = np.inf
    for a, b in zip(jrv._perturbed_bounds(lb, ub, dtype),
                    trv._perturbed_bounds(lb, ub, dtype)):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)


def _wide_easy(seed, M, N, B, n_neg=24):
    """Tall instances whose slack basis is feasible and whose objective
    prices only a few columns in: a short pivot chain at a large M."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    c = np.abs(rng.standard_normal((B, N))) + 3.0
    for b in range(B):
        c[b, rng.choice(N, n_neg, replace=False)] = -1.0
    return (A, c, np.full((B, M), -np.inf), 0.3 + rng.random((B, M)),
            np.zeros((B, N)), np.full((B, N), 5.0))


def test_two_stage_perturbed_solve_matches_highs():
    """Mp >= PERTURB_MIN_M: stage 1 on the relaxed bounds, stage 2 on
    the exact ones; both packages take the same pivots."""
    M, N, B = 449, 1796, 2
    args = _wide_easy(12, M, N, B)
    assert tsx._bucket(M) >= trv.PERTURB_MIN_M
    calls = trv.CALLS
    ref, got = both(args)
    assert trv.CALLS == calls + 1
    assert got.iters.min() > 0
    assert_parity(ref, got, np.float64)
    for i in range(B):
        st, obj, _ = scipy_solve(*(a if k == 0 else a[i]
                                   for k, a in enumerate(args)))
        assert got.status[i] == st == tsx.OPTIMAL
        np.testing.assert_allclose(got.obj[i], obj, rtol=1e-8, atol=1e-8)


def test_refactor_resets_singular_basis_to_slacks():
    """A running instance whose fresh factorization is non-finite comes
    back from _refactor on the slack basis with finite state."""
    args = _random_instances(0, 6, 30, 2)
    prep = tsx._prepare_A(args[0], np.float64, "cpu")
    full_c, lb, ub = tsx._pad_batch_inputs(prep, *args[1:], 2, np.float64)
    c, lb, ub = (torch.from_numpy(a) for a in (full_c, lb, ub))
    st = trv._initial_rstate(prep.dev, c, lb, ub)
    st.Brows[1, 1, 0] = float("nan")         # a poisoned basis column
    st.basis[1, 1] = prep.Mp
    st = trv._refactor(prep.dev, c, lb, ub, st)
    assert st.resets.tolist() == [0, 1]
    assert st.basis[1].tolist() == list(range(prep.Mp))
    assert torch.isfinite(st.Binv).all() and torch.isfinite(st.xb).all()
