"""Parity of the port's tableau simplex (bensolve_tpu_torch.lp.simplex)
with the JAX package's (bensolve_tpu.lp.simplex) on the CPU.

The same numpy inputs go through both.  Required: equal status and
per-LP pivot counts; obj, x, row_dual and col_dual within 1e-9 at
float64 (the GLPK-grade tolerance the solver itself runs at) and 1e-4
at float32 (float32 rounding through a few dozen rank-1 updates and the
final LU, which the two packages sum in different orders).
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu_torch.lp import simplex as tsx

TOL = {np.float64: 1e-9, np.float32: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_parity(ref, got, dtype, values=True):
    """Equal statuses and pivots; values on the OPTIMAL instances."""
    np.testing.assert_array_equal(ref.status, got.status)
    np.testing.assert_array_equal(ref.iters, got.iters)
    ok = ref.status == jsx.OPTIMAL
    if not values or not ok.any():
        return
    tol = TOL[dtype]
    for field in ("obj", "x", "row_dual", "col_dual"):
        np.testing.assert_allclose(getattr(got, field)[ok],
                                   getattr(ref, field)[ok],
                                   rtol=tol, atol=tol, err_msg=field)


def both(args, dtype=np.float64, **kw):
    ref = jsx.solve_batch(*args, dtype=dtype, **kw)
    got = tsx.solve_batch(*args, dtype=dtype, device="cpu", **kw)
    return ref, got


def _one(A, c, rlb, rub, clb, cub):
    return (np.asarray(A, float), np.asarray(c, float)[None],
            np.asarray(rlb, float)[None], np.asarray(rub, float)[None],
            np.asarray(clb, float)[None], np.asarray(cub, float)[None])


inf = np.inf
# the single-LP cases of tests/test_simplex.py
CASES = {
    "tiny_known": _one([[1, 1], [0, 1]], [-1, -2], [-inf, -inf], [4, 3],
                       [0, 0], [inf, inf]),
    "row_dual_lb": _one([[1]], [1], [3], [inf], [-inf], [inf]),
    "row_dual_ub": _one([[1]], [-1], [-inf], [5], [-inf], [inf]),
    "infeasible": _one([[1], [1]], [0], [3, -inf], [inf, 1], [-inf], [inf]),
    "unbounded": _one([[1]], [-1], [0], [inf], [-inf], [inf]),
    "fixed_free": _one([[1, 1]], [0, 1], [2], [2], [0.5, -inf], [0.5, inf]),
    "beale_cycling": _one(
        [[0.25, -60, -0.04, 9], [0.5, -90, -0.02, 3], [0, 0, 1, 0]],
        [-0.75, 150, -0.02, 6], [-inf] * 3, [0, 0, 1], [0] * 4, [inf] * 4),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cases(case, dtype):
    ref, got = both(CASES[case], dtype)
    assert_parity(ref, got, dtype)


def test_mixed_batch_statuses():
    A = np.array([[1.0, 0.0], [0.0, 1.0]])
    c = np.array([[1.0, 1.0], [0.0, 0.0], [-1.0, 0.0]])
    rlb = np.array([[0.0, 0.0], [3.0, -inf], [0.0, 0.0]])
    rub = np.array([[inf, inf], [1.0, inf], [inf, inf]])
    clb = np.array([[0.0, 0.0], [-inf, 0.0], [-inf, 0.0]])
    cub = np.full((3, 2), inf)
    ref, got = both((A, c, rlb, rub, clb, cub))
    assert list(got.status) == [tsx.OPTIMAL, tsx.INFEASIBLE, tsx.UNBOUNDED]
    assert_parity(ref, got, np.float64)


def random_batch(seed, M=7, N=9, B=8):
    """A shared matrix with per-instance objectives and bounds of every
    GLPK type ('f','l','u','d','s'), as in tests/test_simplex.py."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    c = rng.standard_normal((B, N))

    def mk(k):
        kind = rng.integers(0, 5, (B, k))
        lo = rng.standard_normal((B, k)) - 2
        hi = lo + np.abs(rng.standard_normal((B, k))) + 0.5
        lb = np.where((kind == 0) | (kind == 2), -inf, lo)
        ub = np.where((kind == 0) | (kind == 1), inf, hi)
        ub = np.where(kind == 4, lb, ub)
        return lb, ub

    rlb, rub = mk(M)
    clb, cub = mk(N)
    return A, c, rlb, rub, clb, cub


def feasible_batch(seed, M=8, N=12, B=8):
    """Feasible, bounded instances (all OPTIMAL), for warm starts."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    rub = x0 @ A.T + 0.5 + rng.random((B, M))
    return (A, rng.standard_normal((B, N)), np.full((B, M), -inf), rub,
            np.zeros((B, N)), np.full((B, N), 5.0))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_cold(seed, dtype):
    ref, got = both(random_batch(seed), dtype)
    assert_parity(ref, got, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["shared", "per_instance"])
def test_random_warm(mode, dtype):
    args = feasible_batch(3)
    cold = jsx.solve_batch(*args, dtype=dtype)
    assert (cold.status == jsx.OPTIMAL).all()
    A, c, rlb, rub, clb, cub = args
    changed = (A, c, rlb, rub * 0.9, clb, cub)
    if mode == "shared":
        warm = (cold.basis[0], cold.at_upper[0])
    else:
        warm = (cold.basis, cold.at_upper)
    ref, got = both(changed, dtype, start_basis=warm)
    assert_parity(ref, got, dtype)


def test_chunked_batch_matches_one_batch():
    args = random_batch(4, B=12)
    ref = jsx.solve_batch(*args)
    got = tsx.solve_batch(*args, device="cpu", max_chunk=4)
    assert_parity(ref, got, np.float64)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsx.solve_batch(*random_batch(0), device="cuda")


def test_three_d_broadcast_matches_shared():
    """A 3-D A broadcast from one matrix solves to the shared-matrix
    path's results."""
    A, c, rlb, rub, clb, cub = random_batch(0)
    A3 = np.broadcast_to(A, (c.shape[0],) + A.shape)
    got = tsx.solve_batch(A3, c, rlb, rub, clb, cub, device="cpu")
    shared = tsx.solve_batch(A, c, rlb, rub, clb, cub, device="cpu")
    assert_parity(shared, got, np.float64)
