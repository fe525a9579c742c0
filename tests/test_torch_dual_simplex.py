"""Parity of the port's dual simplex (bensolve_tpu_torch.lp.dual_simplex)
with the JAX package's, including the DUAL_LOST -> primal retry and a
kept-state chain that both packages start from the same state.

Required: equal status and pivot counts; values within the tolerances
of tests/test_torch_simplex.py.
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import dual_simplex as jdx
from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu_torch.convert import kept_state_from_numpy, warm_from_result
from bensolve_tpu_torch.lp import dual_simplex as tdx
from tests.test_ipm import random_lp
from tests.test_revised import _random_instances
from tests.test_torch_simplex import assert_parity


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(args, dtype=np.float64, **kw):
    ref = jdx.solve_batch_dual(*args, dtype=dtype, **kw)
    got = tdx.solve_batch_dual(*args, dtype=dtype, device="cpu", **kw)
    return ref, got


def test_cold_start_falls_back_to_primal():
    """From the all-slack basis with mixed-sign objectives most starts
    are dual infeasible: the retry runs the primal solver."""
    ref, got = both(_random_instances(0, 8, 24, 8))
    assert_parity(ref, got, np.float64)


def test_pure_dual_flags_lost():
    A, c, rlb, rub, clb, cub = _random_instances(2, 6, 18, 4)
    c = -np.abs(c)
    ref, got = both((A, c, rlb, rub, clb, cub), retry_primal=False)
    assert (got.status == jsx.DUAL_LOST).any()
    assert_parity(ref, got, np.float64, values=False)


def test_detects_infeasible():
    A = np.array([[1.0, 1.0]])
    args = (A, np.array([[1.0, 1.0]]), np.array([[3.0]]),
            np.array([[np.inf]]), np.zeros((1, 2)), np.ones((1, 2)))
    ref, got = both(args)
    assert list(got.status) == [jsx.INFEASIBLE]
    assert_parity(ref, got, np.float64, values=False)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_warm_after_row_bound_change(dtype):
    """The Benson P2 re-solve pattern: only row bounds change, so the
    parent's optimal basis stays dual feasible."""
    A, c, rlb, rub, clb, cub = _random_instances(1, 8, 24, 8)
    cold = jsx.solve_batch(A, c, rlb, rub, clb, cub, dtype=dtype)
    assert (cold.status == jsx.OPTIMAL).all()
    ref, got = both((A, c, rlb, rub * 0.9, clb, cub), dtype,
                    start_basis=warm_from_result(cold.basis, cold.at_upper))
    assert_parity(ref, got, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kept_state_chain_from_one_state(dtype):
    """Both packages start a dual-simplex chain from the JAX package's
    kept device tableau, once in order and once with a permuted parent
    mapping; each keeps its own state and takes one more step."""
    A, c, rlb, rub, clb, cub = random_lp(20, 24, 6, seed=9)
    cold = jsx.solve_batch(A, c, rlb, rub, clb, cub, dtype=dtype)
    res2, kept = jdx.solve_batch_dual(
        A, c, rlb, rub * 0.99, clb, cub, dtype=dtype,
        start_basis=(cold.basis, cold.at_upper), keep_state=True)
    assert kept is not None
    mine = kept_state_from_numpy(np.asarray(kept.basis),
                                 np.asarray(kept.in_basis),
                                 np.asarray(kept.at_upper),
                                 np.asarray(kept.W), kept.age, "cpu")
    perm = np.array([1, 0, 3, 2, 5, 4])
    for idx in (np.arange(6), perm):
        args = (A, c[idx], rlb[idx], rub[idx] * 0.97, clb[idx], cub[idx])
        ref, ref_kept = jdx.solve_batch_dual(
            *args, dtype=dtype, start_state=(kept, idx), keep_state=True)
        got, got_kept = tdx.solve_batch_dual(
            *args, dtype=dtype, start_state=(mine, idx), keep_state=True,
            device="cpu")
        assert_parity(ref, got, dtype)
        assert (ref_kept is None) == (got_kept is None)
        if got_kept is not None:
            assert got_kept.age == ref_kept.age
            np.testing.assert_array_equal(got_kept.basis.numpy(),
                                          np.asarray(ref_kept.basis))


def test_chunked_keeps_state():
    A, c, rlb, rub, clb, cub = random_lp(10, 12, 12, seed=4)
    cold = jsx.solve_batch(A, c, rlb, rub, clb, cub)
    args = (A, c, rlb, rub * 0.98, clb, cub)
    warm = (cold.basis, cold.at_upper)
    ref = jdx.solve_batch_dual(*args, start_basis=warm)
    got, kept = tdx.solve_batch_dual(*args, start_basis=warm, max_chunk=4,
                                     keep_state=True, device="cpu")
    assert_parity(ref, got, np.float64)
    assert kept is not None and kept.W.shape[0] == 12
