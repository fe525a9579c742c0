"""Parity of the port's many-VLP lockstep engine and of its
per-instance-matrix LP batches with the JAX package's, on the CPU.

LP level: random (B, M, N) batches, every LP with its own matrix, go
through ``bensolve_tpu.lp.simplex.solve_batch`` and the port's: cold,
from a shared warm basis, from per-instance warm bases, and chunked.
Required: equal status and pivot count per LP; obj, x, row_dual and
col_dual within 1e-9 at float64 and 1e-4 at float32 (float32 rounding
through a few dozen rank-1 updates and the final LU, which the packages
sum in different orders).

Engine level: every case of tests/test_many.py that needs no mesh runs
through ``solve_many`` of both packages.  Required per instance: equal
status, equal LP and round counts, vertex sets within 1e-7, and the
port's lockstep result equal to the port's serial ``solve``.
"""

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu import examples
from bensolve_tpu.algs.many import solve_many as jax_solve_many
from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu.vlp.problem import VLPProblem as JaxVLPProblem
from bensolve_tpu_torch.algs import many as tmany
from bensolve_tpu_torch.convert import problems_from_reference
from bensolve_tpu_torch.lp import simplex as tsx

TOL = {np.float64: 1e-9, np.float32: 1e-4}
DTYPES = [np.float64, np.float32]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_batch_3d(seed, B=12, M=7, N=11):
    """B feasible, bounded LPs, each with its own (M, N) matrix."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = np.einsum("bmn,bn->bm", A, x0) + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    return (A, c, np.full((B, M), -np.inf), b, np.zeros((B, N)),
            np.full((B, N), 10.0))


def assert_lp_parity(ref, got, dtype):
    np.testing.assert_array_equal(ref.status, got.status)
    ok = ref.status == jsx.OPTIMAL
    assert ok.any()
    if dtype is np.float64:
        np.testing.assert_array_equal(ref.iters, got.iters)
    tol = TOL[dtype]
    for field in ("obj", "x", "row_dual", "col_dual"):
        np.testing.assert_allclose(getattr(got, field)[ok],
                                   getattr(ref, field)[ok],
                                   rtol=tol, atol=tol, err_msg=field)


def both(args, dtype, **kw):
    ref = jsx.solve_batch(*args, dtype=dtype, **kw)
    got = tsx.solve_batch(*args, dtype=dtype, device="cpu", **kw)
    return ref, got


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_3d_cold_parity(seed, dtype):
    assert_lp_parity(*both(random_batch_3d(seed), dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_3d_shared_warm_basis_parity(dtype):
    """One basis for the whole batch is still one factorization per
    instance when every LP has its own matrix."""
    args = random_batch_3d(2)
    cold = jsx.solve_batch(*args, dtype=dtype)
    i = int(np.flatnonzero(cold.status == jsx.OPTIMAL)[0])
    changed = list(args)
    changed[3] = args[3] * 1.05
    ref, got = both(changed, dtype,
                    start_basis=(cold.basis[i], cold.at_upper[i]))
    assert_lp_parity(ref, got, dtype)
    assert ref.iters.max() > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_3d_per_instance_warm_bases_parity(dtype):
    args = random_batch_3d(3)
    cold = jsx.solve_batch(*args, dtype=dtype)
    changed = list(args)
    changed[3] = args[3] * 0.97
    ref, got = both(changed, dtype,
                    start_basis=(cold.basis, cold.at_upper))
    assert_lp_parity(ref, got, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_3d_chunked_parity_and_chunk_independence(dtype):
    """max_chunk=8 splits 20 LPs into chunks of 8, 8 and 4 in both
    packages; an LP's result does not depend on its chunk."""
    args = random_batch_3d(4, B=20)
    ref, got = both(args, dtype, max_chunk=8)
    assert_lp_parity(ref, got, dtype)
    whole = tsx.solve_batch(*args, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(whole.status, got.status)
    np.testing.assert_array_equal(whole.iters, got.iters)
    np.testing.assert_array_equal(whole.basis, got.basis)
    np.testing.assert_array_equal(whole.obj, got.obj)


def test_3d_mixed_statuses_parity():
    """Optimal, infeasible (crossed bounds) and unbounded LPs in one
    per-instance batch end with the statuses the JAX package gives."""
    A, c, rlb, rub, clb, cub = random_batch_3d(5, B=6)
    clb[1, 0], cub[1, 0] = 3.0, 1.0            # crossed: infeasible
    cub[2] = np.inf                            # free to grow
    A[2] = -np.abs(A[2])
    c[2] = -1.0                                # unbounded
    ref, got = both((A, c, rlb, rub, clb, cub), np.float64)
    np.testing.assert_array_equal(ref.status, got.status)
    assert ref.status[1] == jsx.INFEASIBLE
    assert ref.status[2] == jsx.UNBOUNDED
    assert_lp_parity(ref, got, np.float64)


def test_3d_batch_size_mismatch_raises():
    A, c, rlb, rub, clb, cub = random_batch_3d(0, B=4)
    with pytest.raises(ValueError, match="batch"):
        tsx.solve_batch(A, c[:3], rlb[:3], rub[:3], clb[:3], cub[:3],
                        device="cpu")


def test_3d_path_leaves_the_shared_matrix_cache_alone():
    before = dict(tsx._A_CACHE)
    tsx.solve_batch(*random_batch_3d(6), device="cpu")
    assert dict(tsx._A_CACHE) == before


def test_3d_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsx.solve_batch(*random_batch_3d(0), device="cuda")


# ---------------------------------------------------------------- engine

def random_bounded_vlps(n, q=2, m=4, nn=6, seed=0):
    """tests/test_many.py's random box-constrained minimization VLPs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        P = rng.standard_normal((q, nn))
        A = rng.standard_normal((m, nn))
        x0 = rng.random(nn)
        a = A @ x0 + 0.5 + rng.random(m)
        out.append(JaxVLPProblem.from_arrays(
            P=P, A=A, b=a, l=np.zeros(nn), s=np.full(nn, 2.0)))
    return out


def heterogeneous_vlps():
    """tests/test_many.py's three shapes, four instances each."""
    vlps = []
    for s in range(4):
        vlps.append(examples.random_vlp(q=2, m=6, n=5, seed=s))
        vlps.append(examples.random_vlp(q=3, m=10, n=8, seed=100 + s))
        vlps.append(examples.random_vlp(q=2, m=4, n=9, seed=200 + s))
    return vlps


def _points(r):
    return np.array(sorted(map(tuple, r.primal_points)))


def assert_same_solution(a, b, counts=True):
    assert a.status.name == b.status.name
    if counts:
        assert (a.stats.lps, a.stats.rounds) == (b.stats.lps,
                                                 b.stats.rounds)
    if a.status.name == "OPTIMAL":
        pa, pb = _points(a), _points(b)
        assert pa.shape == pb.shape
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-7)


def run_both(vlps, **kw):
    ref = jax_solve_many(vlps, JaxOptions(write_files=False, **kw))
    got = tmany.solve_many(
        problems_from_reference(vlps),
        bt.Options(write_files=False, device="cpu", **kw))
    assert len(ref) == len(got) == len(vlps)
    return ref, got


def _serial(vlp, **kw):
    return bt.solve(problems_from_reference([vlp])[0],
                    bt.Options(write_files=False, device="cpu", **kw))


def test_solve_many_matches_jax_and_serial():
    vlps = random_bounded_vlps(24)
    ref, got = run_both(vlps, bounded=True)
    for vlp, a, b in zip(vlps, ref, got):
        assert_same_solution(a, b)
        # the serial solve() warm-starts and batches otherwise: same set,
        # other counts
        assert_same_solution(_serial(vlp, bounded=True), b, counts=False)


def test_solve_many_unbounded_fallback():
    """Non-bounded options fall back to the per-instance pipeline."""
    vlps = random_bounded_vlps(3, seed=5)
    ref, got = run_both(vlps)
    for vlp, a, b in zip(vlps, ref, got):
        assert b.status.name == "OPTIMAL"
        assert_same_solution(a, b)
        assert_same_solution(_serial(vlp), b)


def test_solve_many_scale_smoke():
    """200 instances in lockstep: all OPTIMAL, each equal to the JAX
    package's, three of them equal to the port's serial solve()."""
    vlps = random_bounded_vlps(200, seed=7)
    ref, got = run_both(vlps, bounded=True)
    assert sum(r.status.name == "OPTIMAL" for r in got) == 200
    for a, b in zip(ref, got):
        assert_same_solution(a, b)
    for i in (0, 99, 199):
        assert_same_solution(_serial(vlps[i], bounded=True), got[i],
                             counts=False)


def test_solve_many_heterogeneous_groups_ep():
    """Instances of three shapes form three lockstep groups that advance
    on one thread each."""
    vlps = heterogeneous_vlps()
    ref, got = run_both(vlps, bounded=True)
    assert all(r.status.name == "OPTIMAL" for r in got)
    for a, b in zip(ref, got):
        assert_same_solution(a, b)
    for i in (0, 1, 2, 9, 10, 11):
        assert_same_solution(_serial(vlps[i], bounded=True), got[i],
                             counts=False)


def test_solve_many_groups_are_deterministic_under_thread_switching():
    """More groups than cores and a short switch interval: the grouped
    run still equals the one-group-at-a-time run, instance by instance
    (the threads share no state that a lost update could break)."""
    import sys

    vlps = problems_from_reference(heterogeneous_vlps())
    opt = bt.Options(write_files=False, device="cpu", bounded=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        grouped = tmany.solve_many(vlps, opt)
    finally:
        sys.setswitchinterval(old)
    for k in range(3):
        alone = tmany.solve_many(vlps[k::3], opt)
        for a, b in zip(alone, grouped[k::3]):
            assert_same_solution(a, b)
            np.testing.assert_array_equal(_points(a), _points(b))


def test_solve_many_float32():
    """lp_dtype float32 reaches the 3-D tableau path at float32 (never
    the kernel's route): vertex sets within 1e-4 of the float64 run."""
    vlps = problems_from_reference(random_bounded_vlps(6, seed=11))
    kw = dict(write_files=False, device="cpu", bounded=True)
    f64 = tmany.solve_many(vlps, bt.Options(**kw))
    f32 = tmany.solve_many(vlps, bt.Options(
        lp_dtype="float32", eps_benson_phase2=1e-4, **kw))
    for a, b in zip(f64, f32):
        assert a.status.name == b.status.name == "OPTIMAL"
        pa, pb = _points(a), _points(b)
        d = np.abs(pa[:, None, :] - pb[None, :, :]).max(axis=2)
        assert d.min(axis=1).max() <= 1e-4 and d.min(axis=0).max() <= 1e-4


def test_solve_many_infeasible_instance():
    """An infeasible instance ends INFEASIBLE in both packages and
    leaves its neighbours' results alone."""
    vlps = random_bounded_vlps(4, seed=13)
    bad = vlps[2]
    bad.rows.ub[:] = -50.0       # A x <= -50 with 0 <= x <= 2
    bad.rows.lb[:] = -np.inf
    ref, got = run_both(vlps, bounded=True)
    assert got[2].status.name == ref[2].status.name == "INFEASIBLE"
    for i in (0, 1, 3):
        assert_same_solution(ref[i], got[i])


def test_solve_many_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vlps = problems_from_reference(random_bounded_vlps(2))
    with pytest.raises(RuntimeError, match="cuda"):
        tmany.solve_many(vlps, bt.Options(bounded=True))


def test_merged_solve_goes_straight_to_the_tableau_simplex(monkeypatch):
    """_merged_solve hands one stacked (sum B_i, M, N) batch to
    simplex.solve_batch at opt.lp_dtype on opt.device."""
    seen = []
    real = tsx.solve_batch

    def spy(A, *a, **kw):
        seen.append((np.shape(A), kw["dtype"], kw["device"]))
        return real(A, *a, **kw)

    monkeypatch.setattr(tmany.sx, "solve_batch", spy)
    vlps = problems_from_reference(random_bounded_vlps(5, seed=17))
    tmany.solve_many(vlps, bt.Options(write_files=False, device="cpu",
                                      bounded=True))
    assert seen and all(len(s[0]) == 3 for s in seen)
    assert seen[0][0][0] == 5 * 2          # seed round: r = q LPs each
    assert {s[1] for s in seen} == {np.float64}
    assert {s[2] for s in seen} == {"cpu"}
