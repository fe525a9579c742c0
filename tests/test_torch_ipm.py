"""Parity of the port's interior-point method (bensolve_tpu_torch.lp.ipm)
with the JAX package's (bensolve_tpu.lp.ipm) on the CPU.

Every case of tests/test_ipm.py, tests/test_quality.py's quality case,
and the internals a Benson run depends on (one segment of the iteration
from one carry, the warm start with cold rows, chunking and compaction,
the rescue pass with the f64 simplex fallback, the host HiGHS fallback
and its count) go through both packages on the same numpy inputs.
Required at float64: equal status, quality and per-LP iterations; obj,
x, row_dual and col_dual within 1e-8.  At float32: equal status,
iterations within 2, obj within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import ipm as jipm
from bensolve_tpu_torch.lp import ipm as tipm
from bensolve_tpu_torch.lp import simplex as tsx
from bensolve_tpu_torch.lp import solve_batch_auto
from tests.test_ipm import highs_solve, random_lp

TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(args, dtype=np.float64, **kw):
    ref = jipm.solve_batch_ipm(*args, dtype=dtype, **kw)
    got = tipm.solve_batch_ipm(*args, dtype=dtype, device="cpu", **kw)
    return ref, got


def assert_ipm_parity(ref, got, dtype=np.float64):
    np.testing.assert_array_equal(got.status, ref.status)
    assert got.basis is None and got.at_upper is None
    if np.dtype(dtype) == np.dtype(np.float32):
        assert np.abs(got.iters.astype(int) - ref.iters).max() <= 2
        np.testing.assert_allclose(got.obj, ref.obj, rtol=1e-3, atol=1e-3)
        return
    np.testing.assert_array_equal(got.quality, ref.quality)
    np.testing.assert_array_equal(got.iters, ref.iters)
    # values are results only where the LP is OPTIMAL (an UNBOUNDED
    # verdict comes from a diverging iterate)
    ok = ref.status == tsx.OPTIMAL
    for f in ("obj", "x", "s", "row_dual", "col_dual"):
        np.testing.assert_allclose(getattr(got, f)[ok], getattr(ref, f)[ok],
                                   rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("eq_rows,fixed_cols,free_cols", [
    (0, 0, 0), (3, 0, 0), (0, 2, 0), (0, 0, 2), (2, 1, 1)])
def test_bound_patterns_match(eq_rows, fixed_cols, free_cols):
    args = random_lp(24, 40, 4, seed=eq_rows * 7 + fixed_cols * 3
                     + free_cols, eq_rows=eq_rows, fixed_cols=fixed_cols,
                     free_cols=free_cols)
    ref, got = both(args)
    assert_ipm_parity(ref, got)
    for i in range(4):
        hs = highs_solve(*args, i)
        assert hs.status == 0 and got.status[i] == tsx.OPTIMAL
        assert got.obj[i] == pytest.approx(hs.fun, abs=1e-6, rel=1e-6)


def test_duals_match_simplex_convention():
    args = random_lp(12, 20, 2, seed=5)
    A, c = args[0], args[1]
    ref, got = both(args)
    assert_ipm_parity(ref, got)
    res_s = tsx.solve_batch(*args, dtype=np.float64, device="cpu")
    for i in range(2):
        assert got.status[i] == res_s.status[i] == tsx.OPTIMAL
        assert got.obj[i] == pytest.approx(res_s.obj[i], rel=1e-7, abs=1e-6)
        np.testing.assert_allclose(
            got.col_dual[i], c[i] - A.T @ got.row_dual[i], atol=1e-6)
        np.testing.assert_allclose(got.row_dual[i], res_s.row_dual[i],
                                   atol=1e-5)


def test_float32():
    args = random_lp(32, 64, 4, seed=11)
    args32 = tuple(np.asarray(a, np.float32) for a in args)
    ref, got = both(args32, np.float32)
    assert_ipm_parity(ref, got, np.float32)
    for i in range(4):
        assert got.status[i] == tsx.OPTIMAL
        assert got.obj[i] == pytest.approx(highs_solve(*args, i).fun,
                                           abs=2e-3, rel=2e-3)


# (A, c, row_lb, row_ub, col_lb, col_ub, expected status)
TINY = {
    # x1 + x2 <= -1 with x >= 0
    "infeasible": ([[1.0, 1.0]], [[1.0, 1.0]], [[-np.inf]], [[-1.0]],
                   [[0.0, 0.0]], [[np.inf, np.inf]], tsx.INFEASIBLE),
    # min -x1, x1 - x2 <= 1, x >= 0
    "unbounded": ([[1.0, -1.0]], [[-1.0, 0.0]], [[-np.inf]], [[1.0]],
                  [[0.0, 0.0]], [[np.inf, np.inf]], tsx.UNBOUNDED),
    "crossed": ([[1.0, 1.0]], [[1.0, 1.0]], [[-np.inf]], [[4.0]],
                [[2.0, 0.0]], [[1.0, 1.0]], tsx.INFEASIBLE),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_status_classification(name):
    *args, want = TINY[name]
    ref, got = both(tuple(np.array(a) for a in args))
    assert got.status[0] == want
    assert_ipm_parity(ref, got)


def test_p2_template_shape():
    """The Benson oracle's own LP shape (P2 template of a random VLP),
    against the JAX IPM and the port's tableau simplex."""
    from bensolve_tpu.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu.examples import random_vlp

    vlp = random_vlp(q=3, m=12, n=10, seed=3)
    q = 3
    Z = np.eye(q) / (np.eye(q).T @ np.full(q, 1.0 / q))[None, :]
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS)
    V = np.random.default_rng(0).random((6, q)) * 2.0
    args = (t2.A_lp,) + t2.build_inputs(V @ t2.ZR)
    ref, got = both(args)
    assert_ipm_parity(ref, got)
    res_s = tsx.solve_batch(*args, dtype=np.float64, device="cpu")
    ok = res_s.status == tsx.OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(got.obj[ok], res_s.obj[ok], atol=1e-6)
    np.testing.assert_allclose(got.row_dual[ok], res_s.row_dual[ok],
                               atol=1e-4)


def test_warm_interior_start():
    A, c, rlb, rub, clb, cub = random_lp(12, 18, 4, seed=21, free_cols=2)
    cold = tipm.solve_batch_ipm(A, c, rlb, rub, clb, cub, dtype=np.float64,
                                device="cpu")
    assert (cold.status == tsx.OPTIMAL).all()
    rub2 = rub * 0.995
    _, cold2 = both((A, c, rlb, rub2, clb, cub))
    wi = (cold.x[0], cold.s[0], cold.row_dual[0])
    ref, warm2 = both((A, c, rlb, rub2, clb, cub), warm_interior=wi)
    assert_ipm_parity(ref, warm2)
    assert (warm2.status == tsx.OPTIMAL).all()
    np.testing.assert_allclose(warm2.obj, cold2.obj, rtol=1e-6, atol=1e-6)
    assert int(warm2.iters[0]) <= int(cold2.iters[0])


def test_host_highs_duals_match():
    A, c, rlb, rub, clb, cub = random_lp(14, 20, 3, seed=13, eq_rows=3,
                                         fixed_cols=2, free_cols=2)
    rlb = rlb.copy()
    rlb[:, 5:8] = rub[:, 5:8] - 2.0       # two-sided rows
    ref = tsx.solve_batch(A, c, rlb, rub, clb, cub, device="cpu")
    for i in range(3):
        got = tipm._host_highs_one(tipm._sparse_A(A), c[i], rlb[i], rub[i],
                                   clb[i], cub[i])
        want = jipm._host_highs_one(jipm._sparse_A(A), c[i], rlb[i],
                                    rub[i], clb[i], cub[i])
        assert got[0] == want[0] == tsx.OPTIMAL
        assert got[1] == pytest.approx(ref.obj[i], abs=1e-8)
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        assert np.abs(c[i] - got[4] @ A - got[5]).max() < 1e-9
        np.testing.assert_allclose(got[4], ref.row_dual[i], atol=1e-7)


def test_reports_quality():
    args = random_lp(12, 18, 4, seed=3)
    ref, got = both(args)
    assert_ipm_parity(ref, got)
    assert got.quality.shape == (4,)
    assert (got.status == tsx.OPTIMAL).all() and (got.quality == 0).all()


def _core_inputs(seed, B=4, M=10, N=16, free_cols=2):
    """(A, c, l, u, split) in the iteration's layout z = (x, s): the
    free columns split as solve_batch_ipm splits them (no scaling)."""
    A, c, rlb, rub, clb, cub = random_lp(M, N, B, seed=seed,
                                         free_cols=free_cols)
    free = np.arange(N - free_cols, N)
    A2 = np.concatenate([A, -A[:, free]], axis=1)
    cx = np.concatenate([c, -c[:, free]], axis=1)
    lx = np.concatenate([clb, np.zeros((B, free.size))], axis=1)
    lx[:, free] = 0.0
    ux = np.concatenate([cub, np.full((B, free.size), np.inf)], axis=1)
    split = np.stack([free, np.arange(N, N + free.size)], axis=1)
    return (A2, np.concatenate([cx, np.zeros((B, M))], axis=1),
            np.concatenate([lx, rlb], axis=1),
            np.concatenate([ux, rub], axis=1), split)


def _assert_carries_close(jc, tc, tol):
    assert len(jc) == len(tc)
    for k, (a, b) in enumerate(zip(jc, tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=tol,
                                   atol=tol, err_msg=f"carry[{k}]")


@pytest.mark.parametrize("seg,tol", [(5, 1e-10), (60, 1e-6)])
def test_one_segment_of_the_iteration(seg, tol):
    """From the same cold carry, one segment of at most ``seg``
    iterations: equal status and iterations, every carry entry within
    1e-10 after 5 iterations.  A 60-iteration segment runs every
    instance to convergence, where the Newton systems are ill
    conditioned and last-bit differences of the products grow to
    ~1e-7 in the final iterates: there 1e-6."""
    A, c, l, u, split = _core_inputs(seed=4)
    M = A.shape[0]
    jc = jipm._ipm_init_jit(c, l, u, M)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (A, c, l, u)]
    tc = tipm._ipm_init(t[1], t[2], t[3], M)
    _assert_carries_close(jc, tc, 0)
    jc = jipm._ipm_seg_jit(A, c, l, u, split.astype(np.int32), jc, seg, 800)
    tc, steps = tipm._ipm_core(t[0], t[1], t[2], t[3],
                               torch.from_numpy(split), tc, seg, 800)
    assert steps == int(np.asarray(jc[7]).max()) <= seg
    np.testing.assert_array_equal(tc[6].numpy(), np.asarray(jc[6]))
    np.testing.assert_array_equal(tc[7].numpy(), np.asarray(jc[7]))
    _assert_carries_close(jc, tc, tol)


def test_warm_init_with_cold_rows():
    """A NaN row of the carried point starts that instance cold; the
    others start WARM_MARGIN inside their boxes at mu = WARM_MU0."""
    A, c, l, u, _ = _core_inputs(seed=6)
    M = A.shape[0]
    rng = np.random.default_rng(0)
    z0 = np.clip(rng.random(c.shape) * 3.0, l, u)
    y0 = rng.standard_normal((c.shape[0], M))
    z0[1, 3] = np.nan
    y0[2, 0] = np.nan
    jc = jipm._ipm_warm_init_jit(c, l, u, z0, y0, M)
    tc = tipm._ipm_warm_init(*(torch.from_numpy(a) for a in (c, l, u, z0,
                                                             y0)), M)
    # one ulp: XLA may round the divisions WARM_MU0 / p differently
    _assert_carries_close(jc, tc, 1e-15)
    mu0 = tc[8].numpy()
    assert mu0[1] == mu0[2] == 1.0 and mu0[0] == mu0[3] == tipm.WARM_MU0
    cold = tipm._ipm_init(*(torch.from_numpy(a) for a in (c, l, u)), M)
    np.testing.assert_array_equal(tc[0][1].numpy(), cold[0][1].numpy())


def test_chunked_and_compacted(monkeypatch):
    """max_chunk=2 over B=5 (chunks of 2, 2 and a padded 1) with 3-step
    segments, so the straggler cap, the freeze and compaction are
    decided at many boundaries."""
    monkeypatch.setenv("BENSOLVE_IPM_SEG", "3")
    args = random_lp(16, 24, 5, seed=8, eq_rows=2, free_cols=1)
    ref, got = both(args, max_chunk=2)
    assert_ipm_parity(ref, got)
    assert tipm.LAST["chunks"] == 3


def test_compaction_with_a_straggler(monkeypatch, capsys):
    """One instance of the equality-row batch outlives the rest by
    several 4-iteration segments: the batch compacts around it, and the
    straggler cap and the per-instance freeze are decided at the same
    boundaries in both packages."""
    monkeypatch.setenv("BENSOLVE_IPM_SEG", "4")
    args = random_lp(24, 40, 4, seed=21, eq_rows=3)
    ref, got = both(args, verbose=2)
    assert_ipm_parity(ref, got)
    out = capsys.readouterr().out.split("lp_solve[ipm]: solving chunk")
    assert "compacted batch to 1" in out[-1]
    assert got.iters.max() > 2 * got.iters.min()


def test_rescue_and_simplex_fallback(monkeypatch):
    """BENSOLVE_HOST_FALLBACK=0 with a tiny budget: capped instances get
    the rescue pass, and what it leaves goes to the f64 simplex on the
    same device; both packages end with the same exact solutions."""
    monkeypatch.setenv("BENSOLVE_HOST_FALLBACK", "0")
    monkeypatch.setenv("BENSOLVE_IPM_MAXIT", "4")
    args = random_lp(12, 18, 4, seed=3)
    calls = tipm.CALLS
    ref, got = both(args)
    assert tipm.CALLS > calls + 1          # the rescue pass ran
    assert (got.status == tsx.OPTIMAL).all()
    assert_ipm_parity(ref, got)
    res_s = tsx.solve_batch(*args, dtype=np.float64, device="cpu")
    np.testing.assert_allclose(got.obj, res_s.obj, rtol=1e-9, atol=1e-9)


def test_host_fallback_count(monkeypatch):
    """Both packages hand the same LPs to host HiGHS: the port counts
    them in ipm.HOST_FALLBACK, the JAX side through a wrapper here."""
    monkeypatch.setenv("BENSOLVE_IPM_MAXIT", "4")
    jax_calls = []
    real = jipm._host_highs_one

    def counted(*a, **kw):
        jax_calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jipm, "_host_highs_one", counted)
    args = random_lp(12, 18, 4, seed=3)
    before = tipm.HOST_FALLBACK
    ref, got = both(args)
    assert tipm.HOST_FALLBACK - before == len(jax_calls) > 0
    assert tipm.LAST["host_fallback"] == len(jax_calls)
    assert tipm.HOST_FALLBACK_SECONDS > 0
    assert_ipm_parity(ref, got)


@pytest.mark.parametrize("how", ["ipm_min", "env"])
def test_router_takes_the_ipm(how, monkeypatch):
    """ipm_min or BENSOLVE_IPM_MIN sends a batch with M + N at the
    threshold to the IPM, ahead of the kernel's route."""
    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    args = random_lp(12, 18, 4, seed=3)
    kw = {"ipm_min": 30}
    if how == "env":
        monkeypatch.setenv("BENSOLVE_IPM_MIN", "30")
        kw = {}
    calls = tipm.CALLS
    got = solve_batch_auto(*args, dtype=np.float64, device="cpu", **kw)
    assert tipm.CALLS == calls + 1 and got.basis is None
    ref = jipm.solve_batch_ipm(*args, dtype=np.float64)
    assert_ipm_parity(ref, got)
    monkeypatch.setenv("BENSOLVE_IPM_MIN", "31")
    res = solve_batch_auto(*args, dtype=np.float64, device="cpu")
    assert tipm.CALLS == calls + 1 and res.basis is not None


def test_template_carries_its_interior_point(monkeypatch):
    """bench.py's round pattern through both packages' P2 templates:
    the clean interior point of one round starts every LP of the next
    (the JAX package's rule), per-candidate parents pass through, and
    every round gives the JAX template's results."""
    from bensolve_tpu.algs.templates import INHOMOGENEOUS as JINH
    from bensolve_tpu.algs.templates import P2Template as JP2
    from bensolve_tpu.examples import random_vlp as jrandom_vlp
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu_torch.examples import random_vlp

    seen = []
    real = tipm.solve_batch_ipm

    def spy(*a, **kw):
        seen.append(kw.get("warm_interior"))
        return real(*a, **kw)

    monkeypatch.setattr(tipm, "solve_batch_ipm", spy)
    q = 3
    Z = np.eye(q) / (np.eye(q).T @ np.full(q, 1.0 / q))[None, :]
    vlp, jvlp = random_vlp(q=q, m=12, n=10, seed=3), jrandom_vlp(
        q=q, m=12, n=10, seed=3)
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS, dtype=np.float64, ipm_min=1,
                    device="cpu")
    j2 = JP2(jvlp, jvlp.P.astype(float), Z, np.full(q, 1.0 / q), JINH,
             dtype=np.float64, ipm_min=1)
    ub = np.random.default_rng(0).random((6, q)) * 2.0 @ t2.ZR
    carried = []
    for u, parents in ((ub, None), (ub * 0.998, None),
                       (ub[:1] * 0.996, None), (ub[:2] * 0.994, 0)):
        start = None
        if parents is not None:
            # per-candidate parents: the first round's points of LPs 0-1
            start = ("interior", first.x[:2], first.s[:2],
                     first.row_dual[:2])
        got = t2.solve(u, start_basis=start)
        ref = j2.solve(u, start_basis=start)
        assert_ipm_parity(ref, got)
        carried.append(t2._warm_interior)
        if len(carried) == 1:
            first = got
    assert seen[0] is None
    for k in (1, 2):
        assert all(a is b for a, b in zip(seen[k], carried[k - 1]))
    assert seen[3][0].shape == (2, t2.n + q + 1)
