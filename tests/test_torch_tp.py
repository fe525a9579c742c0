"""The port's "tp" mesh axis (parallel/mesh.py's PanelLayout and
exchanges, the panelled tableau and revised simplex) against the
unsplit port and the JAX package's tp-sharded solves, on the CPU.

The port's mesh entries repeat the one CPU; the JAX package runs on
conftest's 8 virtual CPU devices.  Required:

* the exchanges give what torch.argmax / argmin give over whole rows;
* against the port's unsplit solve: equal status, pivots and basis per
  LP, objective values within 1e-12 (partial sums across panels round
  in another order);
* against the JAX package's tp-sharded solve: objective rtol 1e-8, row
  duals rtol 1e-7 (tests/test_sharding.py).
"""

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve as jax_solve
from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu.parallel import mesh as jmesh
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu_torch.convert import problem_from_reference
from bensolve_tpu_torch.lp import revised
from bensolve_tpu_torch.lp import simplex as tsx
from bensolve_tpu_torch.parallel import mesh as pmesh
from tests.test_sharding import _tall_instances


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n, axes=("tp",)):
    return pmesh.make_mesh(n, axes, device="cpu")


def canon(a):
    return sorted(map(tuple, np.round(a, 9)))


def assert_same_lps(ref, got, obj_tol=1e-12):
    for f in ("status", "iters", "basis", "at_upper"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    for f in ("obj", "x", "row_dual", "col_dual"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=obj_tol, err_msg=f)


def square_lps(M=24, N=40, B=8, seed=0):
    """Random feasible LPs in solve_batch argument form (x in [0, 10],
    rows bounded above)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = x0 @ A.T + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    return (A, c, np.full((B, M), -np.inf), b, np.zeros((B, N)),
            np.full((B, N), 10.0))


@pytest.fixture
def splits(monkeypatch):
    """The panels of every tp solve, by route."""
    seen = []
    real = pmesh.record_split

    def record(route, panels, steps):
        seen.append((route, panels))
        real(route, panels, steps)

    monkeypatch.setattr(pmesh, "record_split", record)
    return seen


# ------------------------------------------------------------ exchanges

def _panel_rows(x, T):
    """Cut (B, n) rows into T contiguous panels as PanelLayout(0, n, T)
    cuts structural columns: (values, global indices) per panel."""
    lay = pmesh.PanelLayout(0, x.shape[1], T)
    return [(p, lay.gidx(k, "cpu")) for k, p in
            enumerate(lay.split(x, -float("inf")))]


@pytest.mark.parametrize("T", [2, 3, 5])
def test_combine_best_is_argmax_and_argmin(T):
    """Each panel's first maximum, combined, is torch.argmax over the
    whole row: ties go to the smallest index, rows without an eligible
    column (all -inf) to index 0; Bland's smallest eligible index is the
    argmax of -index; argmin is the argmax of the negated row."""
    rng = np.random.default_rng(T)
    B, n = 12, 17
    x = torch.from_numpy(rng.integers(0, 4, (B, n)).astype(np.float64))
    x[3] = 2.0                                   # one tie over the row
    x[4] = -float("inf")                         # nothing eligible
    x[5, ::3] = -float("inf")
    elig = torch.from_numpy(rng.random((B, n)) < 0.3)
    elig[4] = False
    lane = torch.arange(n, dtype=torch.float64)
    bland = torch.where(elig, -lane, torch.full_like(lane, -float("inf")))
    for rows, want in ((x, x.argmax(dim=1)), (-x, x.argmin(dim=1)),
                       (bland, torch.where(elig.any(dim=1),
                                           elig.to(torch.int8).argmax(dim=1),
                                           0))):
        vals, gidx = [], []
        for p, g in _panel_rows(rows, T):
            loc = p.argmax(dim=1)
            vals.append(p.gather(1, loc[:, None])[:, 0])
            gidx.append(g[loc])
        winner, q = pmesh.combine_best(vals, gidx, torch.device("cpu"))
        np.testing.assert_array_equal(q.numpy(), want.numpy())
        np.testing.assert_array_equal(
            q.numpy(), torch.stack(gidx)[winner, torch.arange(B)].numpy())
    assert pmesh.combine_best(vals, gidx, torch.device("cpu"))[1][4] == 0


def test_select_gather_reduce():
    """select_by_owner picks each LP's part from its winner; all_gather
    concatenates in panel order; all_reduce sums in panel order."""
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.standard_normal((6, 4))) for _ in range(3)]
    winner = torch.tensor([0, 2, 1, 1, 0, 2])
    got = pmesh.select_by_owner(parts, winner, torch.device("cpu"))
    want = torch.stack(parts)[winner, torch.arange(6)]
    assert torch.equal(got, want)
    devs = [torch.device("cpu")] * 3
    g = pmesh.all_gather(parts, devs)
    assert len(g) == 3 and torch.equal(g[2], torch.cat(parts, dim=1))
    r = pmesh.all_reduce(parts, devs)
    assert torch.equal(r[1], parts[0] + parts[1] + parts[2])
    assert [t.device for t in pmesh.to_all(parts[0], devs)] == devs


@pytest.mark.parametrize("Mp, Np, T", [(24, 40, 8), (16, 40, 3), (8, 64, 2),
                                       (9, 5, 4)])
def test_panel_layout_round_trip(Mp, Np, T):
    """split/join are inverses; every real column is owned by exactly one
    panel, at the local index its global index maps to; pad columns are
    numbered past Mp + Np."""
    lay = pmesh.PanelLayout(Mp, Np, T)
    NT = Mp + Np
    x = torch.arange(3 * NT, dtype=torch.float64).reshape(3, NT)
    parts = lay.split(x, -1.0)
    assert all(p.shape == (3, lay.width) for p in parts)
    assert torch.equal(lay.join(parts), x)
    g = torch.arange(NT)
    owners = torch.zeros(NT, dtype=torch.int64)
    for k, p in enumerate(parts):
        gk = lay.gidx(k, "cpu")
        real = gk < NT
        assert torch.equal(p[0, real], x[0, gk[real]])
        assert (p[:, ~real] == -1).all()
        loc, own = lay.local(g, k)
        owners += own
        assert torch.equal(gk[loc[own]], g[own])
    assert (owners == 1).all()
    v = torch.arange(2 * Mp, dtype=torch.float64).reshape(2, Mp)
    assert torch.equal(sum(lay.place_rows(lay.rows(v, k), k)
                           for k in range(T)), v)


def test_mesh_rows():
    """A dp row per dp entry, its tp entries in order, the lead first."""
    m = cpu_mesh(8, ("dp", "tp"))
    rows = pmesh.mesh_rows(m)
    assert [len(r) for r in rows] == [2, 2, 2, 2]
    assert [r[0] for r in rows] == pmesh.shard_entries(m, "dp")
    assert pmesh.mesh_rows(cpu_mesh(4)) == [tuple(cpu_mesh(4).devices)]
    assert [len(r) for r in pmesh.mesh_rows(cpu_mesh(3, ("dp",)))] == [1] * 3
    assert pmesh.mesh_rows(cpu_mesh(8, ("tp", "dp"))) == [
        tuple(r) for r in cpu_mesh(8, ("tp", "dp")).devices.T]


# ------------------------------------------------------- tableau route

@pytest.mark.parametrize("n", [2, 3, 8])
def test_tp_tableau_matches_unsplit(n, splits):
    """The tableau simplex over ("tp",) x n: the same pivots as the
    unsplit port; n = 3 leaves NT = 64 indivisible (pad columns)."""
    args = square_lps()
    plain = tsx.solve_batch(*args, device="cpu")
    got = tsx.solve_batch(*args, device="cpu", mesh=cpu_mesh(n))
    assert [len(p) for r, p in splits] == [n]
    assert splits[0][0] == "tableau"
    assert (plain.status == tsx.OPTIMAL).all()
    assert_same_lps(plain, got)
    if n == 3:
        assert n * splits[0][1][0].W.shape[2] > 64


@pytest.mark.parametrize("n", [2, 8])
def test_tp_tableau_matches_jax(n):
    """Against the JAX package's solve_batch(mesh=make_mesh(n, ("tp",))):
    equal status, objective rtol 1e-8, row duals rtol 1e-7."""
    args = square_lps()
    got = tsx.solve_batch(*args, device="cpu", mesh=cpu_mesh(n))
    ref = jsx.solve_batch(*args, mesh=jmesh.make_mesh(n, ("tp",)))
    np.testing.assert_array_equal(got.status, ref.status)
    np.testing.assert_allclose(got.obj, ref.obj, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.row_dual, ref.row_dual, rtol=1e-7,
                               atol=1e-9)


@pytest.mark.parametrize("shared", [False, True])
def test_tp_tableau_warm_start(shared):
    """A warm start over ("dp", "tp") = 2 x 2, per-instance or shared:
    the basis is gathered from its owning panels and factored once."""
    args = square_lps(seed=2)
    first = tsx.solve_batch(*args, device="cpu")
    moved = list(args)
    moved[3] = args[3] * 1.1
    warm = ((first.basis[0], first.at_upper[0]) if shared
            else (first.basis, first.at_upper))
    plain = tsx.solve_batch(*moved, device="cpu", start_basis=warm)
    got = tsx.solve_batch(*moved, device="cpu", start_basis=warm,
                          mesh=cpu_mesh(4, ("dp", "tp")))
    assert_same_lps(plain, got)
    assert plain.iters.sum() < first.iters.sum()


def test_tp_sharded_round_matches_unsplit():
    """solve_batch_sharded over ("dp", "tp") = 4 x 2 and ("tp",) x 1 as
    the JAX package splits them: equal to the one-device solve."""
    A, c, rlb, rub, clb, cub = square_lps(B=8)
    M = A.shape[0]
    full_c = np.concatenate([np.zeros((8, M)), c], 1)
    lb = np.concatenate([rlb, clb], 1)
    ub = np.concatenate([rub, cub], 1)
    put = lambda a: tsx._put(a, torch.device("cpu"))  # noqa: E731
    one = tsx._solve_tableau_segmented(put(A), put(full_c), put(lb), put(ub),
                                       None, None, 1000)
    one = tsx.LPResult(*(o.numpy() for o in one))
    got = tsx.LPResult(*pmesh.solve_batch_sharded(
        cpu_mesh(8, ("dp", "tp")), A, full_c, lb, ub, max_iter=1000))
    assert_same_lps(one, got)


# ------------------------------------------------------- revised route

def test_tp_revised_perturbed_and_warm(monkeypatch, splits):
    """The revised route over ("tp",) x 3 through the two-stage
    anti-degeneracy solve (PERTURB_MIN_M lowered to reach it at a small
    size) and a warm re-solve: the unsplit port's pivots."""
    monkeypatch.setattr(revised, "PERTURB_MIN_M", 8)
    args = _tall_instances(12, 100, 6)
    plain = revised.solve_batch_revised(*args, device="cpu")
    got = revised.solve_batch_revised(*args, device="cpu", mesh=cpu_mesh(3))
    assert_same_lps(plain, got)
    moved = list(args)
    moved[3] = args[3] * 1.05
    warm = (plain.basis, plain.at_upper)
    p2 = revised.solve_batch_revised(*moved, device="cpu", start_basis=warm)
    g2 = revised.solve_batch_revised(*moved, device="cpu", start_basis=warm,
                                     mesh=cpu_mesh(3))
    assert_same_lps(p2, g2)
    assert [r for r, _ in splits] == ["revised", "revised"]


def test_tp_revised_refactor_reset_matches_unsplit():
    """The refactorization's singular-basis reset over panels: an LP
    whose basis rows hold a NaN resets to the slack basis, the others
    keep theirs, as _refactor does on the unsplit state."""
    A, c, rlb, rub, clb, cub = _tall_instances(8, 64, 4)
    prep = tsx._prepare_A(A, np.float64, "cpu")
    full_c, lb, ub = tsx._pad_batch_inputs(prep, c, rlb, rub, clb, cub, 4,
                                           np.float64)
    basis0 = np.tile(np.arange(8), (4, 1))
    basis0[:, 3] = 8 + 5
    brows = revised._host_brows(prep, basis0, np.float64)
    brows[1, 2, 0] = np.nan
    put = lambda a: tsx._put(a, torch.device("cpu"))  # noqa: E731
    c_t, lb_t, ub_t, b_t, br_t = map(put, (full_c, lb, ub, basis0, brows))
    st = revised._initial_rstate(prep.dev, c_t, lb_t, ub_t, b_t, None, br_t)
    st = revised._refactor(prep.dev, c_t, lb_t, ub_t, st)
    lay = pmesh.PanelLayout(prep.Mp, prep.Np, 2)
    devs = (torch.device("cpu"),) * 2
    panels = pmesh.a_panels(prep, lay, [devs], transposed=True)
    ts = revised._tp_initial_rstate(lay, devs, panels, c_t, lb_t, ub_t, b_t,
                                    None, br_t)
    ts = revised._tp_refactor(ts)
    assert st.resets.tolist() == ts.lead.resets.tolist() == [0, 1, 0, 0]
    assert torch.equal(ts.lead.basis, st.basis)
    torch.testing.assert_close(ts.lead.xb, st.xb, rtol=0, atol=1e-12)
    for name in ("in_basis", "at_upper"):
        joined = lay.join([getattr(p, name) for p in ts.panels])
        assert torch.equal(joined, getattr(st, name)), name
    for name in ("Binv", "Brows"):
        joined = torch.cat([getattr(p, name) for p in ts.panels], dim=2)
        torch.testing.assert_close(joined[:, :, :lay.Mp], getattr(st, name),
                                   rtol=0, atol=1e-12)


# ------------------------------------------------------------ end to end

def test_example05_over_tp_end_to_end():
    """example05 with mesh_axes=("tp",) x 4: point sets equal to the
    unsplit port's and to the JAX package's tp-sharded solve."""
    vlp = examples.example05()
    ref = jax_solve(vlp, JaxOptions(write_files=False, mesh_axes=("tp",)))
    plain = bt.solve(problem_from_reference(vlp),
                     bt.Options(write_files=False, device="cpu"))
    got = bt.solve(problem_from_reference(vlp),
                   bt.Options(write_files=False, device="cpu",
                              mesh_axes=("tp",), mesh_devices=4))
    assert got.status.name == "OPTIMAL" == ref.status.name
    for a in (plain, ref):
        assert canon(got.primal_points) == canon(a.primal_points)
        assert canon(got.dual_points) == canon(a.dual_points)
