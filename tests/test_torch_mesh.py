"""The port's device mesh (parallel/mesh.py, Options.mesh_axes,
solve_many(mesh=)) against the JAX package's, on the CPU.

The JAX package runs on conftest's 8 virtual CPU devices; the port runs
on ``make_mesh(8, ..., device="cpu")``, eight entries of the one CPU,
each shard on a thread of its own.  Required:

* against the port's one-device run: equal status, pivots and basis per
  LP (the tableau simplex prices each LP alone, so its shard changes
  nothing), objective values within 1e-12 (the CPU's matrix products
  round by the batch's row count), and equal point sets end to end;
* against the JAX package's meshed run: the tolerances of
  tests/test_sharding.py and tests/test_many.py.

Under a "tp" axis every LP of a dp row is split into column panels over
the row's entries (tests/test_torch_tp.py holds the panels' own cases).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve as jax_solve
from bensolve_tpu.algs.many import solve_many as jax_solve_many
from bensolve_tpu.algs.templates import P2Template as JaxP2Template
from bensolve_tpu.lp import revised as jrevised
from bensolve_tpu.parallel import mesh as jmesh
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu_torch.algs import many as tmany
from bensolve_tpu_torch.algs.templates import P2Template
from bensolve_tpu_torch.convert import problem_from_reference, \
    problems_from_reference
from bensolve_tpu_torch.lp import group_simplex, ipm, revised
from bensolve_tpu_torch.lp import simplex as tsx
from bensolve_tpu_torch.parallel import mesh as pmesh
from tests.test_sharding import _instances, _tall_instances
from tests.test_torch_many import (assert_same_solution, heterogeneous_vlps,
                                   random_bounded_vlps)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(axes=("dp",), n=8):
    return pmesh.make_mesh(n, axes, device="cpu")


def canon(a):
    return sorted(map(tuple, np.round(a, 9)))


def assert_same_lps(ref, got, obj_tol=1e-12):
    """Equal status, pivots, basis and bound pattern per LP; values
    within ``obj_tol``."""
    for f in ("status", "iters", "basis", "at_upper"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    for f in ("obj", "x", "row_dual"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=0, atol=obj_tol, err_msg=f)


# ------------------------------------------------------------- make_mesh

@pytest.mark.parametrize("n, axes", [(8, ("dp",)), (8, ("dp", "tp")),
                                     (6, ("dp", "tp"))])
def test_make_mesh_shapes_match_jax(n, axes):
    ref = jmesh.make_mesh(n, axes)
    got = cpu_mesh(axes, n)
    assert got.devices.shape == ref.devices.shape
    assert got.axis_names == tuple(ref.axis_names)
    assert got.shape == dict(ref.shape)
    assert [d.type for d in got.devices.flat] == ["cpu"] * n


def test_make_mesh_axes_and_devices(monkeypatch):
    """Three axes raise in both packages; past the visible devices the
    entries repeat round-robin; a CUDA mesh without a card raises."""
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, ("dp", "tp", "x"))
    with pytest.raises(ValueError, match="1 or 2"):
        cpu_mesh(("dp", "tp", "x"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = pmesh.make_mesh(8, ("dp", "tp"), device="cuda")
    assert m.shape == {"dp": 4, "tp": 2}
    assert [str(d) for d in m.devices.flat] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:0", "cuda:1", "cuda:2",
        "cuda:0", "cuda:1"]
    assert [str(d) for d in pmesh.shard_entries(m, "dp")] == [
        "cuda:0", "cuda:2", "cuda:1", "cuda:0"]
    assert pmesh.make_mesh(device="cuda").size == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pmesh.make_mesh(4, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        bt.Options(mesh_axes=("dp",)).build_mesh()


# ------------------------------------- the cases of tests/test_sharding.py

def _one_device(A, c, lb, ub, max_iter):
    put = lambda a: tsx._put(a, torch.device("cpu"))  # noqa: E731
    out = tsx._solve_tableau_segmented(put(A), put(c), put(lb), put(ub),
                                       None, None, max_iter)
    return tsx.LPResult(*(o.numpy() for o in out))


def test_dp_sharded_matches_single_device():
    A, c, lb, ub = _instances(16, 16, 16)
    m = cpu_mesh()
    got = tsx.LPResult(*pmesh.solve_batch_sharded(m, A, c, lb, ub,
                                                  max_iter=512))
    assert_same_lps(_one_device(A, c, lb, ub, 512), got)
    ref = jmesh.solve_batch_sharded(jmesh.make_mesh(8, ("dp",)), A, c, lb,
                                    ub, max_iter=512)
    np.testing.assert_array_equal(np.asarray(ref[0]), got.status)
    np.testing.assert_allclose(got.obj, np.asarray(ref[1]), rtol=1e-5,
                               atol=1e-5)
    assert (got.status == tsx.OPTIMAL).sum() >= 8


def test_2d_mesh_benson_round():
    A, c, lb, ub = _instances(16, 16, 8)
    V = np.random.default_rng(1).random((8, 2)).astype(np.float32)
    ZR = np.eye(2, dtype=np.float32)
    args = (A, c[0], V, ZR, lb[0, :16], ub[0, :16], lb[0, 16:], ub[0, 16:])
    m = cpu_mesh(("dp", "tp"))
    assert m.size == 8
    got = pmesh.benson_round_sharded(m, *args, n_extra_offset=4,
                                     max_iter=256)
    ref = jmesh.benson_round_sharded(jmesh.make_mesh(8, ("dp", "tp")),
                                     *args, n_extra_offset=4, max_iter=256)
    assert got[0].shape == (8,)
    np.testing.assert_array_equal(np.asarray(ref[0]), got[0])
    ok = got[0] == tsx.OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(got[1][ok], np.asarray(ref[1])[ok],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axes", [("tp",), ("dp", "tp")])
def test_tp_sharded_revised_matches_single_device(axes, monkeypatch):
    """The revised route over meshes of 2 and 8 entries: every LP split
    into as many panels as the mesh's tp axis holds, with the unsplit
    port's pivots and the JAX package's values."""
    panels = []
    real = pmesh.record_split
    monkeypatch.setattr(pmesh, "record_split", lambda route, ps, steps: (
        panels.append((route, len(ps))), real(route, ps, steps)))
    args = _tall_instances(8, 64, 4)
    plain = revised.solve_batch_revised(*args, device="cpu")
    for n in (2, 8):
        m = cpu_mesh(axes, n)
        T = m.shape["tp"]
        panels.clear()
        calls = revised.CALLS
        got = revised.solve_batch_revised(*args, device="cpu", mesh=m)
        assert revised.CALLS > calls
        if n == 8:
            assert T > 1
        assert panels == ([("revised", T)] * len(pmesh.mesh_rows(m))
                          if T > 1 else [])
        assert_same_lps(plain, got)
        ref = jrevised.solve_batch_revised(*args,
                                           mesh=jmesh.make_mesh(n, axes))
        np.testing.assert_array_equal(ref.status, got.status)
        ok = ref.status == tsx.OPTIMAL
        assert ok.any()
        np.testing.assert_allclose(got.obj[ok], ref.obj[ok], rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(got.row_dual[ok], ref.row_dual[ok],
                                   rtol=1e-7, atol=1e-9)


def test_mesh_axes_end_to_end_solve():
    """example05 with mesh_axes=("dp", "tp"): the port's point sets equal
    its unsharded solve's and the JAX package's meshed solve's, with
    equal LP and round counts between the packages."""
    vlp = examples.example05()
    ref = jax_solve(vlp, JaxOptions(write_files=False,
                                    mesh_axes=("dp", "tp")))
    plain = bt.solve(problem_from_reference(vlp),
                     bt.Options(write_files=False, device="cpu"))
    got = bt.solve(problem_from_reference(vlp),
                   bt.Options(write_files=False, device="cpu",
                              mesh_axes=("dp", "tp"), mesh_devices=8))
    assert got.status.name == "OPTIMAL" == ref.status.name
    for a in (plain, ref):
        assert canon(got.primal_points) == canon(a.primal_points)
        assert canon(got.dual_points) == canon(a.dual_points)
    assert (got.stats.lps, got.stats.rounds) == (ref.stats.lps,
                                                 ref.stats.rounds)


def test_tp_sharding_distributes_state(monkeypatch):
    """Memory-distribution witness (the JAX package's test of the same
    name): under an 8-way tp mesh each entry holds 1/8 of the columns:
    A's panel (Mp, Np/8), the tableau's (B, M, NT/8), B^-1's and the
    basis rows' (B, M, Mp/8), A^T's (Np/8, Mp), each on its own entry;
    no device holds the whole A."""
    seen = {}
    real = pmesh.record_split
    monkeypatch.setattr(pmesh, "record_split", lambda route, ps, steps: (
        seen.__setitem__(route, ps), real(route, ps, steps)))
    m = cpu_mesh(("tp",))
    rng = np.random.default_rng(4)
    B, M, N = 8, 24, 40
    A = rng.standard_normal((M, N))
    args = (A, rng.standard_normal((B, N)), np.full((B, M), -np.inf),
            rng.random((B, M)) + 1.0, np.zeros((B, N)), np.full((B, N), 3.0))
    tsx.solve_batch(*args, device="cpu", mesh=m)
    tall = _tall_instances(8, 64, 2)
    revised.solve_batch_revised(*tall, device="cpu", mesh=m)
    tab, rev = seen["tableau"], seen["revised"]
    assert [p.k for p in tab] == list(range(8))
    assert all(p.dev == d for p, d in zip(tab, m.devices.flat))
    assert {p.A.shape for p in tab} == {(M, N // 8)}
    assert {p.W.shape for p in tab} == {(B, M, (M + N) // 8)}
    assert {p.A.shape for p in rev} == {(8, 64 // 8)}
    assert {p.AT.shape for p in rev} == {(64 // 8, 8)}
    assert {p.Binv.shape for p in rev} == {p.Brows.shape for p in rev} == {
        (B, 8, 8 // 8)}
    assert all(p.Binv is None for p in tab) and all(p.W is None for p in rev)
    for ps in (tab, rev):
        total = sum(p.nbytes for p in ps)
        assert {p.nbytes for p in ps} == {total // 8}
    # the shared matrix stays on the host: the tp solve uploads panels
    prep = tsx._prepare_A(A, np.float64, "cpu")
    assert sorted(k for k in prep.panels) == [(8, k, "cpu")
                                             for k in range(8)]


def test_mesh_rows_and_padded_batch(monkeypatch):
    """Under ("dp", "tp") the batch is cut into contiguous, equal shards,
    one per dp row (led by the row's first entry), in order, and the
    padded batch follows the JAX rule."""
    m = cpu_mesh(("dp", "tp"))
    assert pmesh.shard_entries(m, "dp") == list(m.devices[:, 0])
    assert pmesh.shard_entries(m, "tp") == list(m.devices[0, :])
    assert pmesh.shard_entries(cpu_mesh(("tp",)), "dp") == [
        torch.device("cpu")]
    assert pmesh.mesh_rows(m) == [tuple(r) for r in m.devices]
    for Bp, n in ((8, 4), (2, 8), (16, 8), (64, 1)):
        want = Bp
        while want % n:          # simplex.py:880-883 of the JAX package
            want *= 2
        assert pmesh.padded_batch(Bp, n) == want
    assert pmesh.padded_batch(8, 3) == 9

    seen = []
    real = tsx._solve_tableau_tp

    def record(lay, row, A_panels, c, *a):
        seen.append((threading.get_ident(), row, c.numpy().copy()))
        return real(lay, row, A_panels, c, *a)

    monkeypatch.setattr(tsx, "_solve_tableau_tp", record)
    rng = np.random.default_rng(4)
    B, M, N = 20, 5, 6
    A = rng.standard_normal((M, N))
    c = rng.standard_normal((B, N))
    args = (A, c, np.full((B, M), -np.inf), rng.random((B, M)) + 1.0,
            np.zeros((B, N)), np.full((B, N), 3.0))
    got = tsx.solve_batch(*args, device="cpu", mesh=m)
    assert len(seen) == 4                      # the dp size
    assert {s[2].shape[0] for s in seen} == {8}  # Bp = 32 in 4 shards
    assert {s[1] for s in seen} == set(pmesh.mesh_rows(m))
    prep = tsx._prepare_A(A, np.float64, "cpu")
    full_c, _, _ = tsx._pad_batch_inputs(prep, c, *args[2:], 32, np.float64)
    blocks = [full_c[8 * k:8 * k + 8] for k in range(4)]
    found = sorted(next(k for k, b in enumerate(blocks)
                        if np.array_equal(b, s[2])) for s in seen)
    assert found == [0, 1, 2, 3]
    assert got.status.shape == (B,)
    monkeypatch.setattr(tsx, "_solve_tableau_tp", real)
    assert_same_lps(tsx.solve_batch(*args, device="cpu"), got)


def test_shard_failure_raises(monkeypatch):
    """A shard that raises makes the whole call raise; nothing carries
    on with fewer shards."""
    real = tsx._solve_tableau_segmented
    calls = []

    def flaky(A, c, *a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("shard 3 failed")
        return real(A, c, *a)

    monkeypatch.setattr(tsx, "_solve_tableau_segmented", flaky)
    A, c, lb, ub = _instances(16, 16, 16)
    with pytest.raises(RuntimeError, match="shard 3 failed"):
        pmesh.solve_batch_sharded(cpu_mesh(), A, c, lb, ub, max_iter=64)
    assert len(calls) == 8


def test_meshed_batch_takes_neither_kernel_nor_ipm(monkeypatch):
    """As in the JAX package, the router gives a meshed batch neither the
    kernel nor the interior-point method: a float32 batch the kernel
    would take runs the tableau simplex."""
    from bensolve_tpu_torch.lp import solve_batch_auto

    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    A, c, lb, ub = _instances(12, 12, 8)
    args = (A, c[:, 12:], lb[:, :12], ub[:, :12], lb[:, 12:], ub[:, 12:])
    routed, ipm_calls = group_simplex.ROUTED, ipm.CALLS
    solve_batch_auto(*args, dtype=np.float32, device="cpu")
    assert group_simplex.ROUTED == routed + 1
    got = solve_batch_auto(*args, dtype=np.float32, device="cpu",
                           ipm_min=1, mesh=cpu_mesh())
    assert (group_simplex.ROUTED, ipm.CALLS) == (routed + 1, ipm_calls)
    assert_same_lps(tsx.solve_batch(*args, dtype=np.float32, device="cpu"),
                    got, obj_tol=1e-5)


# ------------------------------------------ the mesh cases of test_many.py

def test_solve_many_mesh_sharded():
    vlps = random_bounded_vlps(16, seed=3)
    opt = dict(bounded=True)
    plain = tmany.solve_many(problems_from_reference(vlps),
                             bt.Options(write_files=False, device="cpu",
                                        **opt))
    got = tmany.solve_many(problems_from_reference(vlps),
                           bt.Options(write_files=False, device="cpu", **opt),
                           mesh=cpu_mesh())
    ref = jax_solve_many(vlps, JaxOptions(write_files=False, **opt),
                         mesh=jmesh.make_mesh(8, ("dp",)))
    for a, b, r in zip(plain, got, ref):
        assert a.status.name == b.status.name == "OPTIMAL"
        assert (a.stats.lps, a.stats.rounds, a.stats.pivots) == (
            b.stats.lps, b.stats.rounds, b.stats.pivots)
        np.testing.assert_array_equal(a.primal_points, b.primal_points)
        assert_same_solution(r, b)


def test_solve_many_heterogeneous_with_mesh(monkeypatch):
    """Several shape groups with a mesh: group g solves on entry g % 8,
    each on its own thread; results equal the unmeshed port's and the
    JAX package's meshed run."""
    vlps = heterogeneous_vlps()
    places = []
    real = tmany._merged_solve

    def watch(requests, opt, place=None):
        places.append(place)
        return real(requests, opt, place)

    monkeypatch.setattr(tmany, "_merged_solve", watch)
    m = pmesh.make_mesh(3, device="cpu")
    opt = bt.Options(write_files=False, device="cpu", bounded=True)
    got = tmany.solve_many(problems_from_reference(vlps), opt, mesh=m)
    assert places and all(isinstance(p, torch.device) for p in places)
    assert [tmany._group_place(g, m) for g in range(3)] == list(
        m.devices.flat)
    plain = tmany.solve_many(problems_from_reference(vlps), opt)
    ref = jax_solve_many(vlps, JaxOptions(write_files=False, bounded=True),
                         mesh=jmesh.make_mesh(8, ("dp",)))
    for a, b, r in zip(plain, got, ref):
        assert_same_solution(a, b)
        assert_same_solution(r, b)


# ------------------------------------------------- templates and options

def test_template_gates_under_mesh():
    """Under a mesh the kept tableau stays None and the dual warm route
    is off, in both packages' P2 templates, over one warm round."""
    vlp = examples.example05()
    tvlp = problem_from_reference(vlp)
    P = np.asarray(vlp.P, float)
    q = P.shape[0]
    Z = np.eye(q)
    eta = np.full(q, 1.0 / q)
    ref = JaxP2Template(vlp, P, Z, eta, False,
                        mesh=jmesh.make_mesh(8, ("dp",)))
    got = P2Template(tvlp, P, Z, eta, False, device="cpu", mesh=cpu_mesh())
    plain = P2Template(tvlp, P, Z, eta, False, device="cpu")
    V = np.random.default_rng(2).random((5, q)) * 2 + 1
    for t in (ref, got, plain):
        t.solve(V @ Z)
        t.res = t.solve(V @ Z * 1.01)
    for t in (ref, got):
        assert t._warm is not None
        assert not t._use_dual_warm(t._warm)
        assert getattr(t, "_kept_state", None) is None
        assert not t.state_available()
    assert plain._use_dual_warm(plain._warm) and plain.state_available()
    assert got._device() == torch.device("cpu")
    np.testing.assert_array_equal(ref.res.status, got.res.status)
    np.testing.assert_allclose(got.res.obj, ref.res.obj, rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got.res.obj, plain.res.obj, rtol=1e-9,
                               atol=1e-9)


def test_distributed_with_mesh_one_process():
    """distributed=True with mesh_axes=("dp",) on one process gives the
    plain result."""
    vlp = problem_from_reference(examples.example05())
    plain = bt.solve(vlp, bt.Options(write_files=False, device="cpu"))
    got = bt.solve(problem_from_reference(examples.example05()),
                   bt.Options(write_files=False, device="cpu",
                              distributed=True, mesh_axes=("dp",),
                              mesh_devices=8))
    assert got.status.name == "OPTIMAL"
    assert canon(got.primal_points) == canon(plain.primal_points)
    assert canon(got.dual_points) == canon(plain.dual_points)


# ------------------------------------------ the repairs that came first

def test_prepare_A_keys_on_the_exact_device(monkeypatch):
    """A matrix prepared on cuda:0 is not handed to a solve on cuda:1:
    two devices of one type get two copies.  Uploads are faked, so no
    card is needed."""
    import types

    def fake_put(arr, dev):
        return types.SimpleNamespace(dtype=torch.float64,
                                     device=torch.device(dev), arr=arr)

    monkeypatch.setattr(tsx, "_put", fake_put)
    A = np.random.default_rng(0).standard_normal((5, 7))
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    p0 = tsx._prepare_A(A, np.float64, d0)
    p1 = tsx._prepare_A(p0, np.float64, d1)
    assert p1 is not p0
    assert (p0.dev.device, p1.dev.device) == (d0, d1)
    assert tsx._prepare_A(p0, np.float64, d0) is p0
    assert tsx._prepare_A(A, np.float64, d1) is p1
    np.testing.assert_array_equal(p0.host, p1.host)


def test_prepare_A_cache_is_locked(monkeypatch):
    """Lookup, upload and eviction of the shared-matrix cache run under
    its lock, so shard threads may prepare matrices side by side."""
    real = tsx._put
    unlocked = []

    def put(arr, dev):
        if not tsx._A_CACHE_LOCK.locked():
            unlocked.append(arr.shape)
        return real(arr, dev)

    monkeypatch.setattr(tsx, "_put", put)
    rng = np.random.default_rng(1)
    mats = [rng.standard_normal((3, 4)) for _ in range(2 * tsx._A_CACHE_MAX)]
    errors = []

    def work(k):
        try:
            for i in range(60):
                A = mats[(i * 7 + k) % len(mats)]
                p = tsx._prepare_A(A, np.float64, "cpu")
                assert p.A is A
                np.testing.assert_array_equal(p.host[:3, :4], A)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and not unlocked
    assert len(tsx._A_CACHE) <= tsx._A_CACHE_MAX


def _degrees_to_nearest(dirs, ref):
    u = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    v = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    return np.degrees(np.arccos(np.clip((u @ v.T).max(axis=1), -1, 1)))


def test_f32_directions_are_near_copies_of_f64_ones():
    """ROADMAP Queue 3 m: at float32 both packages may list one extreme
    direction several times (example05: 4 at float64; 5 in the port,
    7 in the JAX package at float32), each copy a few 1e-7 off, which the
    polytope's 1e-9 tolerance keeps apart.  Each float32 direction lies
    within 1e-2 degrees (chip_smoke.F32_DIR_DEG) of a float64 one and
    back, in both packages; the counts are not held."""
    F32 = dict(lp_dtype="float32", eps_benson_phase1=1e-4,
               eps_benson_phase2=1e-4)
    vlp = examples.example05()
    ref = bt.solve(problem_from_reference(vlp),
                   bt.Options(write_files=False, device="cpu"))
    got = bt.solve(problem_from_reference(vlp),
                   bt.Options(write_files=False, device="cpu", **F32))
    jax32 = jax_solve(vlp, JaxOptions(write_files=False, **F32))
    f64 = ref.primal_directions
    assert len(f64) == 4
    for r in (got, jax32):
        assert r.status.name == "OPTIMAL"
        d = r.primal_directions
        assert len(d) >= len(f64)
        assert _degrees_to_nearest(d, f64).max() <= 1e-2
        assert _degrees_to_nearest(f64, d).max() <= 1e-2


def test_cpu_batched_lu_returns_with_several_threads():
    """With two intra-op threads, oneMKL's batched getrf on matrices of
    order 256 reports "Parameter 6 was incorrect on entry to DLASWP" and
    never returns; _lu_factor factors such a CPU batch one matrix at a
    time, to what the one-thread batched call gives.  Run in a
    subprocess, so a hang fails the test at its timeout."""
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "from bensolve_tpu_torch.lp import simplex as sx; "
            "g = torch.Generator().manual_seed(0); "
            "X = torch.randn(3, 256, 256, dtype=torch.float64, generator=g); "
            "torch.set_num_threads(2); LU, piv = sx._lu_factor(X); "
            "torch.set_num_threads(1); LU1, piv1 = sx._lu_factor(X); "
            "print(float((LU - LU1).abs().max()), bool((piv == piv1).all()))")
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "oneMKL" not in out.stdout + out.stderr
    err, same = out.stdout.split()
    assert float(err) < 1e-10 and same == "True"


def test_tf32_off_holds_across_threads():
    """The TF32 switch stays off while any shard thread is inside a
    solve, and the caller's setting comes back when the last leaves."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        inside = threading.Barrier(4)
        left = [threading.Event() for _ in range(4)]
        seen = []

        def shard(k):
            # all four enter, then they leave one by one in order
            with tsx._tf32_off():
                inside.wait()
                if k:
                    left[k - 1].wait()
                seen.append(torch.backends.cuda.matmul.allow_tf32)
            left[k].set()

        threads = [threading.Thread(target=shard, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == [False] * 4
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_lu_turns_only_on_shard_threads(monkeypatch):
    """A CUDA LU call takes its turn (the lock, then a sync of its
    stream) only on a thread inside on_own_stream; elsewhere, the
    unsharded path included, it goes straight to torch."""
    import contextlib
    import types

    synced = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.
                        SimpleNamespace(synchronize=lambda: synced.append(d)))
    card = types.SimpleNamespace(device=torch.device("cuda", 0))

    def lu_call():
        locked = tsx._CUDA_LU_LOCK.locked()
        with tsx._lu_turn(card):
            locked = (locked, tsx._CUDA_LU_LOCK.locked())
        return locked

    assert lu_call() == (False, False) and not synced
    on_shard = pmesh.on_own_stream(torch.device("cuda", 0), lu_call)
    assert on_shard == (False, True) and synced == [card.device]
    assert not getattr(tsx._SHARD_THREAD, "on", False)
    assert lu_call() == (False, False) and len(synced) == 1
