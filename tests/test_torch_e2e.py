"""End-to-end parity of the port's solve() with the JAX package's on the
examples the repo builds (bensolve_tpu.examples), on the CPU, for the
primal and the dual Benson algorithm.

Float64 (the default path, torch ops only): equal SolStatus, vertex and
direction sets within 1e-7, equal LP and round counts, and the support
oracle of tests/test_e2e.py at 1e-7.  Float32 with BENSOLVE_FORCE_PALLAS=1
(the kernel's route, which runs its plain version on the CPU): equal
status and vertex sets within 1e-4 each way; float32 rounding may add or
drop a near-duplicate vertex, so the sets are compared by distance, not
by count.  A tall random VLP (P LP columns >= 4x its rows) takes the
revised simplex in both packages.  With lp_ipm_min=1 every LP takes the
interior-point route in both packages, held to the same float64
criteria.
"""

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve as jax_solve
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu.vlp.options import Alg as JaxAlg
from bensolve_tpu_torch.convert import problem_from_reference
from bensolve_tpu_torch.lp import group_simplex, ipm, revised
from bensolve_tpu_torch.vlp.options import Alg
from tests.test_e2e import check_support

F32 = dict(lp_dtype="float32", eps_benson_phase1=1e-4, eps_benson_phase2=1e-4)
DUAL = ("dual", "dual")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(name, algs=("primal", "primal"), vlp=None, **kw):
    """Solve one example (or ``vlp``) with both packages; ``algs``: the
    phase-1 and phase-2 algorithms (-A, -a)."""
    vlp = getattr(examples, name)() if vlp is None else vlp
    a1, a2 = algs
    ref = jax_solve(vlp, JaxOptions(
        write_files=False, alg_phase1=JaxAlg(a1), alg_phase2=JaxAlg(a2),
        **kw))
    got = bt.solve(problem_from_reference(vlp), bt.Options(
        write_files=False, device="cpu", alg_phase1=Alg(a1),
        alg_phase2=Alg(a2), **kw))
    return ref, got


def _norm(d):
    d = np.atleast_2d(d)
    return d / np.abs(d).max(axis=1, keepdims=True) if d.size else d


def assert_sets_close(a, b, tol, same_count=True):
    """Every point of each set lies within tol (max norm) of one of the
    other set."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    if same_count:
        assert a.shape == b.shape, (a, b)
    if a.size == 0 or b.size == 0:
        assert a.size == b.size, (a, b)
        return
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    assert (d.min(axis=1) <= tol).all(), (a, b)
    assert (d.min(axis=0) <= tol).all(), (a, b)


def assert_f64_parity(ref, got):
    assert got.status.name == ref.status.name
    assert got.swap == ref.swap
    assert (got.stats.lps, got.stats.rounds) == (ref.stats.lps,
                                                 ref.stats.rounds)
    if ref.status.name != "OPTIMAL":
        return
    assert_sets_close(got.primal_points, ref.primal_points, 1e-7)
    assert_sets_close(_norm(got.primal_directions),
                      _norm(ref.primal_directions), 1e-7)
    assert_sets_close(got.dual_points, ref.dual_points, 1e-7)
    check_support(got, tol=1e-7)


EXAMPLES = ["example01", "example02", "example03", "example04", "example05",
            "example06", "example08"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_f64_parity(name):
    assert_f64_parity(*run_both(name))


@pytest.mark.parametrize("name", EXAMPLES)
def test_dual_f64_parity(name):
    """-A dual -a dual: the P1 template in both phases."""
    assert_f64_parity(*run_both(name, DUAL))


def test_dual_f64_example11_sets():
    """example11 -A dual -a dual: equal status, vertex and direction sets
    within 1e-7 and the oracle at 1e-7.  LP and round counts are not
    held equal here: exact ties in its degenerate LPs are broken by
    last-bit rounding, which differs between the packages, and the
    batched phase 2 then takes the same cuts in another order (ROADMAP
    Queue 3 h)."""
    ref, got = run_both("example11", DUAL)
    assert got.status.name == ref.status.name == "OPTIMAL"
    assert_sets_close(got.primal_points, ref.primal_points, 1e-7)
    assert_sets_close(_norm(got.primal_directions),
                      _norm(ref.primal_directions), 1e-7)
    assert_sets_close(got.dual_points, ref.dual_points, 1e-7)
    check_support(got, tol=1e-7)


@pytest.mark.parametrize("algs", [("primal", "dual"), ("dual", "primal")])
def test_mixed_algorithms_f64_parity(algs):
    """R/H extraction reads pair.primal of either phase-1 algorithm (the
    lower image after phase1_dual)."""
    assert_f64_parity(*run_both("example05", algs))


def _preimages(result):
    """{rounded vertex: pre-image} over both images of a solution."""
    out = {}
    for poly in (result.pair.primal, result.pair.dual):
        for i in poly.live():
            key = (bool(poly.ideal[i]),) + tuple(np.round(poly.data[i], 6))
            out[key] = poly.primg[i, : poly.dim_primg].copy()
    return out


def test_dual_preimages_parity():
    """solution=True on the dual phase 2: the pre-images of every vertex
    and direction (x for upper-image points, (u, w) for lower-image
    vertices, zero for lower-image directions) agree within 1e-9."""
    ref, got = run_both("example05", DUAL, solution=True)
    assert got.status.name == ref.status.name == "OPTIMAL"
    a, b = _preimages(ref), _preimages(got)
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=1e-9,
                                   err_msg=str(k))


@pytest.mark.parametrize("algs", [("primal", "primal"), DUAL])
def test_tall_vlp_takes_revised_route(algs):
    """random_vlp(q=2, m=4, n=40): every batched LP of both packages is
    tall, so each goes to the revised simplex."""
    vlp = examples.random_vlp(q=2, m=4, n=40)
    calls = revised.CALLS
    ref, got = run_both(None, algs, vlp=vlp)
    assert revised.CALLS > calls
    assert_f64_parity(ref, got)


def _f32_kernel_route_parity(name, algs, monkeypatch):
    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    routed, calls = group_simplex.ROUTED, group_simplex.CALLS
    ref, got = run_both(name, algs, **F32)
    assert got.status.name == ref.status.name == "OPTIMAL"
    assert group_simplex.ROUTED > routed
    assert group_simplex.CALLS == calls   # no kernel launch without a card
    assert_sets_close(got.primal_points, ref.primal_points, 1e-4,
                      same_count=False)
    check_support(got, tol=1e-3)


@pytest.mark.parametrize("name", ["example01", "example05", "example08"])
def test_f32_kernel_route_parity(name, monkeypatch):
    _f32_kernel_route_parity(name, ("primal", "primal"), monkeypatch)


@pytest.mark.parametrize("name", ["example01", "example05", "example08"])
def test_dual_f32_kernel_route_parity(name, monkeypatch):
    """The dual algorithm's P1 rounds reach the kernel's route with one
    shared warm basis (its warm path)."""
    _f32_kernel_route_parity(name, DUAL, monkeypatch)


@pytest.mark.slow
def test_ex10_f64_parity():
    ref, got = run_both("example10")
    assert got.status.name == ref.status.name == "OPTIMAL"
    assert (got.stats.lps, got.stats.rounds) == (ref.stats.lps,
                                                 ref.stats.rounds)
    assert_sets_close(got.primal_points, ref.primal_points, 1e-7)
    check_support(got, tol=1e-4, n_samples=16)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vlp = problem_from_reference(examples.example01())
    with pytest.raises(RuntimeError, match="cuda"):
        bt.solve(vlp, bt.Options(write_files=False, device="cuda"))


@pytest.mark.parametrize("opt", [dict(profile_dir="x"),
                                 dict(mesh_axes=("dp",)),
                                 dict(checkpoint_path="x"),
                                 dict(distributed=True)])
def test_unported_options_raise(opt):
    vlp = problem_from_reference(examples.example01())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.solve(vlp, bt.Options(write_files=False, device="cpu", **opt))


@pytest.mark.parametrize("name", EXAMPLES)
def test_ipm_route_f64_parity(name):
    """lp_ipm_min=1: every LP of the run goes to the interior-point
    method in both packages (polished to vertex duals on the host)."""
    calls = ipm.CALLS
    ref, got = run_both(name, lp_ipm_min=1)
    assert ipm.CALLS > calls
    assert_f64_parity(ref, got)


def test_ipm_route_example11_f64_parity():
    assert_f64_parity(*run_both("example11", lp_ipm_min=1))


def test_ipm_env_route_parity(monkeypatch):
    """BENSOLVE_IPM_MIN=1 enables the route like lp_ipm_min."""
    monkeypatch.setenv("BENSOLVE_IPM_MIN", "1")
    calls = ipm.CALLS
    ref, got = run_both("example05")
    assert ipm.CALLS > calls
    assert_f64_parity(ref, got)


def _planted_loose(solve_fn, templates_mod, monkeypatch, n_loose_rounds,
                   every=1):
    """Solve with every ``every``-th LP of the first ``n_loose_rounds``
    template solves flagged quality=2 (the results themselves stay
    exact)."""
    orig = templates_mod._TemplateBase._run
    state = {"n": 0}

    def wrapped(self, *a, **k):
        res = orig(self, *a, **k)
        state["n"] += 1
        if state["n"] <= n_loose_rounds:
            q = np.zeros(res.status.shape[0], np.int32)
            q[::every] = 2
            res = type(res)(**{**res.__dict__, "quality": q})
        return res

    monkeypatch.setattr(templates_mod._TemplateBase, "_run", wrapped)
    return solve_fn()


@pytest.mark.parametrize("n_loose_rounds,every", [(8, 1), (10**6, 1),
                                                  (10**6, 2)])
def test_planted_loose_results_parity(n_loose_rounds, every, monkeypatch):
    """tests/test_quality.py's planted-loose cases on example05 in both
    packages, plus every other LP of every round flagged (where the order
    matters): loose results are applied last within a round, counted in
    stats.loose_cuts (or loose_deferred when a clean cut removed their
    vertex), and the vertex set equals the unplanted run's."""
    from bensolve_tpu.algs import templates as jtemplates
    from bensolve_tpu_torch.algs import templates as ttemplates

    vlp = examples.example05()
    clean = jax_solve(vlp, JaxOptions(write_files=False))
    ref = _planted_loose(
        lambda: jax_solve(vlp, JaxOptions(write_files=False)), jtemplates,
        monkeypatch, n_loose_rounds, every)
    got = _planted_loose(
        lambda: bt.solve(problem_from_reference(vlp),
                         bt.Options(write_files=False, device="cpu")),
        ttemplates, monkeypatch, n_loose_rounds, every)
    assert got.status.name == ref.status.name == clean.status.name
    assert got.stats.loose_cuts == ref.stats.loose_cuts > 0
    assert got.stats.loose_deferred == ref.stats.loose_deferred
    assert (got.stats.lps, got.stats.rounds) == (ref.stats.lps,
                                                 ref.stats.rounds)
    assert_sets_close(got.primal_points, clean.primal_points, 1e-6)
    assert_sets_close(got.primal_points, ref.primal_points, 1e-7)


class _LowerImage:
    """The three members of a polytope that _extract_R_H reads."""

    def __init__(self, data):
        self.data = np.asarray(data, float)
        self.ideal = np.zeros(len(self.data), bool)

    def live(self):
        return np.arange(len(self.data))


@pytest.mark.parametrize("dtype,floor", [("float32", 1e-3),
                                         ("float64", 1e-8)])
def test_ray_floor_boundary(dtype, floor, monkeypatch):
    """The phase-1 ray test (ROADMAP Queue 3 b) in both directions, in
    both packages: a lower-image vertex whose last component lies just
    under the floor (1e-3 at float32, eps_phase1 at float64) is a ray,
    one just over it is not."""
    import types

    from bensolve_tpu.algs import phases as jphases
    from bensolve_tpu.algs.phases import Stats as JStats
    from bensolve_tpu.vlp.options import Options as JOptions
    from bensolve_tpu_torch.algs import phases as tphases

    verts = [[0.2, 0.0], [0.8, 0.0], [0.4, floor * 0.999],
             [0.6, floor * 1.001], [0.5, 0.5]]
    cols = {}

    def recorder(key):
        def cone_vertenum(arr, q):
            cols[key] = np.asarray(arr).copy()
            return arr, arr
        return cone_vertenum

    monkeypatch.setattr(jphases, "cone_vertenum", recorder("jax"))
    monkeypatch.setattr(tphases, "cone_vertenum", recorder("torch"))
    c = np.array([0.5, 0.5])
    jphases._extract_R_H(types.SimpleNamespace(q=2, c=c),
                         _LowerImage(verts),
                         JOptions(lp_dtype=dtype, message_level=0),
                         JStats())
    tphases._extract_R_H(types.SimpleNamespace(q=2, c=c),
                         _LowerImage(verts),
                         bt.Options(lp_dtype=dtype, message_level=0,
                                    device="cpu"), tphases.Stats())
    np.testing.assert_array_equal(cols["torch"], cols["jax"])
    # the rays: the two zero vertices and the one just under the floor
    np.testing.assert_allclose(cols["torch"][0], [0.2, 0.8, 0.4])
