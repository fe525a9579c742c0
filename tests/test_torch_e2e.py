"""End-to-end parity of the port's solve() with the JAX package's on the
examples the repo builds (bensolve_tpu.examples), on the CPU.

Float64 (the default path, torch ops only): equal SolStatus, vertex and
direction sets within 1e-7, equal LP and round counts, and the support
oracle of tests/test_e2e.py at 1e-7.  Float32 with BENSOLVE_FORCE_PALLAS=1
(the kernel's route, which runs its plain version on the CPU): equal
status and vertex sets within 1e-4 each way; float32 rounding may add or
drop a near-duplicate vertex, so the sets are compared by distance, not
by count.
"""

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve as jax_solve
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu_torch.convert import problem_from_reference
from bensolve_tpu_torch.lp import group_simplex
from tests.test_e2e import check_support

F32 = dict(lp_dtype="float32", eps_benson_phase1=1e-4, eps_benson_phase2=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_both(name, **kw):
    vlp = getattr(examples, name)()
    ref = jax_solve(vlp, JaxOptions(write_files=False, **kw))
    got = bt.solve(problem_from_reference(vlp),
                   bt.Options(write_files=False, device="cpu", **kw))
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


@pytest.mark.parametrize("name", ["example01", "example02", "example03",
                                  "example04", "example05", "example06",
                                  "example08"])
def test_f64_parity(name):
    ref, got = run_both(name)
    assert got.status.name == ref.status.name
    assert (got.stats.lps, got.stats.rounds) == (ref.stats.lps,
                                                 ref.stats.rounds)
    if ref.status.name != "OPTIMAL":
        return
    assert_sets_close(got.primal_points, ref.primal_points, 1e-7)
    assert_sets_close(_norm(got.primal_directions),
                      _norm(ref.primal_directions), 1e-7)
    assert_sets_close(got.dual_points, ref.dual_points, 1e-7)
    check_support(got, tol=1e-7)


@pytest.mark.parametrize("name", ["example01", "example05", "example08"])
def test_f32_kernel_route_parity(name, monkeypatch):
    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    routed, calls = group_simplex.ROUTED, group_simplex.CALLS
    ref, got = run_both(name, **F32)
    assert got.status.name == ref.status.name == "OPTIMAL"
    assert group_simplex.ROUTED > routed
    assert group_simplex.CALLS == calls   # no kernel launch without a card
    assert_sets_close(got.primal_points, ref.primal_points, 1e-4,
                      same_count=False)
    check_support(got, tol=1e-3)


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


@pytest.mark.parametrize("opt", [dict(alg_phase1=bt.vlp.options.Alg.DUAL),
                                 dict(mesh_axes=("dp",)),
                                 dict(checkpoint_path="x")])
def test_unported_options_raise(opt):
    vlp = problem_from_reference(examples.example01())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bt.solve(vlp, bt.Options(write_files=False, device="cpu", **opt))
