"""The per-LP simplex kernel's plain PyTorch version against the JAX
package's Pallas kernel (lp_batch_pallas in interpret mode, as
tests/test_pallas_simplex.py runs it on the CPU), the kernel's gate, and
its wrapper.

Required: equal status, iters, basis and at_upper per LP, and obj / x /
row_dual within 1e-5 (both float32 through the same recovery; the final
LU is the only part summed in another order).  The CUDA kernel itself
needs the card: its tests are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu.lp.pallas_simplex import lp_batch_pallas
from bensolve_tpu_torch.lp import _kernel_eligible
from bensolve_tpu_torch.lp import group_simplex as gs
from tests.test_pallas_simplex import make


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(ref, got):
    np.testing.assert_array_equal(ref.status, got.status)
    np.testing.assert_array_equal(ref.iters, got.iters)
    np.testing.assert_array_equal(ref.basis, got.basis)
    np.testing.assert_array_equal(ref.at_upper, got.at_upper)
    ok = ref.status == jsx.OPTIMAL
    for field in ("obj", "x", "row_dual"):
        np.testing.assert_allclose(getattr(got, field)[ok],
                                   getattr(ref, field)[ok],
                                   rtol=1e-5, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_cold_and_warm(seed, group):
    args = make(16, 16, 8, seed)
    ref = lp_batch_pallas(*args, group=group, interpret=True)
    got = gs.lp_batch_group(*args, group=group, device="cpu")
    assert_same(ref, got)
    i0 = int(np.flatnonzero(ref.status == jsx.OPTIMAL)[0])
    warm = (ref.basis[i0], ref.at_upper[i0])
    ref_w = lp_batch_pallas(*args, group=group, interpret=True,
                            start_basis=warm)
    got_w = gs.lp_batch_group(*args, group=group, device="cpu",
                              start_basis=warm)
    assert_same(ref_w, got_w)
    assert got_w.iters[i0] == 0


def test_statuses_batch():
    A = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    c = np.array([[1, 1], [0, 0], [-1, 0]], np.float32)
    rlb = np.array([[0, 0], [3, 0], [0, 0]], np.float32)
    rub = np.array([[np.inf] * 2, [1, np.inf], [np.inf] * 2], np.float32)
    clb = np.array([[0, 0], [0, 0], [-np.inf, 0]], np.float32)
    cub = np.full((3, 2), np.inf, np.float32)
    ref = lp_batch_pallas(A, c, rlb, rub, clb, cub, interpret=True)
    got = gs.lp_batch_group(A, c, rlb, rub, clb, cub, device="cpu")
    assert list(got.status) == [jsx.OPTIMAL, jsx.INFEASIBLE, jsx.UNBOUNDED]
    assert_same(ref, got)


def test_gate(monkeypatch):
    f32 = {"dtype": np.float32}
    monkeypatch.delenv("BENSOLVE_FORCE_PALLAS", raising=False)
    assert not _kernel_eligible(16, 16, f32, "cpu")
    assert not _kernel_eligible(16, 16, {"dtype": np.float64}, "cuda")
    assert _kernel_eligible(16, 16, f32, "cuda")
    # a tableau whose per-LP vectors overflow a block's shared memory
    assert not _kernel_eligible(4096, 40000, f32, "cuda")
    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    assert _kernel_eligible(16, 16, f32, "cpu")
    assert not _kernel_eligible(16, 16, {"dtype": np.float64}, "cpu")


def test_try_solve_batch_rejects_per_instance_warm():
    args = make(16, 16, 8, seed=3)
    cold = gs.lp_batch_group(*args, device="cpu")
    assert gs.try_solve_batch(*args, start_basis=(cold.basis, cold.at_upper),
                              device="cpu") is None


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    args = make(16, 16, 8, seed=4)
    calls, routed = gs.CALLS, gs.ROUTED
    ref = lp_batch_pallas(*args, group=1, interpret=True)
    got = gs.lp_batch_group(*args, device="cpu")
    assert_same(ref, got)
    assert gs.CALLS == calls and gs.ROUTED == routed + 1
    with pytest.raises(ValueError, match="group=1"):
        gs.lp_batch_group(*args, group=8, device=torch.device("cuda"))


def test_wrapper_checks_inputs():
    W0 = torch.zeros(8, 128)
    c = torch.zeros(2, 128)
    basis0 = torch.arange(8, dtype=torch.int32)
    atup = torch.zeros(2, 128, dtype=torch.bool)
    with pytest.raises(TypeError, match="lb"):
        gs.solve_batch_group(W0, c, c.double(), c, basis0, atup, 10)
    with pytest.raises(ValueError, match="basis0"):
        gs.solve_batch_group(W0, c, c, c, basis0[:4], atup, 10)


def test_chunks_over_the_workspace_budget(monkeypatch):
    args = make(16, 16, 8, seed=5)
    ref = gs.lp_batch_group(*args, device="cpu")
    monkeypatch.setattr(gs, "WORKSPACE_BYTES_BUDGET", 3 * 16 * 128 * 4)
    assert gs._pick_chunk(16, 128) == 2
    got = gs.lp_batch_group(*args, device="cpu")
    assert_same(ref, got)
