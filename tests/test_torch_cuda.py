"""The port on the card: the CUDA kernel's two variants build, launch
on the main path (primal and dual algorithm) and agree with their plain
PyTorch version at one shape per variant and cluster size; the revised
simplex and the interior-point method give on the card what they give on
the CPU, with TF32 off; lp_ipm_min takes a float32 solve past the
kernel's route to the interior-point method.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where JAX is not installed (the
repo's conftest imports it, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bensolve_tpu_torch import Options, examples, solve
from bensolve_tpu_torch.lp import group_simplex as gs
from bensolve_tpu_torch.lp import ipm
from bensolve_tpu_torch.lp import revised as rv
from bensolve_tpu_torch.lp.simplex import OPTIMAL
from bensolve_tpu_torch.vlp.options import Alg

F32 = dict(lp_dtype="float32", eps_benson_phase1=1e-4, eps_benson_phase2=1e-4)


def make(M, N, B, seed):
    """The random-batch recipe of tests/test_pallas_simplex.py::make."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32)
    x0 = rng.random((B, N)).astype(np.float32)
    b = (x0 @ A.T + 0.5 + rng.random((B, M))).astype(np.float32)
    c = rng.standard_normal((B, N)).astype(np.float32)
    rlb = np.full((B, M), -np.inf, np.float32)
    clb = np.zeros((B, N), np.float32)
    cub = np.full((B, N), 10.0, np.float32)
    return A, c, rlb, b, clb, cub


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (M, N, B, variant, C): one shape per kernel variant and cluster size;
# (350, 347) is example10's P2 shape
VARIANT_SHAPES = [(16, 16, 8, "cluster", 1), (160, 160, 16, "cluster", 2),
                  (200, 200, 16, "cluster", 4), (350, 347, 16, "cluster", 8),
                  (500, 500, 8, "cluster", 16), (700, 700, 4, "global", 0)]


def _kernel_and_plain(args, start, dev, monkeypatch):
    """The kernel's LPResult and the plain version's, the latter run on
    the same device inputs and recovered exactly as the wrapper does;
    plus the launches of each variant during the kernel's solve."""
    captured = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        captured["a"] = a
        return real(*a, **kw)

    monkeypatch.setattr(gs, "solve_batch_group", capture)
    before = (gs.CALLS_CLUSTER, gs.CALLS_GLOBAL, gs.CALLS)
    ker = gs.lp_batch_group(*args, device=dev, start_basis=start)
    torch.cuda.synchronize()
    launched = tuple(x - y for x, y in zip(
        (gs.CALLS_CLUSTER, gs.CALLS_GLOBAL, gs.CALLS), before))
    out = gs.solve_batch_group_reference(*captured["a"], group=1)
    monkeypatch.setattr(gs, "solve_batch_group", lambda *a, **kw: out)
    plain = gs.lp_batch_group(*args, device=dev, start_basis=start)
    monkeypatch.setattr(gs, "solve_batch_group", real)
    return ker, plain, launched


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("shape", VARIANT_SHAPES,
                         ids=[f"{v}{c}-M{m}" for m, _, _, v, c in VARIANT_SHAPES])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, warm,
                                              monkeypatch):
    """Each variant against the plain version on its shape, cold and from
    one shared warm basis: equal status per LP; obj within 1e-4 (float32,
    the kernel and the plain version sum in other orders); at M=N=16
    (sequential sums) the same basis and iterations on every LP.  The
    launch lands on the planned variant and only there."""
    M, N, B, kind, C = shape
    assert gs.plan(*gs.padded_shape(M, N)) == (kind, C)
    args = make(M, N, B, seed=0)
    start = None
    if warm:
        cold = gs.lp_batch_group(*args, device=cuda_device)
        i0 = int(np.flatnonzero(cold.status == OPTIMAL)[0])
        start = (cold.basis[i0], cold.at_upper[i0])
    ker, plain, launched = _kernel_and_plain(args, start, cuda_device,
                                             monkeypatch)
    assert launched == ((1, 0, 1) if kind == "cluster" else (0, 1, 1))
    np.testing.assert_array_equal(ker.status, plain.status)
    ok = plain.status == OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(ker.obj[ok], plain.obj[ok], rtol=1e-4,
                               atol=1e-4)
    if M <= 32:
        np.testing.assert_array_equal(ker.basis, plain.basis)
        np.testing.assert_array_equal(ker.iters, plain.iters)


@pytest.mark.cuda
def test_work_counts_on_card(cuda_device, monkeypatch):
    """The cluster kernel's (loop steps, pricing passes, rank-1 updates)
    per LP: pivots <= iters <= steps, and a pass at least every 128
    steps."""
    captured = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        captured["a"] = a
        return real(*a, **kw)

    monkeypatch.setattr(gs, "solve_batch_group", capture)
    gs.lp_batch_group(*make(200, 200, 8, seed=2), device=cuda_device)
    monkeypatch.setattr(gs, "solve_batch_group", real)
    a = captured["a"]
    work = torch.zeros(a[1].shape[0], 3, dtype=torch.int32,
                       device=cuda_device)
    _, _, _, iters = gs.solve_batch_group(*a, work=work)
    steps, passes, pivots = work.cpu().numpy().T
    iters = iters.cpu().numpy()
    assert (pivots <= iters).all() and (iters <= steps).all()
    assert (pivots > 0).all()
    assert (passes >= -(-steps // 128)).all()


@pytest.mark.cuda
def test_wrapper_refuses_groups_on_card(cuda_device):
    with pytest.raises(ValueError, match="group=1"):
        gs.lp_batch_group(*make(16, 16, 8, seed=1), group=8,
                          device=cuda_device)


@pytest.mark.cuda
def test_f32_solve_goes_through_the_kernel(cuda_device):
    calls = gs.CALLS
    res = solve(examples.example05(),
                Options(lp_dtype="float32", eps_benson_phase1=1e-4,
                        eps_benson_phase2=1e-4, write_files=False,
                        device="cuda"))
    assert res.status.name == "OPTIMAL"
    assert gs.CALLS > calls


@pytest.mark.cuda
def test_dual_f32_solve_goes_through_the_kernel(cuda_device):
    calls = gs.CALLS
    res = solve(examples.example05(),
                Options(write_files=False, device="cuda", alg_phase1=Alg.DUAL,
                        alg_phase2=Alg.DUAL, **F32))
    assert res.status.name == "OPTIMAL"
    assert gs.CALLS > calls


def tall(seed, M, N, B):
    """The random-instance recipe of tests/test_revised.py."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    c = rng.standard_normal((B, N))
    row_ub = x0 @ A.T + 0.3 + rng.random((B, M))
    return (A, c, np.full((B, M), -np.inf), row_ub, np.zeros((B, N)),
            np.full((B, N), 5.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((0, 6, 30, 8), np.float64, 1e-9),
                                  ((11, 48, 320, 4), np.float32, 1e-3)])
def test_revised_on_card_matches_cpu(cuda_device, case):
    shape, dtype, tol = case
    args = tall(*shape)
    calls = rv.CALLS
    card = rv.solve_batch_revised(*args, dtype=dtype, device=cuda_device)
    assert rv.CALLS == calls + 1
    cpu = rv.solve_batch_revised(*args, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    np.testing.assert_allclose(card.obj, cpu.obj, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_revised_f32_runs_without_tf32(cuda_device, monkeypatch):
    """Every pivot of a float32 revised solve sees allow_tf32 False, even
    when the caller left it on; the caller's setting comes back after."""
    seen = []
    real = rv._rstep

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(rv, "_rstep", spy)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rv.solve_batch_revised(*tall(11, 48, 320, 4), dtype=np.float32,
                               device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and not any(seen)


def ipm_batch(M, N, B, seed):
    """The random-LP recipe of tests/test_ipm.py::random_lp."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = x0 @ A.T + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    return (A, c, np.full((B, M), -np.inf), b, np.zeros((B, N)),
            np.full((B, N), 10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((24, 40, 4, 0), np.float64, 1e-9),
                                  ((32, 64, 4, 11), np.float32, 1e-3)])
def test_ipm_on_card_matches_cpu(cuda_device, case):
    shape, dtype, tol = case
    args = tuple(np.asarray(a, dtype) for a in ipm_batch(*shape))
    card = ipm.solve_batch_ipm(*args, dtype=dtype, device=cuda_device)
    cpu = ipm.solve_batch_ipm(*args, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    assert (cpu.status == OPTIMAL).all()
    np.testing.assert_allclose(card.obj, cpu.obj, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ipm_f32_runs_without_tf32(cuda_device, monkeypatch):
    """Every iteration of a float32 IPM solve sees allow_tf32 False, even
    when the caller left it on, and the result is the CPU's; the
    caller's setting comes back after."""
    seen = []
    real = ipm._Core.step

    def spy(self, *a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(self, *a, **kw)

    monkeypatch.setattr(ipm._Core, "step", spy)
    args = tuple(np.asarray(a, np.float32) for a in ipm_batch(32, 64, 4, 11))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = ipm.solve_batch_ipm(*args, dtype=np.float32,
                                   device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and not any(seen)
    cpu = ipm.solve_batch_ipm(*args, dtype=np.float32, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    np.testing.assert_allclose(card.obj, cpu.obj, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_ipm_min_routes_f32_solve_past_the_kernel(cuda_device):
    routed, calls = gs.ROUTED, ipm.CALLS
    res = solve(examples.example05(),
                Options(write_files=False, device="cuda", lp_ipm_min=1,
                        **F32))
    assert res.status.name == "OPTIMAL"
    assert ipm.CALLS > calls
    assert gs.ROUTED == routed
