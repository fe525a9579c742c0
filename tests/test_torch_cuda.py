"""The port's CUDA kernel on the card: it builds, launches on the main
path, and agrees with its plain PyTorch version.

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
from bensolve_tpu_torch.lp.simplex import OPTIMAL


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


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_kernel_matches_plain_version_on_card(cuda_device, warm):
    """Equal status per LP; obj within 1e-4 (float32, the kernel and the
    plain version sum in other orders)."""
    args = make(16, 16, 8, seed=0)
    start = None
    if warm:
        cold = gs.lp_batch_group(*args, device="cpu")
        i0 = int(np.flatnonzero(cold.status == OPTIMAL)[0])
        start = (cold.basis[i0], cold.at_upper[i0])
    calls = gs.CALLS
    ker = gs.lp_batch_group(*args, device=cuda_device, start_basis=start)
    torch.cuda.synchronize()
    assert gs.CALLS == calls + 1
    plain = gs.lp_batch_group(*args, device="cpu", start_basis=start)
    np.testing.assert_array_equal(ker.status, plain.status)
    ok = plain.status == OPTIMAL
    np.testing.assert_allclose(ker.obj[ok], plain.obj[ok], rtol=1e-4,
                               atol=1e-4)


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
