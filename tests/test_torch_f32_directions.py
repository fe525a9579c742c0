"""ROADMAP Queue 3 m and g: the extreme directions of a float32 solve lie
in the recession cone of the float64 solve's.

At float32 (epsilon 1e-4) a cut's normal carries ~1e-7 of rounding; one
that falls just outside the true cone of facet normals cuts into the
recession cone, and the new extreme ray lies on a face of the true cone
wherever that normal's rounding puts it (example10 on an H100: [1, 0,
0.5], 26.6 degrees from every true direction; ex11 on the CPU: 8 of 112
directions more than 1 degree off).  Such a direction is a redundant
generator of the right image, not a wrong one: every float32 direction
d must lie in the cone of the float64 directions R, the nonnegative
least-squares residual of R^T lambda = d / |d| at most 1e-4, and the
upper image must pass the support-function oracle at 1e-3.  R comes
from the JAX package's float64 solve of the same example, and the
port's float64 directions must equal it.  Both LP
routes of a float32 batch on the CPU are held: the tableau simplex, and
the kernel's route (BENSOLVE_FORCE_PALLAS=1, its plain PyTorch version).
"""

import numpy as np
import pytest
import torch
from scipy.optimize import nnls

import bensolve_tpu_torch as bt
from bensolve_tpu import examples as jax_examples
from bensolve_tpu.algs.driver import solve as jax_solve
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu_torch import examples
from bensolve_tpu_torch.bench import check_support
from tests.test_torch_e2e import _norm, assert_sets_close

F32 = dict(lp_dtype="float32", eps_benson_phase1=1e-4, eps_benson_phase2=1e-4)
CONE_RESIDUAL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_F64 = {}


def jax_f64_directions(name):
    """The JAX package's float64 extreme directions of an example (one
    solve per example for the module)."""
    if name not in _JAX_F64:
        r = jax_solve(getattr(jax_examples, name)(),
                      JaxOptions(write_files=False))
        assert r.status.name == "OPTIMAL"
        _JAX_F64[name] = np.asarray(r.primal_directions, float)
    return _JAX_F64[name]


def cone_residuals(dirs, ref):
    R = (ref / np.linalg.norm(ref, axis=1, keepdims=True)).T
    return np.array([nnls(R, d / np.linalg.norm(d))[1] for d in dirs])


@pytest.mark.parametrize("route", ["tableau", "kernel"])
@pytest.mark.parametrize("name", ["example05", "example11"])
def test_f32_directions_lie_in_the_f64_cone(name, route, monkeypatch):
    if route == "kernel":
        monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    vlp = getattr(examples, name)
    R = jax_f64_directions(name)
    ref = bt.solve(vlp(), bt.Options(write_files=False, device="cpu"))
    assert ref.status.name == "OPTIMAL"
    assert_sets_close(_norm(ref.primal_directions), _norm(R), 1e-7)
    got = bt.solve(vlp(), bt.Options(write_files=False, device="cpu", **F32))
    assert got.status.name == "OPTIMAL"
    dirs = got.primal_directions
    assert len(dirs) >= len(R)
    assert cone_residuals(dirs, R).max() <= CONE_RESIDUAL
    check_support(got, 1e-3)


def test_cone_residual_sees_a_direction_outside():
    """The measure itself: a direction off the unit axes' cone (R^3_+)
    by 1e-2 fails, one on its face y2 = 0 passes."""
    axes = np.eye(3)
    assert cone_residuals(np.array([[1.0, 0.0, 0.5]]), axes)[0] <= 1e-12
    assert cone_residuals(np.array([[1.0, -0.01, 0.5]]), axes)[0] > 1e-3
