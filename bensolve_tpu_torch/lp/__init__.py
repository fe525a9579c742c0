"""LP backends: the batched tableau simplex (torch ops), the batched
revised simplex for tall LPs (torch ops), the interior-point method for
large LPs (torch ops) and the per-LP simplex kernel (CUDA), behind one
router."""

from __future__ import annotations

import os

import numpy as np
import torch

from bensolve_tpu_torch import spans

# N/M ratio from which a batch routes to the revised simplex: the
# tableau carries (M+N)/M times more state than the basis inverse
REVISED_RATIO = 4


def solve_batch_auto(A, c, row_lb, row_ub, col_lb, col_ub, **kw):
    """Route a batch of LPs to its backend (the role of GLPK's
    glp_simplex dispatch behind lp_solve, bslv_lp.c:219):

    * M + N >= min(``ipm_min``, BENSOLVE_IPM_MIN), where either is set:
      the Mehrotra interior-point method (lp/ipm.py), ahead of every
      simplex route; ``warm_interior`` is its carried interior start;
    * tall problems (N >= REVISED_RATIO * M): the revised simplex
      (lp/revised.py), whatever the dtype, so a tall batch never
      reaches the kernel;
    * float32 batches on a CUDA device whose shape the kernel takes: the
      per-LP simplex kernel (lp/group_simplex.py); a per-instance warm
      start falls through;
    * otherwise: the lockstep tableau simplex (lp/simplex.py).

    ``mesh`` (Options.mesh_axes): as in the JAX package, a meshed batch
    takes neither the interior-point method nor the kernel; the revised
    and the tableau simplex shard it over the mesh (parallel/mesh.py)."""
    from bensolve_tpu_torch.lp import group_simplex, revised, simplex

    if isinstance(A, simplex._PreparedA):
        M, N = A.M, A.N
    else:
        M, N = np.asarray(A).shape[-2:]
    mesh = kw.pop("mesh", None)
    verbose = kw.pop("verbose", 0)
    # Options.lp_ipm_min and BENSOLVE_IPM_MIN: whichever enables the
    # route (the smaller threshold) wins
    ipm_min = kw.pop("ipm_min", 0) or (1 << 62)
    warm_interior = kw.pop("warm_interior", None)
    if mesh is None and M + N >= min(ipm_min, _ipm_min_size()):
        from bensolve_tpu_torch.lp import ipm

        if spans.ON:
            spans.tag(route="ipm")
        ipm_kw = {}
        if "max_iter" in kw:
            ipm_kw["max_iter"] = kw["max_iter"]
        return ipm.solve_batch_ipm(A, c, row_lb, row_ub, col_lb, col_ub,
                                   dtype=kw.get("dtype", np.float64),
                                   verbose=verbose,
                                   warm_interior=warm_interior,
                                   device=kw.get("device", "cuda"), **ipm_kw)
    if N >= REVISED_RATIO * M:
        if spans.ON:
            spans.tag(route="revised")
        return revised.solve_batch_revised(A, c, row_lb, row_ub, col_lb,
                                           col_ub, mesh=mesh, verbose=verbose,
                                           **kw)
    device = kw.get("device", "cuda")
    if mesh is None and _kernel_eligible(M, N, kw, device):
        res = group_simplex.try_solve_batch(A, c, row_lb, row_ub, col_lb,
                                            col_ub, **kw)
        if res is not None:
            if spans.ON:
                spans.tag(route="kernel")
            return res
    if spans.ON:
        spans.tag(route="tableau")
    return simplex.solve_batch(A, c, row_lb, row_ub, col_lb, col_ub,
                               mesh=mesh, **kw)


def _ipm_min_size() -> int:
    """M+N from which BENSOLVE_IPM_MIN routes to the interior-point
    method; unset or 0 disables the variable."""
    v = os.environ.get("BENSOLVE_IPM_MIN")
    n = int(v) if v else 0
    return n if n > 0 else 1 << 62


def _kernel_eligible(M: int, N: int, kw, device) -> bool:
    """The kernel's gate: a float32 request on a CUDA device, at a shape
    the kernel takes.  BENSOLVE_FORCE_PALLAS=1 routes float32 batches to
    the kernel's path on any device (on the CPU the plain version runs;
    the CPU tests use it)."""
    if np.dtype(kw.get("dtype", np.float64)) != np.dtype(np.float32):
        return False
    forced = os.environ.get("BENSOLVE_FORCE_PALLAS") == "1"
    if not forced and torch.device(device).type != "cuda":
        return False
    from bensolve_tpu_torch.lp import group_simplex

    return group_simplex.shape_supported(M, N)
