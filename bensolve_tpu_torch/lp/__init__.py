"""LP backends: the batched tableau simplex (torch ops), the batched
revised simplex for tall LPs (torch ops) and the per-LP simplex kernel
(CUDA), behind one router."""

from __future__ import annotations

import os

import numpy as np
import torch

# N/M ratio from which a batch routes to the revised simplex: the
# tableau carries (M+N)/M times more state than the basis inverse
REVISED_RATIO = 4


def solve_batch_auto(A, c, row_lb, row_ub, col_lb, col_ub, **kw):
    """Route a batch of LPs to its backend (the role of GLPK's
    glp_simplex dispatch behind lp_solve, bslv_lp.c:219):

    * tall problems (N >= REVISED_RATIO * M): the revised simplex
      (lp/revised.py), whatever the dtype, so a tall batch never
      reaches the kernel;
    * float32 batches on a CUDA device whose shape the kernel takes: the
      per-LP simplex kernel (lp/group_simplex.py); a per-instance warm
      start falls through;
    * otherwise: the lockstep tableau simplex (lp/simplex.py).

    The interior-point route (``ipm_min`` / BENSOLVE_IPM_MIN) is not
    ported yet and raises."""
    from bensolve_tpu_torch.lp import group_simplex, revised, simplex

    if isinstance(A, simplex._PreparedA):
        M, N = A.M, A.N
    else:
        M, N = np.asarray(A).shape[-2:]
    if kw.pop("mesh", None) is not None:
        raise NotImplementedError(
            "mesh: multi-device LP sharding is not ported to "
            "bensolve_tpu_torch yet (ROADMAP Queue 1, mesh/distributed)")
    verbose = kw.pop("verbose", 0)
    ipm_min = kw.pop("ipm_min", 0) or _ipm_min_env()
    if ipm_min and M + N >= ipm_min:
        raise NotImplementedError(
            "the interior-point LP route (lp_ipm_min / BENSOLVE_IPM_MIN) is "
            "not ported to bensolve_tpu_torch yet (ROADMAP Queue 1, IPM)")
    if N >= REVISED_RATIO * M:
        return revised.solve_batch_revised(A, c, row_lb, row_ub, col_lb,
                                           col_ub, verbose=verbose, **kw)
    device = kw.get("device", "cuda")
    if _kernel_eligible(M, N, kw, device):
        res = group_simplex.try_solve_batch(A, c, row_lb, row_ub, col_lb,
                                            col_ub, **kw)
        if res is not None:
            return res
    return simplex.solve_batch(A, c, row_lb, row_ub, col_lb, col_ub, **kw)


def _ipm_min_env() -> int:
    v = os.environ.get("BENSOLVE_IPM_MIN")
    return max(int(v), 0) if v else 0


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
