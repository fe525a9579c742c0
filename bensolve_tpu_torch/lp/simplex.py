"""Batched dense bounded-variable primal simplex, in PyTorch.

The torch port of ``bensolve_tpu/lp/simplex.py``: the same lockstep
tableau algorithm, the same tolerances and tie-breaks, so that both
packages take the same pivots on the same inputs.

Formulation (GLPK-compatible, bslv_lp.h:60-105):

    variables   z = (s, x),  s in R^M auxiliary (rows), x in R^N structural
    equalities  E z = 0  with  E = [I | -A]          (s = A x)
    bounds      lb <= z <= ub   (+-inf allowed, lb == ub means fixed)
    objective   min c' z        (c zero on auxiliaries in practice)

Algorithm: bounded-variable primal *tableau* simplex.  The state is the
full tableau W = Binv @ E of shape (B, M, NT); one pivot is a rank-1
update of W.  Composite phase 1 (costs +-1 on out-of-bounds basics),
devex pricing with Bland's rule after a degeneracy stall, bound flips,
and one batched LU at termination for accurate primal and dual
solutions.  Every tensor lives on the device the caller names; the
host loop only reads the status vector between segments of pivots.

Statuses mirror lp_status_type (bslv_lp.h:44).  Duals follow GLPK's
sign convention (row dual >= 0 for a binding lower row bound of a min
problem).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import types

import numpy as np
import torch

from bensolve_tpu_torch import spans
from bensolve_tpu_torch.lp import segments, tableau_step

# status codes
RUNNING = 0
OPTIMAL = 1
INFEASIBLE = 2
UNBOUNDED = 3
ITLIM = 4
DUAL_LOST = 5  # dual simplex lost dual feasibility: retry with primal

BLAND_AFTER = 64  # consecutive degenerate steps before switching to Bland

# pivots between two reads of the status vector grow 1, 2, 4, ... up to
# this cap: warm re-solves finish in a handful of pivots, so a long fixed
# segment would stream the whole tableau for nothing
SEGMENT_MAX = 64


def _tols(dtype):
    """(feasibility, reduced-cost, pivot) tolerances per dtype, as in
    the JAX package: float64 matches GLPK-era 1e-9; float32 is looser,
    with a coarse pivot tolerance (a pivot of size p amplifies basis
    inverse error by ~1/p)."""
    if dtype == torch.float32:
        return 1e-5, 1e-5, 1e-4
    return 1e-9, 1e-9, 1e-11


def torch_dtype(dtype) -> torch.dtype:
    """float32 / float64 from a numpy dtype, its name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"LP dtype must be float32 or float64, not {dtype}")
    return out


def resolve_device(device) -> torch.device:
    """The torch device for LP tensors.  A CUDA device that is not
    there raises: the solver never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"LP device {device!r} requested but torch.cuda.is_available() "
            f"is False (pass device='cpu' to run on the CPU)")
    return dev


@dataclasses.dataclass
class LPResult:
    """Mirror of the GLPK getters used by the reference
    (bslv_lp.c:261-308).  Host numpy arrays."""

    status: np.ndarray    # (B,) int
    obj: np.ndarray       # (B,) objective value c'x
    x: np.ndarray         # (B, N) structural primal values
    s: np.ndarray         # (B, M) row activities (auxiliary primals)
    row_dual: np.ndarray  # (B, M) row duals, GLPK sign
    col_dual: np.ndarray  # (B, N) reduced costs of structural variables
    iters: np.ndarray     # (B,) pivot count
    basis: np.ndarray | None = None  # (B, M) final basis (warm-start seed)
    at_upper: np.ndarray | None = None  # (B, M+N) nonbasic bound pattern
    quality: np.ndarray | None = None  # (B,) solution quality; None (the
    #   simplex family) means clean: exact basic solutions


def concat_results(parts: list) -> "LPResult":
    """Concatenate chunked LPResults field-wise; a field that is None in
    any part stays None."""
    vals = []
    for f in dataclasses.fields(LPResult):
        cols = [getattr(p, f.name) for p in parts]
        vals.append(None if any(v is None for v in cols)
                    else np.concatenate(cols))
    return LPResult(*vals)


def _put(arr, dev) -> torch.Tensor:
    """A host array as a tensor on ``dev`` (read-only or strided arrays
    are copied first: torch tensors must own writable memory)."""
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(dev)


def _take(x, idx):
    """x[b, idx[b]] for a (B, K) tensor and (B,) indices."""
    return x.gather(1, idx[:, None])[:, 0]


def _set_at(x, idx, val, mask):
    """Copy of (B, K) ``x`` with x[b, idx[b]] = val[b] where mask[b]."""
    old = _take(x, idx)
    return x.scatter(1, idx[:, None], torch.where(mask, val, old)[:, None])


def _nb_value(lb, ub, at_upper):
    """Value of a nonbasic variable resting at its active bound."""
    zero = lb.new_zeros(())
    fin_lb, fin_ub = torch.isfinite(lb), torch.isfinite(ub)
    lo = torch.where(fin_lb, lb, torch.where(fin_ub, ub, zero))
    hi = torch.where(fin_ub, ub, torch.where(fin_lb, lb, zero))
    return torch.where(at_upper, hi, lo)


def _e_matmul(A, v):
    """E @ v for E = [I | -A]; v is (B, M+N).  ``A`` is (M, N) shared or
    (B, M, N) per-instance (scenario batches)."""
    M = A.shape[-2]
    if A.ndim == 3:
        return v[:, :M] - torch.bmm(A, v[:, M:, None])[:, :, 0]
    return v[:, :M] - v[:, M:] @ A.T


def _e_rmatmul(A, y):
    """E^T @ y; y has shape (B, M)."""
    if A.ndim == 3:
        return torch.cat([y, -torch.bmm(y[:, None, :], A)[:, 0, :]], dim=1)
    return torch.cat([y, -(y @ A)], dim=1)


def _E(A):
    """[I | -A]: (M, NT) for a shared matrix, (B, M, NT) for a 3-D one."""
    M = A.shape[-2]
    eye = torch.eye(M, dtype=A.dtype, device=A.device)
    if A.ndim == 3:
        return torch.cat([eye.expand(A.shape[0], M, M), -A], dim=2)
    return torch.cat([eye, -A], dim=1)


def _batched_basis_matrices(A, bases):
    """(B, M, M) basis matrices whose columns are E[:, bases[b, k]]: a
    plain row gather of E^T for a shared matrix, a per-instance column
    gather for a 3-D one."""
    if A.ndim == 3:
        M = A.shape[1]
        return _E(A).gather(2, bases[:, None, :].expand(-1, M, -1))
    return _E(A).T[bases].transpose(1, 2)


# order from which the CPU factors a batch one matrix at a time (below)
_CPU_LU_ONE_BY_ONE = 128
# torch factors and solves batched LUs on the card through MAGMA, which
# is not safe to enter from several threads at once.  The threads of
# parallel/mesh.py (the mesh's shards, the many-VLP engine's groups) set
# _SHARD_THREAD.on; their CUDA LU calls take turns, each finished on its
# stream before the next begins.  Other threads call torch directly.
_CUDA_LU_LOCK = threading.Lock()
_SHARD_THREAD = threading.local()


@contextlib.contextmanager
def _lu_turn(t):
    if t.device.type != "cuda" or not getattr(_SHARD_THREAD, "on", False):
        yield
        return
    with _CUDA_LU_LOCK:
        yield
        torch.cuda.current_stream(t.device).synchronize()


def _lu_solve(LU, piv, B, **kw):
    """torch.linalg.lu_solve, taking its turn on the card (_lu_turn)."""
    with _lu_turn(LU):
        return torch.linalg.lu_solve(LU, piv, B, **kw)


def _lu_factor(Bmat):
    """Batched LU with partial pivoting; numerically singular pivots are
    clamped to +-tiny (as the JAX package does) so the solves return
    whatever accuracy survives instead of inf/nan.

    On the CPU with more than one intra-op thread, a batch of matrices
    sent to torch.linalg.lu_factor_ex at once made oneMKL's getrf report
    "Parameter 6 was incorrect on entry to DLASWP" (SLASWP at float32)
    and never return at order 256 (random matrices) and 350 (example10's
    bases); one matrix per call does not.  So a CPU batch of order
    _CPU_LU_ONE_BY_ONE = 128 or more, below the least order seen to
    hang, is factored one matrix at a time."""
    if (Bmat.device.type == "cpu" and Bmat.ndim == 3 and Bmat.shape[0] > 1
            and Bmat.shape[-1] >= _CPU_LU_ONE_BY_ONE
            and torch.get_num_threads() > 1):
        parts = [torch.linalg.lu_factor_ex(Bmat[i:i + 1])
                 for i in range(Bmat.shape[0])]
        LU = torch.cat([p[0] for p in parts])
        piv = torch.cat([p[1] for p in parts])
    else:
        with _lu_turn(Bmat):
            LU, piv, _ = torch.linalg.lu_factor_ex(Bmat)
    tiny = 1e-30 if LU.dtype == torch.float64 else 1e-20
    d = LU.diagonal(dim1=-2, dim2=-1)
    sign = torch.where(d < 0, -tiny, tiny)
    LU.diagonal(dim1=-2, dim2=-1).copy_(
        torch.where(d.abs() < tiny, sign, d))
    return LU, piv


@dataclasses.dataclass
class _State:
    basis: torch.Tensor      # (B, M) int64 variable index per basis slot
    in_basis: torch.Tensor   # (B, NT) bool
    at_upper: torch.Tensor   # (B, NT) bool (meaningful for nonbasic)
    W: torch.Tensor          # (B, M, NT) tableau Binv @ E
    xb: torch.Tensor         # (B, M) basic variable values
    lbB: torch.Tensor        # (B, M) bounds of basic variables
    ubB: torch.Tensor        # (B, M)
    cB: torch.Tensor         # (B, M) true costs of basic variables
    status: torch.Tensor     # (B,) int32
    stall: torch.Tensor      # (B,) int32 consecutive degenerate steps
    iters: torch.Tensor      # (B,) int32
    gamma: torch.Tensor | None = None  # (B, NT) devex reference weights
    # (B, NT) reduced costs of the next step, carried by the CUDA step
    # (lp/tableau_step.py) from the start of a pivot loop; None elsewhere
    d: torch.Tensor | None = None


def _devex_entering(d, eligible, gamma, use_bland):
    """Entering-variable choice: devex scores d^2/gamma, Bland's rule
    after a degeneracy stall.  argmax returns the first index on ties,
    as jnp.argmax does."""
    NT = d.shape[1]
    neg_inf = d.new_full((), -float("inf"))
    devex_score = torch.where(eligible, d * d / gamma, neg_inf)
    lane = torch.arange(NT, dtype=d.dtype, device=d.device)
    bland_score = torch.where(eligible, -lane, neg_inf)
    score = torch.where(use_bland[:, None], bland_score, devex_score)
    return score.argmax(dim=1)


def _devex_update(gamma, w_r_scaled, alpha_r, q_idx, leaving, do_pivot):
    """Forrest-Goldfarb reference-weight update after a pivot."""
    gamma_q = _take(gamma, q_idx)
    g_upd = torch.maximum(gamma, w_r_scaled * w_r_scaled * gamma_q[:, None])
    g_leave = torch.clamp(gamma_q / (alpha_r * alpha_r), min=1.0)
    g_upd = g_upd.scatter(1, leaving[:, None], g_leave[:, None])
    g_new = torch.where(do_pivot[:, None], g_upd, gamma)
    return torch.where(g_new > 1e8, torch.ones_like(g_new), g_new)


def _basis_masks(c, lb, ub, M, basis0, at_upper0):
    """A start's (B, M) basis and (B, NT) in_basis / at_upper masks from
    ``basis0``: None (slack basis), a shared (M,) basis or per-instance
    (B, M) bases; ``at_upper0``: the previous solution's nonbasic bound
    pattern, (NT,) or (B, NT), or None."""
    B, NT = c.shape
    dev = c.device
    if basis0 is None:
        basis = torch.arange(M, device=dev).repeat(B, 1)
        in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
        in_basis[:, :M] = True
    elif basis0.ndim == 2:
        basis = basis0.long().contiguous()
        in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
        in_basis.scatter_(1, basis, True)
    else:
        b0 = basis0.long()
        basis = b0.expand(B, M).clone()
        in_basis1 = torch.zeros(NT, dtype=torch.bool, device=dev)
        in_basis1[b0] = True
        in_basis = in_basis1.expand(B, NT).clone()
    fin_lb, fin_ub = torch.isfinite(lb), torch.isfinite(ub)
    if at_upper0 is None:
        at_upper = (~fin_lb) & fin_ub & ~in_basis
    else:
        at_upper = at_upper0.bool()
        if at_upper.ndim == 1:
            at_upper = at_upper[None, :]
        at_upper = at_upper.expand(B, NT)
        # only meaningful where resting at ub is actually possible
        at_upper = at_upper & fin_ub & ~in_basis
        # a nonbasic with only an upper bound must rest there
        at_upper = at_upper | ((~fin_lb) & fin_ub & ~in_basis)
    return basis, in_basis, at_upper


def _initial_state(A, c, lb, ub, basis0=None, at_upper0=None):
    """Initial tableau state.  ``basis0``: None (slack basis), a shared
    (M,) basis (one LU for the whole batch) or per-instance (B, M)
    bases (batched LU).  ``at_upper0``: the previous solution's nonbasic
    bound pattern, (NT,) or (B, NT).  Over per-instance matrices
    (``A`` (B, M, N)) E is per-instance too, and a shared warm basis is
    still one factorization per instance."""
    B, NT = c.shape
    M = A.shape[-2]
    E = _E(A)
    if basis0 is not None and basis0.ndim == 1 and A.ndim == 3:
        basis0 = basis0.expand(B, M)
    basis, in_basis, at_upper = _basis_masks(c, lb, ub, M, basis0, at_upper0)
    if basis0 is None:
        # a 3-D E is this call's own tensor: the tableau may take it
        W = E if A.ndim == 3 else E.repeat(B, 1, 1)
    elif basis0.ndim == 2:
        LU, piv = _lu_factor(_batched_basis_matrices(A, basis))
        W = _lu_solve(LU, piv, E.expand(B, M, NT))
    else:
        LU, piv = _lu_factor(_batched_basis_matrices(A, basis0.long()[None]))
        W0 = _lu_solve(LU, piv, E[None])
        W = W0.expand(B, M, NT).clone()
    return _start_state(c, lb, ub, basis, in_basis, at_upper, W)


def _start_state(c, lb, ub, basis, in_basis, at_upper, W):
    """xb = -W zn, the basic bound/cost rows, and the crossed-bounds
    rejection shared by every start."""
    B = c.shape[0]
    zn = torch.where(in_basis, c.new_zeros(()), _nb_value(lb, ub, at_upper))
    # xb solves B xb = -E zn;  xb = -W @ zn
    xb = -torch.bmm(W, zn[:, :, None])[:, :, 0]
    zeros = torch.zeros(B, dtype=torch.int32, device=c.device)
    # crossed bounds (lb > ub) make an instance trivially infeasible, and
    # the phase-1 machinery cannot see them on NONBASIC variables
    crossed = (lb > ub).any(dim=1)
    status = torch.where(crossed, torch.full_like(zeros, INFEASIBLE), zeros)
    return _State(basis, in_basis, at_upper, W, xb,
                  lb.gather(1, basis), ub.gather(1, basis), c.gather(1, basis),
                  status, zeros, zeros.clone(), torch.ones_like(c))


def _phase_costs(st):
    """The step's view of the basics: (viol_lo, viol_up, feasible,
    cB_eff), the effective basic costs being the true costs in phase 2
    and +-1 on the violating basics in the composite phase 1."""
    TOL_BND = _tols(st.xb.dtype)[0]
    zero = st.xb.new_zeros(())
    one = st.xb.new_ones(())
    viol_lo = st.xb < st.lbB - TOL_BND
    viol_up = st.xb > st.ubB + TOL_BND
    feasible = ~(viol_lo | viol_up).any(dim=1)                     # (B,)
    cB1 = torch.where(viol_up, one, zero) + torch.where(viol_lo, -one, zero)
    cB_eff = torch.where(feasible[:, None], st.cB, cB1)
    return viol_lo, viol_up, feasible, cB_eff


@dataclasses.dataclass
class _Pivot:
    """What one pivot decides on the (B, M) vectors (``_pivot``): the new
    basis metadata, and what the caller's tableau or basis-inverse
    update needs."""

    basis: torch.Tensor
    xb: torch.Tensor
    lbB: torch.Tensor
    ubB: torch.Tensor
    cB: torch.Tensor
    status: torch.Tensor
    stall: torch.Tensor
    iters: torch.Tensor
    r_idx: torch.Tensor           # (B,) leaving slot
    alpha_r: torch.Tensor         # (B,) pivot element, clamped off zero
    coef: torch.Tensor            # (B, M) rank-1 coefficients (0 off pivot)
    act: torch.Tensor             # (B,) a step is taken (pivot or flip)
    do_pivot: torch.Tensor        # (B,) the basis changes
    do_flip: torch.Tensor         # (B,) the entering variable flips bound
    leaving: torch.Tensor         # (B,) leaving variable (global index)
    leave_at_upper: torch.Tensor  # (B,) the bound it rests at


def _pivot(st, alpha, q_idx, ent, viol_lo, viol_up, feasible, new_status,
           act, use_bland) -> _Pivot:
    """The ratio test (composite phase-1 aware, short-step rule), the
    entering variable's bound flip and the basis metadata of one pivot,
    shared by the tableau and the revised simplex and by their panelled
    forms.  ``st``: the loop state's (B, M) vectors (basis, xb, lbB, ubB,
    cB, stall, iters); ``alpha`` (B, M) the entering column B^-1 E_q;
    ``ent``: the entering variable's (inc, lb, ub, val, c), each (B,):
    whether it increases, its bounds, resting value and cost;
    ``new_status``/``act``: the finish verdicts and which LPs step."""
    TOL_BND, _, TOL_PIV = _tols(alpha.dtype)
    zero = alpha.new_zeros(())
    one = alpha.new_ones(())
    # filled on the device: new_tensor would copy from the host, and a
    # blocking host-to-device copy waits for the card every pivot
    inf = alpha.new_full((), float("inf"))
    sigma = torch.where(ent.inc, one, -one)
    rate = -sigma[:, None] * alpha                                 # dxB/dt

    inc = rate > TOL_PIV
    dec = rate < -TOL_PIV
    target_inc = torch.where(viol_lo, st.lbB, st.ubB)
    target_dec = torch.where(viol_up, st.ubB, st.lbB)
    t_inc = torch.where(viol_up, inf, (target_inc - st.xb) / rate)
    t_dec = torch.where(viol_lo, inf, (target_dec - st.xb) / rate)
    t = torch.where(inc, t_inc, torch.where(dec, t_dec, inf))
    t = torch.maximum(t, zero)
    t = torch.where(torch.isnan(t), inf, t)

    tmin = t.min(dim=1).values                                     # (B,)
    # leaving among near-minimal ratios: largest |pivot| (stability), or
    # smallest variable index under Bland
    cand = t <= tmin[:, None] + 1e-12
    stab_score = torch.where(cand, rate.abs(), -one)
    bland_leave = torch.where(cand, -st.basis.to(alpha.dtype), -inf)
    leave_score = torch.where(use_bland[:, None], bland_leave, stab_score)
    r_idx = leave_score.argmax(dim=1)                              # (B,)

    # entering variable's own opposite bound (bound flip)
    span = ent.ub - ent.lb
    span = torch.where(torch.isfinite(span), span, inf)
    do_flip = span < tmin
    t_star = torch.where(do_flip, span, tmin)

    unbounded = act & feasible & ~torch.isfinite(t_star)
    new_status = torch.where(unbounded, UNBOUNDED, new_status).to(torch.int32)
    act = act & torch.isfinite(t_star)

    # apply the step
    delta = torch.where(act, sigma * t_star, zero)                 # (B,)
    xb_new = st.xb - delta[:, None] * alpha

    do_pivot = act & ~do_flip
    alpha_r = _take(alpha, r_idx)
    alpha_r = torch.where(alpha_r.abs() < TOL_PIV,
                          torch.where(alpha_r < 0, -TOL_PIV * one,
                                      TOL_PIV * one), alpha_r)
    # rank-1 coefficients: alpha_i off row r, alpha_r - 1 on it (the row
    # replacement), 0 where no pivot is taken
    coef = alpha.scatter_add(1, r_idx[:, None],
                             -torch.ones_like(alpha_r)[:, None])
    coef = torch.where(do_pivot[:, None], coef, zero)

    leaving = _take(st.basis, r_idx)
    xb_new = _set_at(xb_new, r_idx, ent.val + delta, do_pivot)
    basis_new = _set_at(st.basis, r_idx, q_idx, do_pivot)

    # incremental basis metadata at slot r
    lbB_new = _set_at(st.lbB, r_idx, ent.lb, do_pivot)
    ubB_new = _set_at(st.ubB, r_idx, ent.ub, do_pivot)
    cB_new = _set_at(st.cB, r_idx, ent.c, do_pivot)

    # leaving variable rests at the ratio-test target bound
    rate_r = _take(rate, r_idx)
    leave_at_upper = torch.where(rate_r > 0, ~_take(viol_lo, r_idx),
                                 _take(viol_up, r_idx))

    degen = act & (t_star < TOL_BND)
    stall_new = torch.where(act, torch.where(degen, st.stall + 1, 0),
                            st.stall).to(torch.int32)
    iters_new = st.iters + act.to(torch.int32)
    return _Pivot(basis_new, xb_new, lbB_new, ubB_new, cB_new, new_status,
                  stall_new, iters_new, r_idx, alpha_r, coef, act, do_pivot,
                  do_flip, leaving, leave_at_upper)


def _step(A, c, lb, ub, st: _State) -> _State:
    """One primal pivot for every running LP of the batch: on a CUDA
    device the two kernels of lp/tableau_step.py (from a state whose
    reduced costs ``d`` that module priced), elsewhere ``_step_plain``."""
    if tableau_step.on_card(st):
        return tableau_step.step(c, lb, ub, st, dual=False)
    return _step_plain(A, c, lb, ub, st)


# which step a pivot loop runs (_run_segmented prices for it)
_step.dual = False


def _reduced_costs(c_eff, cB_eff, W):
    """c_eff - cB_eff W, the prices of the plain steps (one place, so
    that a comparison can hand them the CUDA step's own prices)."""
    return c_eff - torch.bmm(cB_eff[:, None, :], W)[:, 0, :]


def _step_plain(A, c, lb, ub, st: _State) -> _State:
    """One primal pivot for every running LP of the batch, in torch ops
    (the torch form of the JAX package's ``_step``)."""
    TOL_DJ = _tols(c.dtype)[1]
    running = st.status == RUNNING
    zero = c.new_zeros(())
    viol_lo, viol_up, feasible, cB_eff = _phase_costs(st)

    # reduced costs d = c_eff - cB_eff @ W (duals y never materialized)
    d = _reduced_costs(torch.where(feasible[:, None], c, zero), cB_eff,
                       st.W)

    # entering variable
    val = _nb_value(lb, ub, st.at_upper)
    can_inc = (~st.in_basis) & (val < ub)
    can_dec = (~st.in_basis) & (val > lb)
    elig_inc = can_inc & (d < -TOL_DJ)
    elig_dec = can_dec & (d > TOL_DJ)
    eligible = elig_inc | elig_dec
    use_bland = st.stall > BLAND_AFTER
    q_idx = _devex_entering(d, eligible, st.gamma, use_bland)
    has_entering = eligible.any(dim=1)

    # finished instances: optimal if feasible, else proven infeasible
    finish_status = torch.where(feasible, OPTIMAL, INFEASIBLE).to(torch.int32)
    new_status = torch.where(running & ~has_entering, finish_status,
                             st.status)
    act = running & has_entering                                   # will pivot

    # pivot column alpha = Binv E_q = W[:, :, q]
    alpha = st.W.gather(
        2, q_idx[:, None, None].expand(-1, st.W.shape[1], 1))[:, :, 0]
    ent = types.SimpleNamespace(inc=_take(elig_inc, q_idx),
                                lb=_take(lb, q_idx), ub=_take(ub, q_idx),
                                val=_take(val, q_idx), c=_take(c, q_idx))
    pv = _pivot(st, alpha, q_idx, ent, viol_lo, viol_up, feasible,
                new_status, act, use_bland)

    # rank-1 tableau update: W_i -= coef_i * (w_r/alpha_r).  W is updated
    # IN PLACE: every start builds a fresh tableau, so no other reference
    # sees it, and the (B, M, NT) tableau is the whole memory footprint
    # (a copy per pivot would double it).
    w_r = st.W.gather(
        1, pv.r_idx[:, None, None].expand(-1, 1, st.W.shape[2]))[:, 0, :]
    w_r_scaled = w_r / pv.alpha_r[:, None]
    W_new = st.W.addcmul_(pv.coef[:, :, None], w_r_scaled[:, None, :],
                          value=-1)

    true = torch.ones_like(pv.do_pivot)
    in_basis_new = _set_at(st.in_basis, q_idx, true, pv.do_pivot)
    in_basis_new = _set_at(in_basis_new, pv.leaving, ~true, pv.do_pivot)
    at_upper_new = _set_at(st.at_upper, pv.leaving, pv.leave_at_upper,
                           pv.do_pivot)
    # bound flip: entering variable switches bound
    q_at_upper = _take(st.at_upper, q_idx)
    at_upper_new = _set_at(at_upper_new, q_idx, ~q_at_upper,
                           pv.act & pv.do_flip)
    gamma_new = _devex_update(st.gamma, w_r_scaled, pv.alpha_r, q_idx,
                              pv.leaving, pv.do_pivot)

    return _State(pv.basis, in_basis_new, at_upper_new, W_new, pv.xb,
                  pv.lbB, pv.ubB, pv.cB, pv.status, pv.stall, pv.iters,
                  gamma_new)


def _final_solutions(A, c, lb, ub, basis, in_basis, at_upper, cB,
                     Bmat=None):
    """Accurate primal/dual recovery at termination: refactorize the
    final basis once (batched LU) so results do not inherit rank-1
    drift from the pivot loop.  ``Bmat``: the (B, M, M) basis matrices
    when the caller already holds them (the revised simplex maintains
    them); otherwise they are gathered from E."""
    M = A.shape[-2]
    if Bmat is None:
        Bmat = _batched_basis_matrices(A, basis)
    zn = torch.where(in_basis, c.new_zeros(()), _nb_value(lb, ub, at_upper))
    rhs = -_e_matmul(A, zn)                                        # (B, M)
    LU, piv = _lu_factor(Bmat)
    xb = _lu_solve(LU, piv, rhs[:, :, None])[:, :, 0]
    y = _lu_solve(LU, piv, cB[:, :, None], adjoint=True)[:, :, 0]
    z = zn.scatter(1, basis, xb)
    obj = (c * z).sum(dim=1)
    d = c - _e_rmatmul(A, y)
    return obj, z[:, M:], z[:, :M], -y, d[:, M:]


def _finish(A, c, lb, ub, st: _State):
    """Status (RUNNING -> ITLIM) plus the refactorized recovery."""
    status = torch.where(st.status == RUNNING, ITLIM, st.status)
    obj, x, s, row_dual, col_dual = _final_solutions(
        A, c, lb, ub, st.basis, st.in_basis, st.at_upper, st.cB)
    return (status, obj, x, s, row_dual, col_dual, st.iters, st.basis,
            st.at_upper)


def _cheap_finish(A, c, lb, ub, st: _State):
    """LU-free termination: primal values from the loop state, duals
    from the tableau's embedded basis inverse (E = [I | -A] makes
    Binv = W[:, :, :M]).  Valid while the carried rank-1 drift is small
    (the caller gates on KeptState.age + this solve's pivots)."""
    status = torch.where(st.status == RUNNING, ITLIM, st.status)
    M = A.shape[-2]
    zn = torch.where(st.in_basis, c.new_zeros(()),
                     _nb_value(lb, ub, st.at_upper))
    z = zn.scatter(1, st.basis, st.xb)
    obj = (c * z).sum(dim=1)
    y = torch.bmm(st.cB[:, None, :], st.W[:, :, :M])[:, 0, :]
    d = c - _e_rmatmul(A, y)
    return (status, obj, z[:, M:], z[:, :M], -y, d[:, M:], st.iters,
            st.basis, st.at_upper)


@dataclasses.dataclass
class KeptState:
    """Final tableau state of a solve, kept ON DEVICE so the next
    Benson round's warm re-solves skip both factorizations: a child LP
    warm-starting from its parent's optimal basis reuses the parent's
    final W = Binv @ E verbatim.  ``age``: pivots accumulated since the
    last true LU along the warm chain (rank-1 drift bound; the owner
    drops the state when it exceeds the refresh threshold)."""

    basis: torch.Tensor      # (B, M)
    in_basis: torch.Tensor   # (B, NT)
    at_upper: torch.Tensor   # (B, NT)
    W: torch.Tensor          # (B, M, NT)
    age: int = 0

    @property
    def nbytes(self) -> int:
        return self.W.numel() * self.W.element_size()


def _keep_state(st: _State, age: int) -> KeptState:
    return KeptState(st.basis, st.in_basis, st.at_upper, st.W, age)


def _concat_kept(states: list[KeptState]) -> KeptState:
    if len(states) == 1:
        return states[0]
    return KeptState(
        torch.cat([s.basis for s in states]),
        torch.cat([s.in_basis for s in states]),
        torch.cat([s.at_upper for s in states]),
        torch.cat([s.W for s in states]),
        max(s.age for s in states))


def _start_from_state(A, c, lb, ub, ks: KeptState, idx) -> _State:
    """Warm start by GATHERING parent rows of a kept state: instance i
    starts from row idx[i] of the previous solve's final tableau.  No
    factorization."""
    basis = ks.basis[idx]
    in_basis = ks.in_basis[idx]
    W = ks.W[idx]
    fin_lb, fin_ub = torch.isfinite(lb), torch.isfinite(ub)
    at_upper = ks.at_upper[idx] & fin_ub & ~in_basis
    at_upper = at_upper | ((~fin_lb) & fin_ub & ~in_basis)
    return _start_state(c, lb, ub, basis, in_basis, at_upper, W)


# pivots of carried rank-1 drift allowed on a warm chain before the
# kept state is dropped and the next solve refactorizes (f64; f32
# chains are capped at a quarter of this)
STATE_WARM_MAX_AGE = 128


def _run_segmented(step_fn, A, c, lb, ub, st: _State, max_iter: int):
    """The pivot loop of ``step_fn`` (_step or dual_simplex._dstep) from
    ``st``.  The state's tensors are made contiguous first, so the
    graphs and the eager loop step the same layout (a warm tableau from
    the LU solve is column-major).

    Where lp/segments.py has a graph backend for the device (CUDA), every
    segment is a replayed CUDA graph of the step, bit for bit the eager
    loop's pivots.  The eager loop runs instead where _graphs_on says
    so: on the CPU (the plain version) and on a mesh's shard threads.

    ``tableau_step.start`` readies the state for the step, told by its
    ``dual`` attribute which one it is: on a CUDA device the steps are
    the kernels of lp/tableau_step.py, which carry the reduced costs
    from step to step, priced there once, before the first step.

    A ``pivot`` span (spans.py) while recording, the pricing inside it;
    every call adds its steps x Bp x Mp x NTp to the ``stepped_cells``
    counter."""
    sp = spans.begin("pivot") if spans.ON else None
    st = dataclasses.replace(st, **{
        f: getattr(st, f).contiguous() for f in segments.FIELDS})
    st = tableau_step.start(c, st, getattr(step_fn, "dual", False))
    loop = _Loop(max_iter)
    if _graphs_on(st.W.device):
        out = segments.run(step_fn, c, lb, ub, st, loop)
    else:
        out = _run_segmented_eager(step_fn, A, c, lb, ub, st, loop)
    Bp, Mp, NTp = st.W.shape
    spans.count_cells(stepped=loop.steps * Bp * Mp * NTp)
    if sp is not None:
        spans.end(sp, Bp=Bp, Mp=Mp, NTp=NTp, steps=loop.steps,
                  segments=loop.segments)
    return out


class _Loop:
    """A pivot loop's schedule: segments of 1, 2, 4, ... SEGMENT_MAX
    steps up to ``max_iter`` in all, each after a read of the status
    vector that finds an LP running.  The read blocks until the card has
    run what was queued before it (a ``pivot.read`` span, counted in
    ``device_reads``).  ``steps`` and ``segments`` count what ran."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self.steps = self.segments = 0
        self._seg = 1

    def next(self, status) -> int:
        """The steps of the next segment; 0 where the loop ends."""
        if self.steps >= self.max_iter:
            return 0
        sp = spans.begin("pivot.read") if spans.ON else None
        running = bool(spans.read((status == RUNNING).any()))
        if sp is not None:
            spans.end(sp)
        if not running:
            return 0
        n = min(self._seg, self.max_iter - self.steps)
        self.steps += n
        self.segments += 1
        self._seg = min(2 * self._seg, SEGMENT_MAX)
        return n


def _graphs_on(dev) -> bool:
    """Whether this thread's pivot loops on ``dev`` replay graphs
    (lp/segments.py): where the device type has a graph backend, off a
    mesh's shard threads (their solves run side by side, each on a
    stream of its own, and the cache's buffers serve one solve at a
    time) and outside segments.eager_loop().  A "tp" panel's step
    crosses its row's devices, so those loops are always eager."""
    return (dev.type in segments.BACKENDS
            and not getattr(_SHARD_THREAD, "on", False)
            and not segments.eager_only())


def _run_segmented_eager(step_fn, A, c, lb, ub, st, loop: _Loop):
    """Host loop around the pivot step, on ``loop``'s schedule.  State
    stays on the device; the status vector comes back once per segment,
    and a segment is only the number of pivots between two such reads.
    Steps taken after an LP finished leave its state unchanged."""
    while n := loop.next(st.status):
        k0 = segments.tally()
        for _ in range(n):
            st = step_fn(A, c, lb, ub, st)
        segments.count_eager(n, segments.loop_of(step_fn),
                             segments.tally() - k0)
    return st


def _solve_tableau_segmented(A, c, lb, ub, basis0, at_upper0, max_iter):
    st = _initial_state(A, c, lb, ub, basis0, at_upper0)
    st = _run_segmented(_step, A, c, lb, ub, st, max_iter)
    return _finish(A, c, lb, ub, st)


# ------------------------------------------------- tp: column panels
#
# Under a mesh with a "tp" axis every LP of a dp row is split into T
# column panels (parallel/mesh.py's PanelLayout), one per tp entry.  A
# panel holds its columns of the tableau and of every per-variable row;
# the row's lead holds the (B, M) basis vectors, the ratio test and the
# status.  One pivot: each panel prices its own columns and picks its
# devex/Bland candidate; the argmax combine picks the entering column and
# its panel sends it (with the entering variable's bounds, cost and
# weight) to the lead; the lead runs ``_pivot`` and sends the pivot's
# slot and coefficients back; each panel updates its own columns.


@dataclasses.dataclass
class _Panel:
    """One tp entry's columns of a panelled LP batch: its per-variable
    rows (B, width) and its slice of the route's matrices."""

    k: int
    dev: torch.device
    gidx: torch.Tensor       # (width,) global index of each local column
    c: torch.Tensor          # (B, width)
    lb: torch.Tensor
    ub: torch.Tensor
    A: torch.Tensor          # (Mp, ns) its columns of A
    AT: torch.Tensor | None = None      # (ns, Mp) the same as rows (revised)
    in_basis: torch.Tensor | None = None
    at_upper: torch.Tensor | None = None
    gamma: torch.Tensor | None = None   # devex weights
    W: torch.Tensor | None = None       # (B, M, width) tableau columns
    Binv: torch.Tensor | None = None    # (B, M, ms) columns of B^-1
    Brows: torch.Tensor | None = None   # (B, M, ms) of the basis rows
    dred: torch.Tensor | None = None    # carried reduced costs (revised)

    @property
    def nbytes(self) -> int:
        ts = (getattr(self, f.name) for f in dataclasses.fields(self))
        return sum(t.numel() * t.element_size() for t in ts
                   if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class _TPState:
    """A dp row's panelled solve: the layout, the row's devices (lead
    first), its panels, the lead's (B, M) loop state (a _State or
    _RState whose per-column fields are None) and the full (B, NT) cost
    and bound rows on the lead.  ``steps`` counts pivot steps."""

    lay: object
    devs: tuple
    panels: list
    lead: object
    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    steps: int = 0

    @property
    def status(self):
        return self.lead.status

    @property
    def xb(self):
        return self.lead.xb


def _tp_panels(lay, devs, A_panels, c, lb, ub, in_basis, at_upper):
    """The row's panels with their slices of the lead's (B, NT) rows."""
    parts = [lay.split(x, fill) for x, fill in
             ((c, 0), (lb, 0), (ub, 0), (in_basis, False),
              (at_upper, False))]
    panels = []
    for k, d in enumerate(devs):
        ck, lbk, ubk, ibk, auk = (x[k].to(d, non_blocking=True)
                                  for x in parts)
        A_k, AT_k = A_panels[(k, d)]
        panels.append(_Panel(k, d, lay.gidx(k, d), ck, lbk, ubk, A_k, AT_k,
                             ibk, auk, torch.ones_like(ck)))
    return panels


def _panel_E(lay, p):
    """Panel p's columns of E = [I | -A]: (Mp, width)."""
    return torch.cat([lay.eye(p.k, p.A.dtype, p.dev), -p.A], dim=1)


def _panel_e_matmul(lay, p, v):
    """Panel p's share of E @ v for its slice ``v`` (B, width): (B, Mp);
    the shares sum to E @ v."""
    return lay.place_rows(v[:, :lay.ms], p.k) - v[:, lay.ms:] @ p.A.T


def _panel_e_rmatmul(lay, p, y):
    """Panel p's columns of E^T @ y for the full y (B, Mp): (B, width)."""
    return torch.cat([lay.rows(y, p.k), -(y @ p.A)], dim=1)


def _panel_zn(p):
    """Nonbasic values on panel p's columns (0 on basics)."""
    return torch.where(p.in_basis, p.c.new_zeros(()),
                       _nb_value(p.lb, p.ub, p.at_upper))


def _tp_e_zn(ts, devs):
    """E @ zn over the row's panels (all-reduce of the panels' shares),
    on ``devs``."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    return pmesh.all_reduce([_panel_e_matmul(ts.lay, p, _panel_zn(p))
                             for p in ts.panels], devs)


def _tp_basis_rows(lay, devs, panels, basis):
    """(nb, M, Mp) rows E[:, basis[b, k]] for a (nb, M) basis on the lead:
    each panel contributes the basis columns it owns (zero elsewhere),
    summed on the lead (exact: one nonzero term per entry)."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    parts = []
    for p, bas in zip(panels, pmesh.to_all(basis, devs)):
        loc, own = lay.local(bas, p.k)
        parts.append(_panel_E(lay, p).T[loc] * own[..., None])
    return pmesh.all_reduce(parts, devs[:1])[0]


def _tp_candidate(p, d, use_bland, tol_dj):
    """Panel p's entering candidate from its reduced costs ``d``
    (B, width): (score, global index, local index, packet), the packet's
    columns (has, inc, lb, ub, val, c, at_upper, gamma) of the candidate,
    as _devex_entering picks over the whole row."""
    val = _nb_value(p.lb, p.ub, p.at_upper)
    elig_inc = (~p.in_basis) & (val < p.ub) & (d < -tol_dj)
    elig_dec = (~p.in_basis) & (val > p.lb) & (d > tol_dj)
    eligible = elig_inc | elig_dec
    neg_inf = d.new_full((), -float("inf"))
    devex = torch.where(eligible, d * d / p.gamma, neg_inf)
    bland = torch.where(eligible, -p.gidx.to(d.dtype), neg_inf)
    score = torch.where(use_bland[:, None], bland, devex)
    loc = score.argmax(dim=1)
    packet = torch.stack(
        [eligible.any(dim=1).to(d.dtype)]
        + [_take(x, loc).to(d.dtype) for x in
           (elig_inc, p.lb, p.ub, val, p.c, p.at_upper, p.gamma)], dim=1)
    return _take(score, loc), p.gidx[loc], loc, packet


_PACKET = 8   # scalar columns of a candidate's packet (_tp_candidate)


def _tp_enter(ts, cands, cols):
    """The argmax combine and the entering column's broadcast: from each
    panel's candidate and its (B, K) column (``cols``), the entering
    global index, the winner's packet as (has, ent, at_upper, gamma) and
    its column, on the lead."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    lead = ts.devs[0]
    winner, q_idx = pmesh.combine_best([s for s, _, _, _ in cands],
                                       [g for _, g, _, _ in cands], lead)
    P = pmesh.select_by_owner(
        [torch.cat([pk, col], dim=1) for (_, _, _, pk), col
         in zip(cands, cols)], winner, lead)
    ent = types.SimpleNamespace(inc=P[:, 1] > 0, lb=P[:, 2], ub=P[:, 3],
                                val=P[:, 4], c=P[:, 5])
    return q_idx, P[:, 0] > 0, ent, P[:, 6] > 0, P[:, 7], P[:, _PACKET:]


def _tp_after_pivot(lay, p, w_r_scaled, sent):
    """Panel p's own columns after a pivot: in_basis and at_upper at the
    entering and leaving variables it owns, and the devex weights
    (_devex_update on its columns)."""
    (alpha_r, do_pivot, flip, q_idx, leaving, leave_at_upper, gamma_q,
     q_at_upper) = sent
    lq, oq = lay.local(q_idx, p.k)
    ll, ol = lay.local(leaving, p.k)
    true = torch.ones_like(do_pivot)
    p.in_basis = _set_at(p.in_basis, lq, true, do_pivot & oq)
    p.in_basis = _set_at(p.in_basis, ll, ~true, do_pivot & ol)
    p.at_upper = _set_at(p.at_upper, ll, leave_at_upper, do_pivot & ol)
    p.at_upper = _set_at(p.at_upper, lq, ~q_at_upper, flip & oq)
    g_upd = torch.maximum(p.gamma,
                          w_r_scaled * w_r_scaled * gamma_q[:, None])
    g_leave = torch.clamp(gamma_q / (alpha_r * alpha_r), min=1.0)
    g_upd = _set_at(g_upd, ll, g_leave, ol)
    g_new = torch.where(do_pivot[:, None], g_upd, p.gamma)
    p.gamma = torch.where(g_new > 1e8, torch.ones_like(g_new), g_new)


def _tp_send_pivot(ts, pv, q_idx, gamma_q, q_at_upper):
    """The lead's pivot decision, on every panel's device: per panel
    (r_idx, coef, (alpha_r, do_pivot, flip, q_idx, leaving,
    leave_at_upper, gamma_q, q_at_upper))."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    fields = (pv.r_idx, pv.coef, pv.alpha_r, pv.do_pivot,
              pv.act & pv.do_flip, q_idx, pv.leaving, pv.leave_at_upper,
              gamma_q, q_at_upper)
    per = list(zip(*(pmesh.to_all(x, ts.devs) for x in fields)))
    return [(f[0], f[1], f[2:]) for f in per]


def _tp_lead_state(c, lb, ub, basis, xb):
    """The lead's (B, M) loop state at a start (per-column fields None)."""
    B = c.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=c.device)
    crossed = (lb > ub).any(dim=1)
    status = torch.where(crossed, torch.full_like(zeros, INFEASIBLE), zeros)
    return _State(basis, None, None, None, xb, lb.gather(1, basis),
                  ub.gather(1, basis), c.gather(1, basis), status, zeros,
                  zeros.clone(), None)


def _tp_initial_state(lay, devs, A_panels, c, lb, ub, basis0, at_upper0):
    """The panelled start of _initial_state: the masks on the lead, split;
    the cold tableau is E's panel per LP; a warm basis is gathered from
    its owning panels and factored once on the lead, and each panel
    solves for its own columns."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    B = c.shape[0]
    M = lay.Mp
    basis, in_basis, at_upper = _basis_masks(c, lb, ub, M, basis0, at_upper0)
    panels = _tp_panels(lay, devs, A_panels, c, lb, ub, in_basis, at_upper)
    if basis0 is None:
        for p in panels:
            p.W = _panel_E(lay, p).repeat(B, 1, 1)
    else:
        shared = basis0.ndim == 1
        rows = _tp_basis_rows(lay, devs, panels,
                              basis0.long()[None] if shared else basis)
        LU, piv = _lu_factor(rows.transpose(1, 2))
        for p, LU_k, piv_k in zip(panels, pmesh.to_all(LU, devs),
                                  pmesh.to_all(piv, devs)):
            E_k = _panel_E(lay, p)
            if shared:
                p.W = _lu_solve(LU_k, piv_k, E_k[None]).expand(
                    B, M, lay.width).clone()
            else:
                p.W = _lu_solve(LU_k, piv_k, E_k.expand(B, M, lay.width))
    # xb = -W @ zn, the panels' shares summed on the lead
    xb = -pmesh.all_reduce(
        [torch.bmm(p.W, _panel_zn(p)[:, :, None])[:, :, 0] for p in panels],
        devs[:1])[0]
    return _TPState(lay, devs, panels, _tp_lead_state(c, lb, ub, basis, xb),
                    c, lb, ub)


def _tp_step(ts: _TPState) -> _TPState:
    """One primal pivot of _step over the row's panels (see above)."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    ld, devs = ts.lead, ts.devs
    TOL_DJ = _tols(ts.c.dtype)[1]
    running = ld.status == RUNNING
    viol_lo, viol_up, feasible, cB_eff = _phase_costs(ld)
    use_bland = ld.stall > BLAND_AFTER

    # each panel prices its own columns and offers its candidate with
    # the candidate's tableau column
    cands, cols = [], []
    for p, cBe, feas, bland in zip(ts.panels, pmesh.to_all(cB_eff, devs),
                                   pmesh.to_all(feasible, devs),
                                   pmesh.to_all(use_bland, devs)):
        d = (torch.where(feas[:, None], p.c, p.c.new_zeros(()))
             - torch.bmm(cBe[:, None, :], p.W)[:, 0, :])
        cand = _tp_candidate(p, d, bland, TOL_DJ)
        cands.append(cand)
        cols.append(p.W.gather(
            2, cand[2][:, None, None].expand(-1, p.W.shape[1], 1))[:, :, 0])
    q_idx, has_entering, ent, q_at_upper, gamma_q, alpha = _tp_enter(
        ts, cands, cols)

    finish_status = torch.where(feasible, OPTIMAL, INFEASIBLE).to(torch.int32)
    new_status = torch.where(running & ~has_entering, finish_status,
                             ld.status)
    act = running & has_entering
    pv = _pivot(ld, alpha, q_idx, ent, viol_lo, viol_up, feasible,
                new_status, act, use_bland)

    # each panel's rank-1 update of its own columns (in place, as _step)
    for p, (r_idx, coef, sent) in zip(
            ts.panels, _tp_send_pivot(ts, pv, q_idx, gamma_q, q_at_upper)):
        w_r = p.W.gather(
            1, r_idx[:, None, None].expand(-1, 1, p.W.shape[2]))[:, 0, :]
        w_r_scaled = w_r / sent[0][:, None]
        p.W.addcmul_(coef[:, :, None], w_r_scaled[:, None, :], value=-1)
        _tp_after_pivot(ts.lay, p, w_r_scaled, sent)
    ts.lead = _State(pv.basis, None, None, None, pv.xb, pv.lbB, pv.ubB,
                     pv.cB, pv.status, pv.stall, pv.iters, None)
    ts.steps += 1
    return ts


def _tp_final_solutions(ts: _TPState, rows=None):
    """_final_solutions over the row's panels: the basis rows ``rows``
    (B, M, M) on the lead (the revised route keeps them), else gathered
    from their owning panels; E @ zn and E^T y are summed or gathered
    across panels, so no device holds the whole A."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    lay, ld, devs = ts.lay, ts.lead, ts.devs
    M = lay.Mp
    if rows is None:
        rows = _tp_basis_rows(lay, devs, ts.panels, ld.basis)
    rhs = -_tp_e_zn(ts, devs[:1])[0]
    LU, piv = _lu_factor(rows.transpose(1, 2))
    xb = _lu_solve(LU, piv, rhs[:, :, None])[:, :, 0]
    y = _lu_solve(LU, piv, ld.cB[:, :, None], adjoint=True)[:, :, 0]
    zn = lay.join([_panel_zn(p).to(devs[0]) for p in ts.panels])
    z = zn.scatter(1, ld.basis, xb)
    obj = (ts.c * z).sum(dim=1)
    d = lay.join([(p.c - _panel_e_rmatmul(lay, p, y_k)).to(devs[0])
                  for p, y_k in zip(ts.panels, pmesh.to_all(y, devs))])
    return obj, z[:, M:], z[:, :M], -y, d[:, M:]


def _tp_finish(ts: _TPState, rows=None):
    """_finish over the row's panels; at_upper joined on the lead."""
    ld = ts.lead
    status = torch.where(ld.status == RUNNING, ITLIM, ld.status)
    obj, x, s, row_dual, col_dual = _tp_final_solutions(ts, rows)
    at_upper = ts.lay.join([p.at_upper.to(ts.devs[0]) for p in ts.panels])
    return (status, obj, x, s, row_dual, col_dual, ld.iters, ld.basis,
            at_upper)


def _solve_tableau_tp(lay, devs, A_panels, c, lb, ub, basis0, at_upper0,
                      max_iter):
    """_solve_tableau_segmented over a dp row's T panels: ``devs`` the
    row's tp entries (the lead first, where c/lb/ub (B, NT) and the warm
    start live), ``A_panels`` {(k, device): (A_k, _)} from
    parallel/mesh.py's a_panels."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    ts = _tp_initial_state(lay, devs, A_panels, c, lb, ub, basis0, at_upper0)
    # eager: a panelled step crosses the row's devices (see _run_segmented)
    ts = _run_segmented_eager(lambda *a: _tp_step(a[-1]), None, None, None,
                              None, ts, _Loop(max_iter))
    out = _tp_finish(ts)
    pmesh.record_split("tableau", ts.panels, ts.steps)
    return out


def _bucket(x: int) -> int:
    """Round a dimension up to a standard size (dummy rows are free,
    dummy columns fixed at zero, so padding never changes the
    solution); the same buckets as the JAX package, so both number
    the padded variables alike."""
    if x <= 8:
        return 8
    step = max(8, 1 << (x.bit_length() - 3))
    return -(-x // step) * step


MAX_CHUNK = 256  # largest batch solved at once; bigger batches split
# the same cap for per-instance-matrix batches (_solve_batch_3d): many
# small LPs, where every chunk costs a whole launch-bound pivot loop
# (~0.14 s on an H100 for 256 as for 2,048 LPs of 17x12), so the chunk
# is as large as the byte budget allows at such shapes
MAX_CHUNK_3D = 65536
TABLEAU_BYTES_BUDGET = 2 << 30  # cap on the (B, M, NT) tableau size


_TF32_LOCK = threading.Lock()
_TF32_DEPTH = 0
_TF32_SAVED = False


@contextlib.contextmanager
def _tf32_off():
    """float32 matmuls at full precision for the duration of a solve: a
    TF32 pricing pass keeps 10 of the 23 mantissa bits.  The switch is
    one per process, so concurrent solves (one thread per lockstep
    group) count their nesting: the first in saves the caller's
    setting, the last out restores it."""
    global _TF32_DEPTH, _TF32_SAVED
    with _TF32_LOCK:
        if _TF32_DEPTH == 0:
            _TF32_SAVED = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _TF32_DEPTH += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_DEPTH -= 1
            if _TF32_DEPTH == 0:
                torch.backends.cuda.matmul.allow_tf32 = _TF32_SAVED


@dataclasses.dataclass
class _PreparedA:
    """A constraint matrix padded to its bucketed shape and kept
    resident on the device, so per-round Benson solves do not re-pad
    and re-upload a matrix that never changes."""

    A: np.ndarray        # original (strong ref keeps the cache key valid)
    M: int
    N: int
    Mp: int
    Np: int
    dev: torch.Tensor    # (Mp, Np) padded, on ``dev.device``
    host: np.ndarray     # (Mp, Np) padded host copy
    devT: torch.Tensor | None = None   # contiguous A^T, made on first use
    # tp column panels of A (and A^T), by (T, panel, device), made by
    # parallel/mesh.py's a_panels
    panels: dict = dataclasses.field(default_factory=dict)

    def transposed(self) -> torch.Tensor:
        """The padded A^T, contiguous on the same device (the revised
        simplex reads pivot columns as its rows)."""
        if self.devT is None:
            self.devT = self.dev.T.contiguous()
        return self.devT


_A_CACHE: collections.OrderedDict = collections.OrderedDict()
_A_CACHE_MAX = 8
# held over every lookup, upload and eviction of _A_CACHE: the threads of
# a mesh's shards and of the many-VLP engine's groups share the cache
_A_CACHE_LOCK = threading.Lock()


def _np_dtype(tdt: torch.dtype):
    return np.float32 if tdt == torch.float32 else np.float64


def _exact_device(dev: torch.device) -> torch.device:
    """``dev`` with its index: a bare "cuda" names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _prepare_A(A, dtype, device) -> _PreparedA:
    """Pad ``A`` to bucketed dims and place it on ``device``, memoized by
    object identity, dtype and device (callers must not mutate ``A``
    after first use).  A prepared matrix is reused only on the exact
    device it lives on (``cuda:1`` gets a copy of one on ``cuda:0``).
    The cache is guarded by a lock, so threads may call this side by
    side."""
    tdt = torch_dtype(dtype)
    dev = _exact_device(torch.device(device))
    if isinstance(A, _PreparedA):
        if A.dev.dtype == tdt and A.dev.device == dev:
            return A
        A = A.A
    np_dt = _np_dtype(tdt)
    key = (id(A), np.dtype(np_dt).str, str(dev))
    with _A_CACHE_LOCK:
        hit = _A_CACHE.get(key)
        if hit is not None and hit.A is A:
            _A_CACHE.move_to_end(key)
            return hit
        arr = np.asarray(A, np_dt)
        M, N = arr.shape
        Mp, Np = _bucket(M), _bucket(N)
        A_p = np.zeros((Mp, Np), np_dt)
        A_p[:M, :N] = arr
        prep = _PreparedA(A if isinstance(A, np.ndarray) else arr,
                          M, N, Mp, Np, _put(A_p, dev), A_p)
        _A_CACHE[key] = prep
        while len(_A_CACHE) > _A_CACHE_MAX:
            _A_CACHE.popitem(last=False)
        return prep


def _bucket_batch(B: int, Mp: int) -> int:
    """Bucket the batch axis to a power of two; small problems get a
    floor of 8, large-M problems the exact power of two down to 1."""
    Bp = 1 << max(0, B - 1).bit_length()
    return max(8, Bp) if Mp <= 1024 else max(1, Bp)


def _pad_batch_inputs(prep, c, row_lb, row_ub, col_lb, col_ub,
                      Bp, dtype):
    """(B, *) objective/bounds -> padded (Bp, Mp+Np) host arrays, for the
    dimensions ``prep`` names (M, N, Mp, Np).
    Padding instances replicate row 0; padding columns are fixed at
    zero so they never enter the basis usefully."""
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    c = np.atleast_2d(np.asarray(c, dtype))
    if c.size == 0:
        c = c.reshape(0, N)
    B = c.shape[0]

    def _pad(arr, k, kp, fill):
        arr = np.asarray(arr, dtype).reshape(-1, k)
        out = np.full((Bp, kp), fill, dtype)
        out[:B, :k] = arr
        if Bp > B > 0:
            out[B:, :k] = arr[:1]
        return out

    full_c = np.concatenate(
        [np.zeros((Bp, Mp), dtype), _pad(c, N, Np, 0.0)], axis=1)
    lb = np.concatenate(
        [_pad(row_lb, M, Mp, -np.inf), _pad(col_lb, N, Np, 0.0)], axis=1)
    ub = np.concatenate(
        [_pad(row_ub, M, Mp, np.inf), _pad(col_ub, N, Np, 0.0)], axis=1)
    return full_c, lb, ub


def _slice_warm(start_basis, sl):
    """Restrict a warm start to a batch chunk (per-instance arrays are
    sliced; a shared basis applies to every chunk unchanged)."""
    if start_basis is None:
        return None
    b0, u0 = (start_basis if isinstance(start_basis, tuple)
              else (start_basis, None))
    if np.asarray(b0).ndim == 2:
        b0 = np.asarray(b0)[sl]
        if u0 is not None and np.asarray(u0).ndim == 2:
            u0 = np.asarray(u0)[sl]
    return b0 if u0 is None else (b0, u0)


def _pad_warm(start_basis, Mp, NTp, B, Bp):
    """Normalize a warm start to (basis, at_upper) arrays, per-instance
    rows padded to the bucketed batch by replicating row 0.  A wider
    at_upper (the group kernel pads NT to 128) is truncated: real
    variables share one numbering in every backend."""
    if isinstance(start_basis, tuple):
        b0, u0 = start_basis
    else:
        b0, u0 = start_basis, None
    b0 = np.asarray(b0, np.int64)
    if u0 is None:
        u0 = np.zeros(NTp if b0.ndim == 1 else (b0.shape[0], NTp), bool)
    u0 = np.asarray(u0, bool)
    if u0.shape[-1] > NTp:
        u0 = u0[..., :NTp]
    if b0.ndim == 2:
        if b0.shape[0] < Bp:
            b0 = np.concatenate(
                [b0, np.broadcast_to(b0[:1], (Bp - b0.shape[0], Mp))])
        if u0.ndim == 1:
            u0 = np.broadcast_to(u0[None], (Bp, NTp)).copy()
        elif u0.shape[0] < Bp:
            u0 = np.concatenate(
                [u0, np.broadcast_to(u0[:1], (Bp - u0.shape[0], NTp))])
    return b0, u0


def _auto_chunk(M: int, N: int, itemsize: int) -> int:
    """Largest power-of-two batch whose tableau fits the byte budget."""
    per = (M + 8) * (M + N + 16) * itemsize
    cap = max(1, TABLEAU_BYTES_BUDGET // per)
    return min(MAX_CHUNK, 1 << (cap.bit_length() - 1))


def _to_result(out, B, M, N, pivoted: bool = False) -> LPResult:
    """The first B LPs of a padded solve's output tuple (tensors, or the
    numpy arrays of a sharded solve) as an LPResult.  ``pivoted``: the
    output of _run_segmented's pivot loops, whose real LPs' iterations
    x M x (M + N) add to the ``useful_cells`` counter."""
    (status, obj, x, s, row_dual, col_dual, iters, basis, at_upper) = (
        spans.read(o) if torch.is_tensor(o) else o for o in out)
    if pivoted:
        spans.count_cells(
            useful=int(iters[:B].astype(np.int64).sum()) * M * (M + N))
    return LPResult(status[:B], obj[:B], x[:B, :N], s[:B, :M],
                    row_dual[:B, :M], col_dual[:B, :N], iters[:B],
                    basis[:B].astype(np.int32), at_upper[:B])


def solve_batch(A, c, row_lb, row_ub, col_lb, col_ub, *,
                max_iter: int | None = None, dtype=np.float64,
                start_basis=None, max_chunk: int | None = None,
                device="cuda", mesh=None) -> LPResult:
    """Solve a batch of LPs sharing constraint matrix ``A`` (M, N), or
    a batch over per-instance matrices ``A`` (B, M, N).

    ``c``: (B, N) objective on structural variables.
    ``row_lb``/``row_ub``: (B, M); ``col_lb``/``col_ub``: (B, N).
    ``dtype``: float64 (default) or float32 (looser tolerances).
    ``start_basis``: optional warm start, a shared (M,) basis (padded
    numbering: rows then columns) or a tuple (basis, at_upper), with
    (B, M) / (B, NT) per-instance forms.
    ``max_chunk``: batches larger than this are solved in chunks.
    ``device``: the torch device every LP tensor lives on.
    ``mesh``: a ``parallel.mesh.Mesh`` (Options.mesh_axes): every chunk's
    padded batch, grown until the "dp" axis divides it, is solved in
    contiguous shards over the dp entries (parallel/mesh.py), in place
    of ``device``; per-instance matrices shard over the mesh's first
    axis."""
    dev = resolve_device(device)
    if not isinstance(A, _PreparedA) and np.ndim(A) == 3:
        # ahead of _prepare_A: its identity cache is for shared matrices
        return _solve_batch_3d(np.asarray(A), c, row_lb, row_ub, col_lb,
                               col_ub, max_iter=max_iter, dtype=dtype,
                               start_basis=start_basis,
                               max_chunk=max_chunk, device=dev, mesh=mesh)
    # under a tp split no device holds the whole A: the matrix stays on
    # the host and each panel receives its own columns
    tp = mesh is not None and mesh.shape.get("tp", 1) > 1
    prep = _prepare_A(A, dtype, torch.device("cpu") if tp else dev)
    np_dt = prep.host.dtype
    if max_chunk is None:
        chunk = _auto_chunk(prep.M, prep.N, np_dt.itemsize)
    else:
        chunk = max_chunk
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] > chunk:
        parts = []
        for s in range(0, c2.shape[0], chunk):
            sl = slice(s, s + chunk)
            parts.append(solve_batch(
                prep, c2[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, dtype=dtype,
                start_basis=_slice_warm(start_basis, sl),
                max_chunk=chunk, device=dev, mesh=mesh))
        return concat_results(parts)
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    B = c2.shape[0]
    Bp = _bucket_batch(B, Mp)
    rows = None
    if mesh is not None:
        from bensolve_tpu_torch.parallel import mesh as pmesh

        rows = pmesh.mesh_rows(mesh)
        Bp = pmesh.padded_batch(Bp, len(rows))
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500
    full_c, lb, ub = _pad_batch_inputs(prep, c2, row_lb, row_ub,
                                       col_lb, col_ub, Bp, np_dt)
    b0 = u0 = None
    if start_basis is not None:
        b0, u0 = _pad_warm(start_basis, Mp, Mp + Np, B, Bp)
    if rows is None:
        if b0 is not None:
            b0, u0 = _put(b0, dev), _put(u0, dev)
        out = _solve_tableau_segmented(prep.dev, _put(full_c, dev),
                                       _put(lb, dev), _put(ub, dev), b0, u0,
                                       max_iter)
    elif tp:
        lay = pmesh.PanelLayout(Mp, Np, len(rows[0]))
        A_panels = pmesh.a_panels(prep, lay, rows)
        out = pmesh.map_shards(
            rows, (full_c, lb, ub) + _batched_warm(b0, u0),
            lambda row, c_t, lb_t, ub_t, b_t, u_t: _solve_tableau_tp(
                lay, row, A_panels, c_t, lb_t, ub_t,
                *_shard_warm(b0, u0, b_t, u_t, row[0]), max_iter))
    else:
        entries = [r[0] for r in rows]
        preps = {d: _prepare_A(prep, np_dt, d) for d in dict.fromkeys(entries)}
        out = pmesh.map_shards(
            entries, (full_c, lb, ub) + _batched_warm(b0, u0),
            lambda d, c_t, lb_t, ub_t, b_t, u_t: _solve_tableau_segmented(
                preps[d].dev, c_t, lb_t, ub_t,
                *_shard_warm(b0, u0, b_t, u_t, d), max_iter))
    return _to_result(out, B, M, N, pivoted=not tp)


def _batched_warm(b0, u0) -> tuple:
    """The per-instance parts of a padded warm start, for map_shards'
    batched arrays (a shared (M,) basis or (NT,) pattern is None here)."""
    per = b0 is not None and b0.ndim == 2
    return (b0 if per else None,
            u0 if per and u0.ndim == 2 else None)


def _shard_warm(b0, u0, b_t, u_t, dev):
    """A shard's warm start on ``dev``: its slices of per-instance arrays
    (b_t, u_t), or the shared ones uploaded whole."""
    if b0 is None:
        return None, None
    return (b_t if b_t is not None else _put(b0, dev),
            u_t if u_t is not None else _put(u0, dev))


def _solve_batch_3d(A, c, row_lb, row_ub, col_lb, col_ub, *,
                    max_iter=None, dtype=np.float64, start_basis=None,
                    max_chunk=None, device="cuda", mesh=None) -> LPResult:
    """solve_batch for per-instance constraint matrices A (B, M, N): the
    instance-level data-parallel form (scenario batches, BASELINE.json
    config #5).  Every LP of the batch is a DIFFERENT problem, pivoted
    in lockstep on ``device``, or, with ``mesh``, in contiguous shards
    over the mesh's first axis (the JAX package lays the batch over that
    axis).  Padding and chunking mirror the shared-A path; padding
    instances replicate instance 0.  Nothing here touches the
    shared-matrix cache, so threads may call it side by side."""
    dev = resolve_device(device)
    np_dt = _np_dtype(torch_dtype(dtype))
    A = np.asarray(A, np_dt)
    B0, M, N = A.shape
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] != B0:
        raise ValueError(f"A batch {B0} != objective batch {c2.shape[0]}")
    if max_chunk is None:
        per = (M + 8) * (M + N + 16) * np.dtype(np_dt).itemsize * 2
        cap = max(1, TABLEAU_BYTES_BUDGET // per)
        max_chunk = min(MAX_CHUNK_3D, 1 << (cap.bit_length() - 1))
    if B0 > max_chunk:
        parts = []
        for s in range(0, B0, max_chunk):
            sl = slice(s, s + max_chunk)
            parts.append(_solve_batch_3d(
                A[sl], c2[sl], np.asarray(row_lb)[sl],
                np.asarray(row_ub)[sl], np.asarray(col_lb)[sl],
                np.asarray(col_ub)[sl], max_iter=max_iter, dtype=dtype,
                start_basis=_slice_warm(start_basis, sl),
                max_chunk=max_chunk, device=dev, mesh=mesh))
        return concat_results(parts)

    Mp, Np = _bucket(M), _bucket(N)
    Bp = _bucket_batch(B0, Mp)
    entries = None
    if mesh is not None:
        from bensolve_tpu_torch.parallel import mesh as pmesh

        entries = pmesh.shard_entries(mesh, mesh.axis_names[0])
        Bp = pmesh.padded_batch(Bp, len(entries))
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500
    A_p = np.zeros((Bp, Mp, Np), np_dt)
    A_p[:B0, :M, :N] = A
    if Bp > B0 > 0:
        A_p[B0:, :M, :N] = A[0]

    full_c, lb, ub = _pad_batch_inputs(
        types.SimpleNamespace(M=M, N=N, Mp=Mp, Np=Np), c2, row_lb, row_ub,
        col_lb, col_ub, Bp, np_dt)
    b0 = u0 = None
    if start_basis is not None:
        b0, u0 = _pad_warm(start_basis, Mp, Mp + Np, B0, Bp)
    with _tf32_off():
        if entries is None:
            if b0 is not None:
                b0, u0 = _put(b0, dev), _put(u0, dev)
            out = _solve_tableau_segmented(
                _put(A_p, dev), _put(full_c, dev), _put(lb, dev),
                _put(ub, dev), b0, u0, max_iter)
        else:
            out = pmesh.map_shards(
                entries, (A_p, full_c, lb, ub) + _batched_warm(b0, u0),
                lambda d, A_t, c_t, lb_t, ub_t, b_t, u_t:
                _solve_tableau_segmented(A_t, c_t, lb_t, ub_t,
                                         *_shard_warm(b0, u0, b_t, u_t, d),
                                         max_iter))
    return _to_result(out, B0, M, N, pivoted=True)
