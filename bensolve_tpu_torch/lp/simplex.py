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
import dataclasses

import numpy as np
import torch

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
    """E @ v for E = [I | -A] and a shared (M, N) ``A``; v is (B, M+N)."""
    M = A.shape[0]
    return v[:, :M] - v[:, M:] @ A.T


def _e_rmatmul(A, y):
    """E^T @ y; y has shape (B, M)."""
    return torch.cat([y, -(y @ A)], dim=1)


def _E(A):
    M = A.shape[0]
    return torch.cat([torch.eye(M, dtype=A.dtype, device=A.device), -A],
                     dim=1)


def _batched_basis_matrices(A, bases):
    """(B, M, M) basis matrices whose columns are E[:, bases[b, k]], as a
    plain row gather of E^T."""
    return _E(A).T[bases].transpose(1, 2)


def _lu_factor(Bmat):
    """Batched LU with partial pivoting; numerically singular pivots are
    clamped to +-tiny (as the JAX package does) so the solves return
    whatever accuracy survives instead of inf/nan."""
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


def _initial_state(A, c, lb, ub, basis0=None, at_upper0=None):
    """Initial tableau state.  ``basis0``: None (slack basis), a shared
    (M,) basis (one LU for the whole batch) or per-instance (B, M)
    bases (batched LU).  ``at_upper0``: the previous solution's nonbasic
    bound pattern, (NT,) or (B, NT)."""
    B, NT = c.shape
    M, N = A.shape
    dev, dtype = c.device, c.dtype
    E = _E(A)
    if basis0 is None:
        basis = torch.arange(M, device=dev).repeat(B, 1)
        in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
        in_basis[:, :M] = True
        W = E.repeat(B, 1, 1)
    elif basis0.ndim == 2:
        basis = basis0.long()
        in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
        in_basis.scatter_(1, basis, True)
        LU, piv = _lu_factor(_batched_basis_matrices(A, basis))
        W = torch.linalg.lu_solve(LU, piv, E.expand(B, M, NT))
    else:
        b0 = basis0.long()
        basis = b0.expand(B, M).clone()
        in_basis1 = torch.zeros(NT, dtype=torch.bool, device=dev)
        in_basis1[b0] = True
        in_basis = in_basis1.expand(B, NT).clone()
        LU, piv = _lu_factor(_batched_basis_matrices(A, b0[None]))
        W0 = torch.linalg.lu_solve(LU, piv, E[None])
        W = W0.expand(B, M, NT).clone()
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


def _step(A, c, lb, ub, st: _State) -> _State:
    """One primal pivot for every running LP of the batch (the torch
    form of the JAX package's ``_step``)."""
    TOL_BND, TOL_DJ, TOL_PIV = _tols(c.dtype)
    running = st.status == RUNNING
    zero = c.new_zeros(())
    one = c.new_ones(())
    # filled on the device: new_tensor would copy from the host, and a
    # blocking host-to-device copy waits for the card every pivot
    inf = c.new_full((), float("inf"))

    viol_lo = st.xb < st.lbB - TOL_BND
    viol_up = st.xb > st.ubB + TOL_BND
    feasible = ~(viol_lo | viol_up).any(dim=1)                     # (B,)

    # effective costs: true costs in phase 2, +-1 on violating basics in ph.1
    cB1 = torch.where(viol_up, one, zero) + torch.where(viol_lo, -one, zero)
    cB_eff = torch.where(feasible[:, None], st.cB, cB1)

    # reduced costs d = c_eff - cB_eff @ W (duals y never materialized)
    d = (torch.where(feasible[:, None], c, zero)
         - torch.bmm(cB_eff[:, None, :], st.W)[:, 0, :])

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

    sigma = torch.where(_take(elig_inc, q_idx), one, -one)

    # pivot column alpha = Binv E_q = W[:, :, q]
    alpha = st.W.gather(
        2, q_idx[:, None, None].expand(-1, st.W.shape[1], 1))[:, :, 0]
    rate = -sigma[:, None] * alpha                                 # dxB/dt

    # ratio test (composite phase-1 aware, short-step rule)
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
    basis_f = st.basis.to(c.dtype)
    bland_leave = torch.where(cand, -basis_f, -inf)
    leave_score = torch.where(use_bland[:, None], bland_leave, stab_score)
    r_idx = leave_score.argmax(dim=1)                              # (B,)

    # entering variable's own opposite bound (bound flip)
    lb_q = _take(lb, q_idx)
    ub_q = _take(ub, q_idx)
    span = ub_q - lb_q
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

    # rank-1 tableau update: W_i -= alpha_i * (w_r/alpha_r), W_r = w_r/alpha_r,
    # with the row-r replacement (coefficient alpha_r - 1) and the
    # do_pivot mask (coefficient 0) folded into one coefficient vector.
    # W is updated IN PLACE: every start builds a fresh tableau, so no
    # other reference sees it, and the (B, M, NT) tableau is the whole
    # memory footprint (a copy per pivot would double it).
    w_r = st.W.gather(
        1, r_idx[:, None, None].expand(-1, 1, st.W.shape[2]))[:, 0, :]
    w_r_scaled = w_r / alpha_r[:, None]
    coef = alpha.scatter_add(1, r_idx[:, None], -torch.ones_like(alpha_r)[:, None])
    coef = torch.where(do_pivot[:, None], coef, zero)
    W_new = st.W.addcmul_(coef[:, :, None], w_r_scaled[:, None, :], value=-1)

    leaving = _take(st.basis, r_idx)
    val_q = _take(val, q_idx)
    xq_new = val_q + delta
    xb_new = _set_at(xb_new, r_idx, xq_new, do_pivot)
    basis_new = _set_at(st.basis, r_idx, q_idx, do_pivot)

    # incremental basis metadata at slot r
    lbB_new = _set_at(st.lbB, r_idx, lb_q, do_pivot)
    ubB_new = _set_at(st.ubB, r_idx, ub_q, do_pivot)
    cB_new = _set_at(st.cB, r_idx, _take(c, q_idx), do_pivot)

    true = torch.ones_like(do_pivot)
    in_basis_new = _set_at(st.in_basis, q_idx, true, do_pivot)
    in_basis_new = _set_at(in_basis_new, leaving, ~true, do_pivot)

    # leaving variable rests at the ratio-test target bound
    rate_r = _take(rate, r_idx)
    viol_lo_r = _take(viol_lo, r_idx)
    viol_up_r = _take(viol_up, r_idx)
    leave_at_upper = torch.where(rate_r > 0, ~viol_lo_r, viol_up_r)
    at_upper_new = _set_at(st.at_upper, leaving, leave_at_upper, do_pivot)
    # bound flip: entering variable switches bound
    q_at_upper = _take(st.at_upper, q_idx)
    at_upper_new = _set_at(at_upper_new, q_idx, ~q_at_upper, act & do_flip)

    degen = act & (t_star < TOL_BND)
    stall_new = torch.where(act, torch.where(degen, st.stall + 1, 0),
                            st.stall).to(torch.int32)
    iters_new = st.iters + act.to(torch.int32)
    gamma_new = _devex_update(st.gamma, w_r_scaled, alpha_r, q_idx,
                              leaving, do_pivot)

    return _State(basis_new, in_basis_new, at_upper_new, W_new, xb_new,
                  lbB_new, ubB_new, cB_new,
                  new_status, stall_new, iters_new, gamma_new)


def _final_solutions(A, c, lb, ub, basis, in_basis, at_upper, cB,
                     Bmat=None):
    """Accurate primal/dual recovery at termination: refactorize the
    final basis once (batched LU) so results do not inherit rank-1
    drift from the pivot loop.  ``Bmat``: the (B, M, M) basis matrices
    when the caller already holds them (the revised simplex maintains
    them); otherwise they are gathered from E."""
    M = A.shape[0]
    if Bmat is None:
        Bmat = _batched_basis_matrices(A, basis)
    zn = torch.where(in_basis, c.new_zeros(()), _nb_value(lb, ub, at_upper))
    rhs = -_e_matmul(A, zn)                                        # (B, M)
    LU, piv = _lu_factor(Bmat)
    xb = torch.linalg.lu_solve(LU, piv, rhs[:, :, None])[:, :, 0]
    y = torch.linalg.lu_solve(LU, piv, cB[:, :, None], adjoint=True)[:, :, 0]
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
    M = A.shape[0]
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
    """Host loop around the pivot step.  State stays on the device; the
    status vector comes back once per segment, and a segment is only
    the number of pivots between two such reads.  Steps taken after an
    LP finished leave its state unchanged."""
    step, seg = 0, 1
    while step < max_iter and bool((st.status == RUNNING).any()):
        for _ in range(min(seg, max_iter - step)):
            st = step_fn(A, c, lb, ub, st)
        step += min(seg, max_iter - step)
        seg = min(2 * seg, SEGMENT_MAX)
    return st


def _solve_tableau_segmented(A, c, lb, ub, basis0, at_upper0, max_iter):
    st = _initial_state(A, c, lb, ub, basis0, at_upper0)
    st = _run_segmented(_step, A, c, lb, ub, st, max_iter)
    return _finish(A, c, lb, ub, st)


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
TABLEAU_BYTES_BUDGET = 2 << 30  # cap on the (B, M, NT) tableau size


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

    def transposed(self) -> torch.Tensor:
        """The padded A^T, contiguous on the same device (the revised
        simplex reads pivot columns as its rows)."""
        if self.devT is None:
            self.devT = self.dev.T.contiguous()
        return self.devT


_A_CACHE: collections.OrderedDict = collections.OrderedDict()
_A_CACHE_MAX = 8


def _prepare_A(A, dtype, device) -> _PreparedA:
    """Pad ``A`` to bucketed dims and place it on ``device``, memoized by
    object identity, dtype and device (callers must not mutate ``A``
    after first use)."""
    tdt = torch_dtype(dtype)
    dev = torch.device(device)
    if isinstance(A, _PreparedA):
        if A.dev.dtype == tdt and A.dev.device.type == dev.type:
            return A
        A = A.A
    np_dt = np.float32 if tdt == torch.float32 else np.float64
    key = (id(A), np.dtype(np_dt).str, str(dev))
    hit = _A_CACHE.get(key)
    if hit is not None and hit.A is A:
        _A_CACHE.move_to_end(key)
        return hit
    arr = np.asarray(A, np_dt)
    if arr.ndim == 3:
        raise NotImplementedError(
            "per-instance constraint matrices (3-D A) are not ported to "
            "bensolve_tpu_torch yet (ROADMAP Queue 1, many.py/3-D batches)")
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


def _pad_batch_inputs(prep: _PreparedA, c, row_lb, row_ub, col_lb, col_ub,
                      Bp, dtype):
    """(B, *) objective/bounds -> padded (Bp, Mp+Np) host arrays.
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


def _to_result(out, B, M, N) -> LPResult:
    (status, obj, x, s, row_dual, col_dual, iters, basis, at_upper) = (
        o.cpu().numpy() for o in out)
    return LPResult(status[:B], obj[:B], x[:B, :N], s[:B, :M],
                    row_dual[:B, :M], col_dual[:B, :N], iters[:B],
                    basis[:B].astype(np.int32), at_upper[:B])


def solve_batch(A, c, row_lb, row_ub, col_lb, col_ub, *,
                max_iter: int | None = None, dtype=np.float64,
                start_basis=None, max_chunk: int | None = None,
                device="cuda", mesh=None) -> LPResult:
    """Solve a batch of LPs sharing constraint matrix ``A`` (M, N).

    ``c``: (B, N) objective on structural variables.
    ``row_lb``/``row_ub``: (B, M); ``col_lb``/``col_ub``: (B, N).
    ``dtype``: float64 (default) or float32 (looser tolerances).
    ``start_basis``: optional warm start, a shared (M,) basis (padded
    numbering: rows then columns) or a tuple (basis, at_upper), with
    (B, M) / (B, NT) per-instance forms.
    ``max_chunk``: batches larger than this are solved in chunks.
    ``device``: the torch device every LP tensor lives on."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: multi-device LP sharding is not ported to "
            "bensolve_tpu_torch yet (ROADMAP Queue 1, mesh/distributed)")
    dev = resolve_device(device)
    prep = _prepare_A(A, dtype, dev)
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
                max_chunk=chunk, device=dev))
        return concat_results(parts)
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    B = c2.shape[0]
    Bp = _bucket_batch(B, Mp)
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500
    full_c, lb, ub = _pad_batch_inputs(prep, c2, row_lb, row_ub,
                                       col_lb, col_ub, Bp, np_dt)
    b0 = u0 = None
    if start_basis is not None:
        b0, u0 = _pad_warm(start_basis, Mp, Mp + Np, B, Bp)
        b0, u0 = _put(b0, dev), _put(u0, dev)
    out = _solve_tableau_segmented(prep.dev, _put(full_c, dev),
                                   _put(lb, dev), _put(ub, dev), b0, u0,
                                   max_iter)
    return _to_result(out, B, M, N)
