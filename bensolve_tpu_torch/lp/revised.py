"""Batched dense *revised* bounded-variable simplex for tall LPs, in PyTorch.

The torch port of ``bensolve_tpu/lp/revised.py``.  The tableau solver
(lp/simplex.py) carries the full (B, M, M+N) tableau through every
pivot; for problems with N >> M that is (M+N)/M times more state than
needed.  This solver keeps only the basis inverse (B, M, M) per instance
plus ONE shared constraint matrix:

    per iteration     tableau               revised (this file)
    state traffic     B * M * (M+N)         B * M^2  (+ A once for pricing)
    pricing           included in tableau   y = cB_eff @ Binv; d = c - y E
    pivot column      tableau column        alpha = Binv @ E_q (gathered)

E = [I | -A] as in lp/simplex.py, so duals stay free (y = cB @ Binv) and
the pricing product y @ A is one matmul over the shared A.

Semantics (statuses, bound types, composite phase 1, devex with Bland's
rule after a stall, carried pricing, the refactorization schedule, the
two-stage anti-degeneracy perturbation, the final LU) mirror the JAX
package step for step, so both take the same pivots on the same inputs.
Reference contract: bslv_lp.c:219-303.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from bensolve_tpu_torch.lp import simplex as sx
from bensolve_tpu_torch.lp.simplex import (BLAND_AFTER, INFEASIBLE, ITLIM,
                                           OPTIMAL, RUNNING, SEGMENT_MAX,
                                           UNBOUNDED, LPResult, _nb_value,
                                           _set_at, _take, _tols)

# batched device solves run by this backend (one per chunk), on any
# device; the tests and chip_smoke.py read it to see the route was taken
CALLS = 0


@dataclasses.dataclass
class _RState:
    basis: torch.Tensor      # (B, M) int64
    in_basis: torch.Tensor   # (B, NT) bool
    at_upper: torch.Tensor   # (B, NT) bool
    Binv: torch.Tensor       # (B, M, M), updated in place
    Brows: torch.Tensor      # (B, M, M): row k = basis column E[:, basis[k]],
    #   maintained with one row scatter per pivot so the refactorization
    #   and the final LU never gather basis columns out of A again
    xb: torch.Tensor         # (B, M)
    lbB: torch.Tensor        # (B, M)
    ubB: torch.Tensor        # (B, M)
    cB: torch.Tensor         # (B, M)
    status: torch.Tensor     # (B,) int32
    stall: torch.Tensor      # (B,) int32
    iters: torch.Tensor      # (B,) int32
    gamma: torch.Tensor      # (B, NT) devex reference weights
    dred: torch.Tensor       # (B, NT) carried phase-2 reduced-cost row
    force: torch.Tensor      # (B,) bool: the carried row is stale, price
    #   exactly next step
    resets: torch.Tensor     # (B,) int32 singular-basis slack resets


def _e_col(AT, q, M):
    """Column q of E = [I | -A] for a batch of indices q (B,) -> (B, M),
    read as rows of the contiguous A^T."""
    N = AT.shape[0]
    lane = torch.arange(M, device=AT.device)
    aux_col = (q[:, None] == lane[None, :]).to(AT.dtype)
    a_col = -AT.index_select(0, (q - M).clamp(0, N - 1))
    return torch.where((q < M)[:, None], aux_col, a_col)


def _initial_rstate(A, c, lb, ub, basis0=None, at_upper0=None, Brows0=None):
    """Start state.  ``basis0``: None (slack basis), a shared (M,) basis
    or per-instance (B, M) bases, with ``Brows0`` their (1 or B, M, M)
    basis-column rows built on the host (_host_brows)."""
    B, NT = c.shape
    M, N = A.shape
    dev, dtype = c.device, c.dtype
    eye = torch.eye(M, dtype=dtype, device=dev)
    if basis0 is None:
        basis = torch.arange(M, device=dev).repeat(B, 1)
        in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
        in_basis[:, :M] = True
        Binv = eye.repeat(B, 1, 1)
        Brows = eye.repeat(B, 1, 1)   # identity basis: rows ARE unit vectors
    elif basis0.ndim == 2:
        # per-instance warm start: batched LU of each candidate's basis
        basis = basis0.long()
        in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
        in_basis.scatter_(1, basis, True)
        Brows = Brows0
        LU, piv = sx._lu_factor(Brows.transpose(1, 2))
        Binv = torch.linalg.lu_solve(LU, piv, eye.expand(B, M, M))
    else:
        b0 = basis0.long()
        basis = b0.expand(B, M).clone()
        in_basis1 = torch.zeros(NT, dtype=torch.bool, device=dev)
        in_basis1[b0] = True
        in_basis = in_basis1.expand(B, NT).clone()
        Brows1 = Brows0[0]
        LU, piv = sx._lu_factor(Brows1.T[None])
        Binv0 = torch.linalg.lu_solve(LU, piv, eye[None])[0]
        Binv = Binv0.expand(B, M, M).clone()
        Brows = Brows1.expand(B, M, M).clone()
    fin_lb, fin_ub = torch.isfinite(lb), torch.isfinite(ub)
    if at_upper0 is None:
        at_upper = (~fin_lb) & fin_ub & ~in_basis
    else:
        at_upper = at_upper0.bool()
        if at_upper.ndim == 1:
            at_upper = at_upper[None, :]
        at_upper = at_upper.expand(B, NT) & fin_ub & ~in_basis
        at_upper = at_upper | ((~fin_lb) & fin_ub & ~in_basis)
    zn = torch.where(in_basis, c.new_zeros(()), _nb_value(lb, ub, at_upper))
    rhs = -sx._e_matmul(A, zn)                                      # (B, M)
    xb = rhs if basis0 is None else torch.bmm(Binv, rhs[:, :, None])[:, :, 0]
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    crossed = (lb > ub).any(dim=1)
    status = torch.where(crossed, torch.full_like(zeros, INFEASIBLE), zeros)
    return _RState(basis, in_basis, at_upper, Binv, Brows, xb,
                   lb.gather(1, basis), ub.gather(1, basis),
                   c.gather(1, basis), status, zeros, zeros.clone(),
                   torch.ones_like(c), torch.zeros_like(c),
                   torch.ones(B, dtype=torch.bool, device=dev),
                   zeros.clone())


def _rstep(A, AT, c, lb, ub, st: _RState, step: int):
    """One revised pivot for every running LP of the batch (the torch
    form of the JAX package's ``_rstep``); ``step`` is the global step
    count before this pivot.  Returns the new state and a device bool:
    whether any LP was running when the step began.

    The exact pricing pass is computed every step and selected with
    ``torch.where``: the JAX package skips it with a device-side branch,
    which in torch would cost a host read per pivot.  The selected
    values, hence the pivots, are the same."""
    TOL_BND, TOL_DJ, TOL_PIV = _tols(c.dtype)
    M = A.shape[0]
    running = st.status == RUNNING
    zero = c.new_zeros(())
    one = c.new_ones(())
    # filled on the device: new_tensor would copy from the host, and a
    # blocking host-to-device copy waits for the card every pivot
    inf = c.new_full((), float("inf"))

    viol_lo = st.xb < st.lbB - TOL_BND
    viol_up = st.xb > st.ubB + TOL_BND
    feasible = ~(viol_lo | viol_up).any(dim=1)

    cB1 = torch.where(viol_up, one, zero) + torch.where(viol_lo, -one, zero)
    cB_eff = torch.where(feasible[:, None], st.cB, cB1)
    y = torch.bmm(cB_eff[:, None, :], st.Binv)[:, 0, :]           # (B, M)

    # while every running instance is primal feasible, the carried cost
    # row prices the step; the exact pass runs while any instance is
    # infeasible (composite phase-1 costs are not rank-1-maintainable),
    # when a carried row is stale (force), and every 64 steps
    full = torch.where(feasible[:, None], c, zero) - sx._e_rmatmul(A, y)
    run_full = ((running & ~feasible) | (running & st.force)).any()
    if step % 64 == 0:
        run_full = torch.ones_like(run_full)
    d = torch.where(run_full, full, st.dred)

    # non-finite guard: an overflowed instance is never classified; it
    # stays RUNNING until the refactorization repairs it
    finite = torch.isfinite(st.xb).all(dim=1) & torch.isfinite(y).all(dim=1)

    val = _nb_value(lb, ub, st.at_upper)
    can_inc = (~st.in_basis) & (val < ub)
    can_dec = (~st.in_basis) & (val > lb)
    elig_inc = can_inc & (d < -TOL_DJ)
    elig_dec = can_dec & (d > TOL_DJ)
    eligible = elig_inc | elig_dec
    use_bland = st.stall > BLAND_AFTER
    q_idx = sx._devex_entering(d, eligible, st.gamma, use_bland)
    has_entering = eligible.any(dim=1)

    finish_status = torch.where(feasible, OPTIMAL, INFEASIBLE).to(torch.int32)
    # a finish verdict is trusted only off an exact pricing pass; off a
    # carried row the instance sets force and finishes on the next step
    would_finish = running & ~has_entering & finite
    new_status = torch.where(would_finish & run_full, finish_status,
                             st.status)
    act = running & has_entering & finite

    sigma = torch.where(_take(elig_inc, q_idx), one, -one)

    # pivot column alpha = Binv @ E_q
    e_q = _e_col(AT, q_idx, M)                                     # (B, M)
    alpha = torch.bmm(st.Binv, e_q[:, :, None])[:, :, 0]
    rate = -sigma[:, None] * alpha

    inc = rate > TOL_PIV
    dec = rate < -TOL_PIV
    target_inc = torch.where(viol_lo, st.lbB, st.ubB)
    target_dec = torch.where(viol_up, st.ubB, st.lbB)
    t_inc = torch.where(viol_up, inf, (target_inc - st.xb) / rate)
    t_dec = torch.where(viol_lo, inf, (target_dec - st.xb) / rate)
    t = torch.where(inc, t_inc, torch.where(dec, t_dec, inf))
    t = torch.maximum(t, zero)
    t = torch.where(torch.isnan(t), inf, t)

    tmin = t.min(dim=1).values
    cand = t <= tmin[:, None] + 1e-12
    stab_score = torch.where(cand, rate.abs(), -one)
    bland_leave = torch.where(cand, -st.basis.to(c.dtype), -inf)
    leave_score = torch.where(use_bland[:, None], bland_leave, stab_score)
    r_idx = leave_score.argmax(dim=1)

    lb_q = _take(lb, q_idx)
    ub_q = _take(ub, q_idx)
    span = ub_q - lb_q
    span = torch.where(torch.isfinite(span), span, inf)
    do_flip = span < tmin
    t_star = torch.where(do_flip, span, tmin)

    unbounded = act & feasible & ~torch.isfinite(t_star)
    new_status = torch.where(unbounded, UNBOUNDED, new_status).to(torch.int32)
    act = act & torch.isfinite(t_star)

    delta = torch.where(act, sigma * t_star, zero)
    xb_new = st.xb - delta[:, None] * alpha

    do_pivot = act & ~do_flip
    alpha_r = _take(alpha, r_idx)
    alpha_r = torch.where(alpha_r.abs() < TOL_PIV,
                          torch.where(alpha_r < 0, -TOL_PIV * one,
                                      TOL_PIV * one), alpha_r)

    # rank-1 basis-inverse update (product form): Binv_i -= alpha_i b_r,
    # Binv_r = b_r, with b_r = Binv_r / alpha_r; the row-r replacement
    # and the do_pivot mask fold into one coefficient vector.  Binv is
    # updated IN PLACE: every start and refactorization makes a fresh one
    row_r = r_idx[:, None, None].expand(-1, 1, M)
    b_r = st.Binv.gather(1, row_r)[:, 0, :]
    b_r_scaled = b_r / alpha_r[:, None]
    coef = alpha.scatter_add(1, r_idx[:, None],
                             -torch.ones_like(alpha_r)[:, None])
    coef = torch.where(do_pivot[:, None], coef, zero)
    Binv_new = st.Binv.addcmul_(coef[:, :, None], b_r_scaled[:, None, :],
                                value=-1)

    leaving = _take(st.basis, r_idx)
    val_q = _take(val, q_idx)
    xb_new = _set_at(xb_new, r_idx, val_q + delta, do_pivot)
    basis_new = _set_at(st.basis, r_idx, q_idx, do_pivot)

    # basis-matrix rows follow the basis: slot r's column becomes E_q
    cur_row = st.Brows.gather(1, row_r)[:, 0, :]
    new_row = torch.where(do_pivot[:, None], e_q, cur_row)
    Brows_new = st.Brows.scatter_(1, row_r, new_row[:, None, :])

    lbB_new = _set_at(st.lbB, r_idx, lb_q, do_pivot)
    ubB_new = _set_at(st.ubB, r_idx, ub_q, do_pivot)
    cB_new = _set_at(st.cB, r_idx, _take(c, q_idx), do_pivot)

    true = torch.ones_like(do_pivot)
    in_basis_new = _set_at(st.in_basis, q_idx, true, do_pivot)
    in_basis_new = _set_at(in_basis_new, leaving, ~true, do_pivot)

    rate_r = _take(rate, r_idx)
    leave_at_upper = torch.where(rate_r > 0, ~_take(viol_lo, r_idx),
                                 _take(viol_up, r_idx))
    at_upper_new = _set_at(st.at_upper, leaving, leave_at_upper, do_pivot)
    q_at_upper = _take(st.at_upper, q_idx)
    at_upper_new = _set_at(at_upper_new, q_idx, ~q_at_upper, act & do_flip)

    degen = act & (t_star < TOL_BND)
    stall_new = torch.where(act, torch.where(degen, st.stall + 1, 0),
                            st.stall).to(torch.int32)
    iters_new = st.iters + act.to(torch.int32)
    # devex needs the pivot ROW over all NT columns: w_r = Binv_r @ E,
    # one more shared-A matmul per pivot
    w_r_full = sx._e_rmatmul(A, b_r_scaled)                        # (B, NT)
    gamma_new = sx._devex_update(st.gamma, w_r_full, alpha_r, q_idx,
                                 leaving, do_pivot)

    # carried cost row: d' = d - d_q * w_r (exact phase-2 update)
    d_q = _take(d, q_idx)[:, None]
    dred_new = torch.where(do_pivot[:, None], d - d_q * w_r_full, d)
    force_new = (running & ~feasible) | (would_finish & ~run_full)

    new = _RState(basis_new, in_basis_new, at_upper_new, Binv_new,
                  Brows_new, xb_new, lbB_new, ubB_new, cB_new, new_status,
                  stall_new, iters_new, gamma_new, dred_new, force_new,
                  st.resets)
    return new, running.any()


# pivots between basis-inverse refactorizations: the product-form rank-1
# updates drift, float32 faster than float64
REFACTOR_EVERY_F32 = 64
REFACTOR_EVERY_F64 = 200


def _refactor_interval(M: int, NT: int, dtype) -> int:
    """Refactorization cadence: the dtype's base, stretched on huge
    bases (a full LU costs ~M^2/NT pivots' worth of work) up to a hard
    cap, as in the JAX package."""
    f32 = sx.torch_dtype(dtype) == torch.float32
    base = REFACTOR_EVERY_F32 if f32 else REFACTOR_EVERY_F64
    cap = 64 if f32 else 1024
    return max(min(base, cap), min(4 * M * M // max(NT, 1), cap))


def _refactor(A, c, lb, ub, st: _RState) -> _RState:
    """Recompute Binv and xb from a fresh batched LU of the current basis
    (kept in st.Brows), discarding accumulated product-form error.

    Singular-basis recovery: an instance whose fresh LU still leaves
    non-finite state RESETS to the slack basis and re-solves from
    scratch (the batched analogue of GLPK's glp_std_basis retry,
    bslv_lp.c:222-227)."""
    M = A.shape[0]
    B, NT = c.shape
    dev, dtype = c.device, c.dtype
    eye = torch.eye(M, dtype=dtype, device=dev)
    LU, piv = sx._lu_factor(st.Brows.transpose(1, 2))
    Binv = torch.linalg.lu_solve(LU, piv, eye.expand(B, M, M))
    zero = c.new_zeros(())
    zn = torch.where(st.in_basis, zero, _nb_value(lb, ub, st.at_upper))
    xb = torch.bmm(Binv, -sx._e_matmul(A, zn)[:, :, None])[:, :, 0]

    bad = (st.status == RUNNING) & ~(
        torch.isfinite(xb).all(dim=1)
        & torch.isfinite(Binv.reshape(B, -1)).all(dim=1))
    aux = torch.arange(M, device=dev)
    in_basis1 = torch.zeros(NT, dtype=torch.bool, device=dev)
    in_basis1[:M] = True
    basis = torch.where(bad[:, None], aux[None, :], st.basis)
    in_basis = torch.where(bad[:, None], in_basis1[None, :], st.in_basis)
    atup_def = ((~torch.isfinite(lb)) & torch.isfinite(ub)
                & ~in_basis1[None, :])
    at_upper = torch.where(bad[:, None], atup_def, st.at_upper)
    eyeB = eye.expand(B, M, M)
    Binv = torch.where(bad[:, None, None], eyeB, Binv)
    Brows = torch.where(bad[:, None, None], eyeB, st.Brows)
    lbB = torch.where(bad[:, None], lb.gather(1, basis), st.lbB)
    ubB = torch.where(bad[:, None], ub.gather(1, basis), st.ubB)
    cB = torch.where(bad[:, None], c.gather(1, basis), st.cB)
    zn2 = torch.where(in_basis, zero, _nb_value(lb, ub, at_upper))
    xb = torch.where(bad[:, None], -sx._e_matmul(A, zn2), xb)
    gamma = torch.where(bad[:, None], c.new_ones(()), st.gamma)
    stall = torch.where(bad, 0, st.stall).to(torch.int32)
    # the fresh Binv invalidates every carried cost row
    return dataclasses.replace(st, basis=basis, in_basis=in_basis,
                               at_upper=at_upper, Binv=Binv, Brows=Brows,
                               xb=xb, lbB=lbB, ubB=ubB, cB=cB, stall=stall,
                               gamma=gamma,
                               force=torch.ones_like(st.force),
                               resets=st.resets + bad.to(torch.int32))


def _rebound(A, c, lb, ub, st: _RState) -> _RState:
    """Switch a finished perturbed-bounds solve back to the EXACT bounds,
    keeping the basis and its inverse: re-gather the basic bounds,
    recompute xb from the exact nonbasic values, and resume every
    non-INFEASIBLE instance (stage 2 of the anti-degeneracy
    perturbation)."""
    zn = torch.where(st.in_basis, c.new_zeros(()),
                     _nb_value(lb, ub, st.at_upper))
    xb = torch.bmm(st.Binv, -sx._e_matmul(A, zn)[:, :, None])[:, :, 0]
    status = torch.where(st.status == INFEASIBLE, INFEASIBLE,
                         RUNNING).to(torch.int32)
    return dataclasses.replace(st, lbB=lb.gather(1, st.basis),
                               ubB=ub.gather(1, st.basis), xb=xb,
                               status=status,
                               stall=torch.zeros_like(st.stall),
                               force=torch.ones_like(st.force))


# anti-degeneracy bound perturbation (stage-1 relaxation scale, relative)
PERT_F32 = 1e-4
PERT_F64 = 1e-7
# cold instances at least this large get the two-stage treatment
PERTURB_MIN_M = 512


def _perturbed_bounds(lb: np.ndarray, ub: np.ndarray, dtype):
    """Deterministic outward perturbation of every finite bound:
    lb - e, ub + e with e = s*(1+|b|)*u, u in [0.5, 1.5) drawn by numpy
    from the JAX package's fixed seed, so both relax the same bounds."""
    s = PERT_F32 if np.dtype(dtype) == np.dtype(np.float32) else PERT_F64
    rng = np.random.default_rng(0x5EED)
    u_lo = rng.random(lb.shape[-1]) + 0.5
    u_hi = rng.random(ub.shape[-1]) + 0.5
    lb1 = np.where(np.isfinite(lb),
                   lb - s * (1.0 + np.abs(lb)) * u_lo, lb)
    ub1 = np.where(np.isfinite(ub),
                   ub + s * (1.0 + np.abs(ub)) * u_hi, ub)
    return lb1.astype(dtype), ub1.astype(dtype)


def _run(A, AT, c, lb, ub, st: _RState, step: int, cap: int, every: int):
    """Pivot until no LP is running or ``step`` reaches ``cap``, with the
    JAX package's refactorization schedule: after step t (counted after
    the pivot), refactorize when t % every == 0, or when t % 16 == 0 and
    some running LP has non-finite xb.  The device state is read on the
    host once every 16 steps (the schedule) and at the end of each
    segment (1, 2, 4, ... up to SEGMENT_MAX steps).  Steps taken after
    the last LP finished change nothing the result reads; they are not
    counted and never refactorize.  Returns (state, step)."""
    alive = bool((st.status == RUNNING).any())
    seg = 1
    while alive and step < cap:
        last = torch.tensor(step, device=c.device)
        for _ in range(min(seg, cap - step)):
            st, ran = _rstep(A, AT, c, lb, ub, st, step)
            step += 1
            last = torch.where(ran, step, last)
            periodic = step % every == 0
            if periodic or step % 16 == 0:
                bad = ((st.status == RUNNING)
                       & ~torch.isfinite(st.xb).all(dim=1)).any()
                ran_h, bad_h = torch.stack([ran, bad]).tolist()
                if ran_h and (periodic or (bad_h and step % 16 == 0)):
                    st = _refactor(A, c, lb, ub, st)
        step, alive = torch.stack(
            [last, (st.status == RUNNING).any().to(last.dtype)]).tolist()
        alive = bool(alive)
        seg = min(2 * seg, SEGMENT_MAX)
    return st, step


def _finish(A, c, lb, ub, st: _RState):
    """Status (RUNNING -> ITLIM) plus the refactorized recovery from the
    maintained basis rows."""
    status = torch.where(st.status == RUNNING, ITLIM, st.status)
    obj, x, s, row_dual, col_dual = sx._final_solutions(
        A, c, lb, ub, st.basis, st.in_basis, st.at_upper, st.cB,
        Bmat=st.Brows.transpose(1, 2))
    return (status, obj, x, s, row_dual, col_dual, st.iters, st.basis,
            st.at_upper)


def _solve_revised_segmented(A, AT, c, lb, ub, basis0, at_upper0, Brows0,
                             max_iter, pert=None):
    """One batched solve on the device.  ``pert``: (lb1, ub1)
    outward-perturbed bounds for the two-stage anti-degeneracy solve —
    stage 1 pivots on the relaxed bounds, then _rebound restores the
    exact ones and stage 2 cleans up warm from the stage-1 basis."""
    global CALLS
    CALLS += 1
    lb_run, ub_run = pert if pert is not None else (lb, ub)
    st = _initial_rstate(A, c, lb_run, ub_run, basis0, at_upper0, Brows0)
    every = _refactor_interval(A.shape[0], c.shape[1], c.dtype)
    st, step = _run(A, AT, c, lb_run, ub_run, st, 0, max_iter, every)
    if pert is not None:
        st = _rebound(A, c, lb, ub, st)
        # cleanup budget: warm re-verification is short
        st, step = _run(A, AT, c, lb, ub, st, step,
                        step + max(2 * A.shape[0], 2000), every)
    return _finish(A, c, lb, ub, st)


def _host_brows(prep: sx._PreparedA, b0: np.ndarray, dtype) -> np.ndarray:
    """Basis-column rows for a warm start, built on the host:
    out[b, k, :] = E[:, b0[b, k]] with E = [I | -A_padded] (padded
    numbering: rows 0..Mp-1, structurals Mp..Mp+Np-1)."""
    Mp = prep.Mp
    b2 = np.atleast_2d(np.asarray(b0))
    out = np.zeros((b2.shape[0], Mp, Mp), dtype)
    aux = b2 < Mp
    bi, ki = np.nonzero(aux)
    out[bi, ki, b2[aux]] = 1.0
    bi, ki = np.nonzero(~aux)
    if bi.size:
        out[bi, ki, :] = -prep.host[:, b2[~aux] - Mp].T
    return out


@dataclasses.dataclass
class _ScaledA:
    """Equilibrated matrix (the glp_scale_prob role): A' = R A C with
    power-of-two scales, so scaling is EXACT in floating point."""

    A: object           # original (cache identity)
    prep: sx._PreparedA
    rscale: np.ndarray  # (M,)
    cscale: np.ndarray  # (N,)


_S_CACHE: dict = {}


def _pow2(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.round(np.log2(np.maximum(x, 1e-30))))


def _prepare_scaled(A, dtype, device) -> _ScaledA:
    key = (id(A), np.dtype(dtype).str, str(device))
    hit = _S_CACHE.get(key)
    if hit is not None and hit.A is A:
        return hit
    arr = np.asarray(A, np.float64)
    absA = np.abs(arr)
    r = _pow2(1.0 / np.maximum(absA.max(axis=1), 1e-12))
    cvec = _pow2(1.0 / np.maximum((absA * r[:, None]).max(axis=0), 1e-12))
    As = arr * r[:, None] * cvec[None, :]
    prep = sx._prepare_A(np.asarray(As, dtype), dtype, device)
    scaled = _ScaledA(A if isinstance(A, np.ndarray) else arr, prep, r, cvec)
    if len(_S_CACHE) > 8:
        _S_CACHE.clear()
    _S_CACHE[key] = scaled
    return scaled


@contextlib.contextmanager
def _tf32_off():
    """float32 matmuls at full precision for the duration of a solve: a
    TF32 pricing pass keeps 10 of the 23 mantissa bits."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def solve_batch_revised(A, c, row_lb, row_ub, col_lb, col_ub, *,
                        max_iter: int | None = None, dtype=np.float64,
                        start_basis=None, max_chunk: int | None = None,
                        device="cuda", verbose: int = 0) -> LPResult:
    """Drop-in alternative to simplex.solve_batch for N >> M (same
    padding, chunking and warm-start contract).  A matrix that is not
    prepared yet is solved in its equilibrated form (exact power-of-two
    scales), and the solutions come back unscaled; basis indices and
    bound patterns are scale-invariant, so warm starts pass straight
    through.  ``device``:
    the torch device every LP tensor lives on.  ``verbose`` >= 2 prints
    one summary line per batched solve."""
    dev = sx.resolve_device(device)
    if not isinstance(A, sx._PreparedA):
        sc = _prepare_scaled(A, dtype, dev)
        r, cv = sc.rscale, sc.cscale
        res = solve_batch_revised(
            sc.prep, np.atleast_2d(np.asarray(c)) * cv[None, :],
            np.asarray(row_lb) * r[None, :], np.asarray(row_ub) * r[None, :],
            np.asarray(col_lb) / cv[None, :], np.asarray(col_ub) / cv[None, :],
            max_iter=max_iter, dtype=dtype, start_basis=start_basis,
            max_chunk=max_chunk, device=dev, verbose=verbose)
        return LPResult(res.status, res.obj, res.x * cv[None, :],
                        res.s / r[None, :], res.row_dual * r[None, :],
                        res.col_dual / cv[None, :], res.iters,
                        res.basis, res.at_upper)
    prep = sx._prepare_A(A, dtype, dev)
    np_dt = prep.host.dtype
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    if max_chunk is None:
        # Binv dominates: (B, M, M) + shared A
        per = (M + 8) * (M + 8) * np_dt.itemsize * 3
        cap = max(1, int(sx.TABLEAU_BYTES_BUDGET // per))
        max_chunk = min(sx.MAX_CHUNK, 1 << (cap.bit_length() - 1))
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] > max_chunk:
        parts = []
        for s in range(0, c2.shape[0], max_chunk):
            sl = slice(s, s + max_chunk)
            parts.append(solve_batch_revised(
                prep, c2[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, dtype=dtype,
                start_basis=sx._slice_warm(start_basis, sl),
                max_chunk=max_chunk, device=dev, verbose=verbose))
        return sx.concat_results(parts)

    B = c2.shape[0]
    Bp = sx._bucket_batch(B, Mp)
    if max_iter is None:
        # the generic shape-derived cap, bounded for huge-N instances
        max_iter = min(50 * (Mp + Np) + 500, 40 * Mp + 20000)
    full_c, lb, ub = sx._pad_batch_inputs(prep, c2, row_lb, row_ub,
                                          col_lb, col_ub, Bp, np_dt)
    AT = prep.transposed()

    def put(a):
        return sx._put(a, dev)

    with _tf32_off():
        if start_basis is None:
            pert = None
            if Mp >= PERTURB_MIN_M:
                lb1, ub1 = _perturbed_bounds(lb, ub, np_dt)
                pert = (put(lb1), put(ub1))
            out = _solve_revised_segmented(
                prep.dev, AT, put(full_c), put(lb), put(ub), None, None,
                None, max_iter, pert)
        else:
            b0, u0 = sx._pad_warm(start_basis, Mp, Mp + Np, B, Bp)
            out = _solve_revised_segmented(
                prep.dev, AT, put(full_c), put(lb), put(ub), put(b0),
                put(u0), put(_host_brows(prep, b0, np_dt)), max_iter)
    res = sx._to_result(out, B, M, N)
    if verbose >= 2:
        counts = dict(zip(*np.unique(res.status, return_counts=True)))
        print(f"lp_solve[revised]: batch={B} Mp={Mp} NT={Mp + Np} "
              f"statuses={counts} pivots max={int(res.iters.max())}",
              flush=True)
    return res
