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

On a CUDA device the pivot loop between two host reads is one or a few
replayed CUDA graphs of ``_rstep`` (lp/segments.py), the counterpart of
the JAX package's device-side segment program ``_revised_run_jit``; the
refactorizations run eagerly between two replays, where ``_run``'s
schedule reads the device.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from bensolve_tpu_torch import spans
from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.lp import simplex as sx
from bensolve_tpu_torch.lp.simplex import (BLAND_AFTER, INFEASIBLE, ITLIM,
                                           OPTIMAL, RUNNING, SEGMENT_MAX,
                                           LPResult, _nb_value, _set_at,
                                           _take, _tf32_off, _tols)

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


RSTATE_FIELDS = tuple(f.name for f in dataclasses.fields(_RState))


@dataclasses.dataclass
class _RLoop(_RState):
    """The loop state in a graph set (lp/segments.py): _RState plus the
    counters that _run's eager loop keeps beside it, on the device."""

    step: torch.Tensor       # () int64 global step count
    last: torch.Tensor       # () int64 last step on which some LP ran
    ran: torch.Tensor        # () bool: some LP ran in the latest step


def _contiguous(st: _RState) -> _RState:
    """``st`` with contiguous fields, so the graphs and the eager loop
    step the same layout (an LU solve's B^-1 is column-major)."""
    return dataclasses.replace(st, **{f: getattr(st, f).contiguous()
                                      for f in RSTATE_FIELDS})


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
    B = c.shape[0]
    M = A.shape[0]
    dev = c.device
    eye = torch.eye(M, dtype=c.dtype, device=dev)
    basis, in_basis, at_upper = sx._basis_masks(c, lb, ub, M, basis0,
                                                at_upper0)
    if basis0 is None:
        Binv = eye.repeat(B, 1, 1)
        Brows = eye.repeat(B, 1, 1)   # identity basis: rows ARE unit vectors
    elif basis0.ndim == 2:
        # per-instance warm start: batched LU of each candidate's basis
        Brows = Brows0
        LU, piv = sx._lu_factor(Brows.transpose(1, 2))
        Binv = sx._lu_solve(LU, piv, eye.expand(B, M, M))
    else:
        Brows1 = Brows0[0]
        LU, piv = sx._lu_factor(Brows1.T[None])
        Binv0 = sx._lu_solve(LU, piv, eye[None])[0]
        Binv = Binv0.expand(B, M, M).clone()
        Brows = Brows1.expand(B, M, M).clone()
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


def _rstep(A, AT, c, lb, ub, st: _RState, step: torch.Tensor):
    """One revised pivot for every running LP of the batch (the torch
    form of the JAX package's ``_rstep``); ``step`` is the global step
    count before this pivot, a () int64 tensor on the state's device.
    Returns the new state and a device bool: whether any LP was running
    when the step began.

    The exact pricing pass is computed every step and selected with
    ``torch.where``: the JAX package skips it with a device-side branch,
    which in torch would cost a host read per pivot.  The selected
    values, hence the pivots, are the same."""
    TOL_DJ = _tols(c.dtype)[1]
    M = A.shape[0]
    running = st.status == RUNNING
    zero = c.new_zeros(())
    viol_lo, viol_up, feasible, cB_eff = sx._phase_costs(st)
    y = torch.bmm(cB_eff[:, None, :], st.Binv)[:, 0, :]           # (B, M)

    # while every running instance is primal feasible, the carried cost
    # row prices the step; the exact pass runs while any instance is
    # infeasible (composite phase-1 costs are not rank-1-maintainable),
    # when a carried row is stale (force), and every 64 steps
    full = torch.where(feasible[:, None], c, zero) - sx._e_rmatmul(A, y)
    run_full = (((running & ~feasible) | (running & st.force)).any()
                | (step % 64 == 0))
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

    # pivot column alpha = Binv @ E_q
    e_q = _e_col(AT, q_idx, M)                                     # (B, M)
    alpha = torch.bmm(st.Binv, e_q[:, :, None])[:, :, 0]
    ent = types.SimpleNamespace(inc=_take(elig_inc, q_idx),
                                lb=_take(lb, q_idx), ub=_take(ub, q_idx),
                                val=_take(val, q_idx), c=_take(c, q_idx))
    pv = sx._pivot(st, alpha, q_idx, ent, viol_lo, viol_up, feasible,
                   new_status, act, use_bland)

    # rank-1 basis-inverse update (product form): Binv_i -= coef_i b_r,
    # with b_r = Binv_r / alpha_r.  Binv is updated IN PLACE: every start
    # and refactorization makes a fresh one
    row_r = pv.r_idx[:, None, None].expand(-1, 1, M)
    b_r = st.Binv.gather(1, row_r)[:, 0, :]
    b_r_scaled = b_r / pv.alpha_r[:, None]
    Binv_new = st.Binv.addcmul_(pv.coef[:, :, None], b_r_scaled[:, None, :],
                                value=-1)

    # basis-matrix rows follow the basis: slot r's column becomes E_q
    cur_row = st.Brows.gather(1, row_r)[:, 0, :]
    new_row = torch.where(pv.do_pivot[:, None], e_q, cur_row)
    Brows_new = st.Brows.scatter_(1, row_r, new_row[:, None, :])

    true = torch.ones_like(pv.do_pivot)
    in_basis_new = _set_at(st.in_basis, q_idx, true, pv.do_pivot)
    in_basis_new = _set_at(in_basis_new, pv.leaving, ~true, pv.do_pivot)
    at_upper_new = _set_at(st.at_upper, pv.leaving, pv.leave_at_upper,
                           pv.do_pivot)
    q_at_upper = _take(st.at_upper, q_idx)
    at_upper_new = _set_at(at_upper_new, q_idx, ~q_at_upper,
                           pv.act & pv.do_flip)

    # devex needs the pivot ROW over all NT columns: w_r = Binv_r @ E,
    # one more shared-A matmul per pivot
    w_r_full = sx._e_rmatmul(A, b_r_scaled)                        # (B, NT)
    gamma_new = sx._devex_update(st.gamma, w_r_full, pv.alpha_r, q_idx,
                                 pv.leaving, pv.do_pivot)

    # carried cost row: d' = d - d_q * w_r (exact phase-2 update)
    d_q = _take(d, q_idx)[:, None]
    dred_new = torch.where(pv.do_pivot[:, None], d - d_q * w_r_full, d)
    force_new = (running & ~feasible) | (would_finish & ~run_full)

    new = _RState(pv.basis, in_basis_new, at_upper_new, Binv_new,
                  Brows_new, pv.xb, pv.lbB, pv.ubB, pv.cB, pv.status,
                  pv.stall, pv.iters, gamma_new, dred_new, force_new,
                  st.resets)
    return new, running.any()


def _rseg_step(A, AT, c, lb, ub, s: _RLoop) -> _RLoop:
    """_rstep with _run's counters, the step a graph captures: the step
    count advanced in place, and ``last`` moved to it where some LP
    ran."""
    new, ran = _rstep(A, AT, c, lb, ub, s, s.step)
    step = s.step.add_(1)
    return _RLoop(**vars(new), step=step,
                  last=torch.where(ran, step, s.last), ran=ran)


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
    Binv = sx._lu_solve(LU, piv, eye.expand(B, M, M))
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


def _reads(step: int, end: int, every: int) -> list[int]:
    """The steps in (step, end] after which _schedule reads the device:
    every multiple of 16 and of ``every``, and ``end``."""
    return [t for t in range(step + 1, end + 1)
            if t % 16 == 0 or t % every == 0 or t == end]


def _schedule(loop, step: int, cap: int, every: int) -> int:
    """Pivot until no LP is running or ``step`` reaches ``cap``, with the
    JAX package's refactorization schedule: after step t (counted after
    the pivot), refactorize when t % every == 0, or when t % 16 == 0 and
    some running LP has non-finite xb.  The device state is read on the
    host once every 16 steps (the schedule), at every multiple of
    ``every``, and at the end of each segment (1, 2, 4, ... up to
    SEGMENT_MAX steps).  Steps taken after the last LP finished change
    nothing the result reads; they are not counted and never
    refactorize.  ``loop`` (_Eager or _Graphs) takes the steps between
    two reads and holds the state (``st``), the latest step's any-LP-ran
    flag (``ran``) and the last step on which some LP ran (``last``).
    Returns the step count."""
    alive = bool(spans.read((loop.st.status == RUNNING).any()))
    seg = 1
    while alive and step < cap:
        loop.begin()
        for t in _reads(step, step + min(seg, cap - step), every):
            loop.advance(t - step)
            step = t
            periodic = t % every == 0
            if periodic or t % 16 == 0:
                st = loop.st
                bad = ((st.status == RUNNING)
                       & ~torch.isfinite(st.xb).all(dim=1)).any()
                flags = torch.stack([loop.ran, bad])
                ran_h, bad_h = spans.read(flags).tolist()
                if ran_h and (periodic or (bad_h and t % 16 == 0)):
                    loop.refactor()
        ends = torch.stack(
            [loop.last,
             (loop.st.status == RUNNING).any().to(loop.last.dtype)])
        step, alive = spans.read(ends).tolist()
        alive = bool(alive)
        seg = min(2 * seg, SEGMENT_MAX)
    return step


class _Eager:
    """_schedule's steps taken one by one from the host: the plain
    version on the CPU, and the loop of a dp shard thread or of a row's
    "tp" panels.  ``stepper(st, step)`` takes one pivot (``step`` the
    step count before it, a () int64 tensor on the state's device) and
    returns (state, device bool: any LP was running); ``refactor(st)``
    refactorizes."""

    def __init__(self, stepper, refactor, st, step: int):
        self.stepper, self.refactor_fn, self.st = stepper, refactor, st
        self.step = torch.tensor(step, device=st.status.device)
        self.last = self.ran = None

    def begin(self):
        self.last = self.step

    def advance(self, n: int):
        for _ in range(n):
            self.st, self.ran = self.stepper(self.st, self.step)
            self.step = self.step + 1
            self.last = torch.where(self.ran, self.step, self.last)
        segments.count_eager(n, "revised")

    def refactor(self):
        self.st = self.refactor_fn(self.st)


class _Graphs:
    """_schedule's steps as replays of a held graph set of _rseg_step
    (lp/segments.py), whose buffers hold the state and the counters;
    a refactorization runs eagerly on the buffers, and its result is
    copied back into them."""

    def __init__(self, gs, refactor):
        self.gs, self.refactor_fn, self.st = gs, refactor, gs.state

    @property
    def ran(self):
        return self.st.ran

    @property
    def last(self):
        return self.st.last

    def begin(self):
        self.st.last.copy_(self.st.step)

    def advance(self, n: int):
        self.gs.advance(n)

    def refactor(self):
        self.gs.put(self.refactor_fn(self.st))


def _run_eager(stepper, refactor, st, step: int, cap: int, every: int):
    """_schedule's loop taken by _Eager; returns (state, step)."""
    loop = _Eager(stepper, refactor, st, step)
    step = _schedule(loop, step, cap, every)
    return loop.st, step


def _run(A, AT, c, lb, ub, st: _RState, step: int, cap: int, every: int):
    """The revised pivot loop from ``st`` (see _schedule): by replayed
    CUDA graphs of _rstep where simplex._graphs_on says so, eagerly
    otherwise; both take the same pivots, bit for bit.  The state is
    made contiguous on entry and after every refactorization, in both.
    Returns (state, step)."""
    st = _contiguous(st)
    dev = c.device
    if not sx._graphs_on(dev):
        return _run_eager(lambda s, k: _rstep(A, AT, c, lb, ub, s, k),
                          lambda s: _contiguous(_refactor(A, c, lb, ub, s)),
                          st, step, cap, every)
    start = _RLoop(**vars(st), step=torch.tensor(step, device=dev),
                   last=torch.tensor(step, device=dev),
                   ran=torch.zeros((), dtype=torch.bool, device=dev))
    with segments.held(_rseg_step, "revised", start, (A, AT, c, lb, ub),
                       ("Binv", "Brows")) as gs:
        step = _schedule(_Graphs(gs, lambda s: _refactor(A, c, lb, ub, s)),
                         step, cap, every)
        out = gs.unload(start)
    return _RState(**{f: getattr(out, f) for f in RSTATE_FIELDS}), step


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


# ------------------------------------------------- tp: column panels
#
# The revised route over a dp row's T panels (lp/simplex.py's _Panel,
# parallel/mesh.py's PanelLayout): panel k holds its ms columns of B^-1
# and of the basis rows (the minor axis, as the JAX package's
# P(dp, None, tp)), its ns columns of A and rows of A^T, and its columns
# of every per-variable row.  Per pivot: y = cB^T B^-1 is computed per
# panel and all-gathered; each panel prices its own columns and offers
# its candidate with the candidate's column of E; alpha = B^-1 E_q is
# summed from the panels' partial products; the pivot row b_r is local
# and all-gathered for the devex and carried-cost updates.


def _tp_lead_rstate(c, lb, ub, basis, xb):
    """The lead's (B, M) revised loop state (per-column fields None)."""
    st = sx._tp_lead_state(c, lb, ub, basis, xb)
    B = c.shape[0]
    return _RState(st.basis, None, None, None, None, st.xb, st.lbB, st.ubB,
                   st.cB, st.status, st.stall, st.iters, None, None,
                   torch.ones(B, dtype=torch.bool, device=c.device),
                   torch.zeros_like(st.stall))


def _tp_binv_xb(ts, rhs):
    """B^-1 @ rhs (B, Mp) on the lead: the panels' partial products over
    their columns of B^-1, summed (all-reduce)."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    lay = ts.lay
    parts = [torch.bmm(p.Binv, lay.rows(r, p.k)[:, :, None])[:, :, 0]
             for p, r in zip(ts.panels, pmesh.to_all(rhs, ts.devs))]
    return pmesh.all_reduce(parts, ts.devs[:1])[0]


def _tp_initial_rstate(lay, devs, A_panels, c, lb, ub, basis0, at_upper0,
                       Brows0):
    """The panelled start of _initial_rstate: a warm basis's rows (on the
    lead) are factored once there, and each panel solves for its own
    columns of B^-1."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    B = c.shape[0]
    M = lay.Mp
    basis, in_basis, at_upper = sx._basis_masks(c, lb, ub, M, basis0,
                                                at_upper0)
    panels = sx._tp_panels(lay, devs, A_panels, c, lb, ub, in_basis,
                           at_upper)
    if basis0 is None:
        for p in panels:
            p.Binv = lay.eye(p.k, c.dtype, p.dev).repeat(B, 1, 1)
            p.Brows = p.Binv.clone()
    else:
        shared = basis0.ndim == 1
        LU, piv = sx._lu_factor(Brows0.transpose(1, 2))
        for p, LU_k, piv_k, br in zip(panels, pmesh.to_all(LU, devs),
                                      pmesh.to_all(piv, devs),
                                      pmesh.to_all(Brows0, devs)):
            eye_k = lay.eye(p.k, c.dtype, p.dev)
            p.Binv = sx._lu_solve(LU_k, piv_k,
                                  eye_k.expand(LU.shape[0], M, lay.ms))
            p.Brows = lay.rows(br, p.k)
            if shared:
                p.Binv = p.Binv.expand(B, M, lay.ms).clone()
                p.Brows = p.Brows.expand(B, M, lay.ms).clone()
    for p in panels:
        p.dred = torch.zeros_like(p.c)
    ts = sx._TPState(lay, devs, panels, None, c, lb, ub)
    rhs = -sx._tp_e_zn(ts, devs[:1])[0]
    xb = rhs if basis0 is None else _tp_binv_xb(ts, rhs)
    ts.lead = _tp_lead_rstate(c, lb, ub, basis, xb)
    return ts


def _tp_rstep(ts, step: torch.Tensor):
    """One revised pivot of _rstep over the row's panels (see above);
    ``step`` as _rstep's, on the lead.  Returns (state, device bool: any
    LP was running)."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    lay, ld, devs = ts.lay, ts.lead, ts.devs
    TOL_DJ = _tols(ts.c.dtype)[1]
    M = lay.Mp
    running = ld.status == RUNNING
    viol_lo, viol_up, feasible, cB_eff = sx._phase_costs(ld)
    use_bland = ld.stall > BLAND_AFTER
    run_full = (((running & ~feasible) | (running & ld.force)).any()
                | (step % 64 == 0))

    # y = cB^T B^-1: each panel its own columns, then all-gathered
    sent = list(zip(*(pmesh.to_all(x, devs) for x in
                      (cB_eff, feasible, use_bland, run_full))))
    y_loc = [torch.bmm(cBe[:, None, :], p.Binv)[:, 0, :]
             for p, (cBe, _, _, _) in zip(ts.panels, sent)]
    ys = [y[:, :M] for y in pmesh.all_gather(y_loc, devs)]

    cands, cols, ds = [], [], []
    lane = torch.arange(M, device=devs[0])
    for p, (_, feas, bland, full_on), y, y_k in zip(ts.panels, sent, ys,
                                                     y_loc):
        full = (torch.where(feas[:, None], p.c, p.c.new_zeros(()))
                - torch.cat([y_k, -(y @ p.A)], dim=1))
        d = torch.where(full_on, full, p.dred)
        cand = _tp_candidate_e(lay, p, d, bland, TOL_DJ, lane.to(p.dev))
        cands.append(cand[:4])
        cols.append(torch.cat([_take(d, cand[2])[:, None], cand[4]], dim=1))
        ds.append(d)
    q_idx, has_entering, ent, q_at_upper, gamma_q, col = sx._tp_enter(
        ts, cands, cols)
    d_q, e_q = col[:, 0], col[:, 1:]

    finite = torch.isfinite(ld.xb).all(dim=1) & torch.isfinite(ys[0]).all(
        dim=1)
    finish_status = torch.where(feasible, OPTIMAL, INFEASIBLE).to(torch.int32)
    would_finish = running & ~has_entering & finite
    new_status = torch.where(would_finish & run_full, finish_status,
                             ld.status)
    act = running & has_entering & finite

    # alpha = B^-1 E_q: the entering column to every panel, the panels'
    # partial products summed
    e_qs = pmesh.to_all(e_q, devs)
    alpha = pmesh.all_reduce(
        [torch.bmm(p.Binv, lay.rows(e, p.k)[:, :, None])[:, :, 0]
         for p, e in zip(ts.panels, e_qs)], devs[:1])[0]
    pv = sx._pivot(ld, alpha, q_idx, ent, viol_lo, viol_up, feasible,
                   new_status, act, use_bland)

    # each panel's rank-1 update of its columns of B^-1 and basis rows
    sends = sx._tp_send_pivot(ts, pv, q_idx, gamma_q, q_at_upper)
    b_loc = []
    for p, (r_idx, coef, s), e in zip(ts.panels, sends, e_qs):
        row_r = r_idx[:, None, None].expand(-1, 1, lay.ms)
        b_r = p.Binv.gather(1, row_r)[:, 0, :]
        b_loc.append(b_r / s[0][:, None])
        p.Binv.addcmul_(coef[:, :, None], b_loc[-1][:, None, :], value=-1)
        cur_row = p.Brows.gather(1, row_r)[:, 0, :]
        new_row = torch.where(s[1][:, None], lay.rows(e, p.k), cur_row)
        p.Brows.scatter_(1, row_r, new_row[:, None, :])
    # the pivot row w_r = b_r E over every column: b_r all-gathered
    d_qs = pmesh.to_all(d_q, devs)
    for p, (_, _, s), b_k, b, d, dq in zip(
            ts.panels, sends, b_loc, pmesh.all_gather(b_loc, devs), ds,
            d_qs):
        w_r = torch.cat([b_k, -(b[:, :M] @ p.A)], dim=1)
        sx._tp_after_pivot(lay, p, w_r, s)
        p.dred = torch.where(s[1][:, None], d - dq[:, None] * w_r, d)
    force_new = (running & ~feasible) | (would_finish & ~run_full)
    ts.lead = dataclasses.replace(
        ld, basis=pv.basis, xb=pv.xb, lbB=pv.lbB, ubB=pv.ubB, cB=pv.cB,
        status=pv.status, stall=pv.stall, iters=pv.iters, force=force_new)
    ts.steps += 1
    return ts, running.any()


def _tp_candidate_e(lay, p, d, use_bland, tol_dj, lane):
    """simplex._tp_candidate plus the candidate's column of E (B, Mp):
    a unit vector for a slack, -A's column (a row of A^T) otherwise."""
    score, g, loc, packet = sx._tp_candidate(p, d, use_bland, tol_dj)
    aux_col = (g[:, None] == lane[None, :]).to(d.dtype)
    a_col = -p.AT.index_select(0, (loc - lay.ms).clamp(0, lay.ns - 1))
    e = torch.where((loc < lay.ms)[:, None], aux_col, a_col)
    return score, g, loc, packet, e


def _tp_refactor(ts):
    """_refactor over the row's panels: the basis rows gathered on the
    lead and factored once, each panel solving for its own columns of
    B^-1; the singular-basis reset applied per panel."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    lay, ld, devs = ts.lay, ts.lead, ts.devs
    M = lay.Mp
    B = ts.c.shape[0]
    rows = pmesh.all_gather([p.Brows for p in ts.panels], devs[:1])[0]
    LU, piv = sx._lu_factor(rows[:, :, :M].transpose(1, 2))
    eyes = []
    for p, LU_k, piv_k in zip(ts.panels, pmesh.to_all(LU, devs),
                              pmesh.to_all(piv, devs)):
        eyes.append(lay.eye(p.k, ts.c.dtype, p.dev).expand(B, M, lay.ms))
        p.Binv = sx._lu_solve(LU_k, piv_k, eyes[-1])
    xb = _tp_binv_xb(ts, -sx._tp_e_zn(ts, devs[:1])[0])
    binv_ok = torch.stack(
        [torch.isfinite(p.Binv.reshape(B, -1)).all(dim=1).to(devs[0])
         for p in ts.panels]).all(dim=0)
    bad = (ld.status == RUNNING) & ~(torch.isfinite(xb).all(dim=1) & binv_ok)
    aux = torch.arange(M, device=devs[0])
    basis = torch.where(bad[:, None], aux[None, :], ld.basis)
    for p, bad_k, eye_k in zip(ts.panels, pmesh.to_all(bad, devs), eyes):
        slack1 = (p.gidx < M)[None, :]
        p.in_basis = torch.where(bad_k[:, None], slack1, p.in_basis)
        atup_def = ((~torch.isfinite(p.lb)) & torch.isfinite(p.ub)
                    & ~slack1)
        p.at_upper = torch.where(bad_k[:, None], atup_def, p.at_upper)
        p.Binv = torch.where(bad_k[:, None, None], eye_k, p.Binv)
        p.Brows = torch.where(bad_k[:, None, None], eye_k, p.Brows)
        p.gamma = torch.where(bad_k[:, None], p.c.new_ones(()), p.gamma)
    xb = torch.where(bad[:, None], -sx._tp_e_zn(ts, devs[:1])[0], xb)
    ts.lead = dataclasses.replace(
        ld, basis=basis, xb=xb,
        lbB=torch.where(bad[:, None], ts.lb.gather(1, basis), ld.lbB),
        ubB=torch.where(bad[:, None], ts.ub.gather(1, basis), ld.ubB),
        cB=torch.where(bad[:, None], ts.c.gather(1, basis), ld.cB),
        stall=torch.where(bad, 0, ld.stall).to(torch.int32),
        force=torch.ones_like(ld.force),
        resets=ld.resets + bad.to(torch.int32))
    return ts


def _tp_rebound(ts, lb, ub):
    """_rebound over the row's panels: the exact bounds ``lb``/``ub``
    (B, NT, on the lead) replace the perturbed ones everywhere."""
    ts.lb, ts.ub = lb, ub
    for p, lb_k, ub_k in zip(ts.panels, ts.lay.split(lb), ts.lay.split(ub)):
        p.lb = lb_k.to(p.dev, non_blocking=True)
        p.ub = ub_k.to(p.dev, non_blocking=True)
    ld = ts.lead
    xb = _tp_binv_xb(ts, -sx._tp_e_zn(ts, ts.devs[:1])[0])
    status = torch.where(ld.status == INFEASIBLE, INFEASIBLE,
                         RUNNING).to(torch.int32)
    ts.lead = dataclasses.replace(
        ld, lbB=lb.gather(1, ld.basis), ubB=ub.gather(1, ld.basis), xb=xb,
        status=status, stall=torch.zeros_like(ld.stall),
        force=torch.ones_like(ld.force))
    return ts


def _solve_revised_tp(lay, devs, A_panels, c, lb, ub, basis0, at_upper0,
                      Brows0, max_iter, pert=None):
    """_solve_revised_segmented over a dp row's T panels: ``devs`` the
    row's tp entries (the lead first, where the (B, NT) rows, the warm
    start and its basis rows live), ``A_panels`` {(k, device): (A_k,
    A_k^T)} from parallel/mesh.py's a_panels.  The refactorization
    schedule and the exact pricing passes are decided once per row, over
    its whole batch, as the unsplit solve decides them."""
    from bensolve_tpu_torch.parallel import mesh as pmesh

    global CALLS
    CALLS += 1
    lb_run, ub_run = pert if pert is not None else (lb, ub)
    ts = _tp_initial_rstate(lay, devs, A_panels, c, lb_run, ub_run, basis0,
                            at_upper0, Brows0)
    every = _refactor_interval(lay.Mp, c.shape[1], c.dtype)
    ts, step = _run_eager(_tp_rstep, _tp_refactor, ts, 0, max_iter, every)
    if pert is not None:
        ts = _tp_rebound(ts, lb, ub)
        ts, step = _run_eager(_tp_rstep, _tp_refactor, ts, step,
                              step + max(2 * lay.Mp, 2000), every)
    rows = pmesh.all_gather([p.Brows for p in ts.panels], devs[:1])[0]
    out = sx._tp_finish(ts, rows[:, :, :lay.Mp])
    pmesh.record_split("revised", ts.panels, ts.steps)
    return out


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


def solve_batch_revised(A, c, row_lb, row_ub, col_lb, col_ub, *,
                        max_iter: int | None = None, dtype=np.float64,
                        start_basis=None, max_chunk: int | None = None,
                        device="cuda", mesh=None,
                        verbose: int = 0) -> LPResult:
    """Drop-in alternative to simplex.solve_batch for N >> M (same
    padding, chunking and warm-start contract).  A matrix that is not
    prepared yet is solved in its equilibrated form (exact power-of-two
    scales), and the solutions come back unscaled; basis indices and
    bound patterns are scale-invariant, so warm starts pass straight
    through.  ``device``:
    the torch device every LP tensor lives on.  ``mesh``: a
    ``parallel.mesh.Mesh`` (Options.mesh_axes): the padded batch, grown
    until the "dp" axis divides it, is solved in contiguous shards over
    the dp rows, in place of ``device``; with a "tp" axis every LP's
    basis inverse, basis rows and columns of A are split into panels
    over its row's tp entries (parallel/mesh.py), and no device holds
    the whole A.  ``verbose`` >= 2 prints one summary line per batched
    solve."""
    dev = sx.resolve_device(device)
    tp = mesh is not None and mesh.shape.get("tp", 1) > 1
    host = torch.device("cpu")
    if not isinstance(A, sx._PreparedA):
        sc = _prepare_scaled(A, dtype, host if tp else dev)
        r, cv = sc.rscale, sc.cscale
        res = solve_batch_revised(
            sc.prep, np.atleast_2d(np.asarray(c)) * cv[None, :],
            np.asarray(row_lb) * r[None, :], np.asarray(row_ub) * r[None, :],
            np.asarray(col_lb) / cv[None, :], np.asarray(col_ub) / cv[None, :],
            max_iter=max_iter, dtype=dtype, start_basis=start_basis,
            max_chunk=max_chunk, device=dev, mesh=mesh, verbose=verbose)
        return LPResult(res.status, res.obj, res.x * cv[None, :],
                        res.s / r[None, :], res.row_dual * r[None, :],
                        res.col_dual / cv[None, :], res.iters,
                        res.basis, res.at_upper)
    prep = sx._prepare_A(A, dtype, host if tp else dev)
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
                max_chunk=max_chunk, device=dev, mesh=mesh,
                verbose=verbose))
        return sx.concat_results(parts)

    B = c2.shape[0]
    Bp = sx._bucket_batch(B, Mp)
    rows = None
    if mesh is not None:
        from bensolve_tpu_torch.parallel import mesh as pmesh

        rows = pmesh.mesh_rows(mesh)
        Bp = pmesh.padded_batch(Bp, len(rows))
    if max_iter is None:
        # the generic shape-derived cap, bounded for huge-N instances
        max_iter = min(50 * (Mp + Np) + 500, 40 * Mp + 20000)
    full_c, lb, ub = sx._pad_batch_inputs(prep, c2, row_lb, row_ub,
                                          col_lb, col_ub, Bp, np_dt)
    lb1 = ub1 = b0 = u0 = brows = None
    if start_basis is None:
        if Mp >= PERTURB_MIN_M:
            lb1, ub1 = _perturbed_bounds(lb, ub, np_dt)
    else:
        b0, u0 = sx._pad_warm(start_basis, Mp, Mp + Np, B, Bp)
        brows = _host_brows(prep, b0, np_dt)

    def solve(p, c_t, lb_t, ub_t, lb1_t, ub1_t, b_t, u_t, brows_t):
        pert = None if lb1_t is None else (lb1_t, ub1_t)
        return _solve_revised_segmented(p.dev, p.devT, c_t, lb_t, ub_t, b_t,
                                        u_t, brows_t, max_iter, pert)

    per = b0 is not None and b0.ndim == 2
    with _tf32_off():
        if rows is None:
            prep.transposed()
            out = solve(prep, *(None if a is None else sx._put(a, dev)
                                for a in (full_c, lb, ub, lb1, ub1, b0, u0,
                                          brows)))
        elif tp:
            lay = pmesh.PanelLayout(Mp, Np, len(rows[0]))
            A_panels = pmesh.a_panels(prep, lay, rows, transposed=True)

            def solve_tp(row, c_t, lb_t, ub_t, lb1_t, ub1_t, b_t, u_t, br_t):
                b_t, u_t = sx._shard_warm(b0, u0, b_t, u_t, row[0])
                if br_t is None and brows is not None:
                    br_t = sx._put(brows, row[0])
                return _solve_revised_tp(
                    lay, row, A_panels, c_t, lb_t, ub_t, b_t, u_t, br_t,
                    max_iter, None if lb1_t is None else (lb1_t, ub1_t))

            out = pmesh.map_shards(
                rows, (full_c, lb, ub, lb1, ub1) + sx._batched_warm(b0, u0)
                + (brows if per else None,), solve_tp)
        else:
            entries = [r[0] for r in rows]
            # each distinct device's A and A^T are made here, before the
            # shard threads read them
            preps = {d: sx._prepare_A(prep, np_dt, d)
                     for d in dict.fromkeys(entries)}
            for p in preps.values():
                p.transposed()
            out = pmesh.map_shards(
                entries, (full_c, lb, ub, lb1, ub1) + sx._batched_warm(b0, u0)
                + (brows if per else None,),
                lambda d, c_t, lb_t, ub_t, lb1_t, ub1_t, b_t, u_t, br_t:
                solve(preps[d], c_t, lb_t, ub_t, lb1_t, ub1_t,
                      *sx._shard_warm(b0, u0, b_t, u_t, d),
                      br_t if br_t is not None or brows is None
                      else sx._put(brows, d)))
    res = sx._to_result(out, B, M, N)
    if verbose >= 2:
        counts = dict(zip(*np.unique(res.status, return_counts=True)))
        print(f"lp_solve[revised]: batch={B} Mp={Mp} NT={Mp + Np} "
              f"statuses={counts} pivots max={int(res.iters.max())}",
              flush=True)
    return res
