"""Batched bounded-variable DUAL simplex (tableau form), in PyTorch.

The torch port of ``bensolve_tpu/lp/dual_simplex.py``: the same
lockstep tableau state as lp/simplex.py, with pivots chosen by the dual
rules — leaving row first (most primal-infeasible basic), entering
column by the dual ratio test that keeps the reduced costs
sign-feasible.

Benson phase-2 re-solves change ONLY row bounds, so a previous optimum's
basis stays DUAL feasible and the dual simplex warm-started from it
walks back to optimality in a handful of pivots.  Instances whose
starting basis is not dual feasible finish with status DUAL_LOST;
``solve_batch_dual`` then re-solves exactly those with the primal
solver from the same basis (the batched GLP_DUALP fallback,
bslv_lp.c:190-192, 219-259).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bensolve_tpu_torch import spans
from bensolve_tpu_torch.lp import simplex as sx
from bensolve_tpu_torch.lp.simplex import (BLAND_AFTER, DUAL_LOST,
                                           INFEASIBLE, ITLIM, OPTIMAL,
                                           RUNNING, LPResult, _nb_value,
                                           _set_at, _take, _tols)


def _dstep(A, c, lb, ub, st: sx._State) -> sx._State:
    """One dual pivot for every running LP of the batch."""
    TOL_BND, TOL_DJ, TOL_PIV = _tols(c.dtype)
    NT = c.shape[1]
    running = st.status == RUNNING
    zero = c.new_zeros(())
    one = c.new_ones(())
    inf = c.new_full((), float("inf"))

    # --- leaving row: most primal-infeasible basic variable -----------
    below = st.xb < st.lbB - TOL_BND
    above = st.xb > st.ubB + TOL_BND
    viol = torch.where(below, st.lbB - st.xb,
                       torch.where(above, st.xb - st.ubB, zero))
    feasible = ~(viol > 0).any(dim=1)

    use_bland = st.stall > BLAND_AFTER
    basis_f = st.basis.to(c.dtype)
    dantzig_r = torch.where(viol > 0, viol, -inf)
    bland_r = torch.where(viol > 0, -basis_f, -inf)
    r_idx = torch.where(use_bland[:, None], bland_r, dantzig_r).argmax(dim=1)
    r_below = _take(below, r_idx)

    # --- reduced costs (fresh pricing, like the primal solver) --------
    d = c - torch.bmm(st.cB[:, None, :], st.W)[:, 0, :]

    # --- entering column: dual ratio test on row r ---------------------
    alpha_row = st.W.gather(
        1, r_idx[:, None, None].expand(-1, 1, NT))[:, 0, :]       # (B, NT)
    val = _nb_value(lb, ub, st.at_upper)
    can_inc = (~st.in_basis) & (val < ub)
    can_dec = (~st.in_basis) & (val > lb)
    elig = torch.where(
        r_below[:, None],
        (can_inc & (alpha_row < -TOL_PIV)) | (can_dec & (alpha_row > TOL_PIV)),
        (can_inc & (alpha_row > TOL_PIV)) | (can_dec & (alpha_row < -TOL_PIV)))
    ratio = torch.where(elig, d.abs() / alpha_row.abs(), inf)
    rmin = ratio.min(dim=1).values
    near = elig & (ratio <= rmin[:, None] + TOL_DJ)
    stab = torch.where(near, alpha_row.abs(), -one)
    lane = torch.arange(NT, dtype=c.dtype, device=c.device)
    bland_q = torch.where(near, -lane, -inf)
    q_idx = torch.where(use_bland[:, None], bland_q, stab).argmax(dim=1)
    has_entering = elig.any(dim=1)

    # --- statuses -------------------------------------------------------
    new_status = torch.where(running & feasible, OPTIMAL, st.status)
    # dual unbounded == primal infeasible (no column can absorb row r)
    new_status = torch.where(running & ~feasible & ~has_entering,
                             INFEASIBLE, new_status).to(torch.int32)
    act = running & ~feasible & has_entering

    # --- pivot ----------------------------------------------------------
    alpha_col = st.W.gather(
        2, q_idx[:, None, None].expand(-1, st.W.shape[1], 1))[:, :, 0]
    alpha_rq = _take(alpha_row, q_idx)
    alpha_rq = torch.where(alpha_rq.abs() < TOL_PIV,
                           torch.where(alpha_rq < 0, -TOL_PIV * one,
                                       TOL_PIV * one), alpha_rq)
    target = torch.where(r_below, _take(st.lbB, r_idx), _take(st.ubB, r_idx))
    dx_q = torch.where(act, (_take(st.xb, r_idx) - target) / alpha_rq, zero)

    xq_new = _take(val, q_idx) + dx_q
    xb_new = st.xb - dx_q[:, None] * alpha_col
    xb_new = torch.where(act[:, None], _set_at(xb_new, r_idx, xq_new, act),
                         st.xb)

    # rank-1 tableau update, fused and in place exactly like the primal
    # pivot (see simplex._step)
    w_r_scaled = alpha_row / alpha_rq[:, None]
    coef = alpha_col.scatter_add(1, r_idx[:, None],
                                 -torch.ones_like(alpha_rq)[:, None])
    coef = torch.where(act[:, None], coef, zero)
    W_new = st.W.addcmul_(coef[:, :, None], w_r_scaled[:, None, :], value=-1)

    leaving = _take(st.basis, r_idx)
    basis_new = _set_at(st.basis, r_idx, q_idx, act)
    lbB_new = _set_at(st.lbB, r_idx, _take(lb, q_idx), act)
    ubB_new = _set_at(st.ubB, r_idx, _take(ub, q_idx), act)
    cB_new = _set_at(st.cB, r_idx, _take(c, q_idx), act)

    true = torch.ones_like(act)
    in_basis_new = _set_at(st.in_basis, q_idx, true, act)
    in_basis_new = _set_at(in_basis_new, leaving, ~true, act)

    # leaving variable rests at the bound it was pushed to
    at_upper_new = _set_at(st.at_upper, leaving, ~r_below, act)

    degen = act & (dx_q.abs() < TOL_BND)
    stall_new = torch.where(act, torch.where(degen, st.stall + 1, 0),
                            st.stall).to(torch.int32)
    iters_new = st.iters + act.to(torch.int32)

    return sx._State(basis_new, in_basis_new, at_upper_new, W_new, xb_new,
                     lbB_new, ubB_new, cB_new,
                     new_status, stall_new, iters_new,
                     st.gamma)   # devex weights unused by the dual rules


def _dual_feasible_mask(A, c, lb, ub, st) -> torch.Tensor:
    """(B,) True where the starting basis is sign-feasible in the duals:
    at-lb nonbasics need d >= -tol, at-ub need d <= tol, free nonbasics
    need |d| <= tol."""
    _, TOL_DJ, _ = _tols(c.dtype)
    d = c - torch.bmm(st.cB[:, None, :], st.W)[:, 0, :]
    fin_lb, fin_ub = torch.isfinite(lb), torch.isfinite(ub)
    nonb = ~st.in_basis
    at_lb = nonb & ~st.at_upper & fin_lb
    at_ub = nonb & st.at_upper & fin_ub
    free = nonb & ~fin_lb & ~fin_ub
    fixed = nonb & (lb == ub)
    bad = ((at_lb & ~fixed & (d < -TOL_DJ)) | (at_ub & ~fixed & (d > TOL_DJ))
           | (free & (d.abs() > TOL_DJ)))
    return ~bad.any(dim=1)


def _mark_dual_lost(A, c, lb, ub, st) -> sx._State:
    ok = _dual_feasible_mask(A, c, lb, ub, st)
    lost = (st.status == RUNNING) & ~ok
    return dataclasses.replace(
        st, status=torch.where(lost, DUAL_LOST, st.status).to(torch.int32))


def _solve_dual_segmented(A, c, lb, ub, basis0, at_upper0, max_iter,
                          state_warm=None, keep_state=False):
    """``state_warm``: (KeptState, idx (Bp,)) — gather-based warm start
    from a previous solve's kept tableau (no factorizations).
    ``keep_state``: also return the final state as a KeptState for the
    NEXT round; age accounts for the carried rank-1 drift."""
    age0 = 0
    if state_warm is not None:
        ks, idx = state_warm
        age0 = ks.age
        st = sx._start_from_state(
            A, c, lb, ub, ks, torch.as_tensor(idx, device=c.device).long())
    else:
        st = sx._initial_state(A, c, lb, ub, basis0, at_upper0)
    st = _mark_dual_lost(A, c, lb, ub, st)
    st = sx._run_segmented(_dstep, A, c, lb, ub, st, max_iter)
    status = spans.read(st.status)
    max_piv = int(spans.read(st.iters.max()))
    # drift carried by the state's W: the inherited chain age plus this
    # solve's pivots (a start WITHOUT state_warm began from an exact
    # LU or from E itself, so its chain starts at max_piv)
    age = (age0 + max_piv) if state_warm is not None else max_piv
    cap = (sx.STATE_WARM_MAX_AGE
           if c.dtype == torch.float64 else sx.STATE_WARM_MAX_AGE // 4)
    # LU-free finish only for float64 chains, when the whole batch
    # terminated OPTIMAL and the accumulated drift stays within the cap;
    # anything else gets the refactorized (exact) finish.  Float32 chains
    # always refactorize: the loop's basic values carry the absolute
    # error of -W zn, and Benson's far initial vertices put row bounds
    # near 4e7, where that error reaches whole units (the JAX package's
    # LU-free float32 finish returned objectives off by 2.9 on example05)
    if (state_warm is not None and c.dtype == torch.float64
            and age <= cap and (status == OPTIMAL).all()):
        out = sx._cheap_finish(A, c, lb, ub, st)
    else:
        out = sx._finish(A, c, lb, ub, st)
    kept = sx._keep_state(st, age) if keep_state else None
    return out, kept


def solve_batch_dual(A, c, row_lb, row_ub, col_lb, col_ub, *,
                     max_iter: int | None = None, dtype=np.float64,
                     start_basis=None, max_chunk: int | None = None,
                     retry_primal: bool = True, start_state=None,
                     keep_state: bool = False, device="cuda"):
    """Dual simplex over the batch; instances whose start basis is not
    dual feasible (or that hit the iteration cap, when ``retry_primal``)
    are re-solved with the primal solver from the same basis.

    ``start_state``: (KeptState, idx (B,)) — warm start by gathering
    parent rows of a previous solve's kept device tableau.
    ``keep_state``: return ``(LPResult, KeptState | None)``; the kept
    state is dropped (None) when any instance took the primal retry.
    Batches larger than ``max_chunk`` (default: the tableau byte budget,
    as in the primal path) are solved in chunks."""
    dev = sx.resolve_device(device)
    prep = sx._prepare_A(A, dtype, dev)
    M, N, Mp, Np = prep.M, prep.N, prep.Mp, prep.Np
    np_dt = prep.host.dtype
    if max_chunk is None:
        max_chunk = sx._auto_chunk(M, N, np_dt.itemsize)
    c2 = np.atleast_2d(np.asarray(c))
    if c2.shape[0] > max_chunk:
        parts, keeps = [], []
        for s in range(0, c2.shape[0], max_chunk):
            sl = slice(s, s + max_chunk)
            sub_state = (None if start_state is None else
                         (start_state[0],
                          np.asarray(start_state[1])[sl]))
            out = solve_batch_dual(
                prep, c2[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, dtype=dtype,
                start_basis=sx._slice_warm(start_basis, sl),
                max_chunk=max_chunk, retry_primal=retry_primal,
                start_state=sub_state, keep_state=keep_state, device=dev)
            if keep_state:
                out, kept_i = out
                keeps.append(kept_i)
            parts.append(out)
        res = sx.concat_results(parts)
        if keep_state:
            kept = (sx._concat_kept(keeps)
                    if all(k is not None for k in keeps) else None)
            return res, kept
        return res
    B = c2.shape[0]
    Bp = sx._bucket_batch(B, Mp)
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500
    full_c, lb, ub = sx._pad_batch_inputs(prep, c2, row_lb, row_ub,
                                          col_lb, col_ub, Bp, np_dt)
    state_warm = None
    b0 = u0 = None
    if start_state is not None:
        ks, sidx = start_state
        sidx = np.asarray(sidx, np.int64).reshape(-1)
        if (ks is not None and ks.W.shape[-1] == Mp + Np
                and ks.W.shape[-2] == Mp and sidx.size == B):
            pad_idx = np.zeros(Bp, np.int64)
            pad_idx[:B] = sidx
            if Bp > B > 0:
                pad_idx[B:] = sidx[0]
            state_warm = (ks, pad_idx)
    if state_warm is None:
        if start_basis is None:
            # the all-slack basis is dual feasible only for c <= 0 on
            # structurals; DUAL_LOST instances fall back below
            b0 = np.arange(Mp, dtype=np.int64)
            u0 = np.zeros(Mp + Np, bool)
        else:
            b0, u0 = sx._pad_warm(start_basis, Mp, Mp + Np, B, Bp)
        b0, u0 = sx._put(b0, dev), sx._put(u0, dev)
    out, kept = _solve_dual_segmented(
        prep.dev, sx._put(full_c, dev), sx._put(lb, dev), sx._put(ub, dev),
        b0, u0, max_iter, state_warm=state_warm, keep_state=keep_state)
    if kept is not None and Bp != B:
        # drop padding rows so row i of the kept state is row i of the
        # caller's batch (chunk concatenation relies on this)
        kept = sx.KeptState(kept.basis[:B], kept.in_basis[:B],
                            kept.at_upper[:B], kept.W[:B], kept.age)
    res = sx._to_result(out, B, M, N, pivoted=True)
    retry = (res.status == DUAL_LOST) | (res.status == ITLIM)
    if retry_primal and retry.any():
        idx = np.flatnonzero(retry)
        pri = sx.solve_batch(
            prep, c2[idx], np.asarray(row_lb)[idx], np.asarray(row_ub)[idx],
            np.asarray(col_lb)[idx], np.asarray(col_ub)[idx],
            max_iter=max_iter, dtype=dtype,
            start_basis=(res.basis[idx], res.at_upper[idx]),
            max_chunk=max_chunk, device=dev)
        merged = {}
        for f in dataclasses.fields(LPResult):
            dst = getattr(res, f.name)
            src = getattr(pri, f.name)
            if dst is not None and src is not None:
                dst = np.array(dst)
                dst[idx] = src
            merged[f.name] = dst
        res = LPResult(**merged)
        kept = None   # kept rows no longer describe the returned result
    if keep_state:
        return res, kept
    return res
