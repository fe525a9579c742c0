"""The Benson algorithm phases, batched (primal algorithm).

The port of ``bensolve_tpu/algs/phases.py``; the dual phases (P1
template) are not ported yet.  Reference: bslv_algs.c phase0 (:673),
phase1_primal (:811), phase2_init (:943), phase2_primal (:958).

Where the serial C code pops ONE unprocessed vertex of the outer
approximation per iteration and solves one LP (bslv_algs.c:863-895),
these drivers gather the ENTIRE frontier each round, solve the whole
batch of scalarization LPs in one device call, then apply the resulting
cuts in deterministic (ascending vertex index) order.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from bensolve_tpu_torch.algs.solution import (SolStatus, SolutionContext,
                                              cone_vertenum)
from bensolve_tpu_torch.algs.templates import (HOMOGENEOUS, INHOMOGENEOUS,
                                               P2Template)
from bensolve_tpu_torch.lp import simplex
from bensolve_tpu_torch.poly.polytope import (POLY_EPS, PolytopePair,
                                              make_lower_to_upper_v2h)
from bensolve_tpu_torch.vlp.options import Options
from bensolve_tpu_torch.vlp.problem import VLPProblem


@dataclasses.dataclass
class Stats:
    """Run counters (reference lp_num, bslv_lp.c:30; plus round counts
    for the batched execution model)."""

    lps: int = 0
    rounds: int = 0
    cuts: int = 0
    pivots: int = 0   # total simplex pivots (warm-start efficacy metric)


class _FacetWarm:
    """Per-candidate warm starts (the batched analogue of GLPK's
    carried basis, bslv_lp.c:31): map each frontier candidate to the
    final basis of the LP whose cut created it, or to its row in the
    parent solve's kept device tableau."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.by_facet: dict[int, tuple] = {}
        self.serial = 0

    def record(self, facet, basis, at_upper) -> None:
        if self.enabled and facet is not None and basis is not None:
            self.by_facet[int(facet)] = (self.serial, "basis",
                                         np.asarray(basis),
                                         np.asarray(at_upper))
            self.serial += 1

    def record_state_row(self, facet, row, solve_no) -> None:
        """Kept-device-tableau analogue of record(): the carried datum is
        the parent's ROW INDEX in its solve plus the solve number — the
        warm start becomes one gather instead of a batched LU."""
        if self.enabled and facet is not None:
            self.by_facet[int(facet)] = (self.serial, "row", int(row),
                                         int(solve_no))
            self.serial += 1

    def lookup(self, poly, cand):
        """Per-candidate parent warm data: (B, M) bases + bound patterns,
        or ("state_rows", rows, solve_no); None when nothing is known
        yet or the recorded kinds are mixed."""
        if not self.enabled or not self.by_facet:
            return None
        rows = []
        for idx in cand:
            best = None
            for f in poly.inc[int(idx)]:
                e = self.by_facet.get(int(f))
                if e is not None and (best is None or e[0] > best[0]):
                    best = e
            rows.append(best)
        if all(r is None for r in rows):
            return None
        fill = next(r for r in rows if r is not None)
        rows = [r if r is not None else fill for r in rows]
        kinds = {r[1] for r in rows}
        if "row" in kinds:
            # kept-state rows are only gatherable from the LATEST
            # solve's tableau; stale or non-row parents borrow the
            # newest row.  Borrowing is safe for the dual-warm route:
            # dual feasibility of an optimal basis does not depend on
            # the changed bounds, so a foreign parent row costs extra
            # pivots, not correctness.
            latest = max(r[3] for r in rows if r[1] == "row")
            fill2 = next(r for r in rows
                         if r[1] == "row" and r[3] == latest)
            rows = [r if r[1] == "row" and r[3] == latest else fill2
                    for r in rows]
            return ("state_rows",
                    np.array([r[2] for r in rows], np.int64), latest)
        basis = np.stack([r[2] for r in rows])
        atup = np.stack([r[3] for r in rows])
        return basis, atup


def _check_all_optimal(res, what: str) -> None:
    bad = np.flatnonzero(res.status != simplex.OPTIMAL)
    if bad.size:
        raise RuntimeError(
            f"{what}: LP {bad[0]} returned status {res.status[bad[0]]} "
            f"(expected optimal)")


def orthogonal_vector(C: np.ndarray, i: int) -> None:
    """Write into column i a unit vector orthogonalized against columns
    0..i-1, retrying across the unit basis on degeneracy (reference
    orthogonal_vector, bslv_lists.c:113-143)."""
    dim = C.shape[0]
    for r in range(dim):
        v = np.zeros(dim)
        v[(i + r) % dim] = 1.0
        for j in range(i):
            cj = C[:, j]
            v -= (cj @ v) / (cj @ cj) * cj
        if v @ v > 1e-3:
            break
    C[:, i] = v / np.sqrt(v @ v)


def _template(vlp, P_eff, ZR, eta, homogeneous, opt: Options, method):
    return P2Template(vlp, P_eff, ZR, eta, homogeneous,
                      dtype=opt.lp_dtype, lp_verbose=opt.lp_message_level,
                      lp_method=method, max_batch=opt.lp_max_batch,
                      ipm_min=opt.lp_ipm_min, device=opt.device)


def phase0(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
           opt: Options, stats: Stats) -> None:
    """Compute eta in int(D* + K) with eta'c == 1 via a short serial
    sequence of P2-homogeneous probes (reference bslv_algs.c:673-800).
    Sets sol.eta, or sol.status to UNBOUNDED / NOVERTEX."""
    q = sol.q
    m = vlp.m
    t2 = _template(vlp, P_eff, sol.Z, np.zeros(q), HOMOGENEOUS, opt,
                   opt.lp_method_phase0)

    def _log(what, t0):
        if opt.message_level >= 2:
            print(f"phase0: {what} done in {time.perf_counter()-t0:.1f}s",
                  flush=True)

    if opt.message_level >= 3:
        print("solve lp")   # bslv_algs.c:685
    t0 = time.perf_counter()
    res = t2.solve(np.zeros((1, sol.p)))
    stats.lps += 1
    _log("seed LP", t0)
    if res.status[0] == simplex.UNBOUNDED:
        sol.status = SolStatus.UNBOUNDED
        return
    _check_all_optimal(res, "phase0 seed")
    z = res.row_dual[0, m:m + q - 1].copy()

    C = np.zeros((q - 1, q - 1))
    V = np.zeros((q - 1, q - 1))
    for i in range(q - 1):
        orthogonal_vector(C, i)
        ub = (C[:, i] @ sol.Z[: q - 1, :])[None, :]   # (1, p)
        t0 = time.perf_counter()
        res = t2.solve(ub)
        stats.lps += 1
        _log(f"probe {i + 1}/{q - 1}", t0)
        _check_all_optimal(res, "phase0 probe")
        V[:, i] = res.row_dual[0, m:m + q - 1] - z
        if abs(C[:, i] @ V[:, i]) < opt.eps_phase0:
            t0 = time.perf_counter()
            res = t2.solve(-ub)
            stats.lps += 1
            _log(f"probe {i + 1}/{q - 1} (flipped)", t0)
            _check_all_optimal(res, "phase0 probe (flipped)")
            V[:, i] = res.row_dual[0, m:m + q - 1] - z
        if abs(C[:, i] @ V[:, i]) < opt.eps_phase0:
            sol.status = SolStatus.NOVERTEX
            return
        # C(i) <- V(i) orthogonalized against C(0..i-1) (bslv_algs.c:762-780)
        v = V[:, i].copy()
        for j in range(i):
            cj = C[:, j]
            v -= (cj @ V[:, i]) / (cj @ cj) * cj
        C[:, i] = v

    # eta = mean of {0, V(0..q-2)} + z; last component from eta'c == 1
    # (bslv_algs.c:783-798)
    eta = np.zeros(q)
    if q > 1:
        eta[: q - 1] = V.sum(axis=1) / q + z
    eta[q - 1] = 1.0 - sol.c[: q - 1] @ eta[: q - 1]
    sol.eta = eta


def _extract_R_H(sol: SolutionContext, lower_poly, opt: Options,
                 stats: Stats) -> None:
    """Phase 1 part 3 (bslv_algs.c:908-929): collect lower-image
    vertices with last component ~ 0, rescale the last component so
    that c'y* == 1, and run cone vertex enumeration to get R
    (non-redundant) and H (its dual cone)."""
    q = sol.q
    # the reference's 1e-8 ray test (bslv_algs.c:912) assumes
    # GLPK-exact multipliers; float32 LPs carry ~1e-4-scale dual noise
    # in the last component, and a MISSED recession ray wrecks the
    # phase-2 seeding, so the float32 route floors the test at 1e-3
    ray_eps = opt.eps_phase1
    if np.dtype(opt.lp_dtype) == np.dtype(np.float32):
        ray_eps = max(ray_eps, 1e-3)
    cols = []
    alphas = []
    for l in lower_poly.live():
        if lower_poly.ideal[l]:
            continue
        v = lower_poly.data[l]
        alphas.append(abs(v[q - 1]))
        if abs(v[q - 1]) < ray_eps:
            w = np.empty(q)
            w[: q - 1] = v[: q - 1]
            w[q - 1] = 1.0 - sol.c[: q - 1] @ v[: q - 1]
            cols.append(w)
    if opt.message_level >= 2 and alphas:
        alphas = np.sort(np.asarray(alphas))
        print(f"phase1 R/H: {len(cols)}/{alphas.size} lower-image "
              f"vertices classified as rays at ray_eps="
              f"{ray_eps:g}; smallest last-components "
              f"{[f'{a:.2e}' for a in alphas[:6]]}", flush=True)
    arr = np.array(cols).T if cols else np.zeros((q, 0))
    res = cone_vertenum(arr, q)
    if res is None:
        raise RuntimeError("recession cone enumeration failed")
    sol.R, sol.H = res


def phase1_primal(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
                  opt: Options, stats: Stats) -> PolytopePair:
    """Outer-approximate the recession cone of the upper image
    (homogeneous Benson, reference bslv_algs.c:811-933)."""
    q = sol.q
    t2 = _template(vlp, P_eff, sol.Z, sol.eta, HOMOGENEOUS, opt,
                   opt.lp_method_phase1)
    p = sol.p
    pair = PolytopePair(q, eps=POLY_EPS,
                        dual_v2h=make_lower_to_upper_v2h(sol.c))
    # PART 1: one LP per column of Z, each with only its own extra
    # row active (bslv_algs.c:828-848) — batched
    ub = np.full((p, p), np.inf)
    np.fill_diagonal(ub, 0.0)
    res = t2.solve(ub)
    stats.lps += p
    _check_all_optimal(res, "phase1_primal init")
    for j in range(p):
        val = np.empty(q)
        val[: q - 1] = sol.Z[: q - 1, j]
        val[q - 1] = res.obj[j]
        pair.add_vertex(val, ideal=False)
    if not pair.initial_approx():
        raise RuntimeError("phase1_primal: initial approximation failed")

    # PART 2: batched main loop
    _benson_primal_loop(pair, t2, sol, opt.eps_benson_phase1, stats,
                        phase1=True, warm_mode=opt.warm_mode,
                        verbose=opt.message_level)

    # PART 3: R and H
    _extract_R_H(sol, pair.dual, opt, stats)
    return pair


def _benson_primal_loop(pair: PolytopePair, t2: P2Template,
                        sol: SolutionContext, eps: float, stats: Stats,
                        *, phase1: bool, pre_img: bool = False,
                        optdir: int = 1, warm_mode: str = "auto",
                        verbose: int = 0) -> None:
    """Shared main loop of the primal phases: per round, solve P2(v) for
    every unprocessed non-ideal vertex v of the outer approximation and
    either cut (obj > eps) or finalize the vertex.

    ``warm_mode``: "per_candidate" warm-starts every LP from its parent
    basis (_FacetWarm), "shared" keeps only the template's carried
    basis, "auto" picks per-candidate unless the batch routes to the
    per-LP kernel (which broadcasts ONE starting tableau)."""
    P = pair.primal
    q = sol.q
    ZR = sol.Z if phase1 else sol.R
    warm = _FacetWarm(
        warm_mode == "per_candidate"
        or (warm_mode == "auto" and not t2.prefers_shared_warm()))
    deferrals: dict[int, int] = {}
    what = "phase1_primal loop" if phase1 else "phase2_primal loop"
    while True:
        frontier = P.frontier()
        if frontier.size == 0:
            break
        ideals = frontier[P.ideal[frontier]]
        P.sltn[ideals] = True   # directions are never processed
        cand = frontier[~P.ideal[frontier]]
        if cand.size == 0:
            continue
        stats.rounds += 1
        solve_idx = cand
        if verbose >= 3:
            for _ in range(cand.size):   # bslv_algs.c:877
                print("process primal vertex - solve lp")
        V = P.data[solve_idx]                  # (B, q)
        res = t2.solve(V @ ZR,                 # ub_j = ZR_j . v
                       start_basis=warm.lookup(P, solve_idx))
        stats.lps += cand.size
        stats.pivots += int(res.iters.sum())
        # row index of each surviving result in the SOLVE batch — the
        # kept-state warm chain records these, and the deferral filter
        # below must keep the mapping aligned
        orig_rows = np.arange(solve_idx.size)
        # a candidate whose LP did not resolve is DEFERRED: it stays on
        # the frontier while this round's other cuts reshape the
        # polytope, and is retried (bounded) in later rounds.  No
        # progress at all (every LP failed, or a vertex keeps failing)
        # raises.
        bad = np.flatnonzero(res.status != simplex.OPTIMAL)
        if bad.size == solve_idx.size:
            _check_all_optimal(res, what)
        if deferrals:
            for k in np.flatnonzero(res.status == simplex.OPTIMAL):
                deferrals.pop(int(solve_idx[k]), None)
        if bad.size:
            for k in bad:
                vid = int(solve_idx[k])
                deferrals[vid] = deferrals.get(vid, 0) + 1
                if deferrals[vid] > 5:
                    raise RuntimeError(
                        f"{what}: LP for vertex {vid} failed "
                        f"{deferrals[vid]} rounds running (status "
                        f"{res.status[k]})")
            if verbose >= 2:
                print(f"[{what}] deferring {bad.size} unresolved "
                      f"candidate(s) to a later round")
            sel = np.flatnonzero(res.status == simplex.OPTIMAL)
            solve_idx = solve_idx[sel]
            orig_rows = orig_rows[sel]
            res = simplex.LPResult(*(
                None if getattr(res, f.name) is None
                else np.asarray(getattr(res, f.name))[sel]
                for f in dataclasses.fields(simplex.LPResult)))
        W = t2.duals_w(res)                    # (B, q)

        # per-candidate cut data rows
        ystars = np.empty((solve_idx.size, q))
        if phase1:
            alphas = np.asarray(t2.duals_alpha(res))
            ystars[:, : q - 1] = W[:, : q - 1] + alphas[:, None] * \
                sol.eta[: q - 1]
            ystars[:, q - 1] = alphas
        else:
            YY = t2.primal_y(res)
            ystars[:, : q - 1] = W[:, : q - 1]
            ystars[:, q - 1] = np.sum(YY * W, axis=1)
        passed = res.obj > eps
        if pre_img:
            primgs = np.concatenate([
                t2.duals_u(res) * (1 if optdir == 1 else -1),
                W * (1 if sol.c_dir.value > 0 else -1)], axis=1)
            xs = t2.primal_x(res)

        progressed = False
        round_cuts = round_final = 0
        for i in range(solve_idx.size):
            idx = int(solve_idx[i])
            if not P.used[idx]:
                continue   # removed by an earlier cut this round
            if passed[i]:
                primg = primgs[i] if pre_img else None
                if pair.add_vertex(ystars[i], ideal=False, primg=primg):
                    stats.cuts += 1
                    round_cuts += 1
                    progressed = True
                    if verbose >= 3:   # bslv_algs.c:888
                        print("add dual vertex")
                    if t2.state_available():
                        # parent tableau kept on device: record only
                        # the row index (gather-based warm start)
                        warm.record_state_row(pair.last_added,
                                              orig_rows[i],
                                              t2.last_solve_no)
                    else:
                        warm.record(pair.last_added, res.basis[i],
                                    res.at_upper[i])
            else:
                P.sltn[idx] = True
                round_final += 1
                progressed = True
                if pre_img and not phase1:
                    P.primg[idx, : t2.n] = xs[i]
        if verbose >= 2:
            name = "phase1_primal" if phase1 else "phase2_primal"
            print(f"[{name}] round {stats.rounds}: {cand.size} LPs, "
                  f"{round_cuts} cuts, {round_final} finalized, "
                  f"{stats.lps} LPs total")
        if not progressed:
            # cannot happen for live vertices (a vertex always violates
            # its own eps-passing cut); defensive stall guard.  Deferred
            # candidates are excluded: marking an unverified vertex as a
            # solution vertex would silently corrupt the output.
            unverified = [v for v in cand if v in deferrals]
            if unverified:
                raise RuntimeError(
                    f"{what}: no progress while {len(unverified)} "
                    f"candidate(s) have unresolved LPs "
                    f"(e.g. vertex {unverified[0]})")
            P.sltn[cand] = True
            break


def phase2_init(sol: SolutionContext) -> None:
    """Bounded shortcut (-b): R <- Z, H <- Y, skipping phases 0 and 1
    (reference bslv_algs.c:943-956)."""
    sol.R = sol.Z.copy()
    sol.H = sol.Y.copy()


def phase2_primal(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
                  opt: Options, stats: Stats) -> PolytopePair | None:
    """Inhomogeneous primal Benson on the upper image
    (reference bslv_algs.c:958-1161, computation part; output epilogue
    lives in the driver)."""
    q = sol.q
    pre = opt.solution
    t2 = _template(vlp, P_eff, sol.R, sol.eta, INHOMOGENEOUS, opt,
                   opt.lp_method_phase2)
    r = sol.r
    pair = PolytopePair(q, eps=POLY_EPS,
                        dual_v2h=make_lower_to_upper_v2h(sol.c),
                        dim_primg_primal=vlp.n if pre else 0,
                        dim_primg_dual=vlp.m + q if pre else 0)
    # PART 1: seed with one LP per column of R (bslv_algs.c:976-1018)
    ub = np.full((r, r), np.inf)
    np.fill_diagonal(ub, 0.0)
    res = t2.solve(ub)
    stats.lps += r
    for j in range(r):
        if res.status[j] != simplex.OPTIMAL:
            sol.status = (SolStatus.INFEASIBLE
                          if res.status[j] == simplex.INFEASIBLE
                          else SolStatus.UNBOUNDED)
            return None
        val = np.empty(q)
        val[:] = sol.R[:, j]
        val[q - 1] = res.obj[j]
        primg = None
        if pre:
            primg = np.concatenate([
                t2.duals_u(res)[j] * (1 if vlp.optdir == 1 else -1),
                sol.R[:, j] * (1 if sol.c_dir.value > 0 else -1)])
        pair.add_vertex(val, ideal=False, primg=primg)
    if not pair.initial_approx():
        raise RuntimeError("phase2_primal: initial approximation failed")

    # PART 2: batched main loop
    _benson_primal_loop(pair, t2, sol, opt.eps_benson_phase2, stats,
                        phase1=False, pre_img=bool(pre), optdir=vlp.optdir,
                        warm_mode=opt.warm_mode, verbose=opt.message_level)

    # pre-images for the directions of the upper image: re-template
    # P2-homogeneous with the eta row disabled (bslv_algs.c:1084-1114)
    if pre:
        _direction_preimages(sol, vlp, P_eff, pair.primal, stats, opt)
        # directions of the lower image get zero pre-images
        # (bslv_algs.c:1117-1123)
        D = pair.dual
        for i in D.live():
            if D.ideal[i]:
                D.primg[i, : D.dim_primg] = 0.0
    return pair


def _direction_preimages(sol: SolutionContext, vlp: VLPProblem,
                         P_eff: np.ndarray, poly, stats: Stats,
                         opt: Options) -> None:
    """Solve P2-hom (eta row freed) for every ideal vertex of the upper
    image and store x as its pre-image."""
    t2h = P2Template(vlp, P_eff, sol.Z, sol.eta, HOMOGENEOUS,
                     dtype=opt.lp_dtype, device=opt.device)
    idxs = [int(i) for i in poly.live() if poly.ideal[i]]
    if not idxs:
        return
    dirs = poly.data[idxs]                 # (B, q)
    res = t2h.solve(dirs @ sol.Z, eta_ub=np.inf)
    stats.lps += len(idxs)
    _check_all_optimal(res, "direction pre-images")
    X = t2h.primal_x(res)
    for k, i in enumerate(idxs):
        poly.primg[i, : vlp.n] = X[k]


def phase1_dual(*args, **kwargs):
    raise NotImplementedError(
        "the dual Benson algorithm (-A dual) is not ported to "
        "bensolve_tpu_torch yet (ROADMAP Queue 1, dual algorithm)")


def phase2_dual(*args, **kwargs):
    raise NotImplementedError(
        "the dual Benson algorithm (-a dual) is not ported to "
        "bensolve_tpu_torch yet (ROADMAP Queue 1, dual algorithm)")
