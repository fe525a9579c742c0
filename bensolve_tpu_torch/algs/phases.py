"""The Benson algorithm phases, batched.

The port of ``bensolve_tpu/algs/phases.py``.  Reference: bslv_algs.c
phase0 (:673), phase1_primal (:811), phase2_init (:943), phase2_primal
(:958), phase1_dual (:1248), phase2_dual (:1381).

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

from bensolve_tpu_torch import spans
from bensolve_tpu_torch.algs.solution import (SolStatus, SolutionContext,
                                              cone_vertenum)
from bensolve_tpu_torch.algs.templates import (HOMOGENEOUS, INHOMOGENEOUS,
                                               P1Template, P2Template)
from bensolve_tpu_torch.io import checkpoint
from bensolve_tpu_torch.lp import simplex
from bensolve_tpu_torch.parallel import distributed as dist
from bensolve_tpu_torch.poly.polytope import (POLY_EPS, PolytopePair,
                                              make_lower_to_upper_v2h,
                                              make_upper_to_lower_v2h)
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
    loose_deferred: int = 0  # loose results discarded because a clean
    #   cut removed their vertex within the same round (applied last)
    loose_cuts: int = 0      # cuts/finalizations accepted from
    #   loose-quality LPs (a run states how many cuts rode ~1e-2-error
    #   duals)


class _FacetWarm:
    """Per-candidate warm starts (the batched analogue of GLPK's
    carried basis, bslv_lp.c:31): map each frontier candidate to the
    final basis of the LP whose cut created it, to its row in the
    parent solve's kept device tableau, or (the IPM route) to its
    interior solution."""

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

    def record_interior(self, facet, x, s, row_dual) -> None:
        """IPM-route analogue of record(): the parent LP has no basis,
        so the carried state is its interior solution (x, s, row_dual),
        consumed by the IPM's shifted warm start (lp/ipm.py
        _ipm_warm_init).  Stored in float32: a warm START needs no f64
        digits.  At most 768 entries; the 256 oldest go first."""
        if self.enabled and facet is not None:
            self.by_facet[int(facet)] = (self.serial, "interior",
                                         np.asarray(x, np.float32),
                                         np.asarray(s, np.float32),
                                         np.asarray(row_dual, np.float32))
            self.serial += 1
            if len(self.by_facet) > 768:
                drop = sorted(self.by_facet.items(),
                              key=lambda kv: kv[1][0])[:256]
                for k, _ in drop:
                    del self.by_facet[k]

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
        ("state_rows", rows, solve_no), or ("interior", X, S, RD) stacks
        for the IPM route; None when nothing is known yet or the
        recorded kinds are mixed."""
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
        orig = rows
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
        if kinds != {"basis"} and kinds != {"interior"}:
            return None
        if kinds == {"interior"}:
            # candidates WITHOUT a recorded parent start COLD (a NaN row
            # -> per-row cold init in _ipm_warm_init): a borrowed foreign
            # interior point measurably hurts convergence
            return ("interior",) + tuple(
                np.stack([r[2 + k] if r is not None
                          else np.full_like(fill[2 + k], np.nan)
                          for r in orig])
                for k in range(3))
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


def _lp_kw(opt: Options, method) -> dict:
    """Template keywords from the options: every LP of a template runs
    at ``opt.lp_dtype`` on ``opt.device``, or over the mesh of
    ``opt.mesh_axes``."""
    return dict(dtype=opt.lp_dtype, lp_verbose=opt.lp_message_level,
                lp_method=method, max_batch=opt.lp_max_batch,
                ipm_min=opt.lp_ipm_min, device=opt.device,
                mesh=opt.build_mesh())


@spans.traced("phase", phase="phase0")
def phase0(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
           opt: Options, stats: Stats) -> None:
    """Compute eta in int(D* + K) with eta'c == 1 via a short serial
    sequence of P2-homogeneous probes (reference bslv_algs.c:673-800).
    Sets sol.eta, or sol.status to UNBOUNDED / NOVERTEX."""
    q = sol.q
    m = vlp.m
    t2 = P2Template(vlp, P_eff, sol.Z, np.zeros(q), HOMOGENEOUS,
                    **_lp_kw(opt, opt.lp_method_phase0))

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


@spans.traced("phase", phase="phase1_primal")
def phase1_primal(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
                  opt: Options, stats: Stats,
                  resume_pair: PolytopePair | None = None) -> PolytopePair:
    """Outer-approximate the recession cone of the upper image
    (homogeneous Benson, reference bslv_algs.c:811-933).
    ``resume_pair``: continue the main loop from a checkpointed outer
    approximation instead of re-seeding."""
    q = sol.q
    t2 = P2Template(vlp, P_eff, sol.Z, sol.eta, HOMOGENEOUS,
                    **_lp_kw(opt, opt.lp_method_phase1))
    p = sol.p
    if resume_pair is not None:
        pair = resume_pair
    else:
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
            raise RuntimeError(
                "phase1_primal: initial approximation failed")

    # PART 2: batched main loop
    _benson_primal_loop(pair, t2, sol, opt.eps_benson_phase1, stats,
                        phase1=True, distributed=opt.distributed,
                        warm_mode=opt.warm_mode,
                        verbose=opt.message_level,
                        on_round=_checkpoint_cb(opt, sol, "phase1_primal",
                                                "lower2upper"))

    # PART 3: R and H
    _extract_R_H(sol, pair.dual, opt, stats)
    return pair


def _benson_primal_loop(pair: PolytopePair, t2: P2Template,
                        sol: SolutionContext, eps: float, stats: Stats,
                        *, phase1: bool, pre_img: bool = False,
                        optdir: int = 1, on_round=None,
                        distributed: bool = False,
                        warm_mode: str = "auto",
                        verbose: int = 0) -> None:
    """Shared main loop of the primal phases: per round, solve P2(v) for
    every unprocessed non-ideal vertex v of the outer approximation and
    either cut (obj > eps) or finalize the vertex.

    ``distributed``: shard the round's LP batch across processes
    (parallel/distributed.py), all-gather the cuts, and apply them in
    canonical (lexicographic) order so every process's replicated
    polytope stays bit-identical.

    ``warm_mode``: "per_candidate" warm-starts every LP from its parent
    basis (_FacetWarm), "shared" keeps only the template's carried
    basis, "auto" picks per-candidate unless the batch routes to the
    per-LP kernel (which broadcasts ONE starting tableau) or runs
    distributed (remote bases are not gathered).

    ``on_round``: called as on_round(pair, stats) after every round
    that made progress (the checkpoint hook)."""
    P = pair.primal
    q = sol.q
    ZR = sol.Z if phase1 else sol.R
    warm = _FacetWarm(
        warm_mode == "per_candidate"
        or (warm_mode == "auto" and not distributed
            and not t2.prefers_shared_warm()))
    deferrals: dict[int, int] = {}
    what = "phase1_primal loop" if phase1 else "phase2_primal loop"
    rnd = None   # the round's span while spans are recorded
    while True:
        spans.end(rnd)
        frontier = P.frontier()
        if frontier.size == 0:
            break
        ideals = frontier[P.ideal[frontier]]
        P.sltn[ideals] = True   # directions are never processed
        cand = frontier[~P.ideal[frontier]]
        if cand.size == 0:
            continue
        stats.rounds += 1
        if spans.ON:
            rnd = spans.begin("round", round=stats.rounds,
                              candidates=int(cand.size))
        solve_idx = cand[dist.shard_indices(cand.size)] if distributed \
            else cand
        if verbose >= 3:
            for _ in range(cand.size):   # bslv_algs.c:877
                print("process primal vertex - solve lp")
        V = P.data[solve_idx]                  # (B_local, q)
        res = t2.solve(V @ ZR,                 # ub_j = ZR_j . v
                       start_basis=warm.lookup(P, solve_idx))
        stats.lps += cand.size
        stats.pivots += int(res.iters.sum())
        # row index of each surviving result in the SOLVE batch — the
        # kept-state warm chain records these, and the deferral filter
        # below must keep the mapping aligned
        orig_rows = np.arange(solve_idx.size)
        if not distributed:
            # a candidate whose LP did not resolve is DEFERRED: it stays
            # on the frontier while this round's other cuts reshape the
            # polytope, and is retried (bounded) in later rounds.  No
            # progress at all (every LP failed, or a vertex keeps
            # failing) raises.
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
        # LOOSE-quality results (a budget-exhausted f32 IPM accepted at up
        # to 250x the dtype tolerance) are applied LAST within the round,
        # so every clean cut first gets the chance to remove the loose
        # vertex; a loose result whose vertex survives is accepted and
        # COUNTED (stats.loose_cuts), one that died is discarded
        # (stats.loose_deferred)
        loose_mask = (np.zeros(solve_idx.size, bool)
                      if res.quality is None else
                      np.asarray(res.quality) == 2)
        W = t2.duals_w(res)                    # (B_local, q)

        # per-candidate cut data rows
        B_local = solve_idx.size
        ystars = np.empty((B_local, q))
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
        else:
            primgs = np.zeros((B_local, 0))
            xs = np.zeros((B_local, 0))

        if distributed:
            rows = np.concatenate(
                [solve_idx[:, None].astype(float), passed[:, None],
                 res.status[:, None].astype(float), ystars, primgs, xs],
                axis=1)
            rows = dist.allgather_rows(rows, total=cand.size)
            # every process sees every process's LP statuses, so a
            # failure raises on ALL of them together instead of
            # deadlocking the peers in the next collective
            bad = np.flatnonzero(rows[:, 2] != simplex.OPTIMAL)
            if bad.size:
                raise RuntimeError(
                    f"{what}: LP for vertex {int(rows[bad[0], 0])} "
                    f"returned status {int(rows[bad[0], 2])} "
                    f"(expected optimal)")
            idx_all = rows[:, 0].astype(int)
            passed_all = rows[:, 1] > 0.5
            ystars = rows[:, 3:3 + q]
            primgs = rows[:, 3 + q:3 + q + primgs.shape[1]]
            xs = rows[:, 3 + q + primgs.shape[1]:]
            # finalized vertices first (order-free), then cuts in
            # canonical order
            order = np.concatenate([
                np.flatnonzero(~passed_all),
                np.flatnonzero(passed_all)[
                    dist.canonical_order(ystars[passed_all])]])
        else:
            idx_all = solve_idx
            passed_all = passed
            # clean results first, loose ones last (see loose_mask)
            order = np.concatenate([np.flatnonzero(~loose_mask),
                                    np.flatnonzero(loose_mask)])

        progressed = False
        round_cuts = round_final = 0
        for i in order:
            idx = int(idx_all[i])
            is_loose = not distributed and bool(loose_mask[i])
            if not P.used[idx]:
                if is_loose:
                    stats.loose_deferred += 1   # removed by a clean cut
                continue   # removed by an earlier cut this round
            if is_loose:
                stats.loose_cuts += 1
            if passed_all[i]:
                primg = primgs[i] if pre_img else None
                if pair.add_vertex(ystars[i], ideal=False, primg=primg):
                    stats.cuts += 1
                    round_cuts += 1
                    progressed = True
                    if verbose >= 3:   # bslv_algs.c:888
                        print("add dual vertex")
                    if distributed:
                        pass   # remote bases are not gathered
                    elif t2.state_available():
                        # parent tableau kept on device: record only
                        # the row index (gather-based warm start)
                        warm.record_state_row(pair.last_added,
                                              orig_rows[i],
                                              t2.last_solve_no)
                    elif res.basis is not None and not is_loose:
                        warm.record(pair.last_added, res.basis[i],
                                    res.at_upper[i])
                    elif (res.basis is None and not is_loose
                          and (res.quality is None
                               or res.quality[i] == 0)):
                        # IPM route: carry the parent's CLEAN interior
                        # solution (loose parents would poison children)
                        warm.record_interior(pair.last_added, res.x[i],
                                             res.s[i], res.row_dual[i])
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
        if on_round is not None:
            on_round(pair, stats)
    spans.end(rnd)


def phase2_init(sol: SolutionContext) -> None:
    """Bounded shortcut (-b): R <- Z, H <- Y, skipping phases 0 and 1
    (reference bslv_algs.c:943-956)."""
    sol.R = sol.Z.copy()
    sol.H = sol.Y.copy()


def _checkpoint_cb(opt: Options, sol: SolutionContext, phase: str,
                   v2h_kind: str):
    """Build the per-round snapshot callback (None when disabled)."""
    if not opt.checkpoint_path:
        return None
    counter = {"n": 0}

    def cb(pair, stats):
        counter["n"] += 1
        if counter["n"] % max(opt.checkpoint_every, 1) == 0:
            checkpoint.save_checkpoint(
                opt.checkpoint_path, sol=sol, pair=pair, phase=phase,
                v2h_kind=v2h_kind, round_no=stats.rounds, lps=stats.lps)

    return cb


@spans.traced("phase", phase="phase2_primal")
def phase2_primal(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
                  opt: Options, stats: Stats,
                  resume_pair: PolytopePair | None = None
                  ) -> PolytopePair | None:
    """Inhomogeneous primal Benson on the upper image
    (reference bslv_algs.c:958-1161, computation part; the output
    epilogue is algs/driver.py's).  ``resume_pair``: continue the main
    loop from a checkpointed outer approximation instead of re-seeding."""
    q = sol.q
    pre = opt.solution
    t2 = P2Template(vlp, P_eff, sol.R, sol.eta, INHOMOGENEOUS,
                    **_lp_kw(opt, opt.lp_method_phase2))
    r = sol.r
    if resume_pair is not None:
        pair = resume_pair
    else:
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
                        distributed=opt.distributed,
                        warm_mode=opt.warm_mode, verbose=opt.message_level,
                        on_round=_checkpoint_cb(opt, sol, "phase2_primal",
                                                "lower2upper"))

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


@spans.traced("phase", phase="direction_preimages")
def _direction_preimages(sol: SolutionContext, vlp: VLPProblem,
                         P_eff: np.ndarray, poly, stats: Stats,
                         opt: Options) -> None:
    """Solve P2-hom (eta row freed) for every ideal vertex of the upper
    image and store x as its pre-image."""
    t2h = P2Template(vlp, P_eff, sol.Z, sol.eta, HOMOGENEOUS,
                     dtype=opt.lp_dtype, device=opt.device,
                     mesh=opt.build_mesh())
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


@spans.traced("phase", phase="phase1_dual")
def phase1_dual(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
                opt: Options, stats: Stats,
                resume_pair: PolytopePair | None = None) -> PolytopePair:
    """Homogeneous dual Benson on the lower image (reference
    bslv_algs.c:1248-1371).  The pair's primal polytope is the LOWER
    image; upper-image points arrive as dual vertices."""
    t1 = P1Template(vlp, P_eff, sol.eta, HOMOGENEOUS,
                    **_lp_kw(opt, opt.lp_method_phase1))
    if resume_pair is not None:
        pair = resume_pair
    else:
        pair = PolytopePair(sol.q, eps=POLY_EPS,
                            dual_v2h=make_upper_to_lower_v2h(sol.c))
        # PART 1: weighted LP at the mean of Z plus Y columns as
        # directions
        w0 = sol.Z.mean(axis=1)
        res = t1.solve(w0[None])
        stats.lps += 1
        _check_all_optimal(res, "phase1_dual init")
        pair.add_vertex(t1.primal_y(res)[0], ideal=False)
        for j in range(sol.o):
            pair.add_vertex(sol.Y[:, j], ideal=True)
        if not pair.initial_approx():
            raise RuntimeError("phase1_dual: initial approximation failed")

    _benson_dual_loop(pair, t1, sol, opt.eps_benson_phase1, stats,
                      distributed=opt.distributed, warm_mode=opt.warm_mode,
                      verbose=opt.message_level,
                      on_round=_checkpoint_cb(opt, sol, "phase1_dual",
                                              "upper2lower"))
    _extract_R_H(sol, pair.primal, opt, stats)
    return pair


def _w_of_ystar(V: np.ndarray, c: np.ndarray) -> np.ndarray:
    """w(y*) = (y*_1..y*_{q-1}, 1 - sum_i c_i y*_i) (bslv_algs.c:1313)."""
    B, q = V.shape
    W = np.empty((B, q))
    W[:, : q - 1] = V[:, : q - 1]
    W[:, q - 1] = 1.0 - V[:, : q - 1] @ c[: q - 1]
    return W


def _benson_dual_loop(pair: PolytopePair, t1: P1Template,
                      sol: SolutionContext, eps: float, stats: Stats,
                      *, pre_img: bool = False, optdir: int = 1,
                      allow_unbounded: bool = False,
                      on_round=None, warm_mode: str = "auto",
                      distributed: bool = False,
                      verbose: int = 0) -> SolStatus | None:
    """Shared main loop of the dual phases: per round, solve P1(w(y*))
    for every unprocessed vertex y* of the lower-image approximation and
    either add the point P1 found (obj below y*_q - eps) or finalize
    the vertex.  ``warm_mode``, ``distributed`` (here the gathered rows
    are the lower-image points) and ``on_round`` as in
    _benson_primal_loop."""
    P = pair.primal
    q = sol.q
    m = t1.m
    warm = _FacetWarm(
        warm_mode == "per_candidate"
        or (warm_mode == "auto" and not distributed
            and not t1.prefers_shared_warm()))
    rnd = None   # the round's span while spans are recorded
    while True:
        spans.end(rnd)
        frontier = P.frontier()
        if frontier.size == 0:
            break
        ideals = frontier[P.ideal[frontier]]
        P.sltn[ideals] = True
        cand = frontier[~P.ideal[frontier]]
        if cand.size == 0:
            continue
        stats.rounds += 1
        if spans.ON:
            rnd = spans.begin("round", round=stats.rounds,
                              candidates=int(cand.size))
        solve_idx = cand[dist.shard_indices(cand.size)] if distributed \
            else cand
        if verbose >= 3:
            for _ in range(cand.size):   # bslv_algs.c:1319
                print("process dual vertex - solve lp")
        V = P.data[solve_idx].copy()
        W = _w_of_ystar(V, sol.c)
        res = t1.solve(W, start_basis=warm.lookup(P, solve_idx))
        stats.lps += cand.size
        stats.pivots += int(res.iters.sum())
        unbnd = res.status == simplex.UNBOUNDED
        if allow_unbounded and not distributed and unbnd.any():
            return SolStatus.UNBOUNDED
        if not distributed:
            _check_all_optimal(res, "dual Benson loop")
        Y = t1.primal_y(res)
        B_local = solve_idx.size
        passed = V[:, q - 1] - res.obj > eps
        if pre_img:
            xs = t1.primal_x(res)
            uws = np.concatenate([
                t1.duals_u(res) * (1 if optdir == 1 else -1),
                W * (1 if sol.c_dir.value > 0 else -1)], axis=1)
        else:
            xs = np.zeros((B_local, 0))
            uws = np.zeros((B_local, 0))

        if distributed:
            rows = np.concatenate(
                [solve_idx[:, None].astype(float), passed[:, None],
                 unbnd[:, None].astype(float),
                 res.status[:, None].astype(float), Y, xs, uws], axis=1)
            rows = dist.allgather_rows(rows, total=cand.size)
            if allow_unbounded and (rows[:, 2] > 0.5).any():
                return SolStatus.UNBOUNDED
            # gathered status check: one process's LP failure must raise
            # on every process, not strand the peers in the next
            # collective
            bad = np.flatnonzero(rows[:, 3] != simplex.OPTIMAL)
            if bad.size:
                raise RuntimeError(
                    f"dual Benson loop: LP for vertex {int(rows[bad[0], 0])} "
                    f"returned status {int(rows[bad[0], 3])} "
                    f"(expected optimal)")
            idx_all = rows[:, 0].astype(int)
            passed_all = rows[:, 1] > 0.5
            Y = rows[:, 4:4 + q]
            xs = rows[:, 4 + q:4 + q + xs.shape[1]]
            uws = rows[:, 4 + q + xs.shape[1]:]
            order = np.concatenate([
                np.flatnonzero(~passed_all),
                np.flatnonzero(passed_all)[
                    dist.canonical_order(Y[passed_all])]])
        else:
            idx_all = solve_idx
            passed_all = passed
            order = np.arange(idx_all.size)

        progressed = False
        round_cuts = round_final = 0
        for i in order:
            idx = int(idx_all[i])
            if not P.used[idx]:
                continue   # removed by an earlier cut this round
            if passed_all[i]:
                primg = xs[i] if pre_img else None
                if pair.add_vertex(Y[i], ideal=False, primg=primg):
                    stats.cuts += 1
                    round_cuts += 1
                    progressed = True
                    if verbose >= 3:   # bslv_algs.c:1327
                        print("add primal vertex")
                    if distributed:
                        pass   # remote bases are not gathered
                    elif res.basis is not None:
                        warm.record(pair.last_added, res.basis[i],
                                    res.at_upper[i])
                    elif res.quality is None or res.quality[i] == 0:
                        # IPM route: carry the parent's CLEAN interior
                        # solution
                        warm.record_interior(pair.last_added, res.x[i],
                                             res.s[i], res.row_dual[i])
            else:
                P.sltn[idx] = True
                round_final += 1
                progressed = True
                if pre_img:
                    P.primg[idx, : m + q] = uws[i]
        if verbose >= 2:
            print(f"[benson_dual] round {stats.rounds}: {cand.size} LPs, "
                  f"{round_cuts} cuts, {round_final} finalized, "
                  f"{stats.lps} LPs total")
        if not progressed:
            P.sltn[cand] = True
            break
        if on_round is not None:
            on_round(pair, stats)
    spans.end(rnd)
    return None


@spans.traced("phase", phase="phase2_dual")
def phase2_dual(sol: SolutionContext, vlp: VLPProblem, P_eff: np.ndarray,
                opt: Options, stats: Stats,
                resume_pair: PolytopePair | None = None
                ) -> PolytopePair | None:
    """Inhomogeneous dual Benson (reference bslv_algs.c:1381-1592,
    computation part; output epilogue lives in the driver)."""
    q = sol.q
    pre = opt.solution
    t1 = P1Template(vlp, P_eff, sol.eta, INHOMOGENEOUS,
                    **_lp_kw(opt, opt.lp_method_phase2))
    if resume_pair is not None:
        pair = resume_pair
    else:
        pair = PolytopePair(q, eps=POLY_EPS,
                            dual_v2h=make_upper_to_lower_v2h(sol.c),
                            dim_primg_primal=vlp.m + q if pre else 0,
                            dim_primg_dual=vlp.n if pre else 0)
        # PART 1: weighted LP at the mean of R plus H columns as
        # directions
        w0 = sol.R.mean(axis=1)
        res = t1.solve(w0[None])
        stats.lps += 1
        if res.status[0] != simplex.OPTIMAL:
            sol.status = (SolStatus.INFEASIBLE
                          if res.status[0] == simplex.INFEASIBLE
                          else SolStatus.UNBOUNDED)
            return None
        primg = t1.primal_x(res)[0] if pre else None
        pair.add_vertex(t1.primal_y(res)[0], ideal=False, primg=primg)
        for j in range(sol.h):
            pair.add_vertex(sol.H[:, j], ideal=True)
        if not pair.initial_approx():
            raise RuntimeError("phase2_dual: initial approximation failed")

    status = _benson_dual_loop(pair, t1, sol, opt.eps_benson_phase2, stats,
                               pre_img=bool(pre), optdir=vlp.optdir,
                               allow_unbounded=True,
                               distributed=opt.distributed,
                               warm_mode=opt.warm_mode,
                               verbose=opt.message_level,
                               on_round=_checkpoint_cb(opt, sol,
                                                       "phase2_dual",
                                                       "upper2lower"))
    if status is not None:
        sol.status = status
        return None

    if pre:
        # facet pre-images: ideal DUAL vertices are upper-image
        # directions (bslv_algs.c:1514-1543; the reference indexes Z
        # with stride r instead of p at :1535, the JAX package and this
        # port index Z correctly)
        _direction_preimages(sol, vlp, P_eff, pair.dual, stats, opt)
        for i in pair.primal.live():
            if pair.primal.ideal[i]:
                pair.primal.primg[i, : pair.primal.dim_primg] = 0.0
    return pair
