"""Benson-oracle LP templates P2 and P1 as batched dense LPs.

The port of ``bensolve_tpu/algs/templates.py``.  The reference
re-parameterizes ONE GLPK instance in place per iteration (init_P2
bslv_algs.c:562-664, init_P1 bslv_algs.c:1186-1238).  Here each template
is an immutable dense matrix plus base bounds; per-candidate data (the
upper row bounds Z'v for P2, the objective w for P1) comes in as a
batch, and the whole frontier is solved in one device call.

Template P2(v) (homogeneous/inhomogeneous), variables (x, y, z):

    min z   s.t.  row bounds  on A x                  (m rows)
                  -P x + y  == 0                      (q rows)
                  ZR'y - (ZR'c) z <= ZR'v             (p rows, ZR'c = 1)
                  eta'y <= 1 (hom) / free (inhom)     (1 row)

Template P1(w), variables (x, y):

    min w'y s.t.  row bounds on A x                   (m rows)
                  -P x + y == 0                       (q rows)
                  eta'y <= 1 (hom) / free (inhom)     (1 row)
"""

from __future__ import annotations

import os

import numpy as np

from bensolve_tpu_torch.lp import (REVISED_RATIO, _kernel_eligible, simplex,
                                   solve_batch_auto)
from bensolve_tpu_torch.lp.simplex import LPResult
from bensolve_tpu_torch.vlp.problem import VLPProblem

HOMOGENEOUS = True
INHOMOGENEOUS = False


class _TemplateBase:
    # True (P2) when per-candidate re-solves change only row BOUNDS, so
    # a parent optimal basis stays dual feasible (the dual-warm and
    # kept-state routes)
    _bound_change_resolve = False

    def __init__(self, vlp: VLPProblem, P_eff: np.ndarray, homogeneous: bool,
                 dtype=np.float64, lp_verbose: int = 0,
                 lp_method: str = "auto", max_batch: int | None = None,
                 ipm_min: int = 0, device: str = "cuda"):
        self.dtype = np.dtype(dtype).type
        # Options.lp_ipm_min: M+N threshold above which the router takes
        # the interior-point method (0 = off; BENSOLVE_IPM_MIN also
        # enables it)
        self.ipm_min = ipm_min
        # Options.lp_max_batch: hard cap on LPs per device round; the
        # backends' own memory-budget chunking still applies below it
        self.max_batch = max_batch
        # torch device of every LP tensor (Options.device)
        self.device = device
        # -M / lp_message_level analogue (bslv_lp.c:200-215): >= 2 emits
        # one summary line per batched solve on stdout
        self.lp_verbose = lp_verbose
        # -k/-L/-l analogue (bslv_lp.c:153-217): "dual_simplex" /
        # "dual_primal_simplex" route through the batched dual simplex
        # (with the GLP_DUALP-style primal retry); "primal_simplex" and
        # "auto" use the router
        self.lp_method = getattr(lp_method, "value", lp_method)
        self.vlp = vlp
        self.m, self.n, self.q = vlp.m, vlp.n, vlp.q
        self.P_eff = P_eff
        rows = vlp.rows.homogeneous() if homogeneous else vlp.rows
        cols = vlp.cols.homogeneous() if homogeneous else vlp.cols
        self.row_lb_vlp, self.row_ub_vlp = rows.lb, rows.ub
        self.col_lb_vlp, self.col_ub_vlp = cols.lb, cols.ub
        self.homogeneous = homogeneous
        # shared warm-start basis carried across Benson rounds
        self._warm = None

    def _use_dual_warm(self, warm) -> bool:
        """True when a warm re-solve should route through the DUAL
        simplex: this template's per-candidate data enters as row
        bounds (P2), so a parent optimal basis stays dual feasible.
        Gated to tableau-sized shapes; BENSOLVE_NO_DUAL_WARM=1 opts out
        for A/B measurement."""
        if warm is None:
            return False
        if not getattr(self, "_bound_change_resolve", False):
            return False
        if os.environ.get("BENSOLVE_NO_DUAL_WARM") == "1":
            return False
        M, N = self.A_lp.shape
        return N < REVISED_RATIO * M

    @staticmethod
    def _is_interior_warm(w) -> bool:
        return isinstance(w, tuple) and len(w) == 4 and w[0] == "interior"

    @staticmethod
    def _is_state_rows(w) -> bool:
        return isinstance(w, tuple) and len(w) == 3 and w[0] == "state_rows"

    # device bytes allowed for a kept warm-chain tableau
    STATE_KEEP_BYTES = int(2e9)

    def state_available(self) -> bool:
        """True when the LAST _run kept its final tableau on device, so
        the Benson loop should record per-candidate STATE ROWS
        (_FacetWarm.record_state_row) instead of basis copies."""
        return (getattr(self, "_kept_state", None) is not None
                and getattr(self, "_kept_solve_no", -1)
                == getattr(self, "last_solve_no", 0))

    def _run(self, A_lp, obj, row_lb, row_ub, col_lb, col_ub,
             start_basis=None, _chunked=False) -> LPResult:
        B = np.atleast_2d(obj).shape[0]
        if not _chunked:
            self.last_solve_no = getattr(self, "last_solve_no", 0) + 1
        if self.max_batch and B > self.max_batch:
            # snapshot the warm start ONCE so every chunk starts from the
            # same pre-round basis (lp_max_batch stays result-neutral)
            warm0 = start_basis if start_basis is not None else self._warm

            def _chunk_warm(sl):
                if warm0 is None:
                    return None
                if self._is_interior_warm(warm0):
                    return ("interior", warm0[1][sl], warm0[2][sl],
                            warm0[3][sl])
                if self._is_state_rows(warm0):
                    return ("state_rows", np.asarray(warm0[1])[sl],
                            warm0[2])
                return simplex._slice_warm(warm0, sl)

            parts = []
            for s in range(0, B, self.max_batch):
                sl = slice(s, min(s + self.max_batch, B))
                parts.append(self._run(
                    A_lp, np.atleast_2d(obj)[sl], row_lb[sl], row_ub[sl],
                    col_lb[sl], col_ub[sl], start_basis=_chunk_warm(sl),
                    _chunked=True))
            # chunk results do not share one kept state; drop any
            self._kept_state = None
            return simplex.concat_results(parts)
        warm = start_basis if start_basis is not None else self._warm
        # the carried clean interior point of the last IPM solve starts
        # every LP of a batch without per-candidate parents (the JAX
        # package's rule; at BASELINE config #4 it sends more LPs to
        # the host fallback than cold starts do, ROADMAP Queue 3 j)
        warm_interior = getattr(self, "_warm_interior", None)
        state_rows = None
        if self._is_interior_warm(warm):
            # per-candidate parent INTERIOR solutions (_FacetWarm
            # record_interior): consumed by the IPM's shifted warm
            # start, never by a simplex start_basis
            warm_interior = (warm[1], warm[2], warm[3])
            warm = None
        elif self._is_state_rows(warm):
            # per-candidate parent rows of the kept device tableau
            # (_FacetWarm.record_state_row) — a gather-based warm start
            # that skips both batched LUs (simplex.KeptState)
            ks = getattr(self, "_kept_state", None)
            if (ks is not None
                    and getattr(self, "_kept_solve_no", -1) == warm[2]):
                state_rows = (ks, np.asarray(warm[1], np.int64))
            warm = self._warm
        age_cap = (simplex.STATE_WARM_MAX_AGE
                   if np.dtype(self.dtype) == np.dtype(np.float64)
                   else simplex.STATE_WARM_MAX_AGE // 4)
        M0, N0 = A_lp.shape if not hasattr(A_lp, "M") else (A_lp.M, A_lp.N)
        keep = (not _chunked and self._bound_change_resolve
                and os.environ.get("BENSOLVE_NO_STATE_WARM") != "1"
                and max(B, 8) * simplex._bucket(M0)
                * (simplex._bucket(M0) + simplex._bucket(N0))
                * np.dtype(self.dtype).itemsize <= self.STATE_KEEP_BYTES)
        dual_route = (
            self.lp_method in ("dual_simplex", "dual_primal_simplex")
            or (self.lp_method == "auto"
                and self._use_dual_warm(
                    warm if warm is not None else state_rows)))
        if dual_route:
            from bensolve_tpu_torch.lp.dual_simplex import solve_batch_dual

            out = solve_batch_dual(A_lp, obj, row_lb, row_ub, col_lb,
                                   col_ub, start_basis=warm,
                                   dtype=self.dtype,
                                   start_state=state_rows,
                                   keep_state=keep, device=self.device)
            if keep:
                res, kept = out
                if kept is not None and kept.age <= age_cap:
                    self._kept_state = kept
                    self._kept_solve_no = self.last_solve_no
                else:
                    # drift cap reached (or retry invalidated the
                    # state): next round's basis warm refactorizes and
                    # restarts the chain
                    self._kept_state = None
            else:
                res = out
        else:
            res = solve_batch_auto(A_lp, obj, row_lb, row_ub, col_lb,
                                   col_ub, start_basis=warm,
                                   dtype=self.dtype, ipm_min=self.ipm_min,
                                   verbose=self.lp_verbose,
                                   device=self.device,
                                   warm_interior=warm_interior)
            self._kept_state = None
        ok = np.flatnonzero(res.status == simplex.OPTIMAL)
        if ok.size and res.basis is not None:
            # carry basis AND nonbasic bound pattern into the next round
            self._warm = (res.basis[int(ok[0])], res.at_upper[int(ok[0])])
        elif ok.size:
            # IPM result: carry a CLEAN interior solution into the next
            # round's warm start (the IPM analogue of the carried basis)
            clean = (ok if res.quality is None
                     else ok[res.quality[ok] == 0])
            if clean.size:
                i = int(clean[0])
                self._warm_interior = (res.x[i].copy(), res.s[i].copy(),
                                       res.row_dual[i].copy())
        if self.lp_verbose >= 2:
            counts = dict(zip(*np.unique(res.status, return_counts=True)))
            print(f"lp_solve: batch={res.status.size} "
                  f"statuses={{{', '.join(f'{k}:{v}' for k, v in counts.items())}}} "
                  f"pivots max={int(res.iters.max())} "
                  f"mean={float(res.iters.mean()):.1f} "
                  f"warm={'yes' if warm is not None else 'no'}")
        return res

    def prefers_shared_warm(self) -> bool:
        """True when per-candidate (B, M) warm bases would knock the
        batch off its best backend: the per-LP kernel only takes a
        shared basis (it broadcasts ONE starting tableau).  When the
        dual-simplex warm re-solve route applies, per-candidate parent
        bases are strictly better, so shared mode is never preferred."""
        if self._use_dual_warm(warm=True):
            return False
        M, N = self.A_lp.shape
        return _kernel_eligible(M, N, {"dtype": self.dtype}, self.device)

    def _alloc_lp_matrix(self, extra_rows: int, extra_cols: int):
        """Preallocated LP matrix with the shared VLP blocks filled in:
        rows [A 0 ...], [-P I ...]; the caller fills the extra rows."""
        m, n, q = self.m, self.n, self.q
        A_lp = np.zeros((m + q + extra_rows, n + q + extra_cols))
        A_lp[:m, :n] = self.vlp.A
        A_lp[m:m + q, :n] = -self.P_eff
        A_lp[m:m + q, n:n + q] = np.eye(q)
        return A_lp

    # both templates' variables start with (x, y)
    def primal_x(self, res: LPResult) -> np.ndarray:
        return res.x[:, : self.n]

    def primal_y(self, res: LPResult) -> np.ndarray:
        return res.x[:, self.n:self.n + self.q]

    def duals_u(self, res: LPResult) -> np.ndarray:
        """Row duals of the m VLP rows — the dual pre-image u.

        In P1 this is where the reference reads COLUMN duals 1..m
        (bslv_algs.c:1497, lp_dual_solution_cols): those index reduced
        costs of x and are wrong whenever m != n.  Like the JAX package,
        the port reads the row duals, the multipliers of the A-rows."""
        return res.row_dual[:, : self.m]


class P2Template(_TemplateBase):
    # per-candidate data is ROW BOUNDS (ZR'v): a parent basis stays
    # dual feasible across re-solves -> dual-simplex warm route
    _bound_change_resolve = True

    def __init__(self, vlp, P_eff, ZR: np.ndarray, eta: np.ndarray,
                 homogeneous: bool, dtype=np.float64, lp_verbose: int = 0,
                 lp_method: str = "auto", max_batch: int | None = None,
                 ipm_min: int = 0, device: str = "cuda"):
        super().__init__(vlp, P_eff, homogeneous, dtype, lp_verbose,
                         lp_method, max_batch, ipm_min, device)
        m, n, q = self.m, self.n, self.q
        ZR = np.asarray(ZR, float)
        self.p = ZR.shape[1]
        self.ZR = ZR
        p = self.p
        A_lp = self._alloc_lp_matrix(p + 1, 1)   # (m+q+p+1, n+q+1)
        A_lp[m + q:m + q + p, n:n + q] = ZR.T
        A_lp[m + q:m + q + p, n + q] = -1.0      # the z column
        A_lp[m + q + p, n:n + q] = np.asarray(eta, float)
        self.A_lp = A_lp
        self.obj = np.zeros(n + q + 1)
        self.obj[n + q] = 1.0
        self.col_lb = np.concatenate(
            [self.col_lb_vlp, np.full(q + 1, -np.inf)])
        self.col_ub = np.concatenate(
            [self.col_ub_vlp, np.full(q + 1, np.inf)])

    def build_inputs(self, extra_ub: np.ndarray,
                     eta_ub: float | np.ndarray | None = None):
        """The per-candidate LP batch data (obj, row_lb, row_ub, col_lb,
        col_ub) without solving."""
        extra_ub = np.atleast_2d(np.asarray(extra_ub, float))
        B = extra_ub.shape[0]
        if eta_ub is None:
            eta_ub = 1.0 if self.homogeneous else np.inf
        eta_ub = np.broadcast_to(np.asarray(eta_ub, float), (B,))

        m, q, p = self.m, self.q, self.p
        row_lb = np.concatenate([
            np.broadcast_to(self.row_lb_vlp, (B, m)),
            np.zeros((B, q)),
            np.full((B, p + 1), -np.inf)], axis=1)
        row_ub = np.concatenate([
            np.broadcast_to(self.row_ub_vlp, (B, m)),
            np.zeros((B, q)),
            extra_ub,
            eta_ub[:, None]], axis=1)
        return (np.broadcast_to(self.obj, (B, self.obj.size)),
                row_lb, row_ub,
                np.broadcast_to(self.col_lb, (B, self.col_lb.size)),
                np.broadcast_to(self.col_ub, (B, self.col_ub.size)))

    def solve(self, extra_ub: np.ndarray,
              eta_ub: float | np.ndarray | None = None,
              start_basis=None) -> LPResult:
        """``extra_ub``: (B, p) upper bounds ZR'v (+inf rows inactive);
        ``eta_ub``: bound of the eta row (default: 1 hom / +inf inhom);
        ``start_basis``: per-call warm start overriding the template's
        shared carried basis (e.g. (B, M) per-candidate parent bases)."""
        obj, row_lb, row_ub, col_lb, col_ub = self.build_inputs(
            extra_ub, eta_ub)
        return self._run(self.A_lp, obj, row_lb, row_ub, col_lb, col_ub,
                         start_basis=start_basis)

    # result accessors (index maps mirror the reference getter calls)
    def duals_w(self, res: LPResult) -> np.ndarray:
        """Row duals of the q coupling rows -Px+y=0 (rows m+1..m+q)."""
        return res.row_dual[:, self.m:self.m + self.q]

    def duals_alpha(self, res: LPResult) -> np.ndarray:
        """Row dual of the eta row (row m+q+p+1)."""
        return res.row_dual[:, self.m + self.q + self.p]


class P1Template(_TemplateBase):
    # per-candidate data is the OBJECTIVE: a parent basis stays primal
    # feasible, so re-solves take the primal warm start (the default
    # _bound_change_resolve = False)

    def __init__(self, vlp, P_eff, eta: np.ndarray, homogeneous: bool,
                 dtype=np.float64, lp_verbose: int = 0,
                 lp_method: str = "auto", max_batch: int | None = None,
                 ipm_min: int = 0, device: str = "cuda"):
        super().__init__(vlp, P_eff, homogeneous, dtype, lp_verbose,
                         lp_method, max_batch, ipm_min, device)
        m, n, q = self.m, self.n, self.q
        A_lp = self._alloc_lp_matrix(1, 0)       # (m+q+1, n+q)
        A_lp[m + q, n:n + q] = np.asarray(eta, float)
        self.A_lp = A_lp
        self.col_lb = np.concatenate([self.col_lb_vlp, np.full(q, -np.inf)])
        self.col_ub = np.concatenate([self.col_ub_vlp, np.full(q, np.inf)])

    def solve(self, w_batch: np.ndarray, start_basis=None) -> LPResult:
        """``w_batch``: (B, q) objective weights on the y variables."""
        w_batch = np.atleast_2d(np.asarray(w_batch, float))
        B = w_batch.shape[0]
        eta_ub = 1.0 if self.homogeneous else np.inf

        m, n, q = self.m, self.n, self.q
        obj = np.concatenate([np.zeros((B, n)), w_batch], axis=1)
        row_lb = np.concatenate([
            np.broadcast_to(self.row_lb_vlp, (B, m)),
            np.zeros((B, q)),
            np.full((B, 1), -np.inf)], axis=1)
        row_ub = np.concatenate([
            np.broadcast_to(self.row_ub_vlp, (B, m)),
            np.zeros((B, q)),
            np.full((B, 1), eta_ub)], axis=1)
        return self._run(
            self.A_lp, obj, row_lb, row_ub,
            np.broadcast_to(self.col_lb, (B, self.col_lb.size)),
            np.broadcast_to(self.col_ub, (B, self.col_ub.size)),
            start_basis=start_basis)
