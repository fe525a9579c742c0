"""Batched Mehrotra predictor-corrector interior-point LP solver, in
PyTorch: the route the JAX package takes for its largest LPs.

The port of ``bensolve_tpu/lp/ipm.py``, kept step for step: the same
equilibration, cold and warm starts, Mehrotra step, stall restarts,
classification, segment boundaries, batch chunking and compaction, host
polish, certificates, rescue pass and fallbacks, so that both packages
give the same statuses, iteration counts and solutions on the same
inputs.  There is no hand-written kernel here: an iteration is a few
large products (S = A D A^T per instance, G z, G^T y), a batched
Cholesky and its triangular solves, all torch calls on the tensors'
device.

Formulation (solve_batch's contract, bslv_lp.c:34-43 bound types):
min c'x  s.t.  row_lb <= A x <= row_ub, col_lb <= x <= col_ub, with the
row activities s = A x as variables: z = (x, s), G = [A, -I], G z = 0,
l <= z <= u.  Finite bounds get barrier pairs (p = z-l, zl) and
(w = u-z, zu); the Newton system reduces to the normal equations

    (A D_x A^T + D_s + delta I) dy = rhs,   D = 1/(zl/p + zu/w + reg_p)

with D_j = 0 pinning fixed variables.  Duals: row_dual = y and
col_dual = c - A^T y, the simplex backends' sign convention.

Statuses: OPTIMAL on convergence; UNBOUNDED / INFEASIBLE from the
divergence heuristics, each confirmed by a certificate on the host;
ITLIM otherwise.  basis and at_upper are None.

On the card:

* float32 products run at full float32: TF32 is off for the duration of
  a solve, whatever the caller's setting (a TF32 normal matrix keeps 10
  mantissa bits and stalls the Newton steps);
* an iteration is a replayed CUDA graph of ``_Core.step`` (lp/segments.py,
  loop "ipm"; the counterpart of the JAX package's device-side segment
  program ``_ipm_seg_jit``), captured per shape of the carry and the
  chunk's inputs; the eager loop runs on the CPU (the plain version) and
  under segments.eager_loop();
* nothing is read back inside an iteration: the Cholesky retry is
  computed for every instance and selected with torch.where, the solves
  are triangular solves on cuBLAS (torch.cholesky_solve of a batch runs
  MAGMA, which no graph can hold), and the host reads status,
  iterations and best score once per segment of BENSOLVE_IPM_SEG
  iterations.  Inside a segment a flag that says whether any instance
  still runs is copied to the host after every PIECE iterations and read
  one piece later, so a segment ends one piece past where the JAX
  package's while_loop ends it (``LAST["past_stop"]`` counts these
  iterations); an iteration after every instance finished changes only
  mu_prev and noimp (carry[8], carry[9]) of finished rows, which no
  output reads.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import time as _time

import numpy as np
import torch

from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.lp import simplex as sx
from bensolve_tpu_torch.lp.revised import _tf32_off
from bensolve_tpu_torch.lp.simplex import (INFEASIBLE, ITLIM, OPTIMAL,
                                           UNBOUNDED, LPResult)

# batched solves (solve_batch_ipm calls, the rescue pass's included)
CALLS = 0
# LPs handed to the exact host HiGHS fallback, and the seconds they took
HOST_FALLBACK = 0
HOST_FALLBACK_SECONDS = 0.0
# iterations run past the JAX package's stop (masked: every instance had
# finished), over every solve
PAST_STOP = 0
# what the last top-level solve did: batch, chunks, polished and
# polish-skipped instances, LPs handed to the host fallback, iterations
# run past the JAX package's stop (its rescue pass's included)
LAST: dict = {}

# bytes of the (g, M, N) scaled-matrix temporary of one group of the
# S build (the JAX package builds S one instance at a time, lax.map)
S_BUILD_BYTES = 512 << 20
# iterations per replayed graph between two copies of the running flag
PIECE = 1


def _pow2(x):
    return np.exp2(np.round(np.log2(np.maximum(x, 1e-30))))


def _base(A):
    """The original (unpadded) matrix of a prepared one."""
    return A.A if isinstance(A, sx._PreparedA) else A


@dataclasses.dataclass
class _ScaledIPM:
    A: object
    As: np.ndarray      # (M, N) equilibrated, requested dtype
    r: np.ndarray       # (M,) row scales
    cv: np.ndarray      # (N,) col scales
    # device copies of As with its free-column split appended, by
    # (device, free columns): warm rounds do not upload the matrix again
    dev: dict = dataclasses.field(default_factory=dict)


_CACHE: dict = {}


def _scale(A, dtype) -> _ScaledIPM:
    A = _base(A)
    key = (id(A), np.dtype(dtype).str)
    hit = _CACHE.get(key)
    if hit is not None and hit.A is A:
        return hit
    arr = np.asarray(A, np.float64)
    absA = np.abs(arr)
    rmax = absA.max(axis=1)
    # all-zero rows (e.g. the eta row of the phase-0 template, eta = 0)
    # get a NEUTRAL scale: 1/max would blow the row's scaled bounds up
    r = np.where(rmax > 1e-300,
                 np.clip(_pow2(1.0 / np.maximum(rmax, 1e-12)),
                         2.0 ** -30, 2.0 ** 30), 1.0)
    cmax = (absA * r[:, None]).max(axis=0)
    cv = np.where(cmax > 1e-300,
                  np.clip(_pow2(1.0 / np.maximum(cmax, 1e-12)),
                          2.0 ** -30, 2.0 ** 30), 1.0)
    sc = _ScaledIPM(A, (arr * r[:, None] * cv[None, :]).astype(dtype), r, cv)
    if len(_CACHE) > 8:
        _CACHE.clear()
    _CACHE[key] = sc
    return sc


def _device_matrix(sc: _ScaledIPM, As: np.ndarray, free_col: np.ndarray,
                   dev: torch.device) -> torch.Tensor:
    key = (str(dev), free_col.tobytes())
    hit = sc.dev.get(key)
    if hit is None:
        if len(sc.dev) > 4:
            sc.dev.clear()
        hit = sc.dev[key] = sx._put(As, dev)
    return hit


def _params(dtype):
    """(tol, reg_p, reg_d, damping, div_thresh) per dtype.  reg_d is
    RELATIVE to the normal matrix's mean diagonal; div_thresh bounds
    iterate/multiplier norms before an instance is declared
    INFEASIBLE/UNBOUNDED."""
    if np.dtype(dtype) == np.dtype(np.float32):
        return 1e-4, 1e-6, 2e-5, 0.99, 1e7
    return 1e-8, 1e-10, 1e-9, 0.9995, 1e9


def _box(l, u):
    has_l = torch.isfinite(l)
    has_u = torch.isfinite(u)
    fixed = has_l & has_u & (u - l <= 0)
    return has_l, has_u, fixed


def _midpoint(l, u, has_l, has_u, fixed):
    return torch.where(fixed, l, torch.where(
        has_l & has_u, 0.5 * (l + u), torch.where(
            has_l, l + 1.0, torch.where(has_u, u - 1.0, 0.0))))


def _init_core(l, u):
    """Midpoint start with EXACT barrier distances (a floored distance
    let the first step leave narrow boxes)."""
    has_l, has_u, fixed = _box(l, u)
    hl, hu = has_l & ~fixed, has_u & ~fixed
    z0 = _midpoint(l, u, has_l, has_u, fixed)
    p0 = torch.where(hl, (z0 - l).clamp_min(1e-12), 1.0)
    w0 = torch.where(hu, (u - z0).clamp_min(1e-12), 1.0)
    return z0, p0, w0, hl.to(l.dtype), hu.to(l.dtype)


def _start_carry(z, y, zl, zu, p, w, mu0):
    """The 16-entry carry of the JAX package: (z, y, zl, zu, p, w,
    status, it, mu_prev, noimp, best z, y, zl, zu, best score,
    resets)."""
    B = z.shape[0]
    i32 = dict(dtype=torch.int32, device=z.device)
    return (z, y, zl, zu, p, w, torch.full((B,), -1, **i32),
            torch.zeros(B, **i32), mu0, torch.zeros(B, **i32),
            z, y, zl, zu,
            torch.full((B,), math.inf, dtype=z.dtype, device=z.device),
            torch.zeros(B, **i32))


def _ipm_init(c, l, u, M):
    """Cold initial carry."""
    z0, p0, w0, zl0, zu0 = _init_core(l, u)
    B = c.shape[0]
    y0 = torch.zeros((B, M), dtype=c.dtype, device=c.device)
    return _start_carry(z0, y0, zl0, zu0, p0, w0,
                        torch.ones(B, dtype=c.dtype, device=c.device))


# Warm-start interiorization (Gondzio-style): how far inside the box the
# carried primal point is pushed, and the centered barrier level the
# multipliers restart at.
WARM_MARGIN = 1e-3
WARM_MU0 = 1e-3


def _ipm_warm_init(c, l, u, z0, y0, M):
    """Initial carry from a carried interior point (z0, y0) in the
    SCALED space: primal pushed WARM_MARGIN inside every finite bound;
    bound multipliers WARM_MU0 / distance, so every barrier pair starts
    centered at mu = WARM_MU0.  Rows of z0 or y0 holding a non-finite
    value are COLD-started (the _FacetWarm marker for candidates without
    a parent)."""
    has_l, has_u, fixed = _box(l, u)
    hl, hu = has_l & ~fixed, has_u & ~fixed
    row_ok = torch.isfinite(z0).all(dim=1) & torch.isfinite(y0).all(dim=1)
    ok = row_ok[:, None]
    zc0, pc0, wc0, zlc0, zuc0 = _init_core(l, u)
    z0 = torch.where(ok, z0, zc0)
    y0 = torch.where(ok, y0, 0.0)
    narrow = hl & has_u & (u - l < 2.5 * WARM_MARGIN)
    z = torch.where(has_l, torch.maximum(z0, l + WARM_MARGIN), z0)
    z = torch.where(has_u, torch.minimum(z, u - WARM_MARGIN), z)
    z = torch.where(narrow, 0.5 * (l + u), torch.where(fixed, l, z))
    z = torch.where(ok, z, zc0)
    p0 = torch.where(hl, (z - l).clamp_min(1e-8), 1.0)
    w0 = torch.where(hu, (u - z).clamp_min(1e-8), 1.0)
    zl0 = torch.where(hl, WARM_MU0 / p0, 0.0)
    zu0 = torch.where(hu, WARM_MU0 / w0, 0.0)
    p0 = torch.where(ok, p0, pc0)
    w0 = torch.where(ok, w0, wc0)
    zl0 = torch.where(ok, zl0, zlc0)
    zu0 = torch.where(ok, zu0, zuc0)
    mu0 = torch.where(row_ok, torch.full_like(c[:, 0], WARM_MU0), 1.0)
    return _start_carry(z, y0, zl0, zu0, p0, w0, mu0)


@dataclasses.dataclass
class _Carry:
    """The 16-entry carry as the loop state of a graph set
    (lp/segments.py), entry for entry."""

    z: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor
    status: torch.Tensor
    it: torch.Tensor
    mu_prev: torch.Tensor
    noimp: torch.Tensor
    zb: torch.Tensor
    yb: torch.Tensor
    zlb: torch.Tensor
    zub: torch.Tensor
    score_b: torch.Tensor
    resets: torch.Tensor

    def carry(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


@dataclasses.dataclass
class _TraceCarry(_Carry):
    """The carry with BENSOLVE_IPM_TRACE's history, its 17th entry."""

    hist: torch.Tensor


def _state_of(carry) -> _Carry:
    return (_TraceCarry if len(carry) > 16 else _Carry)(*carry)


class _Core:
    """One chunk's fixed data for the iteration: the scaled matrix with
    its free-column split (M, N), c, l, u (B, N + M), the split pairs,
    the tensors derived from c, l, u (DERIVED: computed here, or given,
    as a graph set's buffers are) and the dtype's parameters."""

    DERIVED = ("has_l", "has_u", "fixed", "hl", "hu", "nb", "cmax", "mid")

    def __init__(self, A, c, l, u, split, derived=None):
        self.A, self.c, self.l, self.u, self.split = A, c, l, u, split
        (self.tol, self.reg_p, self.reg_d, self.damp,
         self.div) = _params(np.float64 if c.dtype == torch.float64
                             else np.float32)
        self.M, self.N = A.shape
        if derived is None:
            has_l, has_u, fixed = _box(l, u)
            derived = (has_l, has_u, fixed, has_l & ~fixed, has_u & ~fixed,
                       (has_l.sum(dim=1) + has_u.sum(dim=1)
                        ).clamp_min(1).to(c.dtype),
                       c.abs().amax(dim=1),
                       _midpoint(l, u, has_l, has_u, fixed))
        for name, t in zip(self.DERIVED, derived):
            setattr(self, name, t)
        self.floor = 1e-12 if c.dtype == torch.float64 else 1e-8
        self.group = max(1, S_BUILD_BYTES // max(
            1, self.M * self.N * c.element_size()))

    def tensors(self) -> tuple:
        """A, c, l, u, the split pairs, then DERIVED's tensors."""
        return (self.A, self.c, self.l, self.u, self.split) + tuple(
            getattr(self, name) for name in self.DERIVED)

    def Gz(self, z):
        return torch.matmul(z[:, :self.N], self.A.T) - z[:, self.N:]

    def GTy(self, y):
        return torch.cat([torch.matmul(y, self.A), -y], dim=1)

    def normal_matrix(self, D):
        """S = A D_x A^T + D_s + delta I per instance, with delta
        relative to that instance's mean diagonal (a trace-relative
        shift keeps S positive definite through the structural rank
        deficiency of fixed slacks).  The scaled copy W = A sqrt(D_x)
        is built for ``group`` instances at a time."""
        B, M, N = D.shape[0], self.M, self.N
        S = torch.empty((B, M, M), dtype=D.dtype, device=D.device)
        sq = torch.sqrt(D[:, :N])
        for b0 in range(0, B, self.group):
            W = self.A[None] * sq[b0:b0 + self.group, None, :]
            torch.bmm(W, W.transpose(1, 2), out=S[b0:b0 + self.group])
            del W
        diag = S.diagonal(dim1=1, dim2=2)
        delta = self.reg_d * (diag.mean(dim=1) + 1.0)
        diag.add_(D[:, N:] + delta[:, None])
        return S, delta

    @staticmethod
    def factor(S, delta):
        """Batched Cholesky with the JAX package's one retry at a 1e4x
        boosted shift, computed for every instance and selected per
        instance (no read-back).  A factor failed when cholesky_ex
        reports it or its last row is not finite."""
        L, info = torch.linalg.cholesky_ex(S)
        ok = (info == 0) & torch.isfinite(L[:, -1, :]).all(dim=1)
        Sb = S.clone()
        Sb.diagonal(dim1=1, dim2=2).add_((1e4 * delta)[:, None])
        Lb, info_b = torch.linalg.cholesky_ex(Sb)
        del Sb
        ok_b = (info_b == 0) & torch.isfinite(Lb[:, -1, :]).all(dim=1)
        L = torch.where((~ok & ok_b)[:, None, None], Lb, L)
        return L, ok | ok_b

    @staticmethod
    def solve(L, S, rhs):
        """Cholesky solve plus two passes of iterative refinement against
        the unboosted S (they change the iterates; parity keeps them).
        The solve is the JAX package's _chol_solve, two triangular
        solves: on the card torch.cholesky_solve of a batch runs MAGMA's
        potrs_batched, which cannot be captured in a CUDA graph
        (tests/witness_ipm_linalg.py), and solve_triangular runs
        cuBLAS."""
        r = rhs[..., None]
        Lt = L.transpose(1, 2)

        def chol_solve(b):
            y = torch.linalg.solve_triangular(L, b, upper=False)
            return torch.linalg.solve_triangular(Lt, y, upper=True)

        x = chol_solve(r)
        for _ in range(2):
            x = x + chol_solve(r - torch.bmm(S, x))
        return x[..., 0]

    def direction(self, L, S, D, r_p, r_d, p, w, zl, zu, r_cl, r_cu):
        hl, hu = self.hl, self.hu
        rhat = (r_d - torch.where(hl, r_cl / p, 0.0)
                + torch.where(hu, r_cu / w, 0.0))
        dy = self.solve(L, S, r_p + self.Gz(D * rhat))
        dz = D * (self.GTy(dy) - rhat)
        dzl = torch.where(hl, (r_cl - zl * dz) / p, 0.0)
        dzu = torch.where(hu, (r_cu + zu * dz) / w, 0.0)
        return dy, dz, dzl, dzu

    def steps(self, p, w, zl, zu, dz, dzl, dzu):
        inf = math.inf
        ratio_p = torch.where(self.hl & (dz < 0), -p / dz, inf)
        ratio_p = torch.minimum(
            ratio_p, torch.where(self.hu & (dz > 0), w / dz, inf))
        a_p = (self.damp * ratio_p.amin(dim=1)).clamp_max(1.0)
        ratio_d = torch.where(dzl < 0, -zl / dzl.clamp_max(-1e-30), inf)
        ratio_d = torch.minimum(
            ratio_d, torch.where(dzu < 0, -zu / dzu.clamp_max(-1e-30), inf))
        a_d = (self.damp * ratio_d.amin(dim=1)).clamp_max(1.0)
        return a_p[:, None], a_d[:, None]

    def _mu(self, p, w, zl, zu):
        return (torch.where(self.hl, p * zl, 0.0).sum(dim=1)
                + torch.where(self.hu, w * zu, 0.0).sum(dim=1)) / self.nb

    def step(self, carry, active):
        """One masked iteration (the JAX package's ``body``).  ``active``:
        a device bool, whether any instance runs; when none does, the
        JAX loop would not run this body, so the two entries that change
        finished rows (the free-split recentring and the trace row) are
        held by it."""
        z, y, zl, zu, p, w, status, it, mu_prev, noimp = carry[:10]
        resets = carry[15]
        l, u, c, hl, hu, fixed = (self.l, self.u, self.c, self.hl, self.hu,
                                  self.fixed)
        tol, div = self.tol, self.div
        running = status < 0

        theta = (torch.where(hl, zl / p, 0.0) + torch.where(hu, zu / w, 0.0)
                 + self.reg_p)
        D = torch.where(fixed, 0.0, 1.0 / theta)
        r_p = -self.Gz(z)
        r_d = c - self.GTy(y) - zl + zu
        mu = self._mu(p, w, zl, zu)

        S, delta = self.normal_matrix(D)
        L, chol_ok = self.factor(S, delta)

        # affine (predictor) direction: r_cl = -p*zl, r_cu = -w*zu
        dy_a, dz_a, dzl_a, dzu_a = self.direction(
            L, S, D, r_p, r_d, p, w, zl, zu, -p * zl, -w * zu)
        ap_a, ad_a = self.steps(p, w, zl, zu, dz_a, dzl_a, dzu_a)
        mu_aff = ((torch.where(hl, (p + ap_a * dz_a) * (zl + ad_a * dzl_a),
                               0.0).sum(dim=1)
                   + torch.where(hu, (w - ap_a * dz_a) * (zu + ad_a * dzu_a),
                                 0.0).sum(dim=1)) / self.nb)
        sigma = ((mu_aff / mu.clamp_min(1e-30)) ** 3).clamp(0.0, 1.0)

        # corrector: centering + Mehrotra second-order term
        sm = (sigma * mu)[:, None]
        r_cl = sm - p * zl - dz_a * dzl_a
        r_cu = sm - w * zu + dz_a * dzu_a
        dy, dz, dzl, dzu = self.direction(L, S, D, r_p, r_d, p, w, zl, zu,
                                          r_cl, r_cu)
        del S, L
        a_p, a_d = self.steps(p, w, zl, zu, dz, dzl, dzu)

        dir_ok = (torch.isfinite(dz).all(dim=1)
                  & torch.isfinite(dy).all(dim=1))
        upd = (running & chol_ok & dir_ok)[:, None]
        z_n = torch.where(upd, z + a_p * dz, z)
        if self.split.shape[0]:
            # recentre free-split pairs: subtract the common mode above
            # 1.0 from both halves (Gz and c'z are unchanged)
            i0, i1 = self.split[:, 0], self.split[:, 1]
            shift = (torch.minimum(z_n[:, i0], z_n[:, i1]) - 1.0
                     ).clamp_min(0.0)
            shift = torch.where(active, shift, 0.0)
            z_n = z_n.index_add(1, i0, -shift).index_add(1, i1, -shift)
        y_n = torch.where(upd, y + a_d * dy, y)
        zl_n = torch.where(upd, (zl + a_d * dzl).clamp_min(0.0), zl)
        zu_n = torch.where(upd, (zu + a_d * dzu).clamp_min(0.0), zu)
        # hard projection into the box keeps z <-> (p, w) exact
        z_n = torch.where(fixed, l, torch.clamp(z_n, l, u))
        floor = self.floor
        p_n = torch.where(hl, z_n - l, 1.0).clamp_min(floor)
        w_n = torch.where(hu, u - z_n, 1.0).clamp_min(floor)

        # convergence / divergence classification on the NEW iterate
        r_p_n = -self.Gz(z_n)
        r_d_n = c - self.GTy(y_n) - zl_n + zu_n
        mu_n = self._mu(p_n, w_n, zl_n, zu_n)
        znorm = z_n.abs().amax(dim=1)
        pinf = r_p_n.abs().amax(dim=1) / (1.0 + znorm)
        dinf = torch.where(fixed, 0.0, r_d_n.abs()).amax(dim=1) / (
            1.0 + self.cmax)
        obj = (c * z_n).sum(dim=1)
        # TOTAL complementarity (the duality gap), not the pair average
        gap = mu_n * self.nb / (1.0 + obj.abs())

        # best-iterate tracking BEFORE any restart below
        zb, yb, zlb, zub, score_b = carry[10:15]
        score = torch.maximum(torch.maximum(pinf, dinf), gap)
        better = (running & (score < score_b))[:, None]
        zb = torch.where(better, z_n, zb)
        yb = torch.where(better, y_n, yb)
        zlb = torch.where(better, zl_n, zlb)
        zub = torch.where(better, zu_n, zub)
        score_b = torch.minimum(score_b, torch.where(running, score,
                                                     math.inf))

        improving = mu_n < 0.7 * mu_prev
        noimp_n = torch.where(improving, 0, noimp + 1)
        # barrier restart on a persistent stall: multipliers back to the
        # cold start; from the third restart on, the primal iterate also
        # moves halfway to the box midpoint
        restart = running & (noimp_n >= 16) & (pinf >= 10 * tol)
        zl_n = torch.where(restart[:, None] & hl, 1.0, zl_n)
        zu_n = torch.where(restart[:, None] & hu, 1.0, zu_n)
        full_restart = (restart & (resets >= 2))[:, None]
        resets_n = resets + restart.to(torch.int32)
        z_n = torch.where(full_restart, 0.5 * (z_n + self.mid), z_n)
        p_n = torch.where(full_restart & hl, (z_n - l).clamp_min(floor), p_n)
        w_n = torch.where(full_restart & hu, (u - z_n).clamp_min(floor), w_n)
        noimp_n = torch.where(restart, 0, noimp_n)
        mu_n = torch.where(restart, 1.0, mu_n)
        # loose acceptances need the iterate and the multipliers far
        # from the divergence threshold (drift guard)
        dual_norm = torch.maximum(zl_n.amax(dim=1), zu_n.amax(dim=1))
        no_drift = (znorm < 1e-3 * div) & (dual_norm < 1e-3 * div)
        stalled = ((noimp_n >= 8) & (pinf < 10 * tol) & (dinf < 100 * tol)
                   & (gap < 100 * tol) & no_drift)
        converged = (((pinf < tol) & (dinf < 10 * tol) & (gap < tol))
                     | stalled)
        # divergence is only trusted once the cold-start transient has
        # settled
        settled = it >= 10
        diverged = settled & ((znorm > div) | (dual_norm > div))
        unbounded = diverged & (pinf < math.sqrt(tol))
        infeasible = diverged & ~unbounded
        # factorization/direction failure: salvage-accept the pre-failure
        # iterate at the loose (100x) thresholds, else ITLIM
        bad_step = settled & ~(chol_ok & dir_ok)
        salvage = ((pinf < 100 * tol) & (dinf < 100 * tol)
                   & (gap < 100 * tol) & no_drift)
        status_n = torch.where(
            running & converged, OPTIMAL,
            torch.where(running & unbounded, UNBOUNDED,
                        torch.where(running & infeasible, INFEASIBLE,
                                    torch.where(running & bad_step,
                                                torch.where(salvage, OPTIMAL,
                                                            ITLIM),
                                                status)))).to(torch.int32)
        it_n = it + running.to(torch.int32)
        out = (z_n, y_n, zl_n, zu_n, p_n, w_n, status_n, it_n, mu_n,
               noimp_n.to(torch.int32), zb, yb, zlb, zub, score_b, resets_n)
        if len(carry) > 16:
            # BENSOLVE_IPM_TRACE: instance 0's history, written into a
            # preallocated device tensor
            hist = carry[16]
            row = torch.stack([mu_n[0], pinf[0], dinf[0], gap[0],
                               a_p[0, 0], a_d[0, 0], sigma[0]]).to(hist.dtype)
            idx = it[0].clamp(max=hist.shape[0] - 1).to(torch.long).view(1)
            row = torch.where(active, row, hist.index_select(0, idx)[0])
            out = out + (hist.index_copy(0, idx, row[None]),)
        return out


def _graph_step(A, c, l, u, split, *rest):
    """One iteration on a graph set's buffers (lp/segments.py): ``rest``
    is _Core.DERIVED's tensors, then the loop state (a _Carry)."""
    *derived, st = rest
    core = _Core(A, c, l, u, split, derived)
    return _state_of(core.step(st.carry(), (st.status < 0).any()))


def _advance(advance, running, n, piece, ahead, dev) -> int:
    """At most n iterations, ``advance(k)`` running k of them, in pieces
    of at most ``piece``.  After each piece the device flag ``running()``
    (any instance still running) is copied to the host; the host runs at
    most ``ahead`` pieces past the last flag it has read and stops at the
    first that says none runs, where the JAX package's loop stops.  The
    iterations queued past that point are masked (``_Core.step``).
    Returns the iterations run."""
    cuda = dev.type == "cuda"
    flags = torch.empty(-(-n // piece), dtype=torch.bool, pin_memory=cuda)
    pending = collections.deque()
    done = 0
    while done < n:
        k = min(piece, n - done)
        advance(k)
        flags[done // piece].copy_(running(), non_blocking=cuda)
        fence = None
        if cuda:
            fence = torch.cuda.Event()
            fence.record()
        pending.append((done // piece, fence))
        done += k
        while len(pending) > ahead:
            j, fence = pending.popleft()
            if fence is not None:
                fence.synchronize()
            if not bool(flags[j]):
                return done
    return done


def _ipm_core(A, c, l, u, split, carry0, seg, max_iter):
    """Advance the IPM by at most ``seg`` iterations from ``carry0``, on
    the tensors' device, stopping where the JAX package's loop
    (``k < seg & any(status < 0) & all(it < max_iter)``) stops.  c, l,
    u: (B, K) with K = N + M (x then s), in the iteration's dtype;
    ``split``: (nf, 2) column pairs of free-variable splits.  Returns
    (carry, iterations run); status -1 = still running.

    Where simplex._graphs_on says so (a CUDA device, outside
    segments.eager_loop()) every iteration is a replayed CUDA graph of
    ``_Core.step`` (lp/segments.py, loop "ipm"), PIECE iterations a
    replay; elsewhere the eager loop runs the same steps.  On a CUDA
    device both read the running flag one piece late, so both run at
    most one piece past the JAX package's stop; the CPU's eager loop
    stops there."""
    carry = tuple(x.contiguous() for x in carry0)
    if not bool((carry[6] < 0).any()):
        return carry, 0
    n = max(0, min(seg, max_iter - int(carry[7].max())))
    dev = carry[0].device
    core = _Core(A, c, l, u, split)
    if n and sx._graphs_on(dev):
        st = _state_of(carry)
        with segments.held(_graph_step, "ipm", st, core.tensors(), ()) as gs:
            ran = _advance(gs.advance, lambda: (gs.state.status < 0).any(),
                           n, PIECE, 1, dev)
            return gs.unload(st).carry(), ran
    state = [carry]

    def advance(k):
        for _ in range(k):
            state[0] = core.step(state[0], (state[0][6] < 0).any())
        segments.count_eager(k, "ipm")

    ran = _advance(advance, lambda: (state[0][6] < 0).any(), n, 1,
                   int(dev.type == "cuda"), dev)
    return state[0], ran


def _polish_one(As, z, y, zl, zu, l, u, c_s, max_rounds: int = 24):
    """Crossover-lite polish of one instance in the SCALED space: pin
    the active set read off the final iterate, least-squares-correct
    the free primal variables onto G z = 0 and the duals onto zero
    reduced cost for free columns, repairing the active set adaptively.
    Returns (z', y', ok, rounds used); on ok=False the caller keeps the
    raw iterate and status logic."""
    M, Nc = As.shape
    has_l = np.isfinite(l)
    has_u = np.isfinite(u)
    fixed = has_l & has_u & (u - l <= 0)
    dist_l = np.maximum(z - l, 1e-300)
    dist_u = np.maximum(u - z, 1e-300)
    at_lb = ~fixed & has_l & (zl / dist_l >= zu / dist_u) & (zl > dist_l)
    at_ub = ~fixed & has_u & ~at_lb & (zu > dist_u)
    # marginality of a pinned bound = its multiplier size
    marg = np.where(at_lb, zl, zu)
    dtol = 1e-6 * (1.0 + np.abs(c_s).max())

    used = 0
    for used in range(1, max_rounds + 1):
        pinned = fixed | at_lb | at_ub
        F = np.flatnonzero(~pinned)
        if F.size == 0 or F.size > 6 * M + 16:
            return z, y, False, used
        zp = z.copy()
        zp[fixed | at_lb] = l[fixed | at_lb]
        zp[at_ub] = u[at_ub]

        # G = [As, -I]; free-column block
        GF = np.zeros((M, F.size))
        GF[:, F < Nc] = As[:, F[F < Nc]]
        slack = np.flatnonzero(F >= Nc)
        GF[F[slack] - Nc, slack] = -1.0

        act = zp[:Nc] @ As.T - zp[Nc:]
        d, *_ = np.linalg.lstsq(GF, -act, rcond=None)
        zp[F] += d
        act = zp[:Nc] @ As.T - zp[Nc:]
        scale_z = 1.0 + np.abs(zp).max()
        if not np.isfinite(scale_z):
            return z, y, False, used
        if np.abs(act).max() > 1e-8 * scale_z:
            # residual unreachable from this free set: unpin the single
            # most weakly pinned bound
            cand = np.flatnonzero(at_lb | at_ub)
            if cand.size == 0:
                return z, y, False, used
            k = cand[np.argmin(marg[cand])]
            at_lb[k] = False
            at_ub[k] = False
            continue
        btol = 1e-7 * scale_z
        viol_l = has_l & ~pinned & (zp < l - btol)
        viol_u = has_u & ~pinned & (zp > u + btol)
        if viol_l.any() or viol_u.any():
            at_lb[viol_l & ~fixed] = True
            at_ub[viol_u & ~fixed & ~viol_l] = True
            continue

        e, *_ = np.linalg.lstsq(GF.T, c_s[F] - GF.T @ y, rcond=None)
        yp = y + e
        rd = c_s - np.concatenate([yp @ As, -yp])
        bad_lb = at_lb & (rd < -dtol)
        bad_ub = at_ub & (rd > dtol)
        bad_f = ~pinned & (np.abs(rd) > dtol)
        if not (bad_lb.any() or bad_ub.any() or bad_f.any()):
            return zp, yp, True, used
        if bad_lb.any() or bad_ub.any():
            at_lb[bad_lb] = False
            at_ub[bad_ub] = False
            continue
        # free columns with clearly nonzero reduced cost belong at a
        # bound; pin only the worst offenders, at most enough to bring
        # |F| down to M
        n_pin = max(1, F.size - M)
        order = np.flatnonzero(bad_f)[np.argsort(-np.abs(rd[bad_f]))]
        n_done = 0
        for j in order:
            if n_done >= n_pin:
                break
            if rd[j] > 0 and has_l[j]:
                at_lb[j] = True
                n_done += 1
            elif rd[j] < 0 and has_u[j]:
                at_ub[j] = True
                n_done += 1
        if n_done == 0:
            return z, y, False, used
    return z, y, False, used


def _loose_kkt_ok(As, z, y, zl, zu, l, u, c_s, tol) -> bool:
    """Best-effort acceptance test for budget-exhausted instances: the
    full KKT system within 250x of the dtype tolerance.  Acceptances
    here are surfaced as LPResult.quality == 2."""
    M, Nc = As.shape
    act = z[:Nc] @ As.T - z[Nc:]
    znorm = np.abs(z).max()
    if not np.isfinite(znorm):
        return False
    pinf = np.abs(act).max() / (1.0 + znorm)
    rd = c_s - np.concatenate([y @ As, -y]) - zl + zu
    fixed = np.isfinite(l) & np.isfinite(u) & (u - l <= 0)
    dinf = np.abs(np.where(fixed, 0.0, rd)).max() / (
        1.0 + np.abs(c_s).max())
    has_l = np.isfinite(l) & ~fixed
    has_u = np.isfinite(u) & ~fixed
    binf = max(np.where(has_l, l - z, -np.inf).max(),
               np.where(has_u, z - u, -np.inf).max(), 0.0) / (1.0 + znorm)
    with np.errstate(invalid="ignore"):
        comp = (np.where(has_l, np.maximum(z - l, 0.0) * zl, 0.0).sum()
                + np.where(has_u, np.maximum(u - z, 0.0) * zu, 0.0).sum())
    obj = float(c_s @ z)
    gap = comp / (1.0 + abs(obj))
    lim = 250 * tol
    return (pinf < lim) and (dinf < lim) and (binf < lim) and (gap < lim)


_SPARSE_CACHE: dict = {}


def _host_highs_one(A_csr, ci, rlb, rub, clb, cub):
    """Exact host-side solve of ONE straggler LP via scipy/HiGHS on the
    SPARSE original matrix (the role GLPK plays for the reference,
    bslv_lp.c:219-259).  Returns (status, obj, x, s, row_dual, col_dual)
    in solve_batch's dual sign convention: c = A' row_dual + col_dual."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    M = A_csr.shape[0]
    eq = np.isfinite(rlb) & np.isfinite(rub) & (rlb == rub)
    ubm = np.isfinite(rub) & ~eq
    lbm = np.isfinite(rlb) & ~eq
    blocks = []
    if ubm.any():
        blocks.append(A_csr[ubm])
    if lbm.any():
        blocks.append(-A_csr[lbm])
    A_ub = sp.vstack(blocks, format="csr") if blocks else None
    b_ub = np.concatenate([rub[ubm], -rlb[lbm]])
    kw = {}
    if A_ub is not None:
        kw["A_ub"], kw["b_ub"] = A_ub, b_ub
    if eq.any():
        kw["A_eq"], kw["b_eq"] = A_csr[eq], rub[eq]
    res = linprog(ci, bounds=list(zip(clb, cub)), method="highs", **kw)
    smap = {0: OPTIMAL, 2: INFEASIBLE, 3: UNBOUNDED}
    st = smap.get(res.status, ITLIM)
    if st != OPTIMAL:
        N = A_csr.shape[1]
        return (st, 0.0, np.zeros(N), np.zeros(M), np.zeros(M),
                np.zeros(N))
    row_dual = np.zeros(M)
    if A_ub is not None:
        m_in = np.asarray(res.ineqlin.marginals)
        n_ub = int(ubm.sum())
        row_dual[ubm] += m_in[:n_ub]
        row_dual[lbm] -= m_in[n_ub:]
    if eq.any():
        row_dual[eq] = np.asarray(res.eqlin.marginals)
    x = np.asarray(res.x)
    s = A_csr @ x
    col_dual = np.asarray(ci) - A_csr.T @ row_dual
    return st, float(res.fun), x, s, row_dual, col_dual


def _sparse_A(A):
    """CSR of the ORIGINAL (unscaled, unpadded) constraint matrix,
    memoized by identity."""
    import scipy.sparse as sp

    base = A.A if hasattr(A, "A") and not isinstance(A, np.ndarray) else A
    base = np.asarray(base, np.float64)
    key = id(base)
    hit = _SPARSE_CACHE.get(key)
    if hit is not None and hit[0] is base:
        return hit[1]
    csr = sp.csr_matrix(base)
    if len(_SPARSE_CACHE) > 8:
        _SPARSE_CACHE.clear()
    _SPARSE_CACHE[key] = (base, csr)
    return csr


def _farkas_infeasible(As, y, l, u) -> bool:
    """Infeasibility certificate for {G z = 0, l <= z <= u} from the
    final dual iterate: with g = G'y, a strictly positive (finite)
    box-minimum of y'Gz proves the box and the nullspace incompatible."""
    ynorm = np.abs(y).max()
    if not np.isfinite(ynorm) or ynorm == 0:
        return False
    fin = np.concatenate([l[np.isfinite(l)], u[np.isfinite(u)], [0.0]])
    thresh = 1e-6 * (1.0 + np.abs(fin).max())
    for sign in (1.0, -1.0):
        yh = sign * y / ynorm
        g = np.concatenate([yh @ As, -yh])
        lo = np.where(g > 0, l, np.where(g < 0, u, 0.0))
        terms = np.where(g != 0, g * lo, 0.0)
        if np.isfinite(terms).all() and terms.sum() > thresh:
            return True
    return False


def _unbounded_ray(As, z, c_s, l, u) -> bool:
    """Ray certificate from a diverging iterate: d = z/|z| must be an
    approximate recession direction that improves the objective."""
    znorm = np.abs(z).max()
    if not np.isfinite(znorm) or znorm == 0:
        return False
    d = z / znorm
    Nc = As.shape[1]
    if np.abs(d[:Nc] @ As.T - d[Nc:]).max() > 1e-4:
        return False
    if ((np.isfinite(l) & (d < -1e-4)) | (np.isfinite(u)
                                          & (d > 1e-4))).any():
        return False
    return c_s @ d < -1e-6


def solve_batch_ipm(A, c, row_lb, row_ub, col_lb, col_ub, *,
                    max_iter: int = 800, dtype=np.float32,
                    verbose: int = 0, polish: bool | None = None,
                    max_chunk: int | None = None,
                    warm_interior=None, device="cuda",
                    _rescue: bool = False, **_ignored) -> LPResult:
    """solve_batch-compatible entry (basis/at_upper come back None);
    keywords of the simplex backends (start_basis, ...) are ignored.
    ``warm_interior``: an (x, s, row_dual) triple, shared (1, *) or per
    instance (B, *) with NaN rows for a cold start, from a related
    previous solve, used as a shifted interior start;
    BENSOLVE_IPM_WARM=0 disables.  The batch is chunked against a
    device-memory budget (the per-instance normal matrix + factor is
    2*M*M*itemsize; BENSOLVE_IPM_BYTES overrides).  ``device``: the
    torch device of the iteration; the host polish, certificates and
    HiGHS fallback run on the host whatever it is."""
    global CALLS, HOST_FALLBACK, HOST_FALLBACK_SECONDS, PAST_STOP
    CALLS += 1
    past0 = PAST_STOP
    dev = sx.resolve_device(device)
    dtype = np.dtype(dtype).type
    # BENSOLVE_IPM_MAXIT: budget override
    max_iter = int(os.environ.get("BENSOLVE_IPM_MAXIT", max_iter))
    sc = _scale(A, dtype)
    M, N = sc.As.shape
    c2 = np.atleast_2d(np.asarray(c))
    B = c2.shape[0]
    r, cv = sc.r, sc.cv

    # scaled problem: x' = x / cv, s' = r * s
    cx = c2 * cv[None, :]
    lx = np.asarray(col_lb) / cv[None, :]
    ux = np.asarray(col_ub) / cv[None, :]

    # FREE columns (both bounds infinite across the whole batch) are
    # split x = x+ - x- with both parts in [0, inf): a free column
    # otherwise carries only the tiny regularizer and its barrier weight
    # wrecks the normal matrix
    free_col = np.flatnonzero(
        (~np.isfinite(lx)).all(axis=0) & (~np.isfinite(ux)).all(axis=0))
    nf = free_col.size
    As = sc.As
    if nf:
        As = np.concatenate([As, -As[:, free_col]], axis=1)
        cx = np.concatenate([cx, -cx[:, free_col]], axis=1)
        lx = np.concatenate([lx, np.zeros((B, nf))], axis=1)
        lx[:, free_col] = 0.0
        ux = np.concatenate([ux, np.full((B, nf), np.inf)], axis=1)
    split = (np.stack([free_col.astype(np.int64),
                       np.arange(N, N + nf, dtype=np.int64)], axis=1)
             if nf else np.zeros((0, 2), np.int64))

    c_s = np.concatenate([cx, np.zeros((B, M))], axis=1)
    l_s = np.concatenate([lx, np.asarray(row_lb) * r[None, :]], axis=1)
    u_s = np.concatenate([ux, np.asarray(row_ub) * r[None, :]], axis=1)
    crossed = (l_s > u_s).any(axis=1)
    l_s = np.minimum(l_s, u_s)

    # batch chunking against a memory budget: per instance the loop
    # holds the (M, M) normal matrix and its Cholesky factor plus ~16
    # (K,) iterate/direction vectors
    itemsize = np.dtype(dtype).itemsize
    Nc = N + nf
    K = Nc + M
    budget = int(os.environ.get("BENSOLVE_IPM_BYTES", 2_000_000_000))
    per_inst = 2 * M * M * itemsize + 16 * K * itemsize
    chunk = max(1, min(B, budget // max(per_inst, 1)))
    if max_chunk:
        chunk = min(chunk, int(max_chunk))
    # floor to a power of two so the bucketed batch never pads past the
    # memory budget (the rule decides which instances share a chunk,
    # and with it the straggler cap, so it is kept as it is)
    chunk = 1 << (chunk.bit_length() - 1)

    # carried interior start, mapped into the scaled/split space:
    # x' = x/cv, s' = s*r, y = row_dual/r; free-split pairs rebuilt with
    # min(x+, x-) = 1
    warm = None
    if (warm_interior is not None
            and os.environ.get("BENSOLVE_IPM_WARM", "1") != "0"):
        wx, ws, wrd = (np.atleast_2d(np.asarray(a, np.float64))
                       for a in warm_interior)
        shapes_ok = (wx.shape[-1] == N and ws.shape[-1] == M
                     and wrd.shape[-1] == M
                     and wx.shape[0] in (1, B)
                     and ws.shape[0] == wx.shape[0]
                     and wrd.shape[0] == wx.shape[0])
        # per-instance warms may contain NaN rows (= start that row
        # cold); a shared warm must be fully finite
        finite_ok = (np.isfinite(wx).all() and np.isfinite(ws).all()
                     and np.isfinite(wrd).all()) \
            if wx.shape[0] == 1 else True
        if shapes_ok and finite_ok:
            Bw = wx.shape[0]
            xw = wx / cv[None, :]
            zw = np.concatenate(
                [xw, np.zeros((Bw, nf)), ws * r[None, :]], axis=1)
            if nf:
                zp = np.maximum(xw[:, free_col], 0.0) + 1.0
                zw[:, free_col] = zp
                zw[:, N:N + nf] = zp - xw[:, free_col]
            yw = wrd / r[None, :]
            if Bw == 1:
                zw = np.broadcast_to(zw, (B, zw.shape[1]))
                yw = np.broadcast_to(yw, (B, M))
            warm = (zw, yw)       # (B, K), (B, M)

    A_dev = _device_matrix(sc, As, free_col, dev)
    split_dev = sx._put(split, dev)
    trace_on = os.environ.get("BENSOLVE_IPM_TRACE") == "1"
    seg = int(os.environ.get("BENSOLVE_IPM_SEG", "60"))
    outs = []
    # global batch rows that were per-instance FROZEN (best iterate
    # stopped improving): the rescue pass skips them
    frozen_rows: set = set()
    for s0 in range(0, B, chunk):
        sl = slice(s0, min(s0 + chunk, B))
        Bc = sl.stop - s0
        # bucket the chunk batch to a power of two (pad by repeating
        # row 0): the cap below counts padded rows, so the bucketing
        # decides outcomes and is kept
        Bp = 1 << (Bc - 1).bit_length()
        pad = Bp - Bc

        def _pad(a):
            a = a[sl]
            if pad:
                a = np.concatenate([a, np.broadcast_to(a[:1],
                                                       (pad,) + a.shape[1:])])
            return sx._put(np.asarray(a, dtype), dev)

        if verbose >= 2:
            print(f"lp_solve[ipm]: solving chunk {s0}..{sl.stop} "
                  f"of {B} (M={M} N={Nc} padded_batch={Bp})", flush=True)
        c_p, l_p, u_p = _pad(c_s), _pad(l_s), _pad(u_s)
        if warm is not None:
            carry = _ipm_warm_init(c_p, l_p, u_p, _pad(warm[0]),
                                   _pad(warm[1]), M)
        else:
            carry = _ipm_init(c_p, l_p, u_p, M)
        if trace_on:
            carry = carry + (torch.zeros((max_iter, 7), dtype=torch.float32,
                                         device=dev),)
        t_seg = _time.perf_counter()
        # adaptive straggler budget: once most of the chunk has
        # resolved, cap the rest near 2x the median converged iteration
        # count.  BENSOLVE_IPM_STRAGGLER_MULT tunes; 0 disables.
        smult = (0.0 if _rescue else float(
            os.environ.get("BENSOLVE_IPM_STRAGGLER_MULT", "2.0")))
        # per-instance best-score stall stop after this many segments
        # without a 10% improvement
        stall_cap = int(os.environ.get("BENSOLVE_IPM_STALL_SEGS", "3"))
        best_prev = None
        noimp_segs = None
        cap = max_iter
        # batch compaction: once enough instances finish, shrink the
        # lockstep batch to the running subset (pow2 ladder).  Finished
        # rows are pulled to the host at compaction time; `live` maps
        # current rows to the chunk's padded rows (-1 = pure padding).
        Bp_cur = Bp
        live = np.arange(Bp)
        K_tot = c_p.shape[1]
        Z_out = np.zeros((Bp, K_tot))
        Y_out = np.zeros((Bp, M))
        ZL_out = np.zeros((Bp, K_tot))
        ZU_out = np.zeros((Bp, K_tot))
        ST_out = np.full(Bp, -1, np.int32)
        IT_out = np.zeros(Bp, np.int32)
        written = np.zeros(Bp, bool)

        def _flush(carry, local_rows):
            idx = np.asarray(local_rows, int)
            if idx.size == 0:
                return
            idx_t = torch.as_tensor(idx, device=dev)

            def host(k):
                return carry[k].index_select(0, idx_t).cpu().numpy()

            st_l = host(6)
            best = st_l < 0
            z_l = np.where(best[:, None], host(10), host(0))
            y_l = np.where(best[:, None], host(11), host(1))
            zl_l = np.where(best[:, None], host(12), host(2))
            zu_l = np.where(best[:, None], host(13), host(3))
            it_l = host(7)
            for k, loc in enumerate(idx):
                orig = live[loc]
                if orig < 0 or written[orig]:
                    continue
                Z_out[orig] = z_l[k]
                Y_out[orig] = y_l[k]
                ZL_out[orig] = zl_l[k]
                ZU_out[orig] = zu_l[k]
                ST_out[orig] = st_l[k]
                IT_out[orig] = it_l[k]
                written[orig] = True

        # the running instances' iteration count: every running row has
        # it, so a segment's iterations up to the JAX package's stop are
        # what the largest count grew by
        it_top = 0
        with _tf32_off():
            while True:
                carry, ran = _ipm_core(A_dev, c_p, l_p, u_p, split_dev,
                                       carry, seg, max_iter)
                st_h = carry[6].cpu().numpy()
                it_h = carry[7].cpu().numpy()
                PAST_STOP += ran - (int(it_h.max()) - it_top)
                it_top = int(it_h.max())
                fin = st_h >= 0
                real = live >= 0
                n_fin_total = int(written.sum()) + int((fin & real).sum())
                if (smult > 0 and cap == max_iter
                        and n_fin_total >= max(1, (3 * Bp) // 4)):
                    fin_iters = np.concatenate(
                        [IT_out[written], it_h[fin & real]])
                    med = float(np.median(fin_iters))
                    cap = int(min(max_iter, max(smult * med + 40, 120)))
                run_it = int(it_h[~fin].max()) if (~fin).any() else 0
                # PER-INSTANCE best-score freeze: an instance whose own
                # best KKT score has not improved >10% for stall_cap
                # consecutive segments is flushed from its best iterate
                best = carry[14].cpu().numpy()
                if best_prev is None or best_prev.size != Bp_cur:
                    best_prev = best.copy()
                    noimp_segs = np.zeros(Bp_cur, int)
                else:
                    improved = best < 0.9 * best_prev
                    noimp_segs = np.where(improved, 0, noimp_segs + 1)
                    best_prev = np.minimum(best_prev, best)
                frozen = ((~fin) & (noimp_segs >= stall_cap)
                          if stall_cap > 0 else np.zeros(Bp_cur, bool))
                for j in np.flatnonzero(frozen & real):
                    if live[j] < Bc:
                        frozen_rows.add(int(s0 + live[j]))
                done = (fin | frozen).all() or run_it >= cap
                if verbose >= 2 and not done:
                    print(f"lp_solve[ipm]: segment it={int(it_h.max())} "
                          f"running={int((~fin).sum())}/{Bp_cur} "
                          f"cap={cap} "
                          f"frozen={int(frozen.sum())} "
                          f"({_time.perf_counter() - t_seg:.0f}s)",
                          flush=True)
                if done:
                    break
                n_run = int((~fin & ~frozen).sum())
                Bp_new = 1 << max(0, n_run - 1).bit_length()
                if not trace_on and n_run > 0 and Bp_new <= Bp_cur // 2:
                    _flush(carry, np.flatnonzero(fin | frozen))
                    keep = np.flatnonzero(~fin & ~frozen)
                    pad_k = np.full(Bp_new - keep.size, keep[0], int)
                    sel_np = np.concatenate([keep, pad_k])
                    sel = torch.as_tensor(sel_np, device=dev)
                    carry = tuple(a.index_select(0, sel)
                                  for a in carry[:16]) + tuple(carry[16:])
                    c_p, l_p, u_p = (a.index_select(0, sel)
                                     for a in (c_p, l_p, u_p))
                    live = np.concatenate(
                        [live[keep], np.full(pad_k.size, -1)])
                    Bp_cur = Bp_new
                    best_prev = best_prev[sel_np]
                    noimp_segs = noimp_segs[sel_np]
                    if verbose >= 2:
                        print(f"lp_solve[ipm]: compacted batch to "
                              f"{Bp_cur}", flush=True)
        _flush(carry, np.arange(Bp_cur))
        if trace_on:
            for k, hrow in enumerate(carry[16].cpu().numpy()):
                if not hrow.any():
                    break
                print(f"ipm it={k} mu={hrow[0]:.3e} pinf={hrow[1]:.3e} "
                      f"dinf={hrow[2]:.3e} gap={hrow[3]:.3e} "
                      f"ap={hrow[4]:.3f} ad={hrow[5]:.3f} "
                      f"sigma={hrow[6]:.3f}", flush=True)
        outs.append((Z_out[:Bc], Y_out[:Bc], ZL_out[:Bc], ZU_out[:Bc],
                     ST_out[:Bc], IT_out[:Bc]))
        del carry, c_p, l_p, u_p
    z = np.concatenate([o[0] for o in outs])
    y = np.concatenate([o[1] for o in outs])
    zl = np.concatenate([o[2] for o in outs])
    zu = np.concatenate([o[3] for o in outs])
    status = np.concatenate([o[4] for o in outs]).astype(np.int32)
    iters = np.concatenate([o[5] for o in outs]).astype(np.int32)

    # host-side classification + polish (f64).  Polish every instance
    # that is OPTIMAL or still running, within a cost gate; the rest are
    # certificate-checked (Farkas / ray) before any INFEASIBLE or
    # UNBOUNDED verdict.  Polish also turns the interior duals into
    # VERTEX duals, which the Benson cut constructions rely on.
    As64 = np.asarray(As, np.float64)
    do_polish = polish if polish is not None else (M <= 1500)
    # a DETERMINISTIC work budget for the whole batch (estimated flops
    # of the rounds actually spent): identical inputs always polish
    # identically
    budget_fl = float(os.environ.get("BENSOLVE_POLISH_BUDGET_FLOPS",
                                     "4e11"))
    per_round = 4.0 * M * M * min(6 * M + 16, K)
    rounds_cap = 24 if M <= 512 else 6
    spent = 0.0
    n_skipped = 0
    # provenance per instance: 0 raw device acceptance, 1 polished,
    # 2 loose host acceptance (<=250x tol), 3 exact fallback, 4 rescue
    prov = np.zeros(B, np.int8)
    for i in range(B):
        if crossed[i]:
            continue
        st = int(status[i])
        if st in (OPTIMAL, -1) and do_polish and spent <= budget_fl:
            zp, yp, ok, used = _polish_one(As64, z[i], y[i], zl[i],
                                           zu[i], l_s[i], u_s[i],
                                           c_s[i],
                                           max_rounds=rounds_cap)
            spent += used * per_round
            if ok:
                z[i], y[i] = zp, yp
                status[i] = OPTIMAL
                prov[i] = 1
                continue
        elif st in (OPTIMAL, -1) and do_polish:
            n_skipped += 1
        if st == -1:
            # classify leftovers: certificate, best-effort acceptance,
            # or ITLIM
            if _farkas_infeasible(As64, y[i], l_s[i], u_s[i]):
                status[i] = INFEASIBLE
            elif _unbounded_ray(As64, z[i], c_s[i], l_s[i], u_s[i]):
                status[i] = UNBOUNDED
            elif _loose_kkt_ok(As64, z[i], y[i], zl[i], zu[i], l_s[i],
                               u_s[i], c_s[i], _params(dtype)[0]):
                status[i] = OPTIMAL
                prov[i] = 2
            else:
                status[i] = ITLIM
        elif st == INFEASIBLE and not _farkas_infeasible(
                As64, y[i], l_s[i], u_s[i]):
            # downgrade uncertified heuristic verdicts
            if _unbounded_ray(As64, z[i], c_s[i], l_s[i], u_s[i]):
                status[i] = UNBOUNDED
            else:
                status[i] = ITLIM
        elif st == UNBOUNDED and not _unbounded_ray(
                As64, z[i], c_s[i], l_s[i], u_s[i]):
            status[i] = ITLIM

    xs = z[:, :N]
    if nf:
        xs = xs.copy()
        xs[:, free_col] -= z[:, N:N + nf]
    x = xs * cv[None, :]
    s = z[:, N + nf:] / r[None, :]
    row_dual = y * r[None, :]
    # stationarity under the simplex sign convention, by construction
    col_dual = c2 - row_dual @ np.asarray(_base(A), np.float64)
    obj = np.einsum("bn,bn->b", c2, x)
    status[crossed] = INFEASIBLE

    # rescue pass: instances the ADAPTIVE STRAGGLER CAP cut off get ONE
    # full-budget, uncapped re-run (batch = just the stragglers)
    rescue_quality = {}
    host_fb = os.environ.get("BENSOLVE_HOST_FALLBACK", "1") != "0"
    if (not _rescue and not host_fb
            and float(os.environ.get("BENSOLVE_IPM_STRAGGLER_MULT",
                                     "2.0")) > 0):
        rs = np.array([i for i in np.flatnonzero(status == ITLIM)
                       if i not in frozen_rows], int)
        if rs.size:
            if verbose >= 2:
                print(f"lp_solve[ipm]: rescuing {rs.size} capped "
                      "instance(s) at full budget", flush=True)
            res_r = solve_batch_ipm(
                A, c2[rs], np.asarray(row_lb)[rs],
                np.asarray(row_ub)[rs], np.asarray(col_lb)[rs],
                np.asarray(col_ub)[rs], max_iter=max_iter, dtype=dtype,
                verbose=verbose, polish=polish, max_chunk=max_chunk,
                device=dev, _rescue=True)
            status[rs] = res_r.status
            obj[rs] = res_r.obj
            x[rs] = res_r.x
            s[rs] = res_r.s
            row_dual[rs] = res_r.row_dual
            col_dual[rs] = res_r.col_dual
            iters[rs] += res_r.iters
            prov[rs] = 4   # quality comes from the rescue result
            for j, i0 in enumerate(rs):
                rescue_quality[int(i0)] = int(res_r.quality[j])

    # authoritative fallback: instances the IPM could not resolve are
    # re-solved by the f64 simplex family on the same device when the
    # shape is simplex-tractable
    fb_gate = int(os.environ.get("BENSOLVE_IPM_FALLBACK_M", "2000"))
    fb = np.flatnonzero(status == ITLIM)
    if fb.size and M <= fb_gate and not host_fb:
        from bensolve_tpu_torch.lp import REVISED_RATIO
        from bensolve_tpu_torch.lp import revised as _rv

        solver = (_rv.solve_batch_revised
                  if N > REVISED_RATIO * M else sx.solve_batch)
        if verbose >= 2:
            print(f"lp_solve[ipm]: {fb.size} unresolved -> simplex "
                  "fallback", flush=True)
        res_fb = solver(A, c2[fb], np.asarray(row_lb)[fb],
                        np.asarray(row_ub)[fb], np.asarray(col_lb)[fb],
                        np.asarray(col_ub)[fb], dtype=np.float64,
                        device=dev)
        status[fb] = res_fb.status
        obj[fb] = res_fb.obj
        x[fb] = res_fb.x
        s[fb] = res_fb.s
        row_dual[fb] = res_fb.row_dual
        col_dual[fb] = res_fb.col_dual
        iters[fb] += res_fb.iters
        prov[fb] = 3

    # per-instance quality (LPResult.quality contract): polish and the
    # exact fallbacks are 0; host loose acceptances are 2; raw device
    # OPTIMALs get their quality MEASURED from the f64 KKT residuals
    tol0 = _params(dtype)[0]
    quality = np.zeros(B, np.int32)
    quality[prov == 2] = 2
    raw = np.flatnonzero((status == OPTIMAL) & (prov == 0))
    kkt_score = np.zeros(B)
    if raw.size:
        zr, yr = z[raw], y[raw]
        act = zr[:, :Nc] @ As64.T - zr[:, Nc:]
        pinf_r = np.abs(act).max(axis=1) / (
            1.0 + np.abs(zr).max(axis=1))
        rd = (c_s[raw] - np.concatenate([yr @ As64, -yr], axis=1)
              - zl[raw] + zu[raw])
        dinf_r = np.abs(np.where(l_s[raw] >= u_s[raw], 0.0, rd)).max(
            axis=1) / (1.0 + np.abs(c_s).max())
        has_lr = np.isfinite(l_s[raw]) & (l_s[raw] < u_s[raw])
        has_ur = np.isfinite(u_s[raw]) & (l_s[raw] < u_s[raw])
        with np.errstate(invalid="ignore"):
            comp = (np.where(has_lr, np.maximum(zr - l_s[raw], 0.0)
                             * zl[raw], 0.0).sum(axis=1)
                    + np.where(has_ur, np.maximum(u_s[raw] - zr, 0.0)
                               * zu[raw], 0.0).sum(axis=1))
        gap_r = comp / (1.0 + np.abs(
            np.einsum("bk,bk->b", c_s[raw], zr)))
        score = np.maximum(np.maximum(pinf_r, dinf_r), gap_r)
        kkt_score[raw] = score
        quality[raw] = np.where(score < 10 * tol0, 0,
                                np.where(score < 100 * tol0, 1, 2))
    for i0, qv in rescue_quality.items():
        quality[i0] = qv

    # terminal host fallback (default on): unresolved (ITLIM) and
    # loose- or salvaged-quality instances are re-solved EXACTLY by
    # sparse HiGHS on the host, at most 32 LPs per call
    # (BENSOLVE_HOST_FALLBACK_MAX overrides).  Every LP handed to it is
    # counted in HOST_FALLBACK, its time in HOST_FALLBACK_SECONDS.
    n_host = 0
    if host_fb and not _rescue:
        hmax = int(os.environ.get("BENSOLVE_HOST_FALLBACK_MAX", "32"))
        targets = np.flatnonzero(
            (status == ITLIM) | ((status == OPTIMAL) & (quality >= 1)))
        targets = targets[:hmax]
        n_host = int(targets.size)
        if targets.size:
            if verbose >= 2:
                print(f"lp_solve[ipm]: host HiGHS fallback for "
                      f"{targets.size} instance(s)", flush=True)
            A_csr = _sparse_A(A)
            rlb_a, rub_a = np.asarray(row_lb), np.asarray(row_ub)
            clb_a, cub_a = np.asarray(col_lb), np.asarray(col_ub)
            t_h = _time.perf_counter()
            for i in targets:
                st_i, obj_i, x_i, s_i, rd_i, cd_i = _host_highs_one(
                    A_csr, np.asarray(c2[i], np.float64),
                    np.asarray(rlb_a[i], np.float64),
                    np.asarray(rub_a[i], np.float64),
                    np.asarray(clb_a[i], np.float64),
                    np.asarray(cub_a[i], np.float64))
                HOST_FALLBACK += 1
                if st_i != ITLIM:
                    status[i] = st_i
                    obj[i] = obj_i
                    x[i] = x_i
                    s[i] = s_i
                    row_dual[i] = rd_i
                    col_dual[i] = cd_i
                    quality[i] = 0
                    prov[i] = 3
            dt = _time.perf_counter() - t_h
            HOST_FALLBACK_SECONDS += dt
            if verbose >= 2:
                print(f"lp_solve[ipm]: host fallback done in "
                      f"{dt:.1f}s", flush=True)

    if verbose >= 2:
        counts = dict(zip(*np.unique(status, return_counts=True)))
        qcounts = dict(zip(*np.unique(quality, return_counts=True)))
        print(f"lp_solve[ipm]: batch={B} statuses={counts} "
              f"quality={qcounts} iters max={int(iters.max())} "
              f"kkt max={kkt_score.max():.2e}"
              + (f" polish_skipped={n_skipped}" if n_skipped else ""),
              flush=True)
    if not _rescue:
        LAST.clear()
        LAST.update(batch=B, chunks=len(outs),
                    polished=int((prov == 1).sum()), polish_skipped=n_skipped,
                    host_fallback=n_host, past_stop=PAST_STOP - past0)
    return LPResult(status, obj, x, s, row_dual, col_dual,
                    iters, None, None, quality)
