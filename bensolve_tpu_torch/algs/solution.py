"""Solution context: ordering-cone setup, duality parameter, sign
canonicalization (reference ``sol_init``, bslv_vlp.c:599-864) plus cone
vertex enumeration (reference ``cone_vertenum``, bslv_algs.c:331-407).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from bensolve_tpu_torch.poly.polytope import POLY_EPS, PolytopePair
from bensolve_tpu_torch.vlp.options import EPS_C, Options
from bensolve_tpu_torch.vlp.problem import ConeGen, VLPProblem


class SolStatus(enum.Enum):
    """Solver status (reference ``sol_status_type``, bslv_main.h:103)."""

    NOSTATUS = "no status"
    INFEASIBLE = "infeasible"
    UNBOUNDED = "unbounded"
    NOVERTEX = "no vertex"
    OPTIMAL = "optimal"
    INPUTERROR = "input error"
    ERROR = "error"   # numeric/iteration-limit LP failure (TPU-build
    #   extension: the reference asserts and aborts on unexpected LP
    #   statuses, bslv_algs.c:879; batch engines report instead)


class CDir(enum.Enum):
    POS = 1   # c_q > 0
    NEG = -1  # c_q < 0


class VLPInputError(ValueError):
    pass


def cone_vertenum(gens: np.ndarray, dim: int, *,
                  pair_out: list | None = None):
    """V-representation of a cone -> (non-redundant generators of the
    cone, generators of its dual cone), both as (q, k) column matrices.

    Runs the polytope engine with every generator flagged ideal: the
    halfspaces z_i.x >= 0 intersect to the dual cone, whose extreme rays
    come out as the ideal primal vertices, while the generators that
    survive as facets are the non-redundant ones (reference
    cone_vertenum, bslv_algs.c:331-407).  Returns None on failure (cone
    not pointed / not full-dimensional).

    ``pair_out``: optional 1-element list to receive the finished
    PolytopePair (for .cone file output).
    """
    gens = np.asarray(gens, float)
    pair = PolytopePair(dim, eps=POLY_EPS)
    # neutralize the initial dual vertex (bslv_algs.c:338-339)
    pair.dual.ideal[0] = False
    pair.dual.data[0, dim - 1] = 0.0

    for k in range(gens.shape[1]):
        pair.add_vertex(gens[:, k], ideal=True)
    if not pair.initial_approx():
        return None

    D, P = pair.dual, pair.primal
    prim_idx = [i for i in D.live() if D.ideal[i]]
    prim = D.data[prim_idx].T.copy()                 # (dim, n_prim)

    dual_idx = [i for i in P.live() if P.ideal[i]]
    dual = P.data[dual_idx].T.copy()                 # (dim, n_dual)
    for i in P.live():
        P.sltn[i] = True
    for i in D.live():
        D.sltn[i] = True

    pair.chop()
    pair.normalize_directions()
    pair.update_adjacency(pair.dual)
    if pair_out is not None:
        pair_out.append(pair)
    return prim, dual


@dataclasses.dataclass
class SolutionContext:
    """Mirror of the reference ``soltype`` (bslv_vlp.h:66-87): cone
    generator matrices Y (of C) and Z (of C*), duality parameter c,
    interior direction eta (filled by phase 0), recession-cone data R/H
    (filled by phase 1), status and solution cardinalities."""

    q: int
    Y: np.ndarray               # (q, o) generators of ordering cone C
    Z: np.ndarray               # (q, p) generators of C*, scaled Z'c = 1
    c: np.ndarray               # (q,) duality parameter, c_q = 1
    c_dir: CDir
    eta: np.ndarray             # (q,) interior point, phase 0 output
    status: SolStatus = SolStatus.NOSTATUS
    R: np.ndarray | None = None  # (q, r) dual cone of recession cone
    H: np.ndarray | None = None  # (q, h) recession cone generators
    c_out: np.ndarray | None = None  # c before sign flips (for _c.sol)
    cone_pair: object = None     # PolytopePair of the ordering cone (.cone files)
    cone_swap: bool = False
    # solution cardinalities (poly_count, bslv_algs.c:146-184)
    pp: int = 0
    pp_dir: int = 0
    dd: int = 0
    dd_dir: int = 0

    @property
    def o(self) -> int:
        return self.Y.shape[1]

    @property
    def p(self) -> int:
        return self.Z.shape[1]

    @property
    def r(self) -> int:
        return 0 if self.R is None else self.R.shape[1]

    @property
    def h(self) -> int:
        return 0 if self.H is None else self.H.shape[1]


def sol_init(vlp: VLPProblem, opt: Options) -> tuple[SolutionContext, np.ndarray]:
    """Build the solution context and the sign-canonicalized objective
    matrix P_eff (the reference mutates A_ext in place instead,
    bslv_vlp.c:856-861).  Raises VLPInputError on bad cones.

    Returns (sol, P_eff) where the canonical problem is min P_eff x
    w.r.t. cone(Y) with duality parameter c, c_q = 1 > 0."""
    q = vlp.q
    cone_pair_box: list = []
    cone_swap = False

    if vlp.cone_gen is ConeGen.CONE:
        res = cone_vertenum(vlp.gen, q, pair_out=cone_pair_box)
        cone_swap = True
        if res is None:
            raise VLPInputError("ordering cone has empty interior (1)")
        Y, Z = res
        if Z.shape[1] < q or Y.shape[1] < q:
            raise VLPInputError("ordering cone is not pointed (2)")
    elif vlp.cone_gen is ConeGen.DUALCONE:
        res = cone_vertenum(vlp.gen, q, pair_out=cone_pair_box)
        if res is None:
            raise VLPInputError("ordering cone is not pointed (1)")
        Z, Y = res
        if Z.shape[1] < q or Y.shape[1] < q:
            raise VLPInputError("ordering cone has empty interior (2)")
    else:
        Y = np.eye(q)
        Z = np.eye(q)

    # duality parameter c, scaled so that |c_q| == 1 (bslv_vlp.c:674-772)
    if vlp.cone_gen is ConeGen.DEFAULT:
        c = np.ones(q)
        c_dir = CDir.POS
    else:
        # scale columns of Y to 2-norm 1 first (bslv_vlp.c:686-696)
        Y = Y / np.linalg.norm(Y, axis=0, keepdims=True)
        c_raw = vlp.c if vlp.c is not None else np.zeros(q)
        if abs(c_raw[q - 1]) > EPS_C:
            c = c_raw / abs(c_raw[q - 1])
            c_dir = CDir.POS if c_raw[q - 1] > 0 else CDir.NEG
        else:
            c, c_dir = _generate_c(Y, q)

    # scale columns of Z such that Z'c == 1 (bslv_vlp.c:775-792)
    t = Z.T @ c
    if np.any(t < 1e-8):
        raise VLPInputError("c does not belong to interior of ordering cone")
    Z = Z / t[None, :]

    # pointed / solid validation (bslv_vlp.c:794-831)
    if vlp.cone_gen is not ConeGen.DEFAULT:
        sum_Y = Y.sum(axis=1)
        sum_Z = Z.sum(axis=1)
        if np.any(Z.T @ sum_Y < 1e-8):
            raise VLPInputError("ordering cone is not solid (4)")
        if np.any(Y.T @ sum_Z < 1e-8):
            raise VLPInputError("ordering cone is not pointed (4)")

    c_out = c.copy()  # written to <name>_c.sol BEFORE sign flips

    # canonicalize to c_q > 0 (bslv_vlp.c:845-854)
    if c_dir is CDir.NEG:
        Y = -Y
        Z = -Z
        c = -c

    # canonicalize objective sense to min with c_q > 0: flip P for
    # min/c_q<0 and for max/c_q>0 (bslv_vlp.c:856-861)
    flip = (c_dir is CDir.NEG and vlp.optdir == 1) or \
           (c_dir is CDir.POS and vlp.optdir == -1)
    P_eff = (-vlp.P if flip else vlp.P).astype(float)

    sol = SolutionContext(q=q, Y=Y, Z=Z, c=c, c_dir=c_dir,
                          eta=np.zeros(q), cone_swap=cone_swap,
                          c_out=c_out,
                          cone_pair=cone_pair_box[0] if cone_pair_box else None)
    return sol, P_eff


def _generate_c(Y: np.ndarray, q: int) -> tuple[np.ndarray, CDir]:
    """Auto-generate the duality parameter when c_q ~ 0
    (bslv_vlp.c:704-771): combine the cone generators with positive and
    non-positive last components so the result has |c_q| as large as
    practical, then scale."""
    last = Y[q - 1]
    pos = last > 0
    k1 = int(pos.sum())
    k2 = Y.shape[1] - k1
    mx = float(last[pos].max()) if k1 else 0.0
    mn = float(last[~pos].min()) if k2 else 0.0
    tmp1 = Y[:, pos].sum(axis=1)
    tmp2 = Y[:, ~pos].sum(axis=1)

    if k1 == 0 and mn < EPS_C:
        c_dir = CDir.NEG
        c = tmp2 / abs(tmp2[q - 1])
    elif k2 == 0 and mx > EPS_C:
        c_dir = CDir.POS
        c = tmp1 / abs(tmp1[q - 1])
    elif mn < -EPS_C or mx > EPS_C:
        if -mn > mx:
            c_dir = CDir.NEG
            lam = 0.2 * (-mn / (mx - mn))
        else:
            c_dir = CDir.POS
            lam = 0.8 - 0.2 * mn / (mx - mn)
        c = lam * tmp1 / max(k1, 1) + (1 - lam) * tmp2 / max(k2, 1)
        c = c / abs(c[q - 1])
    else:
        raise VLPInputError("ordering cone is not solid (3)")
    return c, c_dir
