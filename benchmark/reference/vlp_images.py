"""The plain reference for a VLP's upper and lower images (NumPy, SciPy).

It judges a solver's answer to

    min P x  w.r.t. the ordering cone C = cone(Y)   (Y = I when not given)
    s.t.     row_lb <= A x <= row_ub,  col_lb <= x <= col_ub,

given as the upper image's vertices V and extreme directions D and the
lower image's vertices W and directions Dd, under geometric duality with
the duality parameter c (c_q = 1; all ones for the standard cone): a
lower-image point y* stands for the hyperplane {y : w(y*)'y = y*_q} with
w(y*) = (y*_1, ..., y*_{q-1}, 1 - sum_{i<q} c_i y*_i).  Because c'w = 1,
a gap between two such offsets is a distance along c, the unit of
Benson's epsilon; every gap below is in that unit.

From the instance's arrays alone, with HiGHS through
``scipy.optimize.linprog``, it works out:

* ``facet_gap``: at every reported lower-image vertex, |h(w) - y*_q|
  with h(w) = min w'P x over the feasible set: each facet of the answer
  must support the upper image;
* ``vertex_gap``: at every vertex y of the polyhedron those facets
  bound, |t(y)| with t(y) = min {t : y + t c in P[X] + C}, and at every
  extreme direction d of its recession cone max(t(d), 0) over the
  recession cone of P[X] + C: the polyhedron must not reach out of the
  upper image by more than the solver's epsilon;
* ``match_gap`` and ``count_diff``: the vertices and directions of that
  polyhedron, derived from W with a convex hull (qhull), against the
  reported V, D and Dd (the lower image's only direction is -e_q): the
  answer's two representations must describe one polyhedron.

Together these say that the reported polyhedron contains the upper image
and lies within epsilon of it, and that V, D, W and Dd all describe it.
The module imports nothing of the solver and reads its answer only to
judge it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog
from scipy.spatial import ConvexHull, QhullError

# points or directions closer than this (max norm, relative to 1 + their
# size) are one; qhull's triangulated facets give each vertex many times
DEDUP = 1e-9
# |normal_q| under this marks a vertical facet of the lower image's hull
VERTICAL = 1e-9


class Feasible:
    """The feasible set X of an instance as HiGHS rows (or, homogeneous,
    its recession cone: every finite bound at zero), with the rows of
    the two LPs the reference solves over it built once."""

    def __init__(self, inst: dict, homogeneous: bool = False):
        A = np.asarray(inst["A"], float)
        P = np.asarray(inst["P"], float)
        rlb, rub = (np.asarray(inst[k], float) for k in ("row_lb", "row_ub"))
        clb, cub = (np.asarray(inst[k], float) for k in ("col_lb", "col_ub"))
        if homogeneous:
            rlb, rub, clb, cub = (np.where(np.isfinite(b), 0.0, b)
                                  for b in (rlb, rub, clb, cub))
        eq = np.isfinite(rlb) & (rlb == rub)
        up = np.isfinite(rub) & ~eq
        lo = np.isfinite(rlb) & ~eq
        self.P = P
        self.n = A.shape[1]
        A_ub = sp.csr_matrix(np.vstack([A[up], -A[lo]]))
        b_ub = np.concatenate([rub[up], -rlb[lo]])
        A_eq = sp.csr_matrix(A[eq])
        b_eq = rlb[eq]
        bounds = np.column_stack([clb, cub])
        self.support_lp = (A_ub, b_ub, A_eq, b_eq, bounds)
        # t(y): variables (x, lambda, t), rows P x + Y lambda - t c = y
        Y, c = cone_and_c(inst)
        k = Y.shape[1]
        pad = k + 1
        self.dist_lp = (
            sp.hstack([A_ub, sp.csr_matrix((A_ub.shape[0], pad))]).tocsr(),
            b_ub,
            sp.vstack([sp.hstack([A_eq, sp.csr_matrix((A_eq.shape[0], pad))]),
                       sp.csr_matrix(np.hstack([P, Y, -c[:, None]]))]).tocsr(),
            b_eq,
            np.vstack([bounds, np.tile([0.0, np.inf], (k, 1)),
                       [[-np.inf, np.inf]]]))
        self.dist_cost = np.zeros(self.n + pad)
        self.dist_cost[-1] = 1.0

    @staticmethod
    def _solve(cost, lp, extra_b=None) -> float:
        A_ub, b_ub, A_eq, b_eq, bounds = lp
        if extra_b is not None:
            b_eq = np.concatenate([b_eq, extra_b])
        res = linprog(cost, A_ub=A_ub if A_ub.shape[0] else None,
                      b_ub=b_ub if A_ub.shape[0] else None,
                      A_eq=A_eq if A_eq.shape[0] else None,
                      b_eq=b_eq if A_eq.shape[0] else None,
                      bounds=bounds, method="highs")
        if res.status == 3:
            return -np.inf
        if res.status != 0:
            raise RuntimeError(f"HiGHS: {res.message}")
        return float(res.fun)

    def support(self, w: np.ndarray) -> float:
        """h(w) = min w'P x over X (-inf where unbounded)."""
        return self._solve(self.P.T @ w, self.support_lp)

    def c_distance(self, y: np.ndarray) -> float:
        """t(y) = min {t : y + t c in P[X] + C}: the LP in (x, lambda, t)
        with P x + Y lambda - t c = y, lambda >= 0."""
        return self._solve(self.dist_cost, self.dist_lp,
                           np.asarray(y, float))


def cone_and_c(inst: dict):
    """Y (q, k), the generators of C, and c with c_q = 1."""
    q = np.asarray(inst["P"]).shape[0]
    Y = inst.get("Y")
    Y = np.eye(q) if Y is None else np.asarray(Y, float)
    c = inst.get("c")
    c = np.ones(q) if c is None else np.asarray(c, float) / float(c[-1])
    return Y, c


def _dedup(pts: np.ndarray) -> np.ndarray:
    """The first of each group of points within DEDUP of each other."""
    pts = np.atleast_2d(pts)
    scale = 1 + np.abs(pts).max(axis=1) if pts.size else np.zeros(0)
    gone = np.zeros(len(pts), bool)
    for i in range(len(pts)):
        if not gone[i]:
            d = np.abs(pts[i + 1:] - pts[i]).max(axis=1)
            gone[i + 1:] |= d <= DEDUP * np.maximum(scale[i + 1:], scale[i])
    return pts[~gone]


def normalize(dirs: np.ndarray) -> np.ndarray:
    d = np.atleast_2d(np.asarray(dirs, float))
    return d / np.abs(d).max(axis=1, keepdims=True) if d.size else d


def images_from_lower(W: np.ndarray, c: np.ndarray):
    """The upper image's vertices and extreme directions (normalised)
    from the lower image's vertices W: each upper facet of the lower
    image, y*_q = beta + alpha'y*_{<q}, is a vertex v (v_q = beta,
    v_i = alpha_i + c_i beta); each vertical facet n'y*_{<q} <= b is a
    direction (c_i b - n_i, b)."""
    W = np.atleast_2d(np.asarray(W, float))
    q = W.shape[1]
    span = 1.0 + np.abs(W).max()
    low = W.copy()
    low[:, -1] -= span
    hull = ConvexHull(np.vstack([W, low]))
    n, off = hull.equations[:, :-1], hull.equations[:, -1]
    top = n[:, -1] > VERTICAL
    beta = -off[top] / n[top, -1]
    alpha = -n[top, :-1] / n[top, -1:]
    V = np.column_stack([alpha + c[None, :-1] * beta[:, None], beta])
    side = np.abs(n[:, -1]) <= VERTICAL
    b = -off[side]
    D = np.column_stack([c[None, :-1] * b[:, None] - n[side, :-1], b])
    return _dedup(V), _dedup(normalize(D).reshape(-1, q))


def _hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    """Largest max-norm distance from a point of one set to the other
    set, relative to 1 + the point's size (inf if one set is empty and
    the other not)."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    if a.size == 0 or b.size == 0:
        return 0.0 if a.size == b.size else np.inf
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    ra = d.min(axis=1) / (1 + np.abs(a).max(axis=1))
    rb = d.min(axis=0) / (1 + np.abs(b).max(axis=1))
    return float(max(ra.max(), rb.max()))


def lp_values(inst: dict, kind: str, rows: np.ndarray) -> list[float]:
    """h(w) for each row w ("support"), t(y) for each row y ("distance")
    or t(d) over the recession cone for each row d ("recession")."""
    X = Feasible(inst, homogeneous=kind == "recession")
    f = X.support if kind == "support" else X.c_distance
    return [f(r) for r in rows]


def _map(inst, kind, rows, executor, chunks=16):
    """lp_values over ``rows``, in chunks on ``executor`` when given."""
    rows = np.atleast_2d(rows)
    if executor is None or len(rows) < 2 * chunks:
        return np.array(lp_values(inst, kind, rows)).reshape(-1)
    parts = np.array_split(rows, chunks)
    futs = [executor.submit(lp_values, inst, kind, p) for p in parts]
    return np.concatenate([np.asarray(f.result(), float) for f in futs])


def judge(inst: dict, answer: dict, executor=None) -> dict:
    """The numbers by which ``answer`` (status, V, D, W, Dd) is compared
    with the reference, for the instance ``inst`` (A, P, row_lb, row_ub,
    col_lb, col_ub, optional Y and c).  A status other than OPTIMAL reads
    1 there and inf elsewhere.  ``executor``: a concurrent.futures
    executor to spread the LPs over."""
    if answer["status"] != "OPTIMAL":
        return dict(status=1, count_diff=np.inf, match_gap=np.inf,
                    facet_gap=np.inf, vertex_gap=np.inf)
    _, c = cone_and_c(inst)
    q = c.size
    V, D, W, Dd = (np.asarray(answer[k], float).reshape(-1, q)
                   for k in ("V", "D", "W", "Dd"))
    if len(W) == 0:
        return dict(status=0, count_diff=np.inf, match_gap=np.inf,
                    facet_gap=np.inf, vertex_gap=np.inf)
    try:
        V_ref, D_ref = images_from_lower(W, c)
        down = -np.eye(q)[-1:]
        count_diff = (abs(len(V) - len(V_ref)) + abs(len(D) - len(D_ref))
                      + abs(len(Dd) - 1))
        match_gap = max(_hausdorff(V, V_ref),
                        _hausdorff(normalize(D), D_ref),
                        _hausdorff(normalize(Dd), down))
    except QhullError:
        # W bounds no polyhedron qhull can build: the two representations
        # cannot agree; the reported V and D are held to the image alone
        V_ref, D_ref = V, normalize(D)
        count_diff, match_gap = np.inf, np.inf
    Wn = np.column_stack([W[:, :-1], 1.0 - W[:, :-1] @ c[:-1]])
    h = _map(inst, "support", Wn, executor)
    facet_gap = float(np.abs(h - W[:, -1]).max())
    t = _map(inst, "distance", V_ref, executor) if len(V_ref) else [0.0]
    vertex_gap = float(np.abs(t).max())
    if len(D_ref):
        td = _map(inst, "recession", D_ref, executor)
        vertex_gap = max(vertex_gap, float(np.maximum(td, 0.0).max()))
    return dict(status=0, count_diff=count_diff,
                match_gap=float(match_gap), facet_gap=facet_gap,
                vertex_gap=vertex_gap)
