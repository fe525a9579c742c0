"""Dual-pair polytope engine: online vertex enumeration by incremental
halfspace cutting.

This is the TPU build's replacement for the reference's pointer-graph
geometry core (bslv_poly.c).  It maintains a mutually dual pair of
polytopes:

* ``primal`` — vertices of the current outer approximation.  Entries
  flagged *ideal* are points at infinity (extreme directions).
* ``dual`` — one vertex per supporting halfspace of the primal (the
  facets), stored as vertices of the geometric-dual polytope.

Adding a dual vertex y* (``PolytopePair.add_vertex``) maps it through a
vertex-to-hyperplane transform ``v2h`` (the geometric-duality coupling,
bslv_algs.c:287-313) and cuts the primal polytope with the resulting
halfspace {v : h.v >= rhs}, where rhs is h[dim] for ordinary vertices and
0 for ideal ones (bslv_poly.c:104-151, 562-709).

Design differences from the reference (same math, array-first layout):

* vertex coordinates live in growable (cap, dim) float64 arrays with
  boolean masks ``used``/``ideal``/``sltn`` instead of bit-packed words;
* the cut classifies *all* vertices against the hyperplane in one
  matvec (``classify``), instead of discovering them one by one during
  the recursive graph walk; the walk itself (which vertices to touch,
  where to interpolate) is preserved because reachability through the
  adjacency graph is part of the reference's semantics;
* hyperplane transforms are vectorized callables over arrays.

Epsilon semantics are the reference's exactly: a vertex with signed
slack s = h.v - rhs is
  IN     if s >  +eps            (kept; cut edges to OUT vertices)
  NEAR   if +0.01*eps < s <= eps (projected onto the plane, then treated
                                  as ON; bslv_poly.c:666-674)
  ON     if -eps < s <= +0.01*eps(duplicated onto the new facet;
                                  bslv_poly.c:573-588)
  OUT    if s <= -eps            (removed)
with eps = POLY_EPS = 1e-9 by default (bslv_poly.h:47).
"""

from __future__ import annotations

import numpy as np

from bensolve_tpu_torch import native as _native

POLY_EPS = 1e-9
INIT_RANK_EPS = 1e-10    # rank threshold of the initial approx (bslv_poly.c:174)
GS_DEGENERATE_EPS = 1e-6  # Gram-Schmidt degeneracy (bslv_poly.c:1045)


class _RowView:
    """List-like live view of one native adjacency/incidence row."""

    __slots__ = ("_p", "_w", "_i")

    def __init__(self, p: "Polytope", which: int, i: int):
        self._p, self._w, self._i = p, which, i

    def _fetch(self) -> np.ndarray:
        p = self._p
        n = p._L.poly_row_len(p._h, self._w, self._i)
        out = np.empty(n, np.int32)
        if n:
            p._L.poly_row_get(p._h, self._w, self._i, out.ctypes.data)
        return out

    def __len__(self) -> int:
        p = self._p
        return p._L.poly_row_len(p._h, self._w, self._i)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self):
        return iter(self._fetch().tolist())

    def __contains__(self, x) -> bool:
        return int(x) in self._fetch()

    def __getitem__(self, j):
        return int(self._fetch()[j])

    def __eq__(self, other):
        return list(self) == list(other)

    def append(self, x: int) -> None:
        p = self._p
        p._L.poly_row_append(p._h, self._w, self._i, int(x))


class _Rows:
    """Container proxy exposing the native rows as ``poly.adj[i]`` /
    ``poly.inc[i]`` with list semantics."""

    __slots__ = ("_p", "_w")

    def __init__(self, p: "Polytope", which: int):
        self._p, self._w = p, which

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [list(self[j]) for j in range(*i.indices(self._p.cnt))]
        return _RowView(self._p, self._w, int(i))

    def __setitem__(self, i, vals) -> None:
        arr = np.ascontiguousarray(list(vals), dtype=np.int32)
        self._p._L.poly_row_set(self._p._h, self._w, int(i),
                                arr.ctypes.data if arr.size else None,
                                arr.size)


class Polytope:
    """One side of a dual polytope pair (reference struct ``polytope``,
    bslv_poly.h:55-69).  Slots are append-only: removing a vertex clears
    its ``used`` bit but indices are never recycled, matching the
    reference's allocator.

    Vertex coordinates and the used/ideal/sltn masks are numpy buffers;
    the adjacency and facet-incidence lists (and the graph surgery over
    them) live in the native C++ engine when it is available
    (bensolve_tpu_torch/native/poly_engine.cpp), sharing these buffers by
    pointer.  Set BENSOLVE_TPU_NO_NATIVE=1 for the pure-Python engine."""

    def __init__(self, dim: int, dim_primg: int = 0, cap: int = 64):
        self.dim = dim
        self.dim_primg = dim_primg
        self._h = None
        self._cnt = 0
        self.data = np.zeros((cap, dim))
        self.primg = np.zeros((cap, max(dim_primg, 1)))
        self.used = np.zeros(cap, dtype=bool)
        self.ideal = np.zeros(cap, dtype=bool)
        self.sltn = np.zeros(cap, dtype=bool)
        self._L = _native.lib()
        if self._L is not None:
            self._h = self._L.poly_new(dim)
            self._rebind()
            self.adj = _Rows(self, 0)
            self.inc = _Rows(self, 1)
        else:
            self.adj: list[list[int]] = [[] for _ in range(cap)]
            self.inc: list[list[int]] = [[] for _ in range(cap)]
        self.dual: "Polytope" | None = None

    def __del__(self):
        if getattr(self, "_h", None):
            self._L.poly_delete(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._h is not None

    @property
    def cnt(self) -> int:
        if self._h:
            return self._L.poly_cnt(self._h)
        return self._cnt

    @cnt.setter
    def cnt(self, v: int) -> None:
        if self._h:
            self._L.poly_set_cnt(self._h, int(v))
        else:
            self._cnt = int(v)

    def _rebind(self) -> None:
        """(Re)share the numpy buffers with the native engine — after
        construction, growth, or buffer replacement (checkpoint load)."""
        if not self._h:
            return
        for name in ("data", "primg"):
            arr = getattr(self, name)
            if not arr.flags.c_contiguous:
                setattr(self, name, np.ascontiguousarray(arr))
        self._L.poly_bind(
            self._h, self.data.ctypes.data, self.primg.ctypes.data,
            self.primg.shape[1], self.used.ctypes.data,
            self.ideal.ctypes.data, self.sltn.ctypes.data, self.cap)

    # -- storage ----------------------------------------------------------
    @property
    def cap(self) -> int:
        return self.data.shape[0]

    def _grow(self, need: int | None = None) -> None:
        cap = self.cap
        extra = cap
        if need is not None:
            extra = max(extra, need - cap)
        self.data = np.concatenate([self.data, np.zeros((extra, self.dim))])
        self.primg = np.concatenate([self.primg, np.zeros((extra, self.primg.shape[1]))])
        for arr_name in ("used", "ideal", "sltn"):
            arr = getattr(self, arr_name)
            setattr(self, arr_name, np.concatenate([arr, np.zeros(extra, bool)]))
        if self._h:
            self._rebind()
        else:
            self.adj.extend([] for _ in range(extra))
            self.inc.extend([] for _ in range(extra))

    def _ensure(self, need: int) -> None:
        if need > self.cap:
            self._grow(need)

    def append(self) -> int:
        """Claim the next slot (reference ``add_vrtx``, bslv_poly.c:416)."""
        if self.cnt == self.cap:
            self._grow()
        if self._h:
            return self._L.poly_append(self._h)
        k = self.cnt
        self.cnt += 1
        self.used[k] = True
        self.ideal[k] = False
        self.sltn[k] = False
        self.adj[k] = []
        self.inc[k] = []
        return k

    # -- queries ----------------------------------------------------------
    def live(self) -> np.ndarray:
        """Indices of used slots, ascending (= output permutation order,
        reference poly__initialise_permutation, bslv_poly.c:314)."""
        return np.flatnonzero(self.used[: self.cnt])

    def frontier(self) -> np.ndarray:
        """Used but not yet marked as solution (poly__get_vrtx scan order,
        bslv_poly.c:210-226) — the batch the Benson loops process."""
        return np.flatnonzero(self.used[: self.cnt] & ~self.sltn[: self.cnt])


def edge_test(poly: Polytope, v1: int, v2: int) -> bool:
    """Combinatorial adjacency test (reference bslv_poly.c:467-512):
    v1, v2 are adjacent iff they share >= dim-1 facets and no third
    vertex is incident to all of those shared facets."""
    if poly.native:
        return bool(poly._L.poly_edge_test(poly._h, int(v1), int(v2)))
    if poly.dim == 1:
        return True
    f1 = set(poly.inc[v1])
    mutual = [f for f in poly.inc[v2] if f in f1]
    if len(mutual) < poly.dim - 1:
        return False
    others = [u for u in poly.dual.inc[mutual[0]] if u != v1 and u != v2]
    for f in mutual[1:]:
        if not others:
            break
        fv = set(poly.dual.inc[f])
        others = [u for u in others if u in fv]
    return not others


class PolytopePair:
    """The working pair plus cut/initialisation state (reference
    ``poly_args``, bslv_poly.h:71-88).

    ``dual_v2h(vals, ideal) -> (k, dim+1)`` maps dual vertices to primal
    halfspaces; ``primal_v2h`` the other way (only used by ``swap``).
    """

    def __init__(self, dim: int, *, eps: float = POLY_EPS,
                 dim_primg_primal: int = 0, dim_primg_dual: int = 0,
                 dual_v2h=None, primal_v2h=None):
        self.dim = dim
        self.eps = eps
        self.dual_v2h = dual_v2h if dual_v2h is not None else cone_polar_v2h
        self.primal_v2h = primal_v2h
        self.primal = Polytope(dim, dim_primg_primal)
        self.dual = Polytope(dim, dim_primg_dual)
        self.primal.dual = self.dual
        self.dual.dual = self.primal
        if self.primal.native:
            self.primal._L.poly_set_dual(self.primal._h, self.dual._h)

        # initial dual vertex: the ideal direction -e_q of the lower image
        # (bslv_poly.c:83-92)
        k = self.dual.append()
        self.dual.data[k] = 0.0
        self.dual.data[k, dim - 1] = -1.0
        self.dual.ideal[k] = True

        self._queue: list[int] = []   # dual vertices queued before init
        self.initialised = False
        self.last_added: int | None = None  # facet slot of the last cut

    # -- hyperplane helpers ------------------------------------------------
    def _hp_of_dual(self, idx: int) -> np.ndarray:
        return self.dual_v2h(self.dual.data[idx][None],
                             self.dual.ideal[idx][None])[0]

    def classify(self, hp: np.ndarray) -> np.ndarray:
        """Signed slack h.v - rhs(v) of every slot (garbage where unused);
        rhs is hp[dim] for points, 0 for ideal vertices."""
        P = self.primal
        s = P.data[: P.cnt] @ hp[: self.dim]
        rhs = np.where(P.ideal[: P.cnt], 0.0, hp[self.dim])
        return s - rhs

    # -- vertex insertion --------------------------------------------------
    def add_vertex(self, val, ideal: bool = False, primg=None) -> bool:
        """Add a dual vertex / cut the primal with its halfspace
        (reference poly__add_vrtx, bslv_poly.c:104-151).  Returns False
        if the cut is redundant (no primal vertex violates it), in which
        case the dual vertex is discarded."""
        D = self.dual
        k = D.append()
        D.data[k] = np.asarray(val, float)
        D.ideal[k] = bool(ideal)
        self.last_added = k   # facet slot, for callers tracking cut origins
        if primg is not None and D.dim_primg:
            D.primg[k, : D.dim_primg] = np.asarray(primg, float)

        if not self.initialised:
            self._queue.append(k)
            return True

        hp = self._hp_of_dual(k)
        slack = self.classify(hp)
        live = self.primal.used[: self.primal.cnt]
        violated = np.flatnonzero(live & (slack < -self.eps))
        if violated.size == 0:
            D.used[k] = False  # redundant halfspace
            self.last_added = None
            return False
        self._cut(int(violated[0]), hp)
        self._wire_new_facet_adjacency(k)
        return True

    def _wire_new_facet_adjacency(self, facet: int) -> None:
        """Adjacency among the new facet's incident vertices
        (bslv_poly.c:138-143)."""
        P = self.primal
        if P.native:
            P._L.poly_wire_new_facet(P._h, int(facet))
            return
        members = self.dual.inc[facet]
        for a_i in range(len(members)):
            for b_i in range(a_i):
                va, vb = members[a_i], members[b_i]
                if edge_test(self.primal, va, vb):
                    self.primal.adj[va].append(vb)
                    self.primal.adj[vb].append(va)

    # -- the cut -----------------------------------------------------------
    def _cut(self, v: int, hp: np.ndarray) -> None:
        """Remove the part of the primal polytope cut off by halfspace
        ``hp``, starting from violated vertex ``v`` (reference poly__cut,
        bslv_poly.c:562-709).  Depth-first like the reference: the
        recursion happens mid-way through a vertex's adjacency scan, so
        visit order (and thus slot numbering) matches."""
        P = self.primal
        D = self.dual
        dim = self.dim
        eps = self.eps
        if P.native:
            # pre-grow: a cut appends at most (adjacency nnz + 1) vertices
            P._ensure(P.cnt + int(P._L.poly_nnz(P._h, 0)) + dim + 8)
            hp_arr = np.ascontiguousarray(hp, dtype=float)
            rc = P._L.poly_cut(P._h, int(v), hp_arr.ctypes.data, float(eps))
            if rc != 0:
                raise RuntimeError("native poly_cut: capacity overflow")
            return
        newf = D.cnt - 1  # the facet being inserted
        hn = hp[:dim]
        hd = hp[dim]

        def slack_of(i: int) -> float:
            rhs = 0.0 if P.ideal[i] else hd
            return float(hn @ P.data[i]) - rhs

        def rec(v: int):
            # generator-based DFS frame: ``yield k`` recurses into k at
            # exactly this point of the adjacency scan (trampolined below
            # to avoid Python's recursion limit on deep cut cascades)
            P.used[v] = False
            s_v = slack_of(v)
            on_plane = s_v > -eps
            v_out = -1
            if on_plane:
                # duplicate v onto the new facet (bslv_poly.c:573-588)
                v_out = P.append()
                P.data[v_out] = P.data[v]
                P.ideal[v_out] = P.ideal[v]
                if P.sltn[v]:
                    P.sltn[v_out] = True
                    P.primg[v_out] = P.primg[v]
                D.inc[newf].append(v_out)
                P.inc[v_out].append(newf)

            for k in list(P.adj[v]):
                if not P.used[k]:
                    continue
                s_k = slack_of(k)
                if s_k > eps:
                    # IN neighbour: interpolate a new vertex on the edge
                    # unless v sits on the plane (then reuse its copy)
                    if not on_plane:
                        v_out = P.append()
                        vi, ki = bool(P.ideal[v]), bool(P.ideal[k])
                        pv, pk = P.data[v], P.data[k]
                        if ki and vi:
                            start, drctn, rhs_t, ideal_new = pv, pk - pv, 0.0, True
                        elif ki:
                            start, drctn, rhs_t, ideal_new = pv, pk, hd, False
                        elif vi:
                            start, drctn, rhs_t, ideal_new = pk, pv, hd, False
                        else:
                            start, drctn, rhs_t, ideal_new = pk, pv - pk, hd, False
                        mu = (rhs_t - hn @ start) / (hn @ drctn)
                        P.data[v_out] = start + mu * drctn
                        P.ideal[v_out] = ideal_new
                        D.inc[newf].append(v_out)
                        P.inc[v_out].append(newf)
                    # relink the edge (v,k) -> (v_out,k)
                    ak = P.adj[k]
                    for j, u in enumerate(ak):
                        if u == v:
                            ak[j] = v_out
                            break
                    P.adj[v_out].append(k)
                    # v_out joins every facet shared by v and k
                    inc_v = P.inc[v]
                    for f in P.inc[k]:
                        if f not in inc_v:
                            continue
                        if on_plane and f in P.inc[v_out]:
                            continue
                        P.inc[v_out].append(f)
                        df = D.inc[f]
                        for j, u in enumerate(df):
                            if u == v:
                                df[j] = v_out
                                break
                        else:
                            df.append(v_out)
                elif s_k > 0.01 * eps:
                    # NEAR: project k onto the plane, then cut it (it will
                    # take the duplicate path) — bslv_poly.c:666-674
                    P.data[k] = P.data[k] - (s_k / (hn @ hn)) * hn
                    yield k
                else:
                    # OUT (or on-plane from below): unlink from v, drop v
                    # from k's facets, recurse — bslv_poly.c:675-693
                    ak = P.adj[k]
                    for j, u in enumerate(ak):
                        if u == v:
                            ak[j] = ak[-1]
                            ak.pop()
                            break
                    for f in P.inc[k]:
                        df = D.inc[f]
                        for j, u in enumerate(df):
                            if u == v:
                                df[j] = df[-1]
                                df.pop()
                                break
                        if not df:
                            D.used[f] = False
                    if P.used[k]:
                        yield k

            # detach v from its facets; facets left empty die
            # (bslv_poly.c:697-705)
            for f in P.inc[v]:
                df = D.inc[f]
                if df:
                    for j, u in enumerate(df):
                        if u == v:
                            df[j] = df[-1]
                            df.pop()
                            break
                else:
                    D.used[f] = False

        frames = [rec(v)]
        while frames:
            try:
                frames.append(rec(next(frames[-1])))
            except StopIteration:
                frames.pop()

    # -- initial approximation --------------------------------------------
    def initial_approx(self) -> bool:
        """Build the first full-dimensional outer approximation from the
        queued halfspaces (reference poly__intl_apprx + poly__poly_initialise,
        bslv_poly.c:153-208, 711-787):

        1. greedily pick ``dim`` queued halfspaces with maximal orthogonal
           residual (Gram-Schmidt rank test);
        2. construct the initial polytope: one real vertex p solving
           N p = alpha plus ``dim`` ideal directions d_k = N^{-1} e_k
           (so normal_i . d_k = delta_ik), complete incidence/adjacency;
        3. replay the leftover queued halfspaces through the normal
           cut path.

        Returns False if fewer than ``dim`` independent halfspaces are
        available (cone not pointed / approximation rank-deficient)."""
        dim = self.dim
        if len(self._queue) < dim:
            return False
        queue = list(self._queue)
        hps = self.dual_v2h(self.dual.data[queue],
                            self.dual.ideal[queue])  # (k, dim+1)

        chosen: list[int] = []       # positions within `queue`
        basis = np.zeros((dim, dim))  # orthonormalized normals
        nb = 0
        while nb < dim:
            normals = hps[:, :dim]
            resid = normals - (normals @ basis[:nb].T) @ basis[:nb]
            rnorm = np.linalg.norm(resid, axis=1)
            denom = np.linalg.norm(normals, axis=1)
            ratio = np.where(
                (denom > 0) & (rnorm >= GS_DEGENERATE_EPS),
                rnorm / np.where(denom > 0, denom, 1.0), 0.0)
            ratio[chosen] = -np.inf
            best = int(np.argmax(ratio))
            if ratio[best] < INIT_RANK_EPS:
                return False
            basis[nb] = resid[best] / rnorm[best]
            chosen.append(best)
            nb += 1

        N = hps[chosen][:, :dim]       # (dim, dim) chosen normals
        alph = hps[chosen][:, dim]
        Ninv = np.linalg.inv(N)
        p0 = Ninv @ alph

        P = self.primal
        D = self.dual
        k0 = P.append()
        P.data[k0] = p0
        for k in range(dim):
            kk = P.append()
            P.data[kk] = Ninv[:, k]
            P.ideal[kk] = True

        # complete incidence and adjacency (bslv_poly.c:769-780): the
        # facet list is perm = [0, chosen...] where dual vertex 0 is the
        # implicit facet-at-infinity holding all ideal vertices; facet
        # perm[k] contains every initial vertex except k, and the dim+1
        # initial vertices form a complete adjacency graph.
        facet_ids = [queue[c] for c in chosen]
        perm = [0] + facet_ids
        for j in range(dim + 1):
            P.adj[j] = [u for u in range(dim + 1) if u != j]
        for k in range(dim + 1):
            for j in range(dim + 1):
                if j != k:
                    D.inc[perm[k]].append(j)
                    P.inc[j].append(perm[k])

        self.initialised = True
        leftovers = [qi for pos, qi in enumerate(queue) if pos not in chosen]
        # leftover queued halfspaces re-enter through the cut path
        # (bslv_poly.c:190-197): their dual slots are released and re-added
        for qi in leftovers:
            D.used[qi] = False
        for qi in leftovers:
            self.add_vertex(D.data[qi].copy(), bool(D.ideal[qi]),
                            D.primg[qi, : D.dim_primg] if D.dim_primg else None)
        self._queue = []
        return True

    # -- maintenance / output helpers -------------------------------------
    def update_adjacency(self, poly: Polytope) -> None:
        """All-pairs adjacency rebuild via edge_test (reference
        poly__update_adjacence, bslv_poly.c:992-1010); used on the dual
        (facet graph) before writing output."""
        if poly.native:
            poly._L.poly_update_adjacency(poly._h)
            return
        live = poly.live()
        for a_i in range(len(live)):
            for b_i in range(a_i):
                va, vb = int(live[a_i]), int(live[b_i])
                if edge_test(poly, vb, va):
                    poly.adj[vb].append(va)
                    poly.adj[va].append(vb)

    def chop(self, eps_chop: float = 1e-10) -> None:
        """Zero near-zero output entries (poly_chop, bslv_algs.c:186-208)."""
        for poly in (self.primal, self.dual):
            live = poly.live()
            d = poly.data[live]
            d[np.abs(d) < eps_chop] = 0.0
            poly.data[live] = d
            if poly.dim_primg:
                g = poly.primg[live]
                g[np.abs(g) < eps_chop] = 0.0
                poly.primg[live] = g

    def normalize_directions(self) -> None:
        """Scale ideal vertices to inf-norm 1 (poly_normalize_dir,
        bslv_algs.c:244-279)."""
        for poly in (self.primal, self.dual):
            idx = np.flatnonzero(poly.used[: poly.cnt] & poly.ideal[: poly.cnt])
            for i in idx:
                mx = np.max(np.abs(poly.data[i]))
                poly.data[i] = poly.data[i] / mx if mx > 1e-9 else 0.0

    def check(self) -> list[str]:
        """Invariant checker (reference poly__polyck, bslv_poly.c:940-990).
        Returns a list of violation messages (empty = healthy):
        1. every facet hyperplane contains its incident vertices (1e-6);
        2. incidence symmetry between the pair;
        3. adjacency symmetry;
        4. adjacency completeness against edge_test."""
        errs: list[str] = []
        P, D = self.primal, self.dual
        for f in D.live():
            hp = self._hp_of_dual(int(f))
            for v in D.inc[f]:
                rhs = 0.0 if P.ideal[v] else hp[self.dim]
                val = abs(float(hp[: self.dim] @ P.data[v]) - rhs)
                if val > 1e-6:
                    errs.append(f"hyperplane {f} does not contain vertex {v} "
                                f"(residual {val:.2e})")
                if f not in P.inc[v]:
                    errs.append(f"incidence asymmetry: facet {f}, vertex {v}")
        for v in P.live():
            for u in P.adj[v]:
                if v not in P.adj[u]:
                    errs.append(f"adjacency asymmetry: {u} vs {v}")
        if P.native:
            miss = int(P._L.poly_count_missing_adj(P._h))
            if miss:
                errs.append(f"{miss} missing adjacency pair(s)")
            return errs
        live = P.live()
        for a_i in range(len(live)):
            for b_i in range(a_i):
                va, vb = int(live[a_i]), int(live[b_i])
                if edge_test(P, va, vb) and vb not in P.adj[va]:
                    errs.append(f"missing adjacency {va},{vb}")
        return errs

    def swap(self, out: "PolytopePair") -> None:
        """Rebuild the pair with primal/dual roles exchanged (reference
        poly__swap, bslv_poly.c:836-866): seed ``out`` with the facets of
        one non-ideal dual vertex, initialise, then re-add every primal
        vertex of ``self`` as a dual vertex of ``out``."""
        for idx in self.dual.live():
            if self.dual.ideal[idx]:
                continue
            for f in self.dual.inc[idx]:
                out.add_vertex(self.primal.data[f].copy(),
                               bool(self.primal.ideal[f]))
            break
        out.initial_approx()
        for idx in self.primal.live():
            out.add_vertex(self.primal.data[idx].copy(),
                           bool(self.primal.ideal[idx]))


# -- vertex-to-hyperplane transforms (bslv_algs.c:287-329, bslv_poly.c:30) --

def cone_polar_v2h(vals: np.ndarray, ideal: np.ndarray) -> np.ndarray:
    """Polar-cone map: dual point z -> halfspace {x : z.x >= rhs} with
    rhs = -1 for points, 0 for directions (reference ``cone_polar``,
    bslv_poly.c:30-39)."""
    k, dim = vals.shape
    hp = np.empty((k, dim + 1))
    hp[:, :dim] = vals
    hp[:, dim] = np.where(ideal, 0.0, -1.0)
    return hp


def make_lower_to_upper_v2h(c: np.ndarray):
    """Map a lower-image vertex y* to a supporting hyperplane of the
    upper image (reference ``lowerV2upperH``, bslv_algs.c:287-305):
    normal (y*_1..y*_{q-1}, 1 - sum c_i y*_i), rhs y*_q; directions map
    to the trivial halfspace 0.y >= -1."""
    c = np.asarray(c, float)

    def v2h(vals: np.ndarray, ideal: np.ndarray) -> np.ndarray:
        k, dim = vals.shape
        hp = np.zeros((k, dim + 1))
        hp[:, : dim - 1] = vals[:, : dim - 1]
        hp[:, dim - 1] = 1.0 - vals[:, : dim - 1] @ c[: dim - 1]
        hp[:, dim] = vals[:, dim - 1]
        hp[ideal] = 0.0
        hp[ideal, dim] = -1.0
        return hp

    return v2h


def make_upper_to_lower_v2h(c: np.ndarray):
    """Map an upper-image vertex y to a supporting hyperplane of the
    lower image (reference ``upperV2lowerH``, bslv_algs.c:307-313):
    normal (y_1 - y_q c_1, ..., y_{q-1} - y_q c_{q-1}, -1 resp. 0 for
    directions), rhs -y_q."""
    c = np.asarray(c, float)

    def v2h(vals: np.ndarray, ideal: np.ndarray) -> np.ndarray:
        k, dim = vals.shape
        hp = np.zeros((k, dim + 1))
        hp[:, : dim - 1] = vals[:, : dim - 1] - vals[:, dim - 1:dim] * c[: dim - 1]
        hp[:, dim - 1] = np.where(ideal, 0.0, -1.0)
        hp[:, dim] = -vals[:, dim - 1]
        return hp

    return v2h
