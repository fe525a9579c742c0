"""Problem-layer data structures.

Dense, array-first equivalents of the reference's ``vlptype``
(bslv_vlp.h:47-64): the constraint matrix A, objective matrix P, typed
row/column bounds and optional ordering-cone generators.  The reference
keeps a sparse COO triplet list of the extended matrix
``A_ext = (A 0; -P I)`` (bslv_vlp.c:376-382); we keep A and P as dense
float64 arrays and assemble LP templates on demand
(``bensolve_tpu_torch.algs.templates``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

# GLPK-style bound types, see bslv_lp.c:34-43:
#   'f' free, 'l' lower, 'u' upper, 'd' double-bounded, 's' fixed
VALID_BOUND_TYPES = frozenset("fluds")


class ConeGen(enum.Enum):
    """How the ordering cone is specified (bslv_main.h ``_cone_gen_type``)."""

    DEFAULT = 0   # standard cone R^q_+
    CONE = 1      # generators of C given
    DUALCONE = 2  # generators of C* given


@dataclasses.dataclass
class Bounds:
    """Typed bounds for rows or columns (reference ``boundlist``,
    bslv_lists.h:26-38).

    ``types`` holds the original GLPK-style type characters; ``lb``/``ub``
    the numeric bounds with +-inf for absent sides.  The homogeneous
    variant (used by phase 0/1 LPs) maps 'd'/'s' to fixed-at-zero and
    'l'/'u' to one-sided-at-zero (bslv_lp.c:36 ``type_hom``).
    """

    types: np.ndarray  # (k,) of '<U1'
    lb: np.ndarray     # (k,) float64
    ub: np.ndarray     # (k,) float64

    @classmethod
    def from_typed(cls, types, lb_raw, ub_raw) -> "Bounds":
        """Build numeric lb/ub (+-inf filled) from type chars + raw numbers."""
        types = np.asarray(types, dtype="<U1")
        lb_raw = np.asarray(lb_raw, dtype=np.float64)
        ub_raw = np.asarray(ub_raw, dtype=np.float64)
        lb = np.where(np.isin(types, list("lds")), lb_raw, -np.inf)
        ub = np.where(np.isin(types, list("du")), ub_raw, np.inf)
        ub = np.where(types == "s", lb_raw, ub)  # fixed: ub = lb
        return cls(types=types, lb=lb, ub=ub)

    def homogeneous(self) -> "Bounds":
        """Bounds of the homogeneous problem: same structure, zero data
        (bslv_lp.c:118-122, 130-134)."""
        lb = np.where(np.isin(self.types, list("lds")), 0.0, -np.inf)
        ub = np.where(np.isin(self.types, list("uds")), 0.0, np.inf)
        return Bounds(types=self.types.copy(), lb=lb, ub=ub)

    def __len__(self) -> int:
        return len(self.types)


@dataclasses.dataclass
class VLPProblem:
    """A vector linear program

        min/max  P x   (w.r.t. ordering cone C)
        s.t.     row_bounds ∋ A x,   col_bounds ∋ x

    Mirrors the reference ``vlptype`` (bslv_vlp.h:47-64) with dense data.
    ``P`` is stored exactly as given in the input (the canonical sign
    normalization to a min/c_q>0 problem happens in
    ``bensolve_tpu_torch.algs.solution.SolutionContext``, mirroring
    bslv_vlp.c:845-861).
    """

    A: np.ndarray                 # (m, n) float64
    P: np.ndarray                 # (q, n) float64
    rows: Bounds                  # m row bounds
    cols: Bounds                  # n column bounds
    optdir: int = 1               # +1 min, -1 max
    cone_gen: ConeGen = ConeGen.DEFAULT
    gen: np.ndarray | None = None  # (q, n_gen) generators of C or C*
    c: np.ndarray | None = None    # (q,) duality parameter (raw, unscaled)
    nz: int = 0                    # nonzeros of A as declared in the file
    nzobj: int = 0                 # nonzeros of P as declared in the file

    @property
    def m(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[1]

    @property
    def q(self) -> int:
        return self.P.shape[0]

    @property
    def n_gen(self) -> int:
        return 0 if self.gen is None else self.gen.shape[1]

    def validate(self) -> None:
        assert self.A.shape == (self.m, self.n)
        assert self.P.shape == (self.q, self.n)
        assert len(self.rows) == self.m
        assert len(self.cols) == self.n
        assert self.optdir in (1, -1)
        if self.cone_gen is not ConeGen.DEFAULT:
            assert self.gen is not None and self.gen.shape[0] == self.q

    @classmethod
    def from_arrays(
        cls,
        *,
        P,
        A=None,
        a=None,  # row lower bounds (lhs), reference prob2vlp.m field 'a'
        b=None,  # row upper bounds (rhs), field 'b'
        l=None,  # column lower bounds, field 'l'
        s=None,  # column upper bounds, field 's' (alias 'ub')
        Y=None,  # generators of ordering cone C
        Z=None,  # generators of dual cone C*
        c=None,  # duality parameter vector
        opt_dir: int = 1,
    ) -> "VLPProblem":
        """Python analogue of the MATLAB front end ``ex/prob2vlp.m``:
        build a :class:`VLPProblem` from the struct fields
        ``{B,a,b,l,s,P,Y,Z,c,opt_dir}`` (matrix B is called A here).

        Missing bound sides are +-inf.  Y/Z are (q, k) arrays of cone /
        dual-cone generators (mutually exclusive).
        """
        P = np.atleast_2d(np.asarray(P, dtype=np.float64))
        q, n = P.shape
        if A is None:
            A = np.zeros((0, n))
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        m = A.shape[0]

        def _side(v, k, fill):
            if v is None:
                return np.full(k, fill)
            v = np.asarray(v, dtype=np.float64).reshape(-1)
            assert v.shape == (k,)
            return v

        rlb = _side(a, m, -np.inf)
        rub = _side(b, m, np.inf)
        clb = _side(l, n, -np.inf)
        cub = _side(s, n, np.inf)

        def _mk(lb, ub):
            types = np.empty(len(lb), dtype="<U1")
            for i, (lo, hi) in enumerate(zip(lb, ub)):
                if np.isfinite(lo) and np.isfinite(hi):
                    types[i] = "s" if lo == hi else "d"
                elif np.isfinite(lo):
                    types[i] = "l"
                elif np.isfinite(hi):
                    types[i] = "u"
                else:
                    types[i] = "f"
            return Bounds(types=types, lb=np.asarray(lb), ub=np.asarray(ub))

        if Y is not None and Z is not None:
            raise ValueError("give generators of C (Y) or of C* (Z), not both")
        cone_gen, gen = ConeGen.DEFAULT, None
        if Y is not None:
            cone_gen, gen = ConeGen.CONE, np.atleast_2d(np.asarray(Y, np.float64))
        elif Z is not None:
            cone_gen, gen = ConeGen.DUALCONE, np.atleast_2d(np.asarray(Z, np.float64))
        if gen is not None and gen.shape[0] != q:
            gen = gen.T
        cvec = None if c is None else np.asarray(c, np.float64).reshape(q)

        prob = cls(
            A=A,
            P=P,
            rows=_mk(rlb, rub),
            cols=_mk(clb, cub),
            optdir=int(opt_dir),
            cone_gen=cone_gen,
            gen=gen,
            c=cvec,
            nz=int(np.count_nonzero(A)),
            nzobj=int(np.count_nonzero(P)),
        )
        prob.validate()
        return prob
