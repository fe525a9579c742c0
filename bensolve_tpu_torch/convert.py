"""State carried across from the JAX package, as numpy arrays.

The two packages share no objects (importing ``bensolve_tpu`` would
import JAX), so whatever one hands to the other goes through numpy:

* ``problem_from_numpy`` / ``problem_from_reference`` build this
  package's VLPProblem from the JAX package's problem fields, so both
  solve the same problem; ``problems_from_reference`` does so for a
  list (the input of ``algs.many.solve_many``);
* a checkpoint needs no conversion: ``io/checkpoint.py`` writes and
  reads the JAX package's ``.npz`` keys, so ``solve(resume=path)`` of
  either package takes a snapshot written by the other;
* ``kept_state_from_numpy`` and ``warm_from_result`` turn a JAX
  ``KeptState`` or an ``LPResult`` warm start into this package's
  tensors and arrays, so both can start a dual-simplex chain from the
  same state.
"""

from __future__ import annotations

import numpy as np
import torch

from bensolve_tpu_torch.lp.simplex import KeptState, _put
from bensolve_tpu_torch.vlp.problem import Bounds, ConeGen, VLPProblem


def problem_from_numpy(*, A, P, row_types, row_lb, row_ub, col_types,
                       col_lb, col_ub, optdir=1, cone_gen=0, gen=None,
                       c=None, nz=0, nzobj=0) -> VLPProblem:
    """A VLPProblem from plain fields: matrices, typed row/column
    bounds ('f','l','u','d','s' with +-inf for absent sides), the
    ordering-cone kind (ConeGen value: 0 default, 1 C, 2 C*) with its
    (q, k) generators, the duality parameter ``c`` and ``optdir``."""
    prob = VLPProblem(
        A=np.array(A, np.float64), P=np.array(P, np.float64),
        rows=Bounds(np.array(row_types, "<U1"), np.array(row_lb, np.float64),
                    np.array(row_ub, np.float64)),
        cols=Bounds(np.array(col_types, "<U1"), np.array(col_lb, np.float64),
                    np.array(col_ub, np.float64)),
        optdir=int(optdir), cone_gen=ConeGen(int(cone_gen)),
        gen=None if gen is None else np.array(gen, np.float64),
        c=None if c is None else np.array(c, np.float64),
        nz=int(nz), nzobj=int(nzobj))
    prob.validate()
    return prob


def problem_from_reference(obj) -> VLPProblem:
    """This package's VLPProblem from the JAX package's one, reading only
    its numpy attributes (and the integer value of its cone enum)."""
    return problem_from_numpy(
        A=obj.A, P=obj.P, row_types=obj.rows.types, row_lb=obj.rows.lb,
        row_ub=obj.rows.ub, col_types=obj.cols.types, col_lb=obj.cols.lb,
        col_ub=obj.cols.ub, optdir=obj.optdir, cone_gen=obj.cone_gen.value,
        gen=obj.gen, c=obj.c, nz=obj.nz, nzobj=obj.nzobj)


def problems_from_reference(objs) -> list[VLPProblem]:
    """A list of the JAX package's problems as this package's."""
    return [problem_from_reference(o) for o in objs]


def kept_state_from_numpy(basis, in_basis, at_upper, W, age,
                          device) -> KeptState:
    """A KeptState on ``device`` from numpy copies of a kept tableau's
    fields (basis (B, M), in_basis and at_upper (B, NT), W (B, M, NT))."""
    dev = torch.device(device)
    return KeptState(_put(np.asarray(basis, np.int64), dev),
                     _put(np.asarray(in_basis, bool), dev),
                     _put(np.asarray(at_upper, bool), dev),
                     _put(np.asarray(W), dev), int(age))


def warm_from_result(basis, at_upper) -> tuple[np.ndarray, np.ndarray]:
    """A ``start_basis`` for this package's solvers from an LPResult's
    basis and at_upper arrays (shared (M,)/(NT,) or per-instance)."""
    return np.asarray(basis, np.int64), np.asarray(at_upper, bool)
