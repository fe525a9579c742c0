"""bensolve 2.0.1 ``ex/example10.m``, the "bensolvehedron": a MOLP over
the unit hypercube in n = (q + 2m)^q variables whose objective columns
are the base-(q + 2m) digit patterns of 0 .. n - 1, centred.  At
q = 3, m = 2 it is ``ex/ex10.vlp``: q = 3, m = n = 343."""

import numpy as np


def build(q: int = 3, m: int = 2) -> dict:
    base = q + 2 * m
    n = base ** q
    powers = base ** np.arange(q - 1, -1, -1)
    digits = (np.arange(n)[:, None] // powers[None, :]) % base
    P = (digits - (base - 1) / 2).T.astype(float)
    return dict(A=np.eye(n), P=P, row_lb=np.zeros(n), row_ub=np.ones(n),
                col_lb=np.full(n, -np.inf), col_ub=np.full(n, np.inf))
