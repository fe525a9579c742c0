"""bensolve 2.0.1 ``ex/example11.m``: q = 5 objectives P = I over
{x in R^5 : B x >= a}, B of ones and twos (31 rows), a = e_1.  The upper
image is unbounded; its recession cone has 22 extreme directions.  It is
``ex/ex11.vlp``: q = 5, m = 31, n = 5."""

import numpy as np

PATTERNS = [
    [], [0], [1], [2], [3], [4],
    [0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [1, 3], [1, 4],
    [2, 3], [2, 4], [3, 4],
    [0, 1, 2], [0, 1, 3], [0, 1, 4], [0, 2, 4], [0, 3, 4],
    [1, 2, 3], [1, 3, 4], [1, 2, 4], [1, 2, 3], [2, 3, 4],
    [1, 2, 3, 4], [0, 2, 3, 4], [0, 1, 3, 4], [0, 1, 2, 4],
    [0, 1, 2, 3],
]


def build() -> dict:
    B = np.ones((len(PATTERNS), 5))
    for r, idx in enumerate(PATTERNS):
        B[r, idx] = 2
    a = np.zeros(len(PATTERNS))
    a[0] = 1
    return dict(A=B, P=np.eye(5), row_lb=a, row_ub=np.full(len(a), np.inf),
                col_lb=np.full(5, -np.inf), col_ub=np.full(5, np.inf))
