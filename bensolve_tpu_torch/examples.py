"""The reference example problems as Python generators (a copy of
bensolve_tpu/examples.py, so the port can build them without JAX).

example07 and example09 are data-driven in the reference (their raw
matrices ship only inside ex07.vlp / ex09.vlp); their generators load
the .vlp files instead, from ``ex_dir``.  ``ALL`` holds the generators
that need no file.
"""

from __future__ import annotations

import numpy as np

from bensolve_tpu_torch.vlp.problem import VLPProblem
from bensolve_tpu_torch.vlp.reader import read_vlp

REFERENCE_EX = "/root/reference/ex"


def example01() -> VLPProblem:
    """Minimal bi-objective MOLP (ex/example01.m)."""
    return VLPProblem.from_arrays(
        A=[[2, 1], [1, 2]], a=[6, 6],
        P=[[1, -1], [1, 1]], l=[0, 0])


def example02() -> VLPProblem:
    """Infeasible VLP (ex/example02.m)."""
    return VLPProblem.from_arrays(
        A=[[3, 1], [1, 2], [1, 1]], a=[0, 0, 1], b=[1, 1, 2],
        P=[[1, 0], [0, 1]])


def example03() -> VLPProblem:
    """Upper image has no vertex (ex/example03.m)."""
    return VLPProblem.from_arrays(
        A=[[1, 1, 1], [1, 1, -1]], a=[1, 1],
        P=[[1, 0, 0], [0, 1, 0]])


def example04() -> VLPProblem:
    """Totally unbounded VLP (ex/example04.m)."""
    return VLPProblem.from_arrays(
        A=[[1, 1, 1], [1, 1, 2]], a=[1, 1],
        P=[[1, 0, 0], [0, 1, 0]])


def example05() -> VLPProblem:
    """q=3 with ordering cone given by 4 generators (ex/example05.m)."""
    return VLPProblem.from_arrays(
        A=[[1, 1, 1], [1, 2, 2], [2, 2, 1], [2, 1, 2]],
        a=[1, 1.5, 1.5, 1.5],
        P=[[1, 0, 1], [1, 1, 0], [0, 1, 1]],
        l=[0, 0, 0],
        Y=np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 2], [0, -1, 2]]).T,
        c=[1, 1, 1])


def example06() -> VLPProblem:
    """Maximization with dual-cone generators (ex/example06.m)."""
    return VLPProblem.from_arrays(
        A=[[1, 1]], a=[1], b=[2],
        P=[[1, -1], [1, 1]],
        l=[0, 0], s=[1, np.inf],
        Z=[[2, -1], [-1, 2]], c=[1, 1],
        opt_dir=-1)


def example07(ex_dir: str = REFERENCE_EX) -> VLPProblem:
    """Large radiotherapy MOLP (Shao-Ehrgott); data ships only inside
    ex07.vlp.  Recommended flags: -e 0.05 (ex/example07.m:9)."""
    return read_vlp(f"{ex_dir}/ex07.vlp")


def example08() -> VLPProblem:
    """Unbounded but not totally unbounded; solution has points AND
    directions (ex/example08.m)."""
    return VLPProblem.from_arrays(
        A=[[3, 1], [1, 2], [1, 1]], a=[0, 0, 1],
        P=[[1, 0], [0, 1]],
        Y=np.array([[-1, 1.5], [3, -1]]).T,
        c=[0, 1])


def example09(ex_dir: str = REFERENCE_EX) -> VLPProblem:
    """Huge VLP (Hamel-Loehne-Rudloff Ex. 6.6); data ships only inside
    ex09.vlp.  Recommended flags: -e 1e-2 (ex/example09.m:10)."""
    return read_vlp(f"{ex_dir}/ex09.vlp")


def example10(q: int = 3, m: int = 2) -> VLPProblem:
    """The 'bensolvehedron' (ex/example10.m): MOLP over the unit
    hypercube in n = (q+2m)^q variables, objective rows the centered
    base-(q+2m) digit patterns."""
    base = q + 2 * m
    n = base ** q
    P = np.empty((n, q))
    for i in range(n):
        digits = []
        v = i
        for _ in range(q):
            digits.append(v % base)
            v //= base
        digits = digits[::-1]
        P[i] = np.array(digits, float) - (base - 1) / 2
    return VLPProblem.from_arrays(
        A=np.eye(n), a=np.zeros(n), b=np.ones(n), P=P.T,
        l=None, s=None)


def example11() -> VLPProblem:
    """q=5, unbounded; the recession cone of the upper image has 22
    extreme directions (ex/example11.m)."""
    B = np.ones((31, 5))
    patterns = [
        [], [0], [1], [2], [3], [4],
        [0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [1, 3], [1, 4],
        [2, 3], [2, 4], [3, 4],
        [0, 1, 2], [0, 1, 3], [0, 1, 4], [0, 2, 4], [0, 3, 4],
        [1, 2, 3], [1, 3, 4], [1, 2, 4], [1, 2, 3], [2, 3, 4],
        [1, 2, 3, 4], [0, 2, 3, 4], [0, 1, 3, 4], [0, 1, 2, 4],
        [0, 1, 2, 3],
    ]
    for r, idx in enumerate(patterns):
        B[r, idx] = 2
    a = np.zeros(31)
    a[0] = 1
    return VLPProblem.from_arrays(A=B, a=a, P=np.eye(5))


def random_vlp(q: int = 5, m: int = 1000, n: int = 2000,
               seed: int = 0) -> VLPProblem:
    """Synthetic dense feasible bounded VLP (BASELINE.json config #4:
    q=5 objectives, 2k vars x 1k constraints; smaller shapes for the
    scenario-batch config #5).  Ax <= a with a = A x0 + margin keeps the
    feasible region nonempty; box bounds keep the upper image bounded."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = rng.random(n)
    a = A @ x0 + 0.5 + rng.random(m)
    P = rng.standard_normal((q, n)) / np.sqrt(n)
    return VLPProblem.from_arrays(
        A=A, b=a, P=P, l=np.zeros(n), s=np.full(n, 10.0))


ALL = {fn.__name__: fn for fn in
       [example01, example02, example03, example04, example05, example06,
        example08, example10, example11]}
