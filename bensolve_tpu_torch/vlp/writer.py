"""Writer for the .vlp format — the Python equivalent of the MATLAB
front end ``ex/prob2vlp.m`` (the reference project's second API surface).

Nonzeros are emitted in column-major order, matching MATLAB's
``find(sparse(.))``, so files generated here are line-for-line
comparable with the shipped examples.  The port of
``bensolve_tpu/vlp/writer.py`` (host numpy code, unchanged).
"""

from __future__ import annotations

import numpy as np

from bensolve_tpu_torch.vlp.problem import ConeGen, VLPProblem


def _fmt(v: float) -> str:
    return "%g" % v


def _coeff_lines(tag: str, M: np.ndarray) -> list[str]:
    rows, cols = np.nonzero(M.T)  # transpose -> column-major order
    return [f"{tag} {c + 1} {r + 1} {_fmt(M[c, r])}"
            for r, c in zip(rows, cols)]


def _bound_lines(tag: str, lb: np.ndarray, ub: np.ndarray) -> list[str]:
    out = []
    for i, (lo, hi) in enumerate(zip(lb, ub), start=1):
        if lo < hi:
            ch = 2 * np.isfinite(lo) + np.isfinite(hi)
            if ch == 0:
                out.append(f"{tag} {i} f")
            elif ch == 1:
                out.append(f"{tag} {i} u {_fmt(hi)}")
            elif ch == 2:
                out.append(f"{tag} {i} l {_fmt(lo)}")
            else:
                out.append(f"{tag} {i} d {_fmt(lo)} {_fmt(hi)}")
        elif lo == hi and np.isfinite(lo):
            out.append(f"{tag} {i} s {_fmt(lo)}")
        else:
            raise ValueError(f"invalid bounds at {tag} {i}: [{lo}, {hi}]")
    return out


def write_vlp(prob: VLPProblem, path: str) -> None:
    """Write ``prob`` as a .vlp file (grammar per bslv_vlp.c:275-588)."""
    m, n, q = prob.m, prob.n, prob.q
    a_lines = _coeff_lines("a", prob.A)
    o_lines = _coeff_lines("o", prob.P)

    cone_str = ""
    k_lines: list[str] = []
    if prob.cone_gen is not ConeGen.DEFAULT and prob.gen is not None:
        gr, gc = np.nonzero(prob.gen.T)
        k_lines = [f"k {c + 1} {r + 1} {_fmt(prob.gen[c, r])}"
                   for r, c in zip(gr, gc)]
        word = "cone" if prob.cone_gen is ConeGen.CONE else "dualcone"
        cone_str = f" {word} {prob.gen.shape[1]} {len(k_lines)}"
    if prob.c is not None and np.any(prob.c != 0):
        k_lines += [f"k {i + 1} 0 {_fmt(prob.c[i])}" for i in range(q)]

    sense = "min" if prob.optdir == 1 else "max"
    lines = [f"p vlp {sense} {m} {n} {len(a_lines)} {q} "
             f"{len(o_lines)}{cone_str}"]
    lines += a_lines + o_lines + k_lines
    lines += _bound_lines("i", prob.rows.lb, prob.rows.ub)
    lines += _bound_lines("j", prob.cols.lb, prob.cols.ub)
    lines.append("e")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
