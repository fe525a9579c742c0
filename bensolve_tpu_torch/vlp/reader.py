"""Reader for the ``.vlp`` problem format.

Grammar per the reference scanner (bslv_vlp.c:275-588).  A file is a
sequence of lines, each starting with a one-character designator:

  p vlp {min|max} m n nz q nzobj [{cone|dualcone} n_gen nzgen]
  a i j val        constraint coefficient A[i,j]        (1<=i<=m, 1<=j<=n)
  o i j val        objective coefficient  P[i,j]        (1<=i<=q, 1<=j<=n)
  k i j val        cone generator gen[i,j] (j>=1) or duality vector c[i] (j==0)
  i idx type [lb] [ub]   row bounds, type in f|l|u|d|s
  j idx type [lb] [ub]   column bounds
  e                end of data
  c ...            comment

Defaults for unspecified bounds: rows 'f' (free), columns 's' fixed at 0
(bslv_vlp.c:566-574).  Duplicate coefficient entries follow the reference:
later 'a'/'o' entries are *appended* to the COO list, so duplicates
accumulate (GLPK sums duplicate triplets is false - glp_load_matrix forbids
duplicates; in practice the examples have none, we sum).
"""

from __future__ import annotations

import numpy as np

from bensolve_tpu_torch.vlp.problem import Bounds, ConeGen, VLPProblem


class VLPFormatError(ValueError):
    def __init__(self, lineno: int, msg: str):
        super().__init__(f"line {lineno}: {msg}")
        self.lineno = lineno


def _getint(tok: str, lineno: int, what: str) -> int:
    try:
        return int(tok)
    except ValueError:
        raise VLPFormatError(lineno, f"{what} missing or invalid") from None


def _getnum(tok: str, lineno: int, what: str) -> float:
    try:
        v = float(tok)
    except ValueError:
        raise VLPFormatError(lineno, f"{what} missing or invalid") from None
    if not np.isfinite(v):
        raise VLPFormatError(lineno, f"{what} out of range")
    return v


def read_vlp(path_or_text: str, *, is_text: bool = False) -> VLPProblem:
    """Parse a .vlp file (or literal text with ``is_text=True``)."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text, "r") as fh:
            text = fh.read()

    lines = text.split("\n")

    # --- problem line -----------------------------------------------------
    lineno = 0
    fields: list[str] = []
    for lineno, raw in enumerate(lines, start=1):
        fields = raw.split()
        if not fields or fields[0] == "c":
            continue
        break
    if not fields or fields[0] != "p":
        raise VLPFormatError(lineno, "problem line missing or invalid")
    if len(fields) < 2 or fields[1] != "vlp":
        raise VLPFormatError(lineno, "wrong problem designator")
    if len(fields) < 3 or fields[2] not in ("min", "max"):
        raise VLPFormatError(lineno, "objective sense missing or invalid")
    optdir = 1 if fields[2] == "min" else -1
    if len(fields) < 8:
        raise VLPFormatError(lineno, "problem line missing or invalid")
    m = _getint(fields[3], lineno, "number of rows")
    n = _getint(fields[4], lineno, "number of columns")
    nz = _getint(fields[5], lineno, "number of nonzeros")
    q = _getint(fields[6], lineno, "number of objectives")
    nzobj = _getint(fields[7], lineno, "number of objective matrix nonzeros")
    if m < 0 or n < 0 or nz < 0 or q < 1 or nzobj < 0:
        raise VLPFormatError(lineno, "problem dimensions invalid")

    cone_gen = ConeGen.DEFAULT
    n_gen = 0
    nzgen = 0
    if len(fields) > 8:
        if fields[8] == "cone":
            cone_gen = ConeGen.CONE
        elif fields[8] == "dualcone":
            cone_gen = ConeGen.DUALCONE
        else:
            raise VLPFormatError(lineno, "type of cone generators missing or invalid")
        if len(fields) < 11:
            raise VLPFormatError(lineno, "cone generator counts missing")
        n_gen = _getint(fields[9], lineno, "number of cone generating vectors")
        nzgen = _getint(fields[10], lineno, "number of cone generator non-zeros")
        if n_gen < 0 or nzgen < 0:
            raise VLPFormatError(lineno, "cone generator counts invalid")
        if len(fields) > 11:
            raise VLPFormatError(lineno, "too many data fields specified")

    A = np.zeros((m, n), dtype=np.float64)
    P = np.zeros((q, n), dtype=np.float64)
    c = np.zeros(q, dtype=np.float64)
    gen = (
        np.zeros((q, n_gen), dtype=np.float64)
        if cone_gen is not ConeGen.DEFAULT
        else None
    )
    row_types = np.full(m, "x", dtype="<U1")
    row_lb = np.zeros(m)
    row_ub = np.zeros(m)
    col_types = np.full(n, "x", dtype="<U1")
    col_lb = np.zeros(n)
    col_ub = np.zeros(n)

    na = no = nk = 0
    start = lineno  # 1-based index of the problem line
    ended = False

    for lineno, raw in enumerate(lines[start:], start=start + 1):
        fields = raw.split()
        if not fields:
            continue
        d = fields[0]
        if d == "c":
            continue
        if len(d) != 1:
            raise VLPFormatError(lineno, "line designator missing or invalid")

        if d == "a":
            if na == nz:
                raise VLPFormatError(lineno, "too many constraint coefficient descriptors")
            if len(fields) != 4:
                raise VLPFormatError(lineno, "constraint coefficient invalid")
            ridx = _getint(fields[1], lineno, "constraint coefficient row number")
            cidx = _getint(fields[2], lineno, "constraint coefficient column number")
            if not (1 <= ridx <= m):
                raise VLPFormatError(lineno, "constraint coefficient row number out of range")
            if not (1 <= cidx <= n):
                raise VLPFormatError(lineno, "constraint coefficient column number out of range")
            A[ridx - 1, cidx - 1] += _getnum(fields[3], lineno, "constraint coefficient")
            na += 1
        elif d == "o":
            if no == nzobj:
                raise VLPFormatError(lineno, "too many objective coefficient descriptors")
            if len(fields) != 4:
                raise VLPFormatError(lineno, "objective coefficient invalid")
            ridx = _getint(fields[1], lineno, "objective coefficient row number")
            cidx = _getint(fields[2], lineno, "objective coefficient column number")
            if not (1 <= ridx <= q):
                raise VLPFormatError(lineno, "objective coefficient row number out of range")
            if not (1 <= cidx <= n):
                raise VLPFormatError(lineno, "objective coefficient column number out of range")
            P[ridx - 1, cidx - 1] += _getnum(fields[3], lineno, "objective coefficient")
            no += 1
        elif d == "k":
            if cone_gen is ConeGen.DEFAULT:
                raise VLPFormatError(lineno, "invalid designator k")
            if len(fields) != 4:
                raise VLPFormatError(lineno, "cone generator coefficient invalid")
            ridx = _getint(fields[1], lineno, "cone generator coefficient row number")
            cidx = _getint(fields[2], lineno, "cone generator coefficient column number")
            # NOTE: the reference range-checks ridx against n_gen
            # (bslv_vlp.c:467-468) though it semantically indexes 1..q;
            # we check against q (strictly more correct; identical on all
            # shipped examples where n_gen >= q does not hold... we accept
            # the wider of the two to stay input-compatible).
            if not (1 <= ridx <= max(q, n_gen)):
                raise VLPFormatError(lineno, "cone generator coefficient row number out of range")
            if not (0 <= cidx <= n_gen):
                raise VLPFormatError(lineno, "cone generator coefficient column number out of range")
            val = _getnum(fields[3], lineno, "cone generator coefficient")
            if cidx == 0:
                if not (1 <= ridx <= q):
                    raise VLPFormatError(lineno, "duality parameter row number out of range")
                c[ridx - 1] = val
            else:
                if nk == nzgen:
                    raise VLPFormatError(lineno, "too many cone generator coefficient descriptors")
                if not (1 <= ridx <= q):
                    raise VLPFormatError(lineno, "cone generator coefficient row number out of range")
                gen[ridx - 1, cidx - 1] = val
                nk += 1
        elif d in ("i", "j"):
            kmax = m if d == "i" else n
            types = row_types if d == "i" else col_types
            lbs = row_lb if d == "i" else col_lb
            ubs = row_ub if d == "i" else col_ub
            what = "row" if d == "i" else "column"
            if len(fields) < 3:
                raise VLPFormatError(lineno, f"{what} descriptor invalid")
            idx = _getint(fields[1], lineno, f"{what} number")
            if not (1 <= idx <= kmax):
                raise VLPFormatError(lineno, f"{what} number out of range")
            if types[idx - 1] != "x":
                raise VLPFormatError(lineno, f"duplicate {what} descriptor")
            t = fields[2]
            if t not in ("f", "l", "u", "d", "s"):
                raise VLPFormatError(lineno, f"{what} type missing or invalid")
            pos = 3
            if t in ("l", "d", "s"):
                if len(fields) <= pos:
                    raise VLPFormatError(lineno, f"{what} lower bound missing or invalid")
                lbs[idx - 1] = _getnum(fields[pos], lineno, f"{what} lower bound")
                pos += 1
            if t in ("u", "d"):
                if len(fields) <= pos:
                    raise VLPFormatError(lineno, f"{what} upper bound missing or invalid")
                ubs[idx - 1] = _getnum(fields[pos], lineno, f"{what} upper bound")
                pos += 1
            if len(fields) > pos:
                raise VLPFormatError(lineno, "too many data fields specified")
            types[idx - 1] = t
        elif d == "e":
            ended = True
            break
        else:
            raise VLPFormatError(lineno, "line designator missing or invalid")

    if not ended:
        raise VLPFormatError(lineno, "unexpected end of file")

    # defaults: rows free, columns fixed at 0 (bslv_vlp.c:566-574)
    row_types[row_types == "x"] = "f"
    col_types[col_types == "x"] = "s"

    prob = VLPProblem(
        A=A,
        P=P,
        rows=Bounds.from_typed(row_types, row_lb, row_ub),
        cols=Bounds.from_typed(col_types, col_lb, col_ub),
        optdir=optdir,
        cone_gen=cone_gen,
        gen=gen,
        c=c.copy(),
        nz=nz,
        nzobj=nzobj,
    )
    prob.validate()
    return prob
