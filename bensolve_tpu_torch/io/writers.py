"""Solution-file writers, structurally byte-compatible with the
reference output family (bslv_poly.c:341-414 writers, bslv_main.c:346-397
log, bslv_main.h:86-97 names):

  <name>_img_p.sol    vertices+directions of the upper image (1/0-prefixed)
  <name>_img_d.sol    vertices+directions of the lower image
  <name>_adj_p.sol    adjacency lists (row k = neighbours of vertex k)
  <name>_adj_d.sol
  <name>_inc_p.sol    facet-vertex incidence (row k = vertices of facet k)
  <name>_inc_d.sol
  <name>_pre_img_p.sol  pre-images (with -s)
  <name>_pre_img_d.sol
  <name>_c.sol        duality parameter vector
  <name>.log          run log
  *.cone variants of the image/adjacency/incidence family for the
  ordering cone.
"""

from __future__ import annotations

import numpy as np

FORMAT_SHORT_STR = "%10.4g"
FORMAT_LONG_STR = "%.14g"


def _fmt_row(vals, fmt: str) -> str:
    # C prints each value + ' ' then rewinds over the final space
    return " ".join(fmt % v for v in vals)


def format_vertices(poly, fmt: str) -> str:
    """Vertex list: '1'-prefixed points, '0'-prefixed directions
    (poly__vrtx2file, bslv_poly.c:341-360)."""
    lines = []
    for idx in poly.live():
        pre = "0" if poly.ideal[idx] else "1"
        lines.append(pre + " " + _fmt_row(poly.data[idx], fmt))
    return "\n".join(lines) + ("\n" if lines else "")


def format_preimages(poly, fmt: str) -> str:
    """Pre-image rows for solution-flagged vertices (poly__primg2file,
    bslv_poly.c:362-380)."""
    lines = []
    for idx in poly.live():
        if poly.sltn[idx]:
            lines.append(_fmt_row(poly.primg[idx, : poly.dim_primg], fmt))
    return "\n".join(lines) + ("\n" if lines else "")


def format_adjacency(poly) -> str:
    """Row k: neighbours of live vertex k, renumbered to live positions
    (poly__adj2file, bslv_poly.c:382-397)."""
    live = poly.live()
    inv = {int(v): i for i, v in enumerate(live)}
    lines = []
    for v in live:
        lines.append(_fmt_row((inv[u] for u in poly.adj[v] if u in inv),
                              "%u") if poly.adj[v] else "")
    return "\n".join(lines) + ("\n" if lines else "")


def format_incidence(poly, dual) -> str:
    """Row k: vertices (live positions in ``poly``) incident to live
    facet k of ``dual`` (poly__inc2file, bslv_poly.c:399-414)."""
    inv = {int(v): i for i, v in enumerate(poly.live())}
    lines = []
    for f in dual.live():
        lines.append(_fmt_row((inv[u] for u in dual.inc[f] if u in inv),
                              "%u"))
    return "\n".join(lines) + ("\n" if lines else "")


def format_matrix(mat: np.ndarray, fmt: str) -> str:
    """matrix_fprint (bslv_lists.c:83-101): one line per row, entries
    below 1e-14 in magnitude printed as 0."""
    mat = np.atleast_2d(mat)
    lines = []
    for row in mat:
        lines.append(_fmt_row((0.0 if abs(v) < 1e-14 else v for v in row),
                              fmt))
    return "\n".join(lines) + "\n"


def write_image_family(pair, basename: str, *, swap: bool, fmt: str,
                       pre_img: bool, ending: str = ".sol") -> None:
    """The full per-solve artifact family (reference poly_output,
    bslv_algs.c:50-144).  ``swap`` exchanges the primal/dual roles (used
    by the dual algorithm and the CONE output)."""
    primal, dual = (pair.dual, pair.primal) if swap else (pair.primal,
                                                          pair.dual)
    # poly_output marks every used vertex as part of the solution
    for poly in (primal, dual):
        for k in poly.live():
            poly.sltn[k] = True

    def w(path, text):
        with open(path, "w") as fh:
            fh.write(text)

    w(basename + "_img_p" + ending, format_vertices(primal, fmt))
    w(basename + "_img_d" + ending, format_vertices(dual, fmt))
    w(basename + "_adj_p" + ending, format_adjacency(primal))
    w(basename + "_adj_d" + ending, format_adjacency(dual))
    w(basename + "_inc_p" + ending, format_incidence(primal, dual))
    w(basename + "_inc_d" + ending, format_incidence(dual, primal))
    if pre_img:
        w(basename + "_pre_img_p" + ending, format_preimages(primal, fmt))
        w(basename + "_pre_img_d" + ending, format_preimages(dual, fmt))


def write_log(path: str, *, problem_file: str, vlp, sol, opt, time_ms: float,
              n_lps: int) -> None:
    """Run log (bslv_main.c:346-397)."""
    from bensolve_tpu_torch.vlp.options import Format, LPMethod

    def lp_method_str(mth):
        return {LPMethod.PRIMAL_SIMPLEX: "primal_simplex",
                LPMethod.DUAL_SIMPLEX: "dual_simplex",
                LPMethod.DUAL_PRIMAL_SIMPLEX:
                    "dual_primal_simplex (dual simplex, if not succesful, "
                    "primal simplex)",
                LPMethod.AUTO: "auto"}[mth]

    lines = [
        "BENSOLVE-TPU: VLP solver",
        "Problem parameters",
        f"  problem file:      {problem_file}",
        f"  problem rows:      {vlp.m:7d}",
        f"  problem columns:   {vlp.n:7d}",
        f"  matrix non-zeros:  {vlp.nz:7d}",
        f"  primal generators: {sol.o:7d}",
        f"  dual generators:   {sol.p:7d}",
        "Options",
        "  bounded:            " + ("yes (run phase 2 only)" if opt.bounded
                                    else "no (run phases 0 to 2)"),
        "  solution:           " + ("on (solutions (pre-image) written to files)"
                                    if opt.solution else "off (no solution output)"),
        f"  format:             "
        + {Format.AUTO: "auto", Format.LONG: "long",
           Format.SHORT: "short"}[opt.format],
        f"  lp_method_phase0:   {lp_method_str(opt.lp_method_phase0)}",
        f"  lp_method_phase1:   {lp_method_str(opt.lp_method_phase1)}",
        f"  lp_method_phase2:   {lp_method_str(opt.lp_method_phase2)}",
        f"  message_level:      {opt.message_level}",
        f"  lp_message_level:   {opt.lp_message_level}",
        f"  alg_phase1:         {opt.alg_phase1.value}",
        f"  alg_phase2:         {opt.alg_phase2.value}",
        f"  eps_benson_phase1:  {opt.eps_benson_phase1:g}",
        f"  eps_benson_phase2:  {opt.eps_benson_phase2:g}",
        f"  eps_phase0:         {opt.eps_phase0:g}",
        f"  eps_phase1:         {opt.eps_phase1:g}",
        "Computational results",
        f"  CPU time (ms):      {time_ms:g}",
        f"  # LPs:              {n_lps}",
        "Solution properties",
        f"  # primal solution points:     {sol.pp:7d}",
        f"  # primal solution directions: {sol.pp_dir:7d}",
        f"  # dual solution points:       {sol.dd:7d}",
        f"  # dual solution directions:   {sol.dd_dir:7d}",
    ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
