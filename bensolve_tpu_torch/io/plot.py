"""OFF/geomview graphics output for q=3 problems (option -p).

Reference: poly_plot_primal / poly_plot_dual (bslv_algs.c:409-559) and
poly__plot (bslv_poly.c:868-938).  The unbounded image is first cut with
a synthetic hyperplane (shifted by PRIMAL_PLOT_CUT_SHIFT resp.
DUAL_PLOT_CUT_SHIFT, bslv_main.h:49-55) to make it bounded, facet vertex
rings are ordered by walking the adjacency graph, and an INST wrapper
records per-axis scaling.  The port of ``bensolve_tpu/io/plot.py``
(host numpy code, unchanged).
"""

from __future__ import annotations

import os

import numpy as np

from bensolve_tpu_torch.vlp.options import (DUAL_PLOT_CUT_SHIFT,
                                      PRIMAL_PLOT_CUT_SHIFT)

GOLDEN_RATIO = (1 + np.sqrt(5)) / 2


def _plot_cut_v2h(vals, ideal):
    """trnsfrm_plot (bslv_algs.c:315-321): plot-cut vertex (v0,v1,a) ->
    halfspace  -(v0, v1, 1-v0-v1) . y >= -a,  i.e.  w.y <= a."""
    k = vals.shape[0]
    hp = np.empty((k, 4))
    hp[:, 0] = -vals[:, 0]
    hp[:, 1] = -vals[:, 1]
    hp[:, 2] = -1 + vals[:, 0] + vals[:, 1]
    hp[:, 3] = -vals[:, 2]
    return hp


def _plot_cut_dual_v2h(vals, ideal):
    """trnsfrm_plot_dual (bslv_algs.c:323-329): (v0,v1,a) ->
    (v0, v1, 1-v0-v1) . y* >= a."""
    k = vals.shape[0]
    hp = np.empty((k, 4))
    hp[:, 0] = vals[:, 0]
    hp[:, 1] = vals[:, 1]
    hp[:, 2] = 1 - vals[:, 0] - vals[:, 1]
    hp[:, 3] = vals[:, 2]
    return hp


def cut_primal_for_plot(pair, sol) -> np.ndarray:
    """Bound the upper image with the synthetic hyperplane eta.y <= rhs
    (bslv_algs.c:409-459).  Returns the per-axis widths for the INST
    scaling.  Mutates ``pair`` (called after solution files are
    written, like the reference)."""
    poly = pair.primal
    # eta = normalized sum of normalized R columns, sum-norm 1
    R = sol.R
    eta = (R / np.linalg.norm(R, axis=0, keepdims=True)).sum(axis=1)
    eta = eta / eta.sum()

    pts = [i for i in poly.live() if not poly.ideal[i]]
    vals = poly.data[pts] @ eta
    alph_max, alph_min = float(vals.max()), float(vals.min())
    rng = alph_max - alph_min
    shift = PRIMAL_PLOT_CUT_SHIFT * (1.0 if rng < 1e-7 else rng)

    pair.dual_v2h = _plot_cut_v2h
    pair.add_vertex(np.array([eta[0], eta[1], alph_max + shift]),
                    ideal=False)

    pts = [i for i in poly.live() if not poly.ideal[i]]
    data = poly.data[pts]
    widths = data.max(axis=0) - data.min(axis=0)
    return widths


def cut_dual_for_plot(pair) -> np.ndarray:
    """Bound the lower image from below (bslv_algs.c:500-535).  Returns
    the INST scales (x, y, z-with-golden-ratio)."""
    poly = pair.primal
    pts = [i for i in poly.live() if not poly.ideal[i]]
    data = poly.data[pts]
    wmax = data.max(axis=0)
    wmin = data.min(axis=0)
    hght = 1.0 if wmax[2] - wmin[2] < 1e-8 else \
        (1 + DUAL_PLOT_CUT_SHIFT) * (wmax[2] - wmin[2])

    pair.dual_v2h = _plot_cut_dual_v2h
    pair.add_vertex(np.array([0.0, 0.0, wmax[2] - hght]), ideal=False)
    return np.array([wmax[0] - wmin[0], wmax[1] - wmin[1],
                     hght * GOLDEN_RATIO])


def _order_facet(poly, members: list[int]) -> list[int] | None:
    """Order a facet's vertices into a ring by walking adjacency
    (bslv_poly.c:901-926)."""
    rest = list(members)
    if not rest:
        return []
    out = [rest.pop(0)]
    while rest:
        adj = poly.adj[out[-1]]
        nxt = next((v for v in rest if v in adj), None)
        if nxt is None:
            return None  # disconnected facet (reference prints an error)
        rest.remove(nxt)
        out.append(nxt)
    return out


def format_off(pair) -> str:
    """Geomview OFF text of the (bounded) primal polytope of ``pair``
    (poly__plot, bslv_poly.c:868-938)."""
    poly = pair.primal
    dual = pair.dual
    live_v = [int(v) for v in poly.live()]
    live_f = [int(f) for f in dual.live()]
    inv = {v: i for i, v in enumerate(live_v)}

    lines = ["OFF", f"{len(live_v)} {len(live_f)} 0", "", "#vertices:"]
    for v in live_v:
        lines.append(" ".join("%g" % x for x in poly.data[v]))
    lines.append("")
    lines.append("#facets:")
    for f in live_f:
        ring = _order_facet(poly, [v for v in dual.inc[f] if v in inv])
        if ring is None:
            lines.append("# error: fault in plot")
            continue
        lines.append(f"{len(ring)}\t" + " ".join(str(inv[v]) for v in ring))
    return "\n".join(lines) + "\n"


def write_plot_files(pair, basename: str, suffix: str,
                     scales: np.ndarray) -> None:
    """Write <base>_<suffix>.off and the INST wrapper
    (bslv_algs.c:479-497)."""
    off_path = f"{basename}_{suffix}.off"
    with open(off_path, "w") as fh:
        fh.write(format_off(pair))
    with open(f"{basename}_{suffix}.inst", "w") as fh:
        fh.write(f"INST\ngeom < {os.path.basename(off_path)}\n")
        fh.write("transform {%f 0 0 0 0 %f 0 0 0 0 %f 0 0 0 0 1.0}\n"
                 % tuple(1.0 / np.where(scales == 0, 1.0, scales)))
