"""The revised simplex at ex09's shape, unsharded and over a "tp" mesh.

    python3 tests/witness_tp_ex09_shape.py --device cuda          # on the card
    python3 tests/witness_tp_ex09_shape.py --device cpu --m 40 --n 320

ex09's LP is 4611 x 36942 and ships only inside the reference's
``ex09.vlp``; this stands in for it with random dense data of that
shape: the P2 LPs of ``random_vlp(q=3, m, n, seed=7)`` (m=4608,
n=36939 by default: LP (m+7) x (n+4), padded to 5120 x 40960, whose
dense A is 1.68 GB at float64 and B^-1 210 MB per LP), ``--batch`` of
them (the arrays of ``bench.make_p2_instances``), solved at float64 by
``revised.solve_batch_revised``:

1. unsharded, on ``--device``;
2. over ``make_mesh(--entries, ("tp",))``: every LP split into column
   panels of B^-1, of the basis rows and of A, one per entry (entries
   repeat a one-card machine's card).

Per run: wall, pivot steps, ms per step, statuses, pivots, objectives,
the peak device memory and, over the mesh, each panel's bytes.  The
mesh run is held to the unsharded one: equal statuses and, on the
OPTIMAL LPs, objectives within rtol 1e-8 and row duals within rtol 1e-7
(the JAX package's tolerances); the script exits 1 otherwise.  Bases
and the objectives of every LP (ITLIM ones stop wherever their pivots
led) are printed beside.  ``--skip-mesh-above S``
leaves the mesh run out when the unsharded one took more than S
seconds.  ``--max-iter K`` cuts both solves at K pivot steps (the
random LPs at this shape end ITLIM at the revised route's own cap,
40 Mp + 20,000 steps, at 4 ms a step on an H100).  ``--route tableau`` solves through ``simplex.solve_batch``
instead (panels of the tableau and of A): with ``--q 5 --m 1000 --n 2000
--batch 8`` it runs BASELINE config #4's P2 LPs to the end, which
chip_smoke.py's mesh phase cuts short.  Not a pytest module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve(args, device, mesh, route="revised", max_iter=None):
    """One solve of the batch through ``route`` ("revised" or "tableau");
    (result, wall, steps, peak bytes, split)."""
    from bensolve_tpu_torch.lp import revised, simplex
    from bensolve_tpu_torch.parallel import mesh as pmesh

    module, name, fn = ((revised, "_rstep", revised.solve_batch_revised)
                        if route == "revised"
                        else (simplex, "_step", simplex.solve_batch))
    steps = [0]
    real = getattr(module, name)

    def counted(*a):
        steps[0] += 1
        return real(*a)

    setattr(module, name, counted)
    pmesh.LAST_SPLIT.clear()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        _sync(device)
        t0 = time.perf_counter()
        res = fn(*args, dtype=np.float64, device=device, mesh=mesh,
                 max_iter=max_iter)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        setattr(module, name, real)
    split = pmesh.LAST_SPLIT.get(route)
    if split is not None:
        steps[0] = split["steps"]
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    return res, wall, steps[0], peak, split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--m", type=int, default=4608)
    ap.add_argument("--n", type=int, default=36939)
    ap.add_argument("--q", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--entries", type=int, default=4)
    ap.add_argument("--skip-mesh-above", type=float, default=None)
    ap.add_argument("--route", choices=("revised", "tableau"),
                    default="revised")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="pivot steps per solve (default: the route's own "
                         "cap)")
    a = ap.parse_args(argv)

    from bensolve_tpu_torch.bench import make_p2_instances, smi_line
    from bensolve_tpu_torch.parallel.mesh import make_mesh

    if torch.device(a.device).type == "cuda":
        print(smi_line(), flush=True)
    t0 = time.perf_counter()
    t2, extra_ub = make_p2_instances(a.batch, q=a.q, m=a.m, n=a.n,
                                     dtype=np.float64, device=a.device)
    args = (t2.A_lp,) + tuple(t2.build_inputs(extra_ub))
    M, N = t2.A_lp.shape
    print(f"random_vlp(q={a.q}, m={a.m}, n={a.n}, seed=7): P2 LP {M}x{N}, "
          f"B={a.batch}, float64, {a.route} route; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    out = {"lp": [M, N], "batch": a.batch, "entries": a.entries,
           "route": a.route, "max_iter": a.max_iter}
    r0, wall0, steps0, peak0, _ = solve(args, a.device, None, a.route,
                                        a.max_iter)
    out["unsharded"] = dict(wall_s=wall0, steps=steps0,
                            ms_per_step=1e3 * wall0 / max(steps0, 1),
                            status=r0.status.tolist(),
                            iters=r0.iters.tolist(), obj=r0.obj.tolist(),
                            peak_bytes=peak0)
    print(f"unsharded: {json.dumps(out['unsharded'])}", flush=True)
    ok = True
    if a.skip_mesh_above is not None and wall0 > a.skip_mesh_above:
        print(f"mesh run skipped: the unsharded run took {wall0:.1f} s > "
              f"{a.skip_mesh_above} s", flush=True)
    else:
        mesh = make_mesh(a.entries, ("tp",), device=a.device)
        r, wall, steps, peak, split = solve(args, a.device, mesh, a.route,
                                            a.max_iter)
        out["tp"] = dict(wall_s=wall, steps=steps,
                         ms_per_step=1e3 * wall / max(steps, 1),
                         status=r.status.tolist(), iters=r.iters.tolist(),
                         obj=r.obj.tolist(), peak_bytes=peak,
                         panel_bytes=split["panel_bytes"] if split else None)
        print(f"tp x{a.entries}: {json.dumps(out['tp'])}", flush=True)
        same = bool(np.array_equal(r.status, r0.status))
        good = r0.status == 1
        obj_rel = float(np.max(np.abs(r.obj - r0.obj)[good]
                               / np.maximum(1.0, np.abs(r0.obj[good])),
                               initial=0.0))
        dual_err = float(np.max(np.abs(r.row_dual - r0.row_dual)[good],
                                initial=0.0))
        dual_ok = bool(np.allclose(r.row_dual[good], r0.row_dual[good],
                                   rtol=1e-7, atol=1e-9))
        obj_rel_all = float(np.max(np.abs(r.obj - r0.obj)
                                   / np.maximum(1.0, np.abs(r0.obj))))
        out["compare"] = dict(status_equal=same, obj_rel=obj_rel,
                              obj_rel_all_lps=obj_rel_all,
                              basis_equal=bool(np.array_equal(r.basis,
                                                              r0.basis)),
                              row_dual_max_abs=dual_err,
                              row_dual_within=dual_ok,
                              iters_equal=bool(np.array_equal(r.iters,
                                                              r0.iters)),
                              split=split is not None
                              and split["T"] == a.entries)
        ok = (same and obj_rel <= 1e-8 and dual_ok
              and out["compare"]["split"])
        print(f"compare: {json.dumps(out['compare'])}", flush=True)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
