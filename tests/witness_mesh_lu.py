"""Config #5 over a four-entry mesh of one card, with and without the
turns that the shard threads take at torch's batched LU.

    python3 tests/witness_mesh_lu.py [--runs off on off on] [--n 10000]

First it records which library torch runs the LU calls of the many-VLP
path on: the shapes that ``simplex._lu_factor`` and ``simplex._lu_solve``
are given on a few hundred instances, then one ``torch.linalg``
factorization and one solve at the largest of them under
``torch.profiler``, whose CUDA kernel names it prints.  Then it solves
``--n`` instances of ``random_vlp(q=3, m=10, n=8, seed=s)``, bounded,
float64, once without a mesh, and once per entry of ``--runs`` through
``solve_many(mesh=make_mesh(4, ("dp",)))``: "on" as the port runs
(``simplex._lu_turn`` makes the shard threads' LU calls take turns),
"off" with ``_lu_turn`` replaced by a no-op, so that the threads enter
torch's LU at once.  Per run it prints one JSON line: the wall, the LPs
and rounds, the instances whose LP or round counts differ from the
unsharded run's, the instances not OPTIMAL, and the instances whose
vertex set lies farther than 1e-7 from the unsharded one, and writes
the lines to ``--out`` too where given.  ``--device cpu``
rehearses it off the card (no profile; on the CPU the turns are never
taken).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

VLP = dict(q=3, m=10, n=8)


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _lu_backend(out, vlps, dev):
    """Shapes of the path's LU calls, and the CUDA kernels torch launches
    for one factorization and one solve at the largest."""
    from bensolve_tpu_torch.algs import many
    from bensolve_tpu_torch.lp import simplex as sx
    from bensolve_tpu_torch.vlp.options import Options

    shapes = {"factor": [], "solve": []}
    real_f, real_s = sx._lu_factor, sx._lu_solve

    def factor(Bmat):
        shapes["factor"].append(tuple(Bmat.shape))
        return real_f(Bmat)

    def solve(LU, piv, B, **kw):
        shapes["solve"].append((tuple(LU.shape), tuple(B.shape)))
        return real_s(LU, piv, B, **kw)

    sx._lu_factor, sx._lu_solve = factor, solve
    try:
        many.solve_many(vlps, Options(bounded=True, write_files=False,
                                      device=dev))
    finally:
        sx._lu_factor, sx._lu_solve = real_f, real_s
    big = max(shapes["factor"], key=lambda s: s[0])
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(big, dtype=torch.float64, device=dev, generator=g)
    X += 4 * torch.eye(big[-1], dtype=X.dtype, device=X.device)
    rhs = torch.randn(big[0], big[-1], 1, dtype=X.dtype, device=X.device,
                      generator=g)
    kernels = {"factor": None, "solve": None}
    for what in kernels if dev.type == "cuda" else ():
        LU, piv, _ = torch.linalg.lu_factor_ex(X)
        _sync(dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            if what == "factor":
                torch.linalg.lu_factor_ex(X)
            else:
                torch.linalg.lu_solve(LU, piv, rhs)
            _sync(dev)
        kernels[what] = sorted({e.name for e in prof.events()
                                if "CUDA" in str(e.device_type)})
    _emit(out, {"probe": "lu backend", "instances": len(vlps),
                "factor_shapes": sorted(set(shapes["factor"]))[-6:],
                "factor_calls": len(shapes["factor"]),
                "solve_shapes": sorted(set(shapes["solve"]))[-6:],
                "solve_calls": len(shapes["solve"]),
                "profiled_shape": list(big),
                "factor_kernels": kernels["factor"],
                "solve_kernels": kernels["solve"]})


def _distance(a, b):
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def _timed_many(vlps, opt, dev, mesh=None):
    from bensolve_tpu_torch.algs import many

    _sync(dev)
    t0 = time.perf_counter()
    rs = many.solve_many(vlps, opt, mesh=mesh)
    _sync(dev)
    return rs, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", choices=("on", "off"),
                    default=["off", "on", "off", "on"])
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--probe-n", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.devnull)
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("witness_mesh_lu: no CUDA device", file=sys.stderr)
        return 1
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.lp import simplex as sx
    from bensolve_tpu_torch.parallel.mesh import make_mesh
    from bensolve_tpu_torch.vlp.options import Options

    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
           if dev.type == "cuda" else "cpu")
    with open(a.out, "w") as out:
        _emit(out, {"card": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda})
        vlps = [examples.random_vlp(**VLP, seed=s) for s in range(a.n)]
        try:
            _lu_backend(out, vlps[:a.probe_n], dev)
        except Exception as exc:   # the runs below go on without it
            _emit(out, {"probe": "lu backend", "error": repr(exc)})
        opt = Options(bounded=True, write_files=False, device=dev.type)
        rs0, wall0 = _timed_many(vlps, opt, dev)
        _emit(out, {"run": "unsharded", "wall_s": wall0,
                    "lps": sum(r.stats.lps for r in rs0),
                    "rounds": max(r.stats.rounds for r in rs0)})
        mesh = make_mesh(4, ("dp",), device=dev.type)
        real = sx._lu_turn
        for k, turns in enumerate(a.runs):
            if turns == "off":
                sx._lu_turn = lambda t: contextlib.nullcontext()
            try:
                rs, wall = _timed_many(vlps, opt, dev, mesh)
            finally:
                sx._lu_turn = real
            counts = [i for i, (x, y) in enumerate(zip(rs, rs0))
                      if (x.stats.lps, x.stats.rounds)
                      != (y.stats.lps, y.stats.rounds)]
            not_opt = [i for i, r in enumerate(rs)
                       if r.status.name != "OPTIMAL"]
            far = [(i, d) for i, d in (
                (i, _distance(x.primal_points, y.primal_points))
                for i, (x, y) in enumerate(zip(rs, rs0))) if not d <= 1e-7]
            _emit(out, {"run": k, "lu_turns": turns, "wall_s": wall,
                        "lps": sum(r.stats.lps for r in rs),
                        "rounds": max(r.stats.rounds for r in rs),
                        "instances_other_counts": len(counts),
                        "first_other_counts": counts[:5],
                        "instances_not_optimal": len(not_opt),
                        "instances_vertex_set_off": len(far),
                        "worst_off": [(i, d) for i, d in sorted(
                            far, key=lambda t: -t[1])[:3]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
