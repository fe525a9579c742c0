"""Both packages' interior-point method on the same LPs of BASELINE
config #4 (bench.py::make_p2_instances: random_vlp(q=5, m=1000, n=2000,
seed=7), P2 LP 1011x2006), on the CPU, LP by LP.

    JAX_PLATFORMS=cpu python tests/witness_ipm_config4.py --dtype float64 --batch 16
    JAX_PLATFORMS=cpu python tests/witness_ipm_config4.py --dtype float32 --batch 16 --warm
    python3 tests/witness_ipm_config4.py --dtype float64 --batch 16 --port-only --device cuda

It takes the first ``--batch`` LPs of the 128 that bench.py solves,
solves them cold in the JAX package (bensolve_tpu.lp.ipm) and in the
port (bensolve_tpu_torch.lp.ipm, on ``--device``, the CPU by default),
and prints per LP the status, quality and iterations of each.
``--warm`` adds bench.py's first warm round (row bounds times 0.998)
started from the templates' one shared interior point: the first
quality-0 LP of the cold solve.  ``--port-only`` leaves the JAX package
out (it imports no JAX), for a run on the card whose per-LP lines are
held to a CPU run's.  The host HiGHS fallback is capped at 0 LPs
(BENSOLVE_HOST_FALLBACK_MAX=0), so an LP that would go to it (ITLIM, or
OPTIMAL at quality 1 or 2) keeps the device's answer and is counted.
Not a pytest module: at the full width one solve takes minutes on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ["BENSOLVE_HOST_FALLBACK_MAX"] = "0"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template  # noqa: E402
from bensolve_tpu_torch.examples import random_vlp  # noqa: E402
from bensolve_tpu_torch.lp import ipm as tipm  # noqa: E402


def inputs(B, seed=7, q=5, m=1000, n=2000):
    """bench.py::make_p2_instances' LP matrix and its first B rounds'
    bounds."""
    vlp = random_vlp(q=q, m=m, n=n, seed=seed)
    Z = np.eye(q)
    Z = Z / (Z.T @ np.full(q, 1.0 / q))[None, :]
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS, dtype=np.float64, ipm_min=2000,
                    device="cpu")
    rng = np.random.default_rng(seed + 1)
    V = rng.random((128, q)) * 2.0 + 1.0
    A = np.asarray(getattr(t2.A_lp, "A", t2.A_lp), np.float64)
    return t2, A, (V @ t2.ZR)[:B]


def host_bound(res):
    return (res.status == 4) | ((res.status == 1) & (res.quality >= 1))


def report(tag, results):
    """``results``: (name, LPResult, seconds) per package."""
    print(f"== {tag}: " + ", ".join(f"{n} {t:.1f} s" for n, _, t in results),
          flush=True)
    for name, r, _ in results:
        qu = {int(k): int(v) for k, v in zip(*np.unique(r.quality,
                                                          return_counts=True))}
        print(f"   {name}: optimal {int((r.status == 1).sum())}/"
              f"{r.status.size} quality {qu} would go to the host "
              f"{int(host_bound(r).sum())}; iterations max "
              f"{int(r.iters.max())} median {np.median(r.iters):.0f}",
              flush=True)
    names = " ".join(n for n, _, _ in results)
    print(f"   LP: status, quality, iterations, objective ({names})",
          flush=True)
    for i in range(results[0][1].status.size):
        cols = [" ".join(str(int(getattr(r, f)[i])) for _, r, _ in results)
                for f in ("status", "quality", "iters")]
        objs = " ".join(f"{r.obj[i]:.9g}" for _, r, _ in results)
        print(f"   {i:3d}: {cols[0]}, {cols[1]}, {cols[2]}, {objs}",
              flush=True)
    if len(results) == 2:
        ref, got = results[0][1], results[1][1]
        same = ((ref.status == got.status).all()
                and (ref.quality == got.quality).all())
        print(f"   same statuses and qualities: {bool(same)}; LPs where "
              f"the iterations differ: {int((ref.iters != got.iters).sum())}"
              f"; max |obj JAX - obj port| "
              f"{np.abs(ref.obj - got.obj).max():.2e}", flush=True)


def solve(A, t2, ub, dtype, device, jax_too, warm=None):
    args = t2.build_inputs(ub)
    out = []
    if jax_too:
        from bensolve_tpu.lp import ipm as jipm

        t0 = time.perf_counter()
        out.append(("JAX", jipm.solve_batch_ipm(A, *args, dtype=dtype,
                                                warm_interior=warm),
                    time.perf_counter() - t0))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tipm.solve_batch_ipm(A, *args, dtype=dtype, warm_interior=warm,
                               device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    out.append((f"port ({device})", got, time.perf_counter() - t0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--port-only", action="store_true")
    a = ap.parse_args()
    jax_too = not a.port_only
    if jax_too:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    dtype = np.dtype(a.dtype).type
    t2, A, ub = inputs(a.batch)
    print(f"config #4 P2 LP {A.shape[0]}x{A.shape[1]}, first {a.batch} "
          f"LPs, {a.dtype}, torch {torch.__version__}", flush=True)
    res = solve(A, t2, ub, dtype, a.device, jax_too)
    report(f"{a.dtype} cold", res)
    if a.warm:
        first = res[0][1]
        clean = np.flatnonzero((first.status == 1) & (first.quality == 0))
        if not clean.size:
            print("no quality-0 LP in the cold solve: no shared point")
            return 1
        i = int(clean[0])
        warm = (first.x[i], first.s[i], first.row_dual[i])
        res = solve(A, t2, ub * 0.998, dtype, a.device, jax_too, warm=warm)
        report(f"{a.dtype} warm round 1 from LP {i}'s point (shared)", res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
