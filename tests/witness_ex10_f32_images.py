"""example10 at float32: how far apart the primal and dual upper images lie.

    python tests/witness_ex10_f32_images.py --device cuda --sizes 3,2 2,2 3,1
    python tests/witness_ex10_f32_images.py --device cpu --sizes 2,1 2,2

For each ``examples.example10(q, m)`` of ``--sizes`` it solves the VLP
with the primal and with the dual algorithm at float32 (epsilon 1e-4 in
both phases, the bench's ``F32_KW``) and once at float64 (primal), each
``--runs`` times, and prints the largest relative gap between support
functions (``bench.images_close`` at 4,096 weights) of: float32 primal
against float32 dual (the gap the bench's ex10 stage gates), and each
float32 image against the float64 one.  The last line is one JSON
object with every reading; it is the evidence for the bench's float32
image limit.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bensolve_tpu_torch import examples, solve  # noqa: E402
from bensolve_tpu_torch.bench import F32_KW, images_close  # noqa: E402
from bensolve_tpu_torch.vlp.options import Alg, Options  # noqa: E402


def _solve(vlp, device, alg, **kw):
    opt = Options(write_files=False, device=device, alg_phase1=Alg(alg),
                  alg_phase2=Alg(alg), **kw)
    t0 = time.perf_counter()
    r = solve(vlp, opt)
    assert r.status.name == "OPTIMAL", r.status
    return r, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", nargs="+", default=["3,2"],
                    help="q,m pairs of examples.example10")
    ap.add_argument("--runs", type=int, default=1)
    a = ap.parse_args(argv)
    readings = []
    for size in a.sizes:
        q, m = (int(v) for v in size.split(","))
        ref, _ = _solve(examples.example10(q, m), a.device, "primal")
        for run in range(a.runs):
            rp, tp = _solve(examples.example10(q, m), a.device, "primal",
                            **F32_KW)
            rd, td = _solve(examples.example10(q, m), a.device, "dual",
                            **F32_KW)
            row = dict(q=q, m=m, run=run,
                       f32_primal_vs_dual=images_close(rp, rd, np.inf),
                       f32_primal_vs_f64=images_close(rp, ref, np.inf),
                       f32_dual_vs_f64=images_close(rd, ref, np.inf),
                       points=[len(rp.primal_points), len(rd.primal_points)],
                       walls_s=[tp, td])
            readings.append(row)
            print(f"example10({q}, {m}) run {run}: float32 primal vs dual "
                  f"{row['f32_primal_vs_dual']:.3e}, primal vs float64 "
                  f"{row['f32_primal_vs_f64']:.3e}, dual vs float64 "
                  f"{row['f32_dual_vs_f64']:.3e}; points {row['points']}, "
                  f"walls {tp:.2f} s {td:.2f} s", flush=True)
    worst = max(r["f32_primal_vs_dual"] for r in readings)
    print(json.dumps({"device": a.device, "worst_primal_vs_dual": worst,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
