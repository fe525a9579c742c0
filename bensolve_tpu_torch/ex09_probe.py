"""ex09 probe: solve the largest reference instance on the card; the port
of the repo's ``ex09_probe.py``.

    python -m bensolve_tpu_torch.ex09_probe [PATH] [--device cuda|cpu]

PATH defaults to ``examples.REFERENCE_EX``'s ex09.vlp.  Flags mirror the
reference's recommendation (ex/example09.m:10): -e 1e-2, float32 LP
arithmetic.  The scalar LPs go through the interior-point route
(BENSOLVE_IPM_MIN defaults to 2000, BENSOLVE_IPM_BYTES to 6e9).  Exits
0 when the solve ends OPTIMAL, 1 otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from bensolve_tpu_torch.examples import REFERENCE_EX


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=f"{REFERENCE_EX}/ex09.vlp")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    os.environ.setdefault("BENSOLVE_IPM_MIN", "2000")
    os.environ.setdefault("BENSOLVE_IPM_BYTES", "6000000000")

    from bensolve_tpu_torch.algs.driver import solve
    from bensolve_tpu_torch.lp.simplex import resolve_device
    from bensolve_tpu_torch.vlp.options import Options
    from bensolve_tpu_torch.vlp.reader import read_vlp

    resolve_device(a.device)
    t0 = time.time()
    vlp = read_vlp(a.path)
    print(f"parsed in {time.time()-t0:.1f}s: q={vlp.q} m={vlp.m} n={vlp.n}",
          flush=True)

    opt = Options(lp_dtype="float32", eps_benson_phase2=1e-2,
                  message_level=2, lp_message_level=2, write_files=False,
                  device=a.device)
    t0 = time.time()
    r = solve(vlp, opt)
    dt = time.time() - t0
    print(f"status={r.status.name} wall={dt:.1f}s lps={r.stats.lps} "
          f"rounds={r.stats.rounds} cuts={r.stats.cuts}", flush=True)
    if r.pair is not None:
        print("primal points:", len(r.primal_points),
              "dirs:", len(r.primal_directions))
        print(r.primal_points[:10])
    return 0 if r.status.name == "OPTIMAL" else 1


if __name__ == "__main__":
    sys.exit(main())
