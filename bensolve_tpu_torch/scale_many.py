"""BASELINE.json config #5: scenario-batched portfolio VLP at scale.

Solves N random bounded VLP instances ``random_vlp(q, m, n, seed=s)``,
s = 0 .. N-1, through the lockstep many-VLP engine
(``algs.many.solve_many``), optionally over a device mesh, and prints
per-status counts, instances/s and LPs/s.  The port of the repo's
``scale_many.py``.

Usage:
    python -m bensolve_tpu_torch.scale_many [N] [--mesh] [--q Q] [--m M]
        [--n NVARS] [--device cuda|cpu]

``--mesh`` shards every merged LP batch over ``parallel.mesh.make_mesh(4)``
entries of the device (on one card, four streams of it).  The device
is the card unless ``--device cpu`` is given; without a card the run
raises.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

# BASELINE config #5: instances, and the shape of each
N_INSTANCES = 10_000
SHAPE = dict(q=3, m=10, n=8)
MESH_ENTRIES = 4


def run(n_inst: int = N_INSTANCES, q: int = SHAPE["q"], m: int = SHAPE["m"],
        n: int = SHAPE["n"], mesh: bool = False, device: str = "cuda",
        log=print) -> dict:
    """Make the instances and solve them with ``solve_many``; returns the
    results, the wall of the solve (synchronised on a card), the status
    counts, the LP total and the most lockstep rounds of an instance."""
    import torch

    from bensolve_tpu_torch.algs.many import solve_many
    from bensolve_tpu_torch.examples import random_vlp
    from bensolve_tpu_torch.lp.simplex import resolve_device
    from bensolve_tpu_torch.parallel.mesh import make_mesh
    from bensolve_tpu_torch.vlp.options import Options

    dev = resolve_device(device)
    t0 = time.perf_counter()
    vlps = [random_vlp(q=q, m=m, n=n, seed=s) for s in range(n_inst)]
    make_s = time.perf_counter() - t0
    log(f"generated {n_inst} instances in {make_s:.1f}s")

    grid = make_mesh(MESH_ENTRIES, ("dp",), device=dev.type) if mesh \
        else None
    opt = Options(bounded=True, write_files=False, device=dev.type)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = solve_many(vlps, opt, mesh=grid)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    local = [r for r in rs if r is not None]
    counts = collections.Counter(r.status.name for r in local)
    lps = sum(r.stats.lps for r in local)
    rounds = max((r.stats.rounds for r in local), default=0)
    log(f"solved {len(local)}/{n_inst} local instances in {wall:.1f}s "
        f"({len(local) / wall:.1f} inst/s, {lps} LPs, "
        f"{lps / wall:.0f} LP/s)")
    log(f"statuses: {dict(counts)}")
    log(f"lockstep rounds: {rounds}")
    return dict(results=rs, wall=wall, make_s=make_s, counts=dict(counts),
                lps=lps, rounds=rounds, instances=len(local))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Solve N random bounded VLPs (BASELINE config #5) "
                    "with solve_many.")
    ap.add_argument("N", nargs="?", type=int, default=N_INSTANCES)
    ap.add_argument("--mesh", action="store_true",
                    help=f"shard over make_mesh({MESH_ENTRIES}) entries")
    ap.add_argument("--q", type=int, default=SHAPE["q"])
    ap.add_argument("--m", type=int, default=SHAPE["m"])
    ap.add_argument("--n", type=int, default=SHAPE["n"])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    run(a.N, a.q, a.m, a.n, mesh=a.mesh, device=a.device,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
