"""Subprocess worker for the port's real multi-process tests.

Each worker is one process of a ``torch.distributed`` group (Gloo over
localhost, LPs on the CPU).  The parent test
(tests/test_torch_multiprocess.py) spawns P of these with a shared
coordinator port, waits, and compares the artifacts they write.  The
worker imports the port only, never JAX.

Usage: python torch_multiproc_worker.py MODE PORT NPROC PID OUTDIR
"""

import json
import sys


def main() -> None:
    mode, port, nproc, pid, outdir = sys.argv[1:6]
    nproc, pid = int(nproc), int(pid)

    import numpy as np
    import torch
    import torch.distributed

    from bensolve_tpu_torch.parallel import distributed as dist

    torch.set_num_threads(1)
    dist.initialize(f"localhost:{port}", nproc, pid)
    try:
        if torch.distributed.get_world_size() != nproc:
            raise SystemExit("process group has the wrong size")
        run(mode, pid, outdir, np, dist)
    finally:
        torch.distributed.destroy_process_group()


def run(mode, pid, outdir, np, dist) -> None:
    if mode == "allgather":
        # uneven strided shards (total=7 over 2 processes -> 4 and 3
        # rows): the NaN padding/drop path of allgather_rows
        total = 7
        idx = dist.shard_indices(total)
        local = np.stack([np.arange(3.0) + 10 * i for i in idx]) \
            if idx.size else np.zeros((0, 3))
        out = dist.allgather_rows(local, total=total)
        np.save(f"{outdir}/allgather_{pid}.npy", out)
    elif mode in ("solve", "solve_dual"):
        from bensolve_tpu_torch import examples
        from bensolve_tpu_torch.algs.driver import solve
        from bensolve_tpu_torch.vlp.options import Alg, Options

        opt = Options(distributed=True, write_files=False, device="cpu")
        if mode == "solve_dual":
            opt.alg_phase1 = opt.alg_phase2 = Alg.DUAL
        r = solve(examples.example05(), opt)
        np.save(f"{outdir}/pts_{pid}.npy", r.primal_points)
        np.save(f"{outdir}/dpts_{pid}.npy", r.dual_points)
        with open(f"{outdir}/stats_{pid}.json", "w") as f:
            json.dump({"status": r.status.name, "lps": r.stats.lps,
                       "rounds": r.stats.rounds, "cuts": r.stats.cuts}, f)
    elif mode == "many":
        # instance-level DP across processes: each owns a strided shard
        # of the instance list
        from bensolve_tpu_torch.algs.many import solve_many
        from bensolve_tpu_torch.examples import random_vlp
        from bensolve_tpu_torch.vlp.options import Options

        vlps = [random_vlp(q=2, m=6, n=5, seed=s) for s in range(24)]
        rs = solve_many(vlps, Options(bounded=True, write_files=False,
                                      device="cpu"))
        owned = [i for i, r in enumerate(rs) if r is not None]
        np.save(f"{outdir}/many_idx_{pid}.npy", np.asarray(owned))
        for i in owned:
            np.save(f"{outdir}/many_pts_{i}.npy", rs[i].primal_points)
        with open(f"{outdir}/many_stats_{pid}.json", "w") as f:
            json.dump({str(i): rs[i].status.name for i in owned}, f)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
