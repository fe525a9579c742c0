"""The interior-point graphs' piece size (``ipm.PIECE``: iterations per
replay between two copies of the running flag) against ms per
iteration and the iterations run past the JAX package's stop.

    python3 tests/witness_ipm_piece.py [--pieces 1 2 4] [--out PATH]

For each case and each piece size, one ``solve_batch_ipm`` call by
replayed CUDA graphs captures its graphs (the cache emptied first), then
a second identical call is timed: a synchronised host clock around
every ``ipm._ipm_core`` segment, over the iterations the segments ran;
it prints one JSON line with ms per iteration, the iterations, the
iterations past the JAX stop (``ipm.LAST["past_stop"]``), replays, and
the LPResult's statuses, which must not depend on the piece size (every
case's are held to the first piece size's).  Cases, with the host HiGHS
fallback capped at 0: the P2 LPs of ``random_vlp(2, 150, 300)`` at
float64, B = 64, to the end; BASELINE config #4's P2 LPs at float32, B =
8 and B = 128, to the end without host polish.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _cases():
    from bensolve_tpu_torch.bench import make_p2_instances

    tv, ub = make_p2_instances(64, q=2, m=150, n=300, seed=0,
                               dtype=np.float64, device="cuda")
    small = (tv.A_lp,) + tuple(tv.build_inputs(ub))
    t4, ub = make_p2_instances(128, dtype=np.float32, device="cuda")
    big = (t4.A_lp,) + tuple(t4.build_inputs(ub))
    tail = (big[0],) + tuple(x[:8] for x in big[1:])
    return [("random_vlp(2, 150, 300) P2 B=64 float64", small,
             dict(dtype=np.float64)),
            ("config #4 P2 B=8 float32", tail,
             dict(dtype=np.float32, polish=False)),
            ("config #4 P2 B=128 float32", big,
             dict(dtype=np.float32, polish=False))]


def _timed(args, kw):
    from bensolve_tpu_torch.lp import ipm, segments

    segs, real = [], ipm._ipm_core

    def clock(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a)
        torch.cuda.synchronize()
        segs.append((out[1], time.perf_counter() - t0))
        return out

    segments.reset_counts()
    ipm._ipm_core = clock
    try:
        res = ipm.solve_batch_ipm(*args, device="cuda", **kw)
    finally:
        ipm._ipm_core = real
    its = sum(n for n, _ in segs)
    secs = sum(s for _, s in segs)
    return res, dict(iterations=its, ms_per_iteration=1e3 * secs / its,
                     past_stop=ipm.LAST["past_stop"],
                     replays=segments.counts()["by_loop"]["ipm"]["replays"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pieces", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("witness_ipm_piece: needs a CUDA device", file=sys.stderr)
        return 1
    from bensolve_tpu_torch.bench import host_fallback_cap
    from bensolve_tpu_torch.lp import ipm, segments

    torch.backends.cuda.matmul.allow_tf32 = False
    out = open(a.out, "w") if a.out else None
    with host_fallback_cap(0):
        for name, args, kw in _cases():
            ref = None
            for piece in a.pieces:
                ipm.PIECE = piece
                segments.clear()
                _timed(args, kw)                    # captures
                res, rec = _timed(args, kw)
                if ref is None:
                    ref = res.status
                assert np.array_equal(res.status, ref), (name, piece)
                rec = dict(case=name, piece=piece, **rec,
                           statuses={int(k): int(v) for k, v in zip(
                               *np.unique(res.status, return_counts=True))})
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
