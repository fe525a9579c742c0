"""Which kernels torch launches for the interior-point iteration's
batched Cholesky and solves, and whether each call survives CUDA graph
capture and replay.

    python3 tests/witness_ipm_linalg.py [--out PATH]

For each (B, M, dtype) of the IPM's shapes on the main path (config #4's
P2 LPs at B = 128 and at a compaction tail of 8, the 155x303 P2 LP of
random_vlp(2, 150, 300) at B = 64, ex09's shape at B = 8, a small
batch) it builds B symmetric positive definite matrices S and a right
side r from a seed, and for each call of ``lp/ipm.py::_Core``'s factor
and solve:

* ``cholesky_ex``: ``torch.linalg.cholesky_ex(S)``;
* ``cholesky_solve``: ``torch.cholesky_solve(r, L)``;
* ``triangular pair``: ``solve_triangular(L, r, upper=False)`` then
  ``solve_triangular(L^T, ., upper=True)``;
* ``triangular pair by 8``: the same pair on groups of at most 8
  matrices;

it prints one JSON line: the CUDA kernel names ``torch.profiler`` saw
for one call, the eager milliseconds (CUDA events, the mean of 5), and
the graph check: the call captured once into a ``torch.cuda.CUDAGraph``
on static inputs, then twice new inputs copied in, pinned host memory
allocated and overwritten (so that a pointer array left in freed pinned
memory is clobbered), one replay, and its output held bit for bit to an
eager call on the same inputs ("equal", the largest difference, or the
capture's error).  Each shape runs in a process of its own, so that a
capture that breaks the CUDA context spoils no other shape's lines.
``--shapes`` takes a subset by index.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

SHAPES = [
    (128, 1011, "float32", "config #4 B=128"),
    (8, 1011, "float32", "config #4 tail B=8"),
    (64, 155, "float64", "random_vlp(2,150,300) P2 B=64"),
    (8, 4615, "float32", "ex09 shape B=8"),
    (4, 20, "float64", "small B=4"),
]


def _spd(B, M, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    W = torch.randn(B, M, 2 * M, dtype=dtype, device="cuda", generator=g)
    S = torch.bmm(W, W.transpose(1, 2)) / (2 * M)
    S.diagonal(dim1=1, dim2=2).add_(1.0)
    r = torch.randn(B, M, 1, dtype=dtype, device="cuda", generator=g)
    return S, r


def _calls():
    def chol(S, L, r):
        return torch.linalg.cholesky_ex(S)[0]

    def chol_solve(S, L, r):
        return torch.cholesky_solve(r, L)

    def tri_pair(S, L, r):
        y = torch.linalg.solve_triangular(L, r, upper=False)
        return torch.linalg.solve_triangular(L.transpose(1, 2), y,
                                             upper=True)

    def tri_by_8(S, L, r):
        return torch.cat([tri_pair(None, L[b:b + 8], r[b:b + 8])
                          for b in range(0, L.shape[0], 8)])

    # the call most likely to break a capture last
    return {"cholesky_ex": chol, "triangular pair": tri_pair,
            "triangular pair by 8": tri_by_8, "cholesky_solve": chol_solve}


def _kernels(fn, args):
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if "CUDA" in str(e.device_type)})


def _eager_ms(fn, args, reps=5):
    fn(*args)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _churn_pinned():
    for _ in range(4):
        p = torch.empty(1 << 20, dtype=torch.int64, pin_memory=True)
        p.fill_(-1)
        del p


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _graph_check(fn, args, fresh):
    """Capture fn on static copies of args, replay on new inputs twice;
    ("equal" | "differs by x" | "capture failed: ...", replay ms)."""
    static = [a.clone() for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn(*static)
    except Exception as exc:     # report it: this is what the probe asks
        torch.cuda.synchronize()
        return f"capture failed: {type(exc).__name__}: {exc}"[:400], None
    verdict = "equal"
    for k in range(2):
        new = fresh(k)
        for s, a in zip(static, new):
            s.copy_(a)
        torch.cuda.synchronize()
        _churn_pinned()
        graph.replay()
        torch.cuda.synchronize()
        want = fn(*new)
        if not torch.equal(_bits(out), _bits(want)):
            diff = (out - want).abs().max().item()
            verdict = f"differs by {diff:.3e} (replay {k})"
            break
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(5):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 5
    graph.reset()
    return verdict, ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--shapes", type=int, nargs="*", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("witness_ipm_linalg: needs a CUDA device", file=sys.stderr)
        return 1
    out = open(a.out, "w") if a.out else None
    if a.shapes is None or len(a.shapes) > 1:
        print(json.dumps({
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": torch.cuda.get_device_name(0),
            "preferred_linalg_library": str(
                torch.backends.cuda.preferred_linalg_library())}), flush=True)
    picks = a.shapes if a.shapes is not None else range(len(SHAPES))
    if a.shapes is None or len(picks) > 1:
        import subprocess
        rc = 0
        for i in picks:
            cmd = [sys.executable, os.path.abspath(__file__), "--shapes",
                   str(i)] + (["--out", a.out + f".{i}"] if a.out else [])
            rc |= subprocess.run(cmd).returncode
        return rc
    for i in picks:
        B, M, dt, name = SHAPES[i]
        dtype = getattr(torch, dt)
        S, r = _spd(B, M, dtype, 0)
        L = torch.linalg.cholesky_ex(S)[0]

        def fresh(k, B=B, M=M, dtype=dtype):
            S2, r2 = _spd(B, M, dtype, 10 + k)
            return S2, torch.linalg.cholesky_ex(S2)[0], r2

        for call, fn in _calls().items():
            args = (S, L, r)
            rec = dict(shape=name, B=B, M=M, dtype=dt, call=call,
                       kernels=_kernels(fn, args),
                       eager_ms=_eager_ms(fn, args))
            rec["graph"], rec["replay_ms"] = _graph_check(fn, args, fresh)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del S, r, L
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
