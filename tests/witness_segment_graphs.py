"""Walls of the main path with the pivot loops eager and as replayed CUDA
graphs (bensolve_tpu_torch/lp/segments.py), on the card.

    python tests/witness_segment_graphs.py [--many N] [--cases ...]

Cases, each at float64: example10 with the primal and with the dual
Benson algorithm, ex11 (example11) at its defaults, BASELINE config #5
(N x random_vlp(q=3, m=10, n=8, seed=s), bounded, solve_many), and the
tall VLP of chip_smoke.py's phase 8 (random_vlp(q=2, m=50, n=500), every
LP through the revised simplex) with the primal and with the dual
algorithm.  Each
case runs in turns, eager, graph, graph, eager (the graph cache lives
for the process, so the first graph run holds the captures), then once
eagerly and once by graph under torch.profiler: the device busy share
is the union of the trace's kernel intervals over the profiled wall.
Per run: wall, pivot steps by graph and eager, captures and their
seconds, replays (in all and per loop), and the revised LP layer's
seconds (a synchronised host clock around every batched revised solve)
and solves.  Every run's vertex set equals the first eager run's
bit for bit (the graphs pivot as the eager loop does).  One JSON line
per case, and the card's name and power limit.  Without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bensolve_tpu_torch import examples, solve  # noqa: E402
from bensolve_tpu_torch.lp import segments  # noqa: E402
from bensolve_tpu_torch.vlp.options import Alg, Options  # noqa: E402

ORDER = ("eager", "graph", "graph", "eager")


def _cases(many_n, device):
    f64 = dict(write_files=False, device=device)
    dual = dict(alg_phase1=Alg.DUAL, alg_phase2=Alg.DUAL)
    vlps = None

    def many():
        from bensolve_tpu_torch.algs.many import solve_many

        nonlocal vlps
        if vlps is None:
            vlps = [examples.random_vlp(q=3, m=10, n=8, seed=s)
                    for s in range(many_n)]
        return solve_many(vlps, Options(bounded=True, **f64))

    return {
        "example10 primal": lambda: [solve(examples.example10(),
                                           Options(**f64))],
        "example10 dual": lambda: [solve(examples.example10(),
                                         Options(**dual, **f64))],
        "ex11": lambda: [solve(examples.example11(), Options(**f64))],
        f"config #5 ({many_n} instances)": many,
        "tall primal": lambda: [solve(examples.random_vlp(q=2, m=50, n=500),
                                      Options(**f64))],
        "tall dual": lambda: [solve(examples.random_vlp(q=2, m=50, n=500),
                                    Options(**dual, **f64))],
    }


def _points(results):
    return [np.asarray(r.primal_points) for r in results]


def _busy(trace_path):
    """(union of kernel intervals, their sum) in s and the kernel count,
    from a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "kernel")
    union, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e6, sum(b - a for a, b in spans) / 1e6, len(spans)


def _run(fn, mode, profile=False):
    from bensolve_tpu_torch.lp import revised

    segments.reset_counts()
    ctx = (segments.eager_loop() if mode == "eager"
           else contextlib.nullcontext())
    prof = None
    real, layer = revised._solve_revised_segmented, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        layer.append(time.perf_counter() - t0)
        return out

    revised._solve_revised_segmented = timed
    with ctx, contextlib.ExitStack() as stack:
        stack.callback(setattr, revised, "_solve_revised_segmented", real)
        if profile:
            prof = stack.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = dict(mode=mode, wall_s=wall, **segments.counts(),
               revised_s=sum(layer), revised_solves=len(layer))
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            union, total, n = _busy(path)
        rec.update(profiled=True, kernels=n, busy_s=union,
                   kernel_sum_s=total, busy_share=union / wall)
    return out, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--many", type=int, default=10_000,
                    help="config #5's instances")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="case names' first words (default: all)")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("witness_segment_graphs: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if args.device == "cuda" \
        else "no card"
    print(smi, flush=True)
    for name, fn in _cases(args.many, args.device).items():
        if args.cases and not any(name.startswith(c) for c in args.cases):
            continue
        runs, ref = [], None
        modes = ORDER + (() if args.no_profile else ("eager", "graph"))
        for i, mode in enumerate(modes):
            out, rec = _run(fn, mode, profile=i >= len(ORDER))
            pts = _points(out)
            if ref is None:
                ref = pts
            elif not all(a.shape == b.shape and np.array_equal(a, b)
                         for a, b in zip(pts, ref)):
                raise AssertionError(f"{name}: the {mode} run's vertices "
                                     f"differ from the first eager run's")
            if (rec["replays"] > 0) != (mode == "graph"):
                raise AssertionError(f"{name}: a {mode} run replayed "
                                     f"{rec['replays']} graphs")
            runs.append(rec)
            print(f"[witness] {name} {mode}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in rec.items() if k != "mode"), flush=True)
        print(json.dumps(dict(case=name, card=smi, runs=runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
