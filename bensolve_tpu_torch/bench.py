"""Benchmark of the port on one card: the repo's bench.py metrics, and more.

    python -m bensolve_tpu_torch.bench [--device cuda|cpu] [--stages STAGE ...]
        [--highs-k K] [--device-lps M N B] [--p2 Q M N B]
        [--p2-warm R] [--p2-host-cap K] [--many N] [--ex10 Q M]
        [--tall Q M N]

Prints ONE JSON line, last on stdout, with every key of the repo's
``bench.py`` under the same names, and more; progress and per-stage
detail go to stderr.  A stage left out by ``--stages`` gives ``null``.
Stages, in this order:

* ``device``: ``make_instances(96, 96, 4096)``, random feasible bounded
  float32 LPs over one matrix, through the router
  ``lp.solve_batch_auto``.  On a card the batch pads to Mp = 96,
  NT = 256 and reaches the per-LP kernel (cluster C = 1, 16 launches of
  256 LPs per solve); the launches per variant are reported and a run
  with none fails.  One cold solve, three timed re-solves with scaled
  objectives (``value``, LP/s: the batch over the fastest), then the
  Benson re-solve pattern: row bounds tightened by 1%, each LP warm
  from its own optimal basis through ``dual_simplex.solve_batch_dual``
  (``warm_pivots_per_lp``).  There is no fallback: a kernel that fails
  to build or launch fails the run.
* ``serial``: scipy's HiGHS on the first k = 24 of those LPs, one at a
  time (``vs_baseline`` = ``value`` over its rate).
* ``p2``: BASELINE config #4, the P2 template of
  ``random_vlp(q=5, m=1000, n=2000, seed=7)`` (LP 1011 x 2006) at
  float32 for B = 128 synthetic frontier vertices, through the
  interior-point route (``ipm_min`` 2000): one cold solve, then re-solves
  with the row bounds scaled by 1 - 0.002 (r + 1), and serial HiGHS on
  ``--highs-k`` of the same LPs (null when k is 0).  The IPM hands the
  LPs it leaves unresolved or loose to HiGHS on the host, at most
  ``--p2-host-cap`` of them per call (12-22 s each on the card's host).
  At the reference's cap of 32, the cap bench.py runs with, the rate is
  bench.py's ``p2_LPs_per_s`` (B over the fastest re-solve) and
  ``p2_vs_baseline``; at any other cap (0 by default, which keeps the
  run to minutes) the same numbers are ``p2_LPs_per_s_fallback_capped``
  and ``p2_vs_baseline_fallback_capped``, and bench.py's keys stay null.
  ``p2_host_bound`` counts, per round (cold first), the LPs the IPM
  would hand to the host with no cap.
* ``ex11``: ``examples.example11()`` with the default Options, one
  warm-up solve and one timed solve (``ex11_wall_s``,
  ``benson_iters_per_s`` = (rounds + 1) / wall).
* ``many``: BASELINE config #5 through ``scale_many.run``: N x
  ``random_vlp(q=3, m=10, n=8, seed=s)``, bounded, float64, lockstep
  (``many_instances_per_s``, ``many_LPs_per_s``).
* ``ex10``: ``examples.example10()`` wall at float64 and at float32
  (epsilon 1e-4), with the primal and with the dual algorithm.
* ``tall``: ``random_vlp(q=2, m=50, n=500)`` at float64 with the primal
  algorithm, the revised simplex's route.

Gates: a rate is printed only behind its gate; a failed gate raises and
the run exits non-zero without printing the JSON line.  ``device``:
every LP OPTIMAL, cold and warm, and the first k objectives within 1e-3
(relative) of HiGHS.  ``p2``: at least 90% of every round OPTIMAL, cold
and warm, and the cold round's LPs 0-3 within 1e-3 of HiGHS (the first
min(4, k) of them).
``ex11``: OPTIMAL and the support-function oracle at 1e-4.  ``many``:
every instance OPTIMAL, and at config #5's size 740,232 LPs in 15
rounds.  ``ex10``, ``tall``: OPTIMAL and the oracle (1e-4 at float64,
1e-3 at float32); example10's primal and dual upper images within 1e-6
at float64 and ``EX10_F32_IMAGES`` at float32.

``--device cpu`` runs every stage on the CPU (the tests); without it the
bench runs on the card and raises when there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

STAGES = ("device", "serial", "p2", "ex11", "many", "ex10", "tall")
# the keys of the repo's bench.py result line, under the same names
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "p2_LPs_per_s",
              "p2_vs_baseline", "ex11_wall_s", "benson_iters_per_s",
              "cold_pivots_per_lp", "warm_pivots_per_lp")
# the rest of the result line
EXTRA_KEYS = ("device", "device_name", "device_kernel_launches",
              "serial_LPs_per_s", "p2_cold_s", "p2_warm_s",
              "p2_host_fallback_cap", "p2_host_bound",
              "p2_LPs_per_s_fallback_capped",
              "p2_vs_baseline_fallback_capped",
              "ex11_lps", "ex11_rounds", "many_instances", "many_wall_s",
              "many_instances_per_s", "many_LPs_per_s", "many_lps",
              "many_rounds", "ex10_wall_s_f64", "ex10_wall_s_f32",
              "ex10_dual_wall_s_f64", "ex10_dual_wall_s_f32", "tall_wall_s")
# the P2 template's interior-point threshold (M + N); a smaller template
# takes the route from its own M + N
P2_IPM_MIN = 2000
# the IPM's host HiGHS fallback cap (LPs per call) that bench.py runs with
REFERENCE_HOST_CAP = 32
# LPs of the device stage solved by serial HiGHS (at most the batch)
SERIAL_K = 24
# config #5's LP total and lockstep rounds at scale_many's defaults
MANY_LPS, MANY_ROUNDS = 740_232, 15
F32_KW = dict(lp_dtype="float32", eps_benson_phase1=1e-4,
              eps_benson_phase2=1e-4)
# example10's float32 primal and dual upper images: the largest gap that
# tests/witness_ex10_f32_images.py read over example10(q, m) from (2, 1)
# to (3, 3) was 8.3e-7 (on the CPU; 8.1e-7 on an H100, equal in two
# runs), 1.2 times under 1e-6; this limit is 12 times the largest
# reading and 100 times under the oracle's 1e-3
EX10_F32_IMAGES = 1e-5


class GateError(AssertionError):
    """A correctness gate failed: the bench prints no result."""


def gate(ok, what: str) -> None:
    if not ok:
        raise GateError(what)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def host_fallback_cap(n: int):
    """The IPM's host HiGHS fallback capped at n LPs per call
    (BENSOLVE_HOST_FALLBACK_MAX) inside the block, restored after it."""
    saved = os.environ.get("BENSOLVE_HOST_FALLBACK_MAX")
    os.environ["BENSOLVE_HOST_FALLBACK_MAX"] = str(n)
    try:
        yield
    finally:
        os.environ.pop("BENSOLVE_HOST_FALLBACK_MAX", None)
        if saved is not None:
            os.environ["BENSOLVE_HOST_FALLBACK_MAX"] = saved


def make_instances(M, N, B, seed=0, dtype=np.float32):
    """Random feasible bounded LP batch sharing one constraint matrix:
    min c'x  s.t.  Ax <= b (b = A x0 + margin), 0 <= x <= 10 (the
    instances of bench.py::make_instances)."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(dtype)
    x0 = rng.random((B, N)).astype(dtype)
    b = (x0 @ A.T + 0.5 + rng.random((B, M))).astype(dtype)
    c = rng.standard_normal((B, N)).astype(dtype)
    row_lb = np.full((B, M), -np.inf, dtype)
    col_lb = np.zeros((B, N), dtype)
    col_ub = np.full((B, N), 10.0, dtype)
    return A, c, row_lb, b, col_lb, col_ub


def highs_one(A, ci, rlb, rub, clb, cub):
    """One serial HiGHS solve over the full bound-type range: rows split
    by pattern (equality, <=, >=), free rows dropped (linprog rejects a
    non-finite b_ub, and the P2 template's eta row is free)."""
    from scipy.optimize import linprog

    A = np.float64(A)
    rlb, rub = np.float64(rlb), np.float64(rub)
    eq = np.isfinite(rlb) & np.isfinite(rub) & (rlb == rub)
    ub_rows = np.isfinite(rub) & ~eq
    lb_rows = np.isfinite(rlb) & ~eq
    A_ub = np.concatenate([A[ub_rows], -A[lb_rows]])
    b_ub = np.concatenate([rub[ub_rows], -rlb[lb_rows]])
    return linprog(np.float64(ci),
                   A_ub=A_ub if A_ub.size else None,
                   b_ub=b_ub if b_ub.size else None,
                   A_eq=A[eq] if eq.any() else None,
                   b_eq=rub[eq] if eq.any() else None,
                   bounds=list(zip(np.float64(clb), np.float64(cub))),
                   method="highs")


def make_p2_instances(B, q=5, m=1000, n=2000, seed=7, dtype=np.float32,
                      device="cpu"):
    """The P2-template LP batch of BASELINE config #4 (bench.py::
    make_p2_instances): the template of ``random_vlp(q, m, n, seed)``
    with Z'c = 1 and eta = 1/q, through the interior-point route, and B
    synthetic frontier vertices' row bounds V ZR."""
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu_torch.examples import random_vlp

    vlp = random_vlp(q=q, m=m, n=n, seed=seed)
    Z = np.eye(q)
    c_dual = np.full(q, 1.0 / q)
    Z = Z / (Z.T @ c_dual)[None, :]
    eta = np.full(q, 1.0 / q)
    size = (m + 2 * q + 1) + (n + q + 1)
    t2 = P2Template(vlp, vlp.P.astype(float), Z, eta, INHOMOGENEOUS,
                    dtype=dtype, ipm_min=min(P2_IPM_MIN, size),
                    device=device)
    rng = np.random.default_rng(seed + 1)
    V = rng.random((B, q)) * 2.0 + 1.0
    return t2, V @ t2.ZR


def canonical(result):
    """P and the solution points and directions of the canonical min
    problem (the sign flips of bslv_vlp.c:856-861 and the output
    transforms undone)."""
    vlp, sol = result.vlp, result.sol
    flip = (sol.c_dir.value < 0) == (vlp.optdir == 1)
    P_eff = (-vlp.P if flip else vlp.P).astype(float)
    pts, dirs = result.primal_points.copy(), result.primal_directions.copy()
    pos = sol.c_dir.value > 0
    if (pos and vlp.optdir == -1) or (not pos and vlp.optdir == 1):
        pts, dirs = -pts, -dirs
    return P_eff, pts, dirs


def check_support(result, tol, n_samples=64):
    """Support-function oracle (the method of tests/test_e2e.py): for
    sampled w in the interior of C*, min over the solution points of
    w'y equals min over the feasible set of w'P x (scipy/HiGHS) within
    tol * (1 + |h|).  Returns the worst relative gap; raises past tol."""
    from scipy.optimize import linprog

    vlp, sol = result.vlp, result.sol
    P_eff, pts, dirs = canonical(result)
    gate(pts.shape[0] > 0, "support oracle: no upper-image point")
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(vlp.m):
        lo, hi = vlp.rows.lb[i], vlp.rows.ub[i]
        if np.isfinite(lo) and lo == hi:
            A_eq.append(vlp.A[i])
            b_eq.append(lo)
        else:
            if np.isfinite(hi):
                A_ub.append(vlp.A[i])
                b_ub.append(hi)
            if np.isfinite(lo):
                A_ub.append(-vlp.A[i])
                b_ub.append(-lo)
    kw = {}
    if A_ub:
        kw["A_ub"], kw["b_ub"] = np.array(A_ub), np.array(b_ub)
    if A_eq:
        kw["A_eq"], kw["b_eq"] = np.array(A_eq), np.array(b_eq)
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(n_samples):
        w = sol.Z @ (rng.random(sol.p) + 1e-3)
        w = w / np.abs(w).sum()
        lp = linprog(w @ P_eff, bounds=list(zip(vlp.cols.lb, vlp.cols.ub)),
                     method="highs", **kw)
        h_hat = float(np.min(pts @ w))
        if dirs.size and np.min(dirs @ w) < -1e-9:
            h_hat = -np.inf
        if lp.status == 3:
            gate(not np.isfinite(h_hat), "support oracle: unbounded missed")
            continue
        gate(lp.status == 0, f"support oracle: HiGHS {lp.message}")
        gap = abs(h_hat - lp.fun) / (1 + abs(lp.fun))
        worst = max(worst, gap)
        gate(gap <= tol, f"support oracle: gap {gap:.2e} > {tol} at w={w}")
    return worst


def images_close(ra, rb, tol, n_samples=4096):
    """Largest relative gap between the support functions (min over the
    points of w'y) of two solutions' upper images at sampled w in the
    interior of C*; raises past tol.  Two epsilon-solutions of one VLP
    agree here even where their vertex lists differ."""
    _, pa, _ = canonical(ra)
    _, pb, _ = canonical(rb)
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(n_samples // 1024):
        W = ra.sol.Z @ (rng.random((ra.sol.p, 1024)) + 1e-3)
        W /= np.abs(W).sum(axis=0)
        ha, hb = (pa @ W).min(axis=0), (pb @ W).min(axis=0)
        worst = max(worst, float((np.abs(ha - hb) / (1 + np.abs(hb))).max()))
    gate(worst <= tol, f"upper images differ by {worst:.2e} > {tol}")
    return worst


def _sync(device) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _timed(device, fn, *args, **kw):
    """fn(*args, **kw) and its seconds, synchronised on the card."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(device)
    return out, time.perf_counter() - t0


def _launches():
    from bensolve_tpu_torch.lp import group_simplex as gs

    return {"cluster": gs.CALLS_CLUSTER, "global": gs.CALLS_GLOBAL}


def run_device(device, M, N, B, reps=3):
    """The LP batch through the router, cold, re-solved, and warm."""
    from bensolve_tpu_torch.lp import simplex, solve_batch_auto
    from bensolve_tpu_torch.lp.dual_simplex import solve_batch_dual

    A, c, row_lb, row_ub, col_lb, col_ub = make_instances(M, N, B)

    def solve(cc):
        return solve_batch_auto(A, cc, row_lb, row_ub, col_lb, col_ub,
                                dtype=np.float32, max_chunk=B, device=device)

    before = _launches()
    cold, cold_s = _timed(device, solve, c)
    gate((cold.status == simplex.OPTIMAL).all(),
         f"device: {int((cold.status != simplex.OPTIMAL).sum())} of {B} "
         f"cold LPs not OPTIMAL")
    times = []
    res = cold
    for r in range(reps):
        # scaled objectives: the same optimal bases, nothing cached
        res, t = _timed(device, solve, c * (1.0 + 0.01 * (r + 1)))
        gate((res.status == simplex.OPTIMAL).all(),
             f"device: re-solve {r} not all OPTIMAL")
        times.append(t)
    after = _launches()
    launches = {k: after[k] - before[k] for k in after}
    if device == "cuda":
        gate(launches["cluster"] + launches["global"] > 0,
             f"device: the batch made no kernel launch ({launches})")

    # the Benson re-solve pattern: each LP restarts from its own optimal
    # basis after a small row-bound tightening, which keeps the basis
    # dual feasible, through the dual simplex
    warm = (np.asarray(res.basis), np.asarray(res.at_upper))
    rub2 = (row_ub * 0.99).astype(row_ub.dtype)

    def wsolve():
        return solve_batch_dual(A, c, row_lb, rub2, col_lb, col_ub,
                                start_basis=warm, dtype=np.float32,
                                max_chunk=B, device=device)

    wsolve()
    wres, warm_s = _timed(device, wsolve)
    gate((wres.status == simplex.OPTIMAL).all(),
         f"device: {int((wres.status != simplex.OPTIMAL).sum())} warm LPs "
         f"not OPTIMAL")
    out = dict(rate=B / min(times), cold_s=cold_s, times=times,
               cold_pivots=float(cold.iters.mean()),
               warm_pivots=float(wres.iters.mean()), warm_rate=B / warm_s,
               launches=launches, obj=cold.obj, inputs=(A, c, row_lb, row_ub,
                                                        col_lb, col_ub))
    log(f"# device: {B} LPs {M}x{N} float32 on {device}: cold {cold_s:.3f} s "
        f"(all OPTIMAL), re-solves {[round(t, 4) for t in times]} s -> "
        f"{out['rate']:.1f} LP/s; kernel launches cluster/global "
        f"{launches['cluster']}/{launches['global']}; pivots/LP cold "
        f"{out['cold_pivots']:.2f}; warm re-solve (dual simplex) "
        f"{warm_s:.3f} s, {out['warm_rate']:.1f} LP/s, pivots/LP "
        f"{out['warm_pivots']:.2f}")
    return out


def run_serial(inputs, k, device_obj=None):
    """Serial HiGHS on the first k instances; with ``device_obj``, the
    device's objectives held to HiGHS's within 1e-3 relative."""
    A, c, row_lb, row_ub, col_lb, col_ub = inputs
    t0 = time.perf_counter()
    fun = []
    for i in range(k):
        res = highs_one(A, c[i], row_lb[i], row_ub[i], col_lb[i], col_ub[i])
        gate(res.status == 0, f"serial: HiGHS LP {i}: {res.message}")
        fun.append(res.fun)
    dt = time.perf_counter() - t0
    line = f"# serial: HiGHS on {k} LPs in {dt:.3f} s = {k / dt:.1f} LP/s"
    if device_obj is not None:
        fun = np.asarray(fun)
        err = np.abs(device_obj[:k] - fun) / (1 + np.abs(fun))
        worst = float(err.max()) if k else 0.0
        gate(worst <= 1e-3, f"device: objectives differ from HiGHS by "
             f"{worst:.2e} relative (limit 1e-3)")
        line += (f"; device objectives within {worst:.1e} relative "
                 f"(limit 1e-3)")
    log(line)
    return k / dt


def run_p2(device, q, m, n, B, warm_rounds, highs_k, host_cap=0):
    """Config #4's P2 rounds through the interior-point route, with the
    host fallback capped at ``host_cap`` LPs per IPM call."""
    from bensolve_tpu_torch.lp import ipm, simplex

    gate(warm_rounds >= 1, "p2: at least one warm round is timed")
    with host_fallback_cap(host_cap):
        t2, extra_ub = make_p2_instances(B, q, m, n, device=device)
        M, N = t2.A_lp.shape
        calls = ipm.CALLS
        host_bound = []

        def timed_round(name, ub):
            h0 = ipm.HOST_FALLBACK
            res, secs = _timed(device, t2.solve, ub)
            solved = ipm.HOST_FALLBACK - h0
            opt = res.status == simplex.OPTIMAL
            qual = (res.quality if res.quality is not None
                    else np.zeros(B, int))
            # the LPs the host solved, and those the cap left to the device
            host_bound.append(solved + int(((res.status == simplex.ITLIM)
                                            | (opt & (qual >= 1))).sum()))
            log(f"# p2: {name} {secs:.2f} s optimal={int(opt.sum())}/{B} "
                f"loose={int((qual == 2).sum())} bound for the host "
                f"fallback={host_bound[-1]}, solved there={solved} (cap "
                f"{host_cap} per call)")
            gate(opt.sum() >= 0.9 * B, f"p2: {name} {int(opt.sum())}/{B} "
                 f"OPTIMAL (< 90%)")
            return res, secs

        log(f"# p2: random_vlp(q={q}, m={m}, n={n}) P2 LP {M}x{N}, B={B}, "
            f"float32, ipm_min={t2.ipm_min}, on {device}")
        cold, cold_s = timed_round("cold", extra_ub)
        gate(ipm.CALLS > calls, "p2: the interior-point route was not taken")
        times = [timed_round(f"warm round {r}",
                             extra_ub * (1.0 - 0.002 * (r + 1)))[1]
                 for r in range(warm_rounds)]
    rate = B / min(times)

    base_rate = None
    if highs_k:
        obj, row_lb, row_ub, col_lb, col_ub = t2.build_inputs(extra_ub)
        t0 = time.perf_counter()
        errs = []
        for i in range(highs_k):
            h = highs_one(t2.A_lp, obj[i], row_lb[i], row_ub[i], col_lb[i],
                          col_ub[i])
            gate(h.status == 0, f"p2: HiGHS LP {i}: {h.message}")
            if i < 4:
                gate(cold.status[i] == simplex.OPTIMAL,
                     f"p2: cold LP {i} status {cold.status[i]}")
                errs.append(abs(cold.obj[i] - h.fun) / (1 + abs(h.fun)))
        base_rate = highs_k / (time.perf_counter() - t0)
        gate(max(errs) <= 1e-3, f"p2: cold LPs 0-{len(errs) - 1} differ "
             f"from HiGHS by {max(errs):.2e} relative (limit 1e-3)")
        log(f"# p2: serial HiGHS {base_rate:.4f} LP/s on {highs_k} LPs; "
            f"cold LPs 0-{len(errs) - 1} within {max(errs):.1e} relative "
            f"(limit 1e-3)")
    log(f"# p2: cold {cold_s:.2f} s, warm {[round(t, 3) for t in times]} s "
        f"-> {rate:.2f} LP/s")
    return dict(rate=rate, base_rate=base_rate, cold_s=cold_s, times=times,
                host_bound=host_bound)


def _solve(device, vlp, **kw):
    from bensolve_tpu_torch import solve
    from bensolve_tpu_torch.vlp.options import Alg, Options

    for k in ("alg_phase1", "alg_phase2"):
        if k in kw:
            kw[k] = Alg(kw[k])
    return _timed(device, solve, vlp,
                  Options(write_files=False, device=device, **kw))


def _checked(tag, r, wall, tol):
    gate(r.status.name == "OPTIMAL", f"{tag}: status {r.status}")
    gap = check_support(r, tol)
    log(f"# {tag}: OPTIMAL in {wall:.3f} s, {len(r.primal_points)} points "
        f"{len(r.primal_directions)} directions, {r.stats.lps} LPs "
        f"{r.stats.rounds} rounds {r.stats.pivots} pivots; support oracle "
        f"worst gap {gap:.1e} (limit {tol:g})")


def run_ex11(device):
    """ex11 with the default Options: a warm-up solve, then the timed one."""
    from bensolve_tpu_torch import examples

    _solve(device, examples.example11())
    r, wall = _solve(device, examples.example11())
    _checked("ex11", r, wall, 1e-4)
    log(f"# ex11: {r.stats.lps} LPs in {r.stats.rounds} rounds (the JAX "
        f"package on the CPU: 679 LPs in 16 rounds; not gated, ties may "
        f"break on the last bit on the card)")
    return dict(wall=wall, iters_per_s=(r.stats.rounds + 1) / wall,
                lps=r.stats.lps, rounds=r.stats.rounds)


def run_many(device, n_inst):
    """Config #5 through scale_many.run."""
    from bensolve_tpu_torch import scale_many

    out = scale_many.run(n_inst, device=device,
                         log=lambda s: log(f"# many: {s}"))
    bad = [i for i, r in enumerate(out["results"])
           if r.status.name != "OPTIMAL"]
    gate(not bad, f"many: {len(bad)} of {n_inst} instances not OPTIMAL")
    if n_inst == scale_many.N_INSTANCES:
        gate((out["lps"], out["rounds"]) == (MANY_LPS, MANY_ROUNDS),
             f"many: {out['lps']} LPs in {out['rounds']} rounds, config #5 "
             f"gives {MANY_LPS} in {MANY_ROUNDS}")
    return out


def run_ex10(device, q, m):
    """example10 at float64 and float32, primal and dual algorithm."""
    from bensolve_tpu_torch import examples

    walls, runs = {}, {}
    for dtype, kw, tol in (("f64", {}, 1e-4), ("f32", F32_KW, 1e-3)):
        for alg in ("primal", "dual"):
            r, wall = _solve(device, examples.example10(q, m),
                             alg_phase1=alg, alg_phase2=alg, **kw)
            _checked(f"ex10 {alg} {dtype}", r, wall, tol)
            walls[(alg, dtype)], runs[(alg, dtype)] = wall, r
        lim = 1e-6 if dtype == "f64" else EX10_F32_IMAGES
        gap = images_close(runs[("primal", dtype)], runs[("dual", dtype)],
                           lim)
        log(f"# ex10 {dtype}: primal and dual upper images within {gap:.1e} "
            f"(limit {lim:g})")
    return walls


def run_tall(device, q, m, n):
    """A tall random VLP at float64, primal: the revised simplex."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.lp import revised

    calls = revised.CALLS
    r, wall = _solve(device, examples.random_vlp(q=q, m=m, n=n))
    gate(revised.CALLS > calls, "tall: the revised simplex did not run")
    _checked(f"tall random_vlp(q={q}, m={m}, n={n})", r, wall, 1e-4)
    return wall


def run(stages=STAGES, device="cuda", device_lps=(96, 96, 4096),
        p2=(5, 1000, 2000, 128), p2_warm=3, highs_k=4, p2_host_cap=0,
        many=10_000, ex10=(3, 2), tall=(2, 50, 500)) -> dict:
    """Run the named stages on ``device``; returns the result line."""
    import torch

    from bensolve_tpu_torch.lp.simplex import resolve_device

    resolve_device(device)
    out = dict.fromkeys(BENCH_KEYS + EXTRA_KEYS)
    out.update(metric="scalarization_LPs_per_s_per_chip", unit="LP/s",
               device=device)
    if device == "cuda":
        from bensolve_tpu_torch.lp import group_simplex

        torch.backends.cuda.matmul.allow_tf32 = False
        out["device_name"] = smi_line()
        t0 = time.perf_counter()
        group_simplex._library()
        log(f"# setup: {out['device_name']}; the kernel built and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        out["device_name"] = "cpu"
    dev = None
    if "device" in stages:
        log("# stage: device")
        dev = run_device(device, *device_lps)
        out.update(cold_pivots_per_lp=dev["cold_pivots"],
                   warm_pivots_per_lp=dev["warm_pivots"],
                   device_kernel_launches=dev["launches"])
    if "device" in stages or "serial" in stages:
        log("# stage: serial baseline")
        inputs = dev["inputs"] if dev else make_instances(*device_lps)
        base = run_serial(inputs, min(SERIAL_K, device_lps[2]),
                          dev["obj"] if dev else None)
        if "serial" in stages:
            out["serial_LPs_per_s"] = base
        if dev:
            out["value"] = dev["rate"]
            if "serial" in stages:
                out["vs_baseline"] = dev["rate"] / base
    if "p2" in stages:
        log("# stage: p2 shape")
        p = run_p2(device, *p2, p2_warm, highs_k, p2_host_cap)
        tail = "" if p2_host_cap == REFERENCE_HOST_CAP else "_fallback_capped"
        out.update({"p2_cold_s": p["cold_s"], "p2_warm_s": p["times"],
                    "p2_host_fallback_cap": p2_host_cap,
                    "p2_host_bound": p["host_bound"],
                    "p2_LPs_per_s" + tail: p["rate"],
                    "p2_vs_baseline" + tail: (p["rate"] / p["base_rate"]
                                              if p["base_rate"] else None)})
    if "ex11" in stages:
        log("# stage: ex11")
        e = run_ex11(device)
        out.update(ex11_wall_s=e["wall"], benson_iters_per_s=e["iters_per_s"],
                   ex11_lps=e["lps"], ex11_rounds=e["rounds"])
    if "many" in stages:
        log("# stage: many")
        mv = run_many(device, many)
        out.update(many_instances=mv["instances"], many_wall_s=mv["wall"],
                   many_instances_per_s=mv["instances"] / mv["wall"],
                   many_LPs_per_s=mv["lps"] / mv["wall"],
                   many_lps=mv["lps"], many_rounds=mv["rounds"])
    if "ex10" in stages:
        log("# stage: ex10")
        w = run_ex10(device, *ex10)
        out.update(ex10_wall_s_f64=w[("primal", "f64")],
                   ex10_wall_s_f32=w[("primal", "f32")],
                   ex10_dual_wall_s_f64=w[("dual", "f64")],
                   ex10_dual_wall_s_f32=w[("dual", "f32")])
    if "tall" in stages:
        log("# stage: tall")
        out["tall_wall_s"] = run_tall(device, *tall)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--stages", nargs="+", choices=STAGES, default=STAGES)
    ap.add_argument("--highs-k", type=int, default=4,
                    help="LPs of the p2 stage solved by serial HiGHS")
    ap.add_argument("--device-lps", type=int, nargs=3, default=(96, 96, 4096),
                    metavar=("M", "N", "B"))
    ap.add_argument("--p2", type=int, nargs=4, default=(5, 1000, 2000, 128),
                    metavar=("Q", "M", "N", "B"))
    ap.add_argument("--p2-warm", type=int, default=3,
                    help="timed re-solve rounds of the p2 stage")
    ap.add_argument("--p2-host-cap", type=int, default=0,
                    help="the p2 stage's host HiGHS fallback cap per IPM "
                    f"call ({REFERENCE_HOST_CAP} gives bench.py's keys)")
    ap.add_argument("--many", type=int, default=10_000,
                    help="instances of the many stage")
    ap.add_argument("--ex10", type=int, nargs=2, default=(3, 2),
                    metavar=("Q", "M"), help="examples.example10(q, m)")
    ap.add_argument("--tall", type=int, nargs=3, default=(2, 50, 500),
                    metavar=("Q", "M", "N"), help="examples.random_vlp")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run(a.stages, a.device, tuple(a.device_lps), tuple(a.p2),
              a.p2_warm, a.highs_k, a.p2_host_cap, a.many, tuple(a.ex10),
              tuple(a.tall))
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
