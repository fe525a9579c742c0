"""The large-example flows of ``bensolve_tpu_torch.slow_runner`` at the
shapes of ex07 and ex09, on random data of those shapes.

    python3 tests/witness_large_shapes.py --device cuda       # on the card
    python3 tests/witness_large_shapes.py --device cpu --ex07 2 20 2000 \\
        --ex09 3 20 2000 2                                    # rehearsal

ex07 (q=3, m=1211, n=1143) and ex09 (q=3, m=4608, n=36939) ship only
inside the reference's .vlp files; ``examples.random_vlp(q, m, n,
seed=7)`` stands in for them:

1. **ex07 shape** (``--ex07 Q M N``): the runner's ``solve_one("ex07",
   vlp=...)``, end to end under ``CONFIGS["ex07"]`` (float32 LPs, every
   LP with M + N >= 2000 through the interior-point route, eps 0.05, a
   checkpoint per phase-2 round).  Recorded: wall, LPs, rounds, points,
   directions, the oracle at 0.05, IPM batched solves (``ipm.CALLS``),
   the LPs the IPM would hand to host HiGHS and those it did
   (``ipm.HOST_FALLBACK``, ``HOST_FALLBACK_SECONDS``).  ``--host K``
   caps that fallback at K LPs per IPM call (default: the config's own,
   32); ``--host off`` turns it off (the IPM's rescue pass and float64
   simplex fallback then resolve its ITLIM LPs on the device), and the
   IPM's seconds are split into four disjoint terms (``HostBound``): the
   top-level calls, the rescue IPM, the simplex nested in the rescue
   pass and the simplex after it, with the LPs of each and those the
   rescue IPM resolved itself.
2. **ex09 shape** (``--ex09 Q M N B``): one phase-2 round of B LPs, the
   P2 template's LPs of the VLP for B synthetic frontier vertices
   (``bench.make_p2_instances``), through ``lp.solve_batch_auto`` at
   float32 under ``CONFIGS["ex09"]``'s environment with the host
   fallback capped at 0 (HiGHS takes many minutes on a dense LP of this
   size): ms per IPM iteration (on the card split into the S build, the
   Cholesky pair and the solves by CUDA events), iterations, statuses,
   quality, the LPs bound for the host, peak device memory and the chunk
   width.  Every LP called OPTIMAL is held to certificates computed in
   float64 on the host from its (x, row duals): primal residual, bound
   violation, dual infeasibility and the relative gap between the primal
   and the dual objective, each at most 1e-2 (ex09's eps).

The script exits 1 when the ex07-shape run does not end OPTIMAL with the
oracle passed, or an ex09-shape certificate fails.  ``--out PATH`` writes
both records as JSON.  ``chip_smoke.py`` phase 17 runs the same
functions.  Not a pytest module.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

EX07 = (3, 1211, 1143)
EX09 = (3, 4608, 36939, 8)
SEED = 7
CERT_TOL = 1e-2


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# the four disjoint terms of the IPM's seconds (HostBound)
SPLIT = ("top_level_s", "rescue_ipm_s", "simplex_in_rescue_s",
         "simplex_top_s")


class HostBound:
    """Counts over the interior-point solves inside the block: top-level
    calls, their LPs and seconds (synchronised host clock); the LPs each
    call hands, or under a cap would hand, to host HiGHS (ITLIM, or
    OPTIMAL at quality 1 or 2, after its device pass) and those HiGHS
    solved; and, with the host fallback off, the LPs the IPM's rescue
    pass re-ran on the device, those it resolved itself, and those the
    float64 simplex fallback re-solved there, with the LPs left loose or
    ITLIM at the end.

    The rescue pass is a nested ``solve_batch_ipm(..., _rescue=True)``
    call, and its ITLIM LPs go to the simplex fallback inside that call;
    a top-level call's own fallback runs after its rescue pass.  The
    seconds are split four ways (``SPLIT``), each the sum of its own
    stretches of one clock: entering a nested call closes the stretch of
    the call around it and leaving it opens a new one, so the terms are
    disjoint and together fill the top-level calls' wall (``seconds``):
    (a) ``top_level_s``, the top-level calls outside their rescue pass
    and fallback; (b) ``rescue_ipm_s``, the rescue passes outside their
    nested simplex; (c) ``simplex_in_rescue_s``, that nested simplex;
    (d) ``simplex_top_s``, a top-level call's fallback after its rescue
    pass.  ``rescue_s`` = (b) + (c) and ``simplex_s`` = (c) + (d).
    ``per_call`` holds one record per top-level call.  ``pkg`` names the
    package whose ``lp.ipm``, ``lp.simplex`` and ``lp.revised`` are
    wrapped (the JAX package's too: only counts are meaningful there, its
    device work being asynchronous); ``clock`` is the host clock."""

    def __init__(self, device, pkg="bensolve_tpu_torch",
                 clock=time.perf_counter):
        self.device, self.pkg, self.clock = device, pkg, clock
        self.calls = self.lps = self.bound = self.solved = 0
        self.rescued = self.rescue_resolved = self.loose = self.itlim = 0
        self.simplex_in_rescue = self.simplex_top = 0
        self.seconds = 0.0
        self.split = dict.fromkeys(SPLIT, 0.0)
        self.per_call = []
        # the terms in progress, innermost last: [term, stretch start]
        self._stack = []

    @property
    def simplex(self):
        return self.simplex_in_rescue + self.simplex_top

    @property
    def rescue_s(self):
        return self.split["rescue_ipm_s"] + self.split["simplex_in_rescue_s"]

    @property
    def simplex_s(self):
        return self.split["simplex_in_rescue_s"] + self.split["simplex_top_s"]

    def _enter(self, term):
        _sync(self.device)
        now = self.clock()
        if self._stack:
            outer = self._stack[-1]
            self.split[outer[0]] += now - outer[1]
        self._stack.append([term, now])
        return now

    def _leave(self):
        _sync(self.device)
        now = self.clock()
        term, start = self._stack.pop()
        self.split[term] += now - start
        if self._stack:
            self._stack[-1][1] = now
        return now

    def record(self):
        """The counts and seconds as record keys."""
        total = self.seconds
        parts = sum(self.split.values())
        return dict(ipm_top_calls=self.calls, ipm_lps=self.lps,
                    ipm_s=total, host_bound=self.bound,
                    rescued=self.rescued,
                    rescue_resolved=self.rescue_resolved,
                    rescue_s=self.rescue_s,
                    simplex_fallback=self.simplex,
                    simplex_in_rescue=self.simplex_in_rescue,
                    simplex_top=self.simplex_top, simplex_s=self.simplex_s,
                    **self.split, split_sum_s=parts,
                    split_gap=abs(parts - total) / total if total else 0.0,
                    loose_end=self.loose, itlim_end=self.itlim,
                    per_call=self.per_call)

    def __enter__(self):
        import importlib

        ipm = importlib.import_module(f"{self.pkg}.lp.ipm")
        simplex = importlib.import_module(f"{self.pkg}.lp.simplex")
        revised = importlib.import_module(f"{self.pkg}.lp.revised")
        ITLIM, OPTIMAL = simplex.ITLIM, simplex.OPTIMAL

        self.saved = [(ipm, "solve_batch_ipm", ipm.solve_batch_ipm),
                      (simplex, "solve_batch", simplex.solve_batch),
                      (revised, "solve_batch_revised",
                       revised.solve_batch_revised)]
        real_ipm = ipm.solve_batch_ipm

        def rescue(*a, **kw):
            call = (self.per_call[-1] if self._stack
                    and self._stack[-1][0] == "top_level_s" else None)
            n_sx = self.simplex_in_rescue
            self._enter("rescue_ipm_s")
            try:
                res = real_ipm(*a, **kw)
            finally:
                self._leave()
            n = int(np.asarray(res.status).size)
            to_sx = self.simplex_in_rescue - n_sx
            # the nested fallback takes exactly the LPs the rescue IPM
            # left ITLIM; without it they come back ITLIM
            left = to_sx or int((np.asarray(res.status) == ITLIM).sum())
            self.rescued += n
            self.rescue_resolved += n - left
            if call is not None:
                call["rescued"] += n
                call["rescue_resolved"] += n - left
                call["simplex_in_rescue"] += to_sx
            return res

        def counted(*a, **kw):
            if kw.get("_rescue"):
                return rescue(*a, **kw)
            h0 = getattr(ipm, "HOST_FALLBACK", 0)
            call = dict(lps=0, rescued=0, rescue_resolved=0,
                        simplex_in_rescue=0, simplex_top=0, seconds=0.0)
            self.per_call.append(call)
            t0 = self._enter("top_level_s")
            try:
                res = real_ipm(*a, **kw)
            finally:
                t1 = self._leave()
            self.seconds += t1 - t0
            # an LP HiGHS solved is OPTIMAL at quality 0 now
            solved = getattr(ipm, "HOST_FALLBACK", 0) - h0
            status = np.asarray(res.status)
            q = (np.asarray(res.quality) if res.quality is not None
                 else np.zeros(status.size, int))
            loose = int(((status == OPTIMAL) & (q >= 1)).sum())
            itlim = int((status == ITLIM).sum())
            call.update(lps=int(status.size), seconds=t1 - t0)
            self.calls += 1
            self.lps += int(status.size)
            self.solved += solved
            self.bound += solved + loose + itlim
            self.loose += loose
            self.itlim += itlim
            return res

        def fallback(real):
            def run(A, c, *a, **kw):
                # only a fallback called by an IPM call is counted (a
                # solver the fallback calls in turn stays in its term)
                inside = self._stack[-1][0] if self._stack else None
                if inside not in ("top_level_s", "rescue_ipm_s"):
                    return real(A, c, *a, **kw)
                n = int(np.atleast_2d(c).shape[0])
                if inside == "rescue_ipm_s":
                    self.simplex_in_rescue += n
                    term = "simplex_in_rescue_s"
                else:
                    self.simplex_top += n
                    self.per_call[-1]["simplex_top"] += n
                    term = "simplex_top_s"
                self._enter(term)
                try:
                    return real(A, c, *a, **kw)
                finally:
                    self._leave()
            return run

        ipm.solve_batch_ipm = counted
        simplex.solve_batch = fallback(simplex.solve_batch)
        revised.solve_batch_revised = fallback(revised.solve_batch_revised)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def ex07_shape(device, q=EX07[0], m=EX07[1], n=EX07[2], seed=SEED,
               host=None, ckpt_dir=None):
    """The runner's ex07 flow on random_vlp(q, m, n, seed); a record.
    ``host``: None for the config's own host HiGHS fallback (at most 32
    LPs per IPM call), an int for that cap, or "off" for none
    (BENSOLVE_HOST_FALLBACK=0: the IPM's rescue pass at full budget and
    its float64 simplex fallback, both on the device)."""
    from bensolve_tpu_torch import slow_runner
    from bensolve_tpu_torch.bench import host_fallback_cap
    from bensolve_tpu_torch.examples import random_vlp
    from bensolve_tpu_torch.lp import ipm

    vlp = random_vlp(q=q, m=m, n=n, seed=seed)
    calls, h0, hs0 = ipm.CALLS, ipm.HOST_FALLBACK, ipm.HOST_FALLBACK_SECONDS
    if host == "off":
        mode = slow_runner.environ({"BENSOLVE_HOST_FALLBACK": "0"})
    elif host is not None:
        mode = host_fallback_cap(int(host))
    else:
        mode = contextlib.nullcontext()
    with mode, HostBound(device) as hb:
        row, r = slow_runner.solve_one("ex07", device, vlp=vlp,
                                       ckpt_dir=ckpt_dir)
    return dict(row, shape=[q, m, n], seed=seed,
                lp_shape=[m + 2 * q + 1, n + q + 1], host=host,
                ipm_calls=ipm.CALLS - calls, host_lps=ipm.HOST_FALLBACK - h0,
                host_s=ipm.HOST_FALLBACK_SECONDS - hs0, **hb.record()), r


def ex07_ok(rec):
    return rec["status"] == "OPTIMAL" and rec["support"].startswith("pass")


def split_line(rec):
    """The IPM's seconds in HostBound's four disjoint terms."""
    return (f"IPM {rec['ipm_s']:.2f} s = top-level calls "
            f"{rec['top_level_s']:.2f} ({rec['ipm_lps']} LPs) + rescue IPM "
            f"{rec['rescue_ipm_s']:.2f} ({rec['rescued']} LPs, "
            f"{rec['rescue_resolved']} resolved by it) + simplex in the "
            f"rescue pass {rec['simplex_in_rescue_s']:.2f} "
            f"({rec['simplex_in_rescue']} LPs) + simplex after it "
            f"{rec['simplex_top_s']:.2f} ({rec['simplex_top']} LPs); the "
            f"four sum to {rec['split_sum_s']:.2f} s, "
            f"{rec['split_gap']:.1e} of the total apart")


def ex07_line(rec):
    host = rec["host"]
    if host == "off":
        fb = (f"host fallback off: {rec['rescued']} LPs re-run by the "
              f"rescue pass ({rec['rescue_s']:.2f} s with its nested "
              f"simplex), {rec['rescue_resolved']} of them resolved by "
              f"the rescue IPM, and {rec['simplex_fallback']} re-solved "
              f"by the float64 simplex ({rec['simplex_s']:.2f} s), all on "
              f"the device; at the end {rec['loose_end']} loose (quality "
              f">= 1) and {rec['itlim_end']} ITLIM LPs, which the default "
              f"hands to host HiGHS; {split_line(rec)}")
    else:
        fb = (f"LPs bound for host HiGHS {rec['host_bound']}, solved there "
              f"{rec['host_lps']} in {rec['host_s']:.2f} s (cap per call: "
              f"{'the config' if host is None else host})")
    return (f"random_vlp{tuple(rec['shape'])} seed={rec['seed']} (LP "
            f"{rec['lp_shape'][0]}x{rec['lp_shape'][1]}) under "
            f"CONFIGS['ex07'] on {rec['backend']}: {rec['status']} in "
            f"{rec['wall_s']:.2f} s; {rec['lps']} LPs, {rec['rounds']} "
            f"rounds, {rec['points']} points, {rec['directions']} "
            f"directions; oracle {rec['support']}; IPM batched solves "
            f"{rec['ipm_calls']} ({rec['ipm_top_calls']} top-level, "
            f"{rec['ipm_lps']} LPs, {rec['ipm_s']:.2f} s); {fb}")


class HostClock:
    """A synchronised host clock around every ``ipm._ipm_core`` segment
    (the interface of chip_smoke.py's _IPMClock, without the split)."""

    def __enter__(self):
        from bensolve_tpu_torch.lp import ipm

        self.ipm, real = ipm, ipm._ipm_core
        self.real = real
        self.segments = []

        def timed(A, c, *a, **kw):
            _sync(c.device)
            t0 = time.perf_counter()
            out = real(A, c, *a, **kw)
            _sync(c.device)
            self.segments.append((c.shape[0], out[1],
                                  time.perf_counter() - t0))
            return out

        ipm._ipm_core = timed
        return self

    def __exit__(self, *exc):
        self.ipm._ipm_core = self.real

    def per_iteration_ms(self, B):
        its = sum(n for b, n, _ in self.segments if b == B)
        secs = sum(s for b, n, s in self.segments if b == B)
        return (secs / its * 1e3 if its else float("nan")), its

    def part_ms(self, iterations):
        return {}


def certificates(A, c, row_lb, row_ub, col_lb, col_ub, x, row_dual):
    """Per LP, in float64: (primal residual, bound violation, dual
    infeasibility, relative gap) of min c'x s.t. row_lb <= A x <= row_ub,
    col_lb <= x <= col_ub from x and the row duals y (c = A'y + d).  The
    dual objective takes each multiplier at the bound its sign needs
    (y_i > 0: row_lb_i, y_i < 0: row_ub_i; the same for d and the column
    bounds); a multiplier whose bound is infinite counts as dual
    infeasibility instead.  Residuals are relative to 1 + the largest
    activity, value or cost; the gap to 1 + |c'x|."""
    A = np.asarray(A, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(row_dual, np.float64)
    c, rlb, rub, clb, cub = (np.asarray(v, np.float64) for v in
                             (c, row_lb, row_ub, col_lb, col_ub))
    act = x @ A.T
    pres = np.maximum(np.maximum(rlb - act, act - rub), 0.0).max(axis=1) / (
        1.0 + np.abs(act).max(axis=1))
    bviol = np.maximum(np.maximum(clb - x, x - cub), 0.0).max(axis=1) / (
        1.0 + np.abs(x).max(axis=1))
    d = c - y @ A

    def side(mult, lo, hi):
        lo_ok, hi_ok = np.isfinite(lo), np.isfinite(hi)
        term = np.where((mult > 0) & lo_ok, mult * np.where(lo_ok, lo, 0.0),
                        0.0) + np.where((mult < 0) & hi_ok,
                                        mult * np.where(hi_ok, hi, 0.0), 0.0)
        bad = np.where((mult > 0) & ~lo_ok, mult, 0.0) + np.where(
            (mult < 0) & ~hi_ok, -mult, 0.0)
        return term.sum(axis=1), bad.max(axis=1)

    ty, by = side(y, rlb, rub)
    td, bd = side(d, clb, cub)
    pobj = np.einsum("bn,bn->b", c, x)
    dinf = np.maximum(by, bd) / (1.0 + np.abs(c).max(axis=1))
    gap = np.abs(pobj - (ty + td)) / (1.0 + np.abs(pobj))
    return pres, bviol, dinf, gap


def ex09_round(device, q=EX09[0], m=EX09[1], n=EX09[2], B=EX09[3],
               seed=SEED, clock=None):
    """One P2 round of B LPs of random_vlp(q, m, n, seed) through
    lp.solve_batch_auto at float32 under CONFIGS["ex09"]'s environment,
    the host fallback capped at 0; a record.  ``clock``: a context that
    times the IPM (default HostClock)."""
    from bensolve_tpu_torch import slow_runner
    from bensolve_tpu_torch.bench import make_p2_instances
    from bensolve_tpu_torch.lp import ipm, simplex, solve_batch_auto

    simplex.resolve_device(device)
    cfg = slow_runner.CONFIGS["ex09"]
    env = dict(slow_runner.run_env("ex09"), BENSOLVE_HOST_FALLBACK_MAX="0")
    clock = clock or HostClock()
    cuda = torch.device(device).type == "cuda"
    with slow_runner.environ(env):
        t0 = time.perf_counter()
        t2, extra_ub = make_p2_instances(B, q=q, m=m, n=n, seed=seed,
                                         dtype=np.float32, device=device)
        inputs = t2.build_inputs(extra_ub)
        setup = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        calls, h0 = ipm.CALLS, ipm.HOST_FALLBACK
        with clock:
            _sync(device)
            t0 = time.perf_counter()
            res = solve_batch_auto(t2.A_lp, *inputs, dtype=np.float32,
                                   ipm_min=cfg["lp_ipm_min"],
                                   verbose=cfg["lp_message_level"],
                                   device=device)
            _sync(device)
            wall = time.perf_counter() - t0
        last = dict(ipm.LAST)
        max_iter = int(os.environ["BENSOLVE_IPM_MAXIT"])
        budget = int(os.environ["BENSOLVE_IPM_BYTES"])
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if ipm.CALLS == calls:
        raise AssertionError("ex09 shape: the interior-point route was not "
                             "taken")
    M, N = t2.A_lp.shape
    Nc = N + int(np.sum(~np.isfinite(t2.col_lb) & ~np.isfinite(t2.col_ub)))
    per_inst = 2 * M * M * 4 + 16 * (Nc + M) * 4
    budget_chunk = 1 << (max(1, budget // per_inst).bit_length() - 1)
    width = 1 << (-(-B // last["chunks"]) - 1).bit_length()
    ms_it, n_it = clock.per_iteration_ms(width)
    parts = clock.part_ms(sum(k for _, k, _ in clock.segments))
    pres, bviol, dinf, gap = certificates(t2.A_lp, *inputs, res.x,
                                          res.row_dual)
    opt = res.status == simplex.OPTIMAL
    quality = (res.quality if res.quality is not None
               else np.zeros(B, int))
    bound = (res.status == simplex.ITLIM) | (opt & (quality >= 1))
    worst = {k: float(v[opt].max()) if opt.any() else None
             for k, v in (("primal_residual", pres),
                          ("bound_violation", bviol),
                          ("dual_infeasibility", dinf), ("gap", gap))}
    failed = [int(i) for i in np.flatnonzero(opt) if max(
        pres[i], bviol[i], dinf[i], gap[i]) > CERT_TOL]
    return dict(
        shape=[q, m, n], seed=seed, B=B, lp_shape=[M, N], Nc=Nc,
        backend=torch.device(device).type, setup_s=setup, wall_s=wall,
        max_iter=max_iter, iters=res.iters.tolist(),
        statuses={int(k): int(v) for k, v in zip(
            *np.unique(res.status, return_counts=True))},
        quality={int(k): int(v) for k, v in zip(
            *np.unique(quality, return_counts=True))},
        host_bound=int(bound.sum()), host_lps=ipm.HOST_FALLBACK - h0,
        chunks=last["chunks"], chunk_width=width,
        budget=budget, budget_chunk=budget_chunk,
        peak_bytes=peak, ms_per_iteration=ms_it, iterations_timed=n_it,
        segments=len(clock.segments), parts_ms=parts,
        certificates=dict(primal_residual=pres.tolist(),
                          bound_violation=bviol.tolist(),
                          dual_infeasibility=dinf.tolist(), gap=gap.tolist()),
        worst=worst, cert_tol=CERT_TOL, cert_failed=failed), res


def s_bound_ms(rec, peak_flops):
    """Least time of the S builds of one iteration at the round's width:
    2 M^2 Nc flops per LP (the port's full product) at ``peak_flops``."""
    M = rec["lp_shape"][0]
    return rec["chunk_width"] * 2.0 * M * M * rec["Nc"] / peak_flops * 1e3


def ex09_ok(rec):
    return not rec["cert_failed"]


def ex09_line(rec):
    M, N = rec["lp_shape"]
    w = rec["worst"]
    fmt = {k: ("n/a" if v is None else f"{v:.1e}") for k, v in w.items()}
    peak = ("not measured" if rec["peak_bytes"] is None
            else f"{rec['peak_bytes'] / 2**20:.0f} MiB")
    parts = ", ".join(f"{k} {v:.2f} ms" for k, v in rec["parts_ms"].items())
    return (f"random_vlp{tuple(rec['shape'])} seed={rec['seed']}: one P2 "
            f"round of B={rec['B']} LPs {M}x{N} (Nc {rec['Nc']}) float32 on "
            f"{rec['backend']} under CONFIGS['ex09'] (max_iter "
            f"{rec['max_iter']}, host fallback capped at 0): wall "
            f"{rec['wall_s']:.2f} s (set-up {rec['setup_s']:.2f} s); "
            f"statuses {rec['statuses']} quality {rec['quality']}; IPM "
            f"iterations {rec['iters']}; {rec['ms_per_iteration']:.2f} ms per "
            f"iteration at B={rec['chunk_width']} over "
            f"{rec['iterations_timed']} iterations"
            + (f" ({parts})" if parts else "")
            + f"; LPs bound for the host {rec['host_bound']}; chunks "
            f"{rec['chunks']} of width {rec['chunk_width']} (budget "
            f"{rec['budget']:.0e} bytes allows {rec['budget_chunk']}); peak "
            f"device memory {peak}; worst certificate over the OPTIMAL LPs: "
            f"primal residual {fmt['primal_residual']}, bound violation "
            f"{fmt['bound_violation']}, dual infeasibility "
            f"{fmt['dual_infeasibility']}, gap {fmt['gap']} (limit "
            f"{rec['cert_tol']:g}); failed {rec['cert_failed']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", nargs="+", choices=("ex07", "ex09"),
                    default=("ex07", "ex09"))
    ap.add_argument("--ex07", type=int, nargs=3, default=EX07,
                    metavar=("Q", "M", "N"))
    ap.add_argument("--ex09", type=int, nargs=4, default=EX09,
                    metavar=("Q", "M", "N", "B"))
    ap.add_argument("--host", default=None,
                    help="the ex07-shape run's host HiGHS fallback: a cap "
                    "per IPM call, or 'off' (default: the config's own)")
    ap.add_argument("--out", help="write the records as JSON here")
    a = ap.parse_args(argv)
    ok, out = True, {}
    if "ex07" in a.only:
        rec, _ = ex07_shape(a.device, *a.ex07, host=a.host)
        print(f"[ex07 shape] {ex07_line(rec)}", flush=True)
        out["ex07"], ok = rec, ok and ex07_ok(rec)
    if "ex09" in a.only:
        clock = None
        if torch.device(a.device).type == "cuda":
            from chip_smoke import PEAK_FLOPS, _IPMClock

            clock = _IPMClock(split=True)
        q, m, n, B = a.ex09
        rec, _ = ex09_round(a.device, q, m, n, B, clock=clock)
        print(f"[ex09 shape] {ex09_line(rec)}", flush=True)
        if clock is not None:
            rec["s_bound_ms"] = s_bound_ms(rec, PEAK_FLOPS["float32"])
            print(f"[ex09 shape] S build bound {rec['s_bound_ms']:.2f} ms "
                  f"per iteration (2 M^2 Nc flops per LP at "
                  f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s)", flush=True)
        out["ex09"], ok = rec, ok and ex09_ok(rec)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
