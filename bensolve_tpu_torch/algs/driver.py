"""End-to-end solve driver: the library equivalent of the reference CLI
pipeline (bslv_main.c:36-409): sol_init -> phase0 -> phase1 -> phase2 ->
transforms -> output, with status short-circuits.  The port of
``bensolve_tpu/algs/driver.py``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from bensolve_tpu_torch import spans
from bensolve_tpu_torch.algs import phases
from bensolve_tpu_torch.algs.phases import Stats
from bensolve_tpu_torch.algs.solution import (SolStatus, SolutionContext,
                                              VLPInputError, sol_init)
from bensolve_tpu_torch.io import checkpoint, plot, writers
from bensolve_tpu_torch.lp import simplex
from bensolve_tpu_torch.poly.polytope import (PolytopePair,
                                              make_lower_to_upper_v2h,
                                              make_upper_to_lower_v2h)
from bensolve_tpu_torch.vlp.options import Alg, Format, Options
from bensolve_tpu_torch.vlp.problem import VLPProblem


@dataclasses.dataclass
class VLPSolution:
    """Solve outcome plus the finished polytope pair.

    ``swap`` records whether the pair's roles are exchanged (dual
    algorithm in phase 2): the *upper image* is ``pair.dual`` when
    swapped."""

    status: SolStatus
    vlp: VLPProblem
    opt: Options
    sol: SolutionContext | None = None
    pair: PolytopePair | None = None
    swap: bool = False
    stats: Stats = dataclasses.field(default_factory=Stats)
    time_ms: float = 0.0
    message: str = ""
    plot_swap_pair: PolytopePair | None = None  # untransformed swapped pair (-p)

    def _images(self):
        if self.swap:
            return self.pair.dual, self.pair.primal
        return self.pair.primal, self.pair.dual

    def _collect(self, poly, ideal: bool) -> np.ndarray:
        idx = [i for i in poly.live() if bool(poly.ideal[i]) == ideal]
        return poly.data[idx].copy()

    @property
    def primal_points(self) -> np.ndarray:
        """Vertices of the upper image (of the canonical min problem)."""
        return self._collect(self._images()[0], False)

    @property
    def primal_directions(self) -> np.ndarray:
        return self._collect(self._images()[0], True)

    @property
    def dual_points(self) -> np.ndarray:
        return self._collect(self._images()[1], False)

    @property
    def dual_directions(self) -> np.ndarray:
        return self._collect(self._images()[1], True)


def _poly_minus(pair: PolytopePair, p_hi: int, d_lo: int, d_hi: int,
                p_lo: int = 0) -> None:
    """Negate column ranges of used vertices (reference poly_minus,
    bslv_algs.c:210-220); ranges are [lo, hi) on primal resp. dual."""
    for poly, lo, hi in ((pair.primal, p_lo, p_hi), (pair.dual, d_lo, d_hi)):
        if hi > lo:
            live = poly.live()
            poly.data[np.ix_(live, range(lo, hi))] *= -1.0


def trans_primal(vlp, sol, pair) -> None:
    """Output transform for max problems / negative c_q on the primal
    algorithm's pair (reference poly_trans_primal, bslv_algs.c:223-231)."""
    q = vlp.q
    pos = sol.c_dir.value > 0
    if pos and vlp.optdir == -1:
        _poly_minus(pair, q, q - 1, q)      # y -> -y ; y*_q -> -y*_q
    elif not pos and vlp.optdir == 1:
        _poly_minus(pair, q, 0, 0)          # y -> -y
    elif not pos and vlp.optdir == -1:
        _poly_minus(pair, 0, q - 1, q)      # y*_q -> -y*_q


def trans_dual(vlp, sol, pair) -> None:
    """Same for the dual algorithm's pair, whose primal polytope is the
    LOWER image (reference poly_trans_dual, bslv_algs.c:234-242)."""
    q = vlp.q
    pos = sol.c_dir.value > 0
    if pos and vlp.optdir == -1:
        _poly_minus(pair, q, 0, q, p_lo=q - 1)
    elif not pos and vlp.optdir == 1:
        _poly_minus(pair, 0, 0, q)
    elif not pos and vlp.optdir == -1:
        _poly_minus(pair, q, 0, 0, p_lo=q - 1)


def _count(sol, pair, swap: bool) -> None:
    """Solution cardinalities (reference poly_count, bslv_algs.c:146-184)."""
    upper, lower = (pair.dual, pair.primal) if swap else (pair.primal,
                                                          pair.dual)
    up_ideal = upper.ideal[upper.live()]
    lo_ideal = lower.ideal[lower.live()]
    sol.pp = int((~up_ideal).sum())
    sol.pp_dir = int(up_ideal.sum())
    sol.dd = int((~lo_ideal).sum())
    sol.dd_dir = int(lo_ideal.sum())


def _profiled(profile_dir: str, device, run):
    """``run()`` under torch.profiler (CPU activity always, CUDA activity
    when the LPs run on a card), its Chrome trace written into
    ``profile_dir`` as ``bensolve_trace_<ms since the epoch>.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = run()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"bensolve_trace_{time.time_ns() // 10**6}.json"))
    return out


def solve(vlp: VLPProblem, opt: Options | None = None,
          resume: str | None = None) -> VLPSolution:
    """Solve a VLP.  Pure computation — no files are written; see
    solve_file for the CLI artifact family.  Every LP tensor lives on
    ``opt.device``; a CUDA device that is not there raises.

    ``resume``: path to a checkpoint written via
    Options.checkpoint_path (by this package or the JAX one): the
    phases before it and its phase's seeding are skipped, and the main
    loop continues from the stored outer approximation.

    While spans are recorded (spans.py) the solve is a ``solve`` span,
    whose id every span inside it carries."""
    if not spans.ON:
        return _solve(vlp, opt, resume)
    sp = spans.begin("solve", q=vlp.q, m=vlp.m, n=vlp.n)
    try:
        return _solve(vlp, opt, resume)
    finally:
        spans.end(sp)


def _solve(vlp, opt, resume) -> VLPSolution:
    opt = opt if opt is not None else Options()
    opt.build_mesh()   # the mesh of mesh_axes, built once and cached
    dev = simplex.resolve_device(opt.device)
    if opt.profile_dir:
        return _profiled(
            opt.profile_dir, dev,
            lambda: _solve(vlp, dataclasses.replace(opt, profile_dir=""),
                           resume))
    stats = Stats()
    t0 = time.perf_counter()

    try:
        sol, P_eff = sol_init(vlp, opt)
    except VLPInputError as e:
        return VLPSolution(SolStatus.INPUTERROR, vlp, opt, message=str(e))

    if resume:
        sol_chk, pair_chk, meta = checkpoint.load_checkpoint(resume)
        sol_chk.cone_pair, sol_chk.cone_swap = sol.cone_pair, sol.cone_swap
        sol = sol_chk
        stats.lps, stats.rounds = meta["lps"], meta["round"]
        phase = meta["phase"]
        if phase.startswith("phase1"):
            # finish phase 1 from the snapshot (R/H extraction included),
            # then continue with the normal phase-2 path
            if phase == "phase1_primal":
                phases.phase1_primal(sol, vlp, P_eff, opt, stats,
                                     resume_pair=pair_chk)
            else:
                phases.phase1_dual(sol, vlp, P_eff, opt, stats,
                                   resume_pair=pair_chk)
            swap = opt.alg_phase2 is Alg.DUAL
            pair = (phases.phase2_dual if swap else
                    phases.phase2_primal)(sol, vlp, P_eff, opt, stats)
            return _finish(vlp, opt, sol, pair, swap, stats, t0)
        swap = phase == "phase2_dual"
        pair = (phases.phase2_dual if swap else phases.phase2_primal)(
            sol, vlp, P_eff, opt, stats, resume_pair=pair_chk)
        return _finish(vlp, opt, sol, pair, swap, stats, t0)

    if opt.bounded:
        phases.phase2_init(sol)
    else:
        phases.phase0(sol, vlp, P_eff, opt, stats)
        if sol.status is SolStatus.UNBOUNDED:
            return VLPSolution(
                sol.status, vlp, opt, sol, stats=stats,
                message="VLP is totally unbounded, there is no solution")
        if sol.status is SolStatus.NOVERTEX:
            return VLPSolution(
                sol.status, vlp, opt, sol, stats=stats,
                message="upper image of VLP has no vertex "
                        "(this case is not covered by this version)")
        if opt.alg_phase1 is Alg.PRIMAL:
            phases.phase1_primal(sol, vlp, P_eff, opt, stats)
        else:
            phases.phase1_dual(sol, vlp, P_eff, opt, stats)

    swap = opt.alg_phase2 is Alg.DUAL
    if not swap:
        pair = phases.phase2_primal(sol, vlp, P_eff, opt, stats)
    else:
        pair = phases.phase2_dual(sol, vlp, P_eff, opt, stats)
    return _finish(vlp, opt, sol, pair, swap, stats, t0)


def _finish(vlp, opt, sol, pair, swap, stats, t0) -> VLPSolution:
    """Status short-circuits + output epilogue shared by fresh and
    resumed solves."""
    if sol.status in (SolStatus.INFEASIBLE, SolStatus.UNBOUNDED):
        if sol.status is SolStatus.INFEASIBLE:
            msg = "VLP is infeasible"
        elif opt.bounded:
            msg = "VLP is not bounded, re-run without option -b"
        else:
            msg = "LP in phase 2 is not bounded, probably by inaccuracy in phase 1"
        return VLPSolution(sol.status, vlp, opt, sol, stats=stats, message=msg)

    # save the swapped-role pair for plotting BEFORE the output
    # transforms (bslv_algs.c:1125-1134 / :1554-1563)
    plot_swap_pair = None
    if opt.plot and vlp.q == 3:
        v2h = (make_upper_to_lower_v2h(sol.c) if not swap
               else make_lower_to_upper_v2h(sol.c))
        plot_swap_pair = PolytopePair(vlp.q, dual_v2h=v2h)
        pair.swap(plot_swap_pair)
        plot_swap_pair.chop()
        plot_swap_pair.normalize_directions()

    # output epilogue (bslv_algs.c:1125-1146 / :1554-1575)
    if not swap:
        trans_primal(vlp, sol, pair)
    else:
        trans_dual(vlp, sol, pair)
    pair.chop()
    pair.normalize_directions()
    pair.update_adjacency(pair.dual)
    time_ms = (time.perf_counter() - t0) * 1e3  # excludes file writing
    sol.status = SolStatus.OPTIMAL
    _count(sol, pair, swap)
    res = VLPSolution(SolStatus.OPTIMAL, vlp, opt, sol, pair, swap, stats,
                      time_ms, plot_swap_pair=plot_swap_pair)
    if opt.poly_test:
        errs = pair.check()
        if errs:
            res.message = "; ".join(errs)
    return res


def solve_file(path: str, opt: Options | None = None) -> VLPSolution:
    """Read a .vlp file, solve, and write the full artifact family
    (the reference CLI behavior)."""
    from bensolve_tpu_torch.vlp.reader import read_vlp

    opt = opt if opt is not None else Options()
    if not opt.filename:
        opt.filename = os.path.splitext(path)[0]
    vlp = read_vlp(path)
    result = solve(vlp, opt)
    base = opt.filename
    fmt_file = (writers.FORMAT_SHORT_STR
                if opt.format is Format.SHORT else writers.FORMAT_LONG_STR)

    if result.sol is not None and result.sol.c_out is not None \
            and opt.write_files:
        with open(base + "_c.sol", "w") as fh:
            fh.write(writers.format_matrix(result.sol.c_out, fmt_file))
        if result.sol.cone_pair is not None:
            writers.write_image_family(
                result.sol.cone_pair, base, swap=result.sol.cone_swap,
                fmt=fmt_file, pre_img=False, ending=".cone")

    if result.status is SolStatus.OPTIMAL and opt.write_files:
        # stdout image listing at message level >= 1 (poly_output,
        # bslv_algs.c:78-84), short format unless -f long
        if opt.message_level >= 1:
            fmt_out = (writers.FORMAT_LONG_STR
                       if opt.format is Format.LONG
                       else writers.FORMAT_SHORT_STR)
            upper, lower = ((result.pair.dual, result.pair.primal)
                            if result.swap
                            else (result.pair.primal, result.pair.dual))
            mn = vlp.optdir == 1
            print(("Upper image of primal problem:" if mn
                   else "Lower image of primal problem:"))
            print(writers.format_vertices(upper, fmt_out), end="")
            print(("Lower image of dual problem:" if mn
                   else "Upper image of dual problem:"))
            print(writers.format_vertices(lower, fmt_out), end="")
        writers.write_image_family(result.pair, base, swap=result.swap,
                                   fmt=fmt_file, pre_img=bool(opt.solution))
        writers.write_log(base + ".log", problem_file=path, vlp=vlp,
                          sol=result.sol, opt=opt, time_ms=result.time_ms,
                          n_lps=result.stats.lps)
        if opt.plot and vlp.q == 3 and result.plot_swap_pair is not None:
            _write_plots(result, base)
    return result


def _write_plots(result: VLPSolution, base: str) -> None:
    """OFF/INST graphics (reference plot epilogue, bslv_algs.c:1148-1156
    / :1580-1588): the cuts mutate the pairs, so this runs only after
    the solution files are on disk."""
    vlp, sol = result.vlp, result.sol
    pair, swap_pair = result.pair, result.plot_swap_pair
    if not result.swap:
        # primal algorithm: pair = upper image, swap_pair = lower image
        trans_primal(vlp, sol, pair)                 # undo display transform
        widths = plot.cut_primal_for_plot(pair, sol)
        trans_primal(vlp, sol, pair)                 # re-apply for display
        plot.write_plot_files(pair, base, "p", widths)
        scales = plot.cut_dual_for_plot(swap_pair)
        trans_dual(vlp, sol, swap_pair)
        plot.write_plot_files(swap_pair, base, "d", scales)
    else:
        # dual algorithm: pair's primal polytope is the lower image
        trans_dual(vlp, sol, pair)                   # undo
        scales = plot.cut_dual_for_plot(pair)
        trans_dual(vlp, sol, pair)
        plot.write_plot_files(pair, base, "d", scales)
        widths = plot.cut_primal_for_plot(swap_pair, sol)
        trans_primal(vlp, sol, swap_pair)
        plot.write_plot_files(swap_pair, base, "p", widths)
