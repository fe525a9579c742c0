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

from bensolve_tpu_torch.algs import phases
from bensolve_tpu_torch.algs.phases import Stats
from bensolve_tpu_torch.algs.solution import (SolStatus, SolutionContext,
                                              VLPInputError, sol_init)
from bensolve_tpu_torch.io import writers
from bensolve_tpu_torch.lp import simplex
from bensolve_tpu_torch.poly.polytope import PolytopePair
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


def _not_ported(opt: Options, resume) -> str | None:
    if resume:
        return "resume (checkpoint restart)"
    if opt.checkpoint_path:
        return "checkpoint_path"
    if opt.profile_dir:
        return "profile_dir (profiler)"
    if opt.plot:
        return "plot (OFF/INST graphics)"
    if opt.distributed:
        return "distributed"
    return None


def solve(vlp: VLPProblem, opt: Options | None = None,
          resume: str | None = None) -> VLPSolution:
    """Solve a VLP.  Pure computation — no files are written; see
    solve_file for the CLI artifact family.  Every LP tensor lives on
    ``opt.device``; a CUDA device that is not there raises."""
    opt = opt if opt is not None else Options()
    missing = _not_ported(opt, resume)
    if missing:
        raise NotImplementedError(
            f"{missing} is not ported to bensolve_tpu_torch yet (ROADMAP "
            f"Queue 1)")
    opt.build_mesh()   # raises when mesh_axes asks for sharding
    simplex.resolve_device(opt.device)
    stats = Stats()
    t0 = time.perf_counter()

    try:
        sol, P_eff = sol_init(vlp, opt)
    except VLPInputError as e:
        return VLPSolution(SolStatus.INPUTERROR, vlp, opt, message=str(e))

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
    """Status short-circuits + output epilogue."""
    if sol.status in (SolStatus.INFEASIBLE, SolStatus.UNBOUNDED):
        if sol.status is SolStatus.INFEASIBLE:
            msg = "VLP is infeasible"
        elif opt.bounded:
            msg = "VLP is not bounded, re-run without option -b"
        else:
            msg = "LP in phase 2 is not bounded, probably by inaccuracy in phase 1"
        return VLPSolution(sol.status, vlp, opt, sol, stats=stats, message=msg)

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
                      time_ms)
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
    return result
