"""Instance-level data parallelism: solve MANY independent VLPs at once
(BASELINE.json config #5, "scenario-batched portfolio VLP").  The port
of ``bensolve_tpu/algs/many.py``.

The reference solves one VLP per process run (bslv_main.c:36).  Here a
list of VLP instances is:

* sharded across processes (parallel/distributed.py): each process
  solves its strided share and returns None for the other indices;
* within a process, instances of identical shape run in LOCKSTEP: every
  Benson round gathers all active instances' candidate LPs into ONE
  batch over per-instance constraint matrices (the 3-D-A path of
  lp/simplex.py) on ``Options.device``, so 1000 small VLPs cost the
  same number of device solves as one;
* optionally over a device mesh (``mesh=``, parallel/mesh.py): one
  group's merged batch is cut into contiguous shards over the mesh's
  first axis, one thread and stream each; several shape groups are
  placed round-robin, group g on mesh entry g % n.

The lockstep engine covers the bounded case (-b: phase2_init + primal
phase 2, bslv_algs.c:943-1161); unbounded instances fall back to the
serial per-instance ``solve`` — phases 0/1 are a handful of LPs each and
dominate nothing at portfolio scale.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bensolve_tpu_torch.algs import driver as _driver
from bensolve_tpu_torch.algs import phases
from bensolve_tpu_torch.algs.phases import Stats
from bensolve_tpu_torch.algs.solution import SolStatus, sol_init
from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template
from bensolve_tpu_torch.lp import simplex as sx
from bensolve_tpu_torch.parallel import distributed as dist
from bensolve_tpu_torch.parallel import mesh as pmesh
from bensolve_tpu_torch.poly.polytope import POLY_EPS, PolytopePair, \
    make_lower_to_upper_v2h
from bensolve_tpu_torch.vlp.options import Options
from bensolve_tpu_torch.vlp.problem import VLPProblem


class _Instance:
    """Per-instance Benson state inside a lockstep group."""

    def __init__(self, index: int, vlp: VLPProblem, opt: Options):
        self.index = index
        self.vlp = vlp
        self.t0 = time.perf_counter()
        self.stats = Stats()
        self.done: SolStatus | None = None
        self.sol, self.P_eff = sol_init(vlp, opt)
        phases.phase2_init(self.sol)   # bounded shortcut: R<-Z, H<-Y
        self.t2 = P2Template(vlp, self.P_eff, self.sol.R, self.sol.eta,
                             INHOMOGENEOUS, dtype=opt.lp_dtype,
                             device=opt.device)
        self.pair = PolytopePair(
            vlp.q, eps=POLY_EPS,
            dual_v2h=make_lower_to_upper_v2h(self.sol.c))
        self.seeded = False

    def shape_key(self):
        v = self.vlp
        return (v.m, v.n, v.q, self.sol.r, self.t2.A_lp.shape)


def _merged_solve(requests, opt, place=None):
    """Solve the union of per-instance LP batches in one call of the
    tableau simplex (like the JAX package, past the LP router and its
    other backends).  ``place``: the torch device of the call, or a
    mesh whose first axis shards the merged batch; None means
    ``opt.device``.  ``requests``: list of (inst, extra_ub (B_i, p)).
    Returns per-instance LPResult slices."""
    objs, rlbs, rubs, clbs, cubs, A3 = [], [], [], [], [], []
    sizes = []
    for inst, extra_ub in requests:
        obj, rlb, rub, clb, cub = inst.t2.build_inputs(extra_ub)
        objs.append(obj)
        rlbs.append(rlb)
        rubs.append(rub)
        clbs.append(clb)
        cubs.append(cub)
        B_i = obj.shape[0]
        sizes.append(B_i)
        A3.append(np.broadcast_to(inst.t2.A_lp[None],
                                  (B_i,) + inst.t2.A_lp.shape))
    place_kw = (dict(device=opt.device, mesh=place)
                if isinstance(place, pmesh.Mesh)
                else dict(device=opt.device if place is None else place))
    res = sx.solve_batch(
        np.concatenate(A3), np.concatenate(objs), np.concatenate(rlbs),
        np.concatenate(rubs), np.concatenate(clbs), np.concatenate(cubs),
        dtype=np.dtype(opt.lp_dtype).type, **place_kw)
    out, off = [], 0
    for B_i in sizes:
        sl = slice(off, off + B_i)
        out.append(sx.LPResult(*(getattr(res, f.name)[sl]
                                 if getattr(res, f.name) is not None
                                 else None
                                 for f in dataclasses.fields(sx.LPResult))))
        off += B_i
    return out


def solve_many(vlps: list[VLPProblem], opt: Options | None = None, *,
               mesh=None) -> list:
    """Solve a batch of independent VLP instances on ``opt.device``.
    Returns a list of VLPSolution aligned with ``vlps``; under
    multi-process execution, entries owned by other processes are None
    (instance-level DP across processes, SURVEY.md section 2.2).

    ``mesh``: an optional ``parallel.mesh.Mesh`` whose FIRST axis shards
    the merged LP batch (instance-level DP across devices); with
    several shape groups, group g runs on entry g % n of the mesh."""
    opt = opt if opt is not None else Options()
    sx.resolve_device(opt.device)
    local = set(dist.shard_indices(len(vlps)).tolist())
    results: list = [None] * len(vlps)

    lockstep: dict = {}
    for i, vlp in enumerate(vlps):
        if i not in local:
            continue
        if not opt.bounded:
            # general instances run the full phase pipeline individually
            results[i] = _driver.solve(vlp, opt)
            continue
        inst = _Instance(i, vlp, opt)
        lockstep.setdefault(inst.shape_key(), []).append(inst)

    groups = list(lockstep.values())
    if len(groups) > 1:
        # EP analogue (SURVEY.md section 2.2): heterogeneous shape
        # groups (different LP templates) advance ROUND-LOCKSTEP: every
        # group's merged batch is SUBMITTED before any group's results
        # are consumed
        _run_groups_ep(groups, opt, mesh)
    else:
        for group in groups:
            _run_lockstep(group, opt, mesh)
    for group in groups:
        for inst in group:
            results[inst.index] = _finish_instance(inst, opt)
    return results


def _group_place(g, mesh):
    """Where group g of several solves: ``opt.device`` (None) without a
    mesh, else entry g % n of the mesh, on a stream of its own (the JAX
    package's expert placement)."""
    if mesh is None:
        return None
    devices = list(mesh.devices.flat)
    return devices[g % len(devices)]


def _on_stream(place, fn, *args):
    """fn(*args) inside a CUDA stream of its own when ``place`` is a
    CUDA device; otherwise plainly."""
    if isinstance(place, torch.device):
        return pmesh.on_own_stream(place, fn, *args)
    return fn(*args)


def _run_groups_ep(groups, opt, mesh=None) -> None:
    """Advance heterogeneous lockstep groups concurrently: per global
    round, submit each active group's merged LP batch, then apply every
    group's results in group order (so the outcome does not depend on
    which thread finishes first).  Every group runs on ``opt.device``,
    or with a mesh on its entry (_group_place)."""
    # per-group solver threads: _merged_solve blocks on the read-back of
    # its results, so one thread per group lets group g+1's host
    # stacking and device work run while g's results come back.  The
    # threads share no mutable state: each works on its own group, and
    # the 3-D LP path keeps no cache.
    places = [_group_place(g, mesh) for g in range(len(groups))]
    with ThreadPoolExecutor(max_workers=max(len(groups), 1)) as pool:
        list(pool.map(lambda g: _on_stream(places[g], _seed_group,
                                           groups[g], opt, places[g]),
                      range(len(groups))))
        while True:
            pending = []
            for g, group in enumerate(groups):
                reqs = _gather_round_requests(group)
                if reqs:
                    batch_insts, cand_lists, requests = reqs
                    fut = pool.submit(_on_stream, places[g], _merged_solve,
                                      requests, opt, places[g])
                    pending.append((batch_insts, cand_lists, fut))
            if not pending:
                break
            for batch_insts, cand_lists, fut in pending:
                _apply_round_results(batch_insts, cand_lists, fut.result(),
                                     opt)


def _seed_group(group, opt, place=None) -> None:
    """Seed round: one LP per column of R for every instance, solved at
    ``place`` (see _merged_solve)."""
    requests = []
    for inst in group:
        r = inst.sol.r
        ub = np.full((r, r), np.inf)
        np.fill_diagonal(ub, 0.0)
        requests.append((inst, ub))
    for inst, res in zip(group, _merged_solve(requests, opt, place)):
        inst.stats.lps += inst.sol.r
        q = inst.vlp.q
        for j in range(inst.sol.r):
            if res.status[j] != sx.OPTIMAL:
                inst.done = (SolStatus.INFEASIBLE
                             if res.status[j] == sx.INFEASIBLE
                             else SolStatus.UNBOUNDED
                             if res.status[j] == sx.UNBOUNDED
                             else SolStatus.ERROR)
                break
            val = inst.sol.R[:, j].copy()
            val[q - 1] = res.obj[j]
            inst.pair.add_vertex(val, ideal=False)
        if inst.done is None and not inst.pair.initial_approx():
            inst.done = SolStatus.UNBOUNDED


def _gather_round_requests(group):
    """(batch_insts, cand_lists, requests) for the group's active
    instances this round, or None when the group is finished."""
    requests, batch_insts, cand_lists = [], [], []
    for inst in group:
        if inst.done is not None:
            continue
        P = inst.pair.primal
        frontier = P.frontier()
        ideals = frontier[P.ideal[frontier]]
        P.sltn[ideals] = True
        cand = frontier[~P.ideal[frontier]]
        if cand.size == 0:
            if P.frontier().size == 0:
                inst.done = SolStatus.OPTIMAL
            continue
        V = P.data[cand]
        requests.append((inst, V @ inst.sol.R))
        batch_insts.append(inst)
        cand_lists.append(cand)
    if not requests:
        return None
    return batch_insts, cand_lists, requests


def _apply_round_results(batch_insts, cand_lists, results, opt) -> None:
    for inst, cand, res in zip(batch_insts, cand_lists, results):
        inst.stats.rounds += 1
        inst.stats.lps += cand.size
        inst.stats.pivots += int(res.iters.sum())
        bad = np.flatnonzero(res.status != sx.OPTIMAL)
        if bad.size:
            s = res.status[bad[0]]
            inst.done = (SolStatus.INFEASIBLE if s == sx.INFEASIBLE
                         else SolStatus.UNBOUNDED if s == sx.UNBOUNDED
                         else SolStatus.ERROR)
            continue
        q = inst.vlp.q
        W = inst.t2.duals_w(res)
        YY = inst.t2.primal_y(res)
        ystars = np.empty((cand.size, q))
        ystars[:, : q - 1] = W[:, : q - 1]
        ystars[:, q - 1] = np.sum(YY * W, axis=1)
        passed = res.obj > opt.eps_benson_phase2
        P = inst.pair.primal
        for i, idx in enumerate(cand):
            idx = int(idx)
            if not P.used[idx]:
                continue
            if passed[i]:
                if inst.pair.add_vertex(ystars[i], ideal=False):
                    inst.stats.cuts += 1
            else:
                P.sltn[idx] = True


def _run_lockstep(group, opt, place=None) -> None:
    """Advance a shape-homogeneous group of bounded instances through
    seeding + the phase-2 primal main loop, one merged LP batch per
    round (the batched analogue of bslv_algs.c:976-1081), solved at
    ``place`` (see _merged_solve)."""
    _seed_group(group, opt, place)
    while True:
        reqs = _gather_round_requests(group)
        if reqs is None:
            break
        batch_insts, cand_lists, requests = reqs
        _apply_round_results(batch_insts, cand_lists,
                             _merged_solve(requests, opt, place), opt)


def _finish_instance(inst, opt):
    if inst.done not in (None, SolStatus.OPTIMAL):
        inst.sol.status = inst.done
        return _driver.VLPSolution(inst.done, inst.vlp, opt, inst.sol,
                                   stats=inst.stats)
    return _driver._finish(inst.vlp, opt, inst.sol, inst.pair, False,
                           inst.stats, inst.t0)
