"""example10 at float32: which LP yields each far extreme direction.

    python tests/witness_example10_dirs.py --device cuda --runs 3
    python tests/witness_example10_dirs.py --device cpu --runs 1 --example example05 --far-deg 1e-7

Solves ``--example`` once at float64 (the reference directions and
phase 1's R) and ``--runs`` times at float32 (epsilon 1e-4 in both
phases, as ``bench.F32_KW``) on ``--device``.  The package is not
edited: ``algs.phases`` is wrapped from outside (``phase1_primal``,
``phase2_primal``, their ``P2Template``, ``_benson_primal_loop``,
``_extract_R_H``, ``PolytopePair.add_vertex`` and the template's LP
routes).  Every P2 solve of both primal phases is recorded (phase,
round, frontier vertex ids, row bounds ZR'v, the warm start it was
given, the route it took: the per-LP kernel, the tableau simplex, or
the dual simplex from a parent basis or from a kept tableau; every LP's
result), and so is every dual vertex y* the phases add, with the solve
and batch row it came from.

The upper image's directions are the extreme rays of the recession cone
that the cuts leave: each dual vertex y* adds the halfspace n'y >= y*_q
with n = (y*_1 .. y*_{q-1}, 1 - c'y*) (``make_lower_to_upper_v2h``), so a
ray d is bounded by the cuts with n'd = 0.  A float32 direction is *far*
when it lies more than ``--far-deg`` degrees from every float64
direction.  For each far direction the witness lists the recorded cuts
that bound it, how far each normal lies from the float64 run's facet
normals (phase 1's R), and the LP behind each.  The LPs of the cuts
whose normals are not float64 facet normals are then solved again on
the same inputs through every route on hand: the dual simplex from the
parent basis at float32 on ``--device`` and on the CPU, the kernel cold
(on a card) and its plain PyTorch version (on the card and on the CPU),
the tableau simplex cold at float32 on both devices, and at float64 the
tableau simplex cold, the dual simplex from the parent basis and the
dual simplex from the recorded LP's own final basis (zero pivots there
means that basis is optimal at float64).  Each line gives the status,
objective, pivots, y* and its normal.

Every float32 direction is also held to the cone of the float64 ones:
the nonnegative least-squares residual of R^T lambda = d / |d|
(scipy's ``nnls``).  The JSON written to ``--out``, when given, holds
all of it.
Not a pytest module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

F32_KW = dict(lp_dtype="float32", eps_benson_phase1=1e-4,
              eps_benson_phase2=1e-4)


def _unit(d):
    d = np.atleast_2d(np.asarray(d, float))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def degrees_to_nearest(dirs, ref):
    if not len(dirs) or not len(ref):
        return np.zeros(len(dirs))
    cos = np.clip(_unit(dirs) @ _unit(ref).T, -1.0, 1.0)
    return np.degrees(np.arccos(cos.max(axis=1)))


def cone_residuals(dirs, ref):
    """NNLS residual of each unit direction against the cone of ``ref``."""
    from scipy.optimize import nnls

    R = _unit(ref).T
    return np.array([nnls(R, u)[1] for u in _unit(dirs)]) if len(dirs) \
        else np.zeros(0)


class _Recorder:
    """Wraps phase 1 (its P2 template's solves, its Benson loop, the dual
    vertices it adds) and the R/H extraction; holds what they saw."""

    def __init__(self):
        from bensolve_tpu_torch.algs import phases, templates
        from bensolve_tpu_torch.lp import dual_simplex
        from bensolve_tpu_torch.lp import group_simplex as gs
        from bensolve_tpu_torch.poly.polytope import PolytopePair

        self.phases, self.templates = phases, templates
        self.dual_simplex, self.gs, self.Pair = dual_simplex, gs, PolytopePair
        self.calls = []         # one dict per P2Template.solve of phase 1
        self.added = []         # (dual vertex, call index, row) of phase 1
        self.route = None       # the route of the current solve
        self.phase = 0          # 1 or 2 while that primal phase runs
        self.in_loop = False
        self.t2 = None
        self.rh = None

    def __enter__(self):
        ph, tp, ds = self.phases, self.templates, self.dual_simplex
        self.real = (ph.phase1_primal, ph.phase2_primal, ph.P2Template,
                     ph._benson_primal_loop, ph._extract_R_H,
                     tp.solve_batch_auto, ds.solve_batch_dual,
                     self.Pair.add_vertex)
        phase1, phase2, Template, loop, extract, auto, dual, add = self.real
        rec = self

        def routed_auto(*a, **kw):
            before = rec._launches()
            out = auto(*a, **kw)
            rec.route = ("kernel" if rec._launches() != before
                         else "tableau" if kw.get("start_basis") is None
                         else "tableau (warm basis)")
            return out

        def routed_dual(*a, **kw):
            rec.route = ("dual simplex (kept tableau)"
                         if kw.get("start_state") is not None
                         else "dual simplex (parent basis)")
            return dual(*a, **kw)

        def recording_template(*a, **kw):
            t2 = Template(*a, **kw)
            if not rec.phase:
                return t2
            real_solve = t2.solve
            phase = rec.phase

            def solve(extra_ub, eta_ub=None, start_basis=None):
                f = sys._getframe(1).f_locals
                rec.route = None
                res = real_solve(extra_ub, eta_ub, start_basis=start_basis)
                stats, sol = f.get("stats"), f.get("sol")
                rec.calls.append(dict(
                    phase=phase, t2=t2, eta=np.asarray(sol.eta, float),
                    c=np.asarray(sol.c, float),
                    round=int(stats.rounds) if stats is not None else -1,
                    in_loop=rec.in_loop,
                    vertices=np.asarray(f.get("solve_idx", []),
                                        int).tolist(),
                    solve_no=int(t2.last_solve_no), route=rec.route,
                    extra_ub=np.asarray(extra_ub, float),
                    start=start_basis, res=res))
                return res

            t2.solve = solve
            return t2

        def in_phase(k, fn):
            def run(*a, **kw):
                rec.phase = k
                try:
                    return fn(*a, **kw)
                finally:
                    rec.phase = 0
            return run

        def watched_loop(*a, phase1, **kw):
            # the solves of a phase's loop are its frontier rounds; the
            # one before it is the initial batch, one LP per column of Z
            # (phase 1) or of R (phase 2)
            rec.in_loop = True
            try:
                return loop(*a, phase1=phase1, **kw)
            finally:
                rec.in_loop = False

        def watched_add(pair, val, ideal=False, primg=None):
            kept = add(pair, val, ideal, primg)
            frame = sys._getframe(1)
            if (rec.phase and rec.calls and kept and frame.f_code.co_name
                    in ("phase1_primal", "phase2_primal",
                        "_benson_primal_loop")):
                # the loop's i and the initial batch's j index the batch
                f = frame.f_locals
                row = int(f["i"] if "i" in f else f["j"])
                rec.added.append((np.array(val, float), len(rec.calls) - 1,
                                  row))
            return kept

        def watched_extract(sol, lower_poly, opt, stats):
            verts = np.array([lower_poly.data[i] for i in lower_poly.live()
                              if not lower_poly.ideal[i]])
            extract(sol, lower_poly, opt, stats)
            rec.rh = dict(lower=verts, R=np.asarray(sol.R, float).T,
                          H=np.asarray(sol.H, float).T,
                          c=np.asarray(sol.c, float),
                          eta=np.asarray(sol.eta, float))

        ph.phase1_primal = in_phase(1, phase1)
        ph.phase2_primal = in_phase(2, phase2)
        ph.P2Template = recording_template
        ph._benson_primal_loop, ph._extract_R_H = watched_loop, \
            watched_extract
        tp.solve_batch_auto, ds.solve_batch_dual = routed_auto, routed_dual
        self.Pair.add_vertex = watched_add
        return self

    def __exit__(self, *exc):
        ph = self.phases
        (ph.phase1_primal, ph.phase2_primal, ph.P2Template,
         ph._benson_primal_loop, ph._extract_R_H,
         self.templates.solve_batch_auto, self.dual_simplex.solve_batch_dual,
         self.Pair.add_vertex) = self.real

    def _launches(self):
        return (self.gs.CALLS_CLUSTER, self.gs.CALLS_GLOBAL, self.gs.ROUTED)

    def normal(self, y):
        """The normal of the upper-image halfspace of a lower-image vertex
        y (polytope.make_lower_to_upper_v2h): the generator _extract_R_H
        makes of y in phase 1, the recession part of a cut in phase 2."""
        q = y.size
        w = np.empty(q)
        w[:q - 1] = y[:q - 1]
        w[q - 1] = 1.0 - self.rh["c"][:q - 1] @ y[:q - 1]
        return w

    @staticmethod
    def ystar(call, res, k):
        """The lower-image vertex the LP ``k`` of ``res`` makes in the
        loop of its phase (phases._benson_primal_loop)."""
        t2, eta = call["t2"], call["eta"]
        q = eta.size
        w = np.asarray(t2.duals_w(res), float)[k]
        y = np.empty(q)
        if call["phase"] == 1:
            alpha = float(np.asarray(t2.duals_alpha(res), float)[k])
            y[:q - 1] = w[:q - 1] + alpha * eta[:q - 1]
            y[q - 1] = alpha
        else:
            y[:q - 1] = w[:q - 1]
            y[q - 1] = float(np.asarray(t2.primal_y(res), float)[k] @ w)
        return y

    def parent_basis(self, call, k):
        """The warm start LP ``k`` of ``call`` was given, as one basis
        and bound pattern, or None for a cold start."""
        st = call["start"]
        if st is None:
            return None
        if isinstance(st, tuple) and len(st) == 3 and st[0] == "state_rows":
            src = next(c for c in self.calls if c["solve_no"] == st[2])
            row = int(np.asarray(st[1])[k])
            return src["res"].basis[row], src["res"].at_upper[row]
        basis, atup = st
        return np.asarray(basis)[k], np.asarray(atup)[k]


def _resolve_routes(rec, call, k, device):
    """The LP ``k`` of ``call`` solved again through every route."""
    from bensolve_tpu_torch.lp import dual_simplex, simplex
    from bensolve_tpu_torch.lp import group_simplex as gs

    t2 = call["t2"]
    inputs = t2.build_inputs(call["extra_ub"][k:k + 1])
    A = t2.A_lp
    parent = rec.parent_basis(call, k)
    own = (call["res"].basis[k], call["res"].at_upper[k])
    on_card = torch.device(device).type == "cuda"
    runs = {}

    def dual(dtype, dev, start):
        return dual_simplex.solve_batch_dual(
            A, *inputs, dtype=dtype, device=dev,
            start_basis=(start[0][None], start[1][None]))

    if parent is not None:
        runs[f"dual f32 from the parent basis, {device}"] = lambda: dual(
            np.float32, device, parent)
        if on_card:
            runs["dual f32 from the parent basis, cpu"] = lambda: dual(
                np.float32, "cpu", parent)
    if on_card:
        runs["kernel f32 cold, cuda"] = lambda: gs.lp_batch_group(
            A, *inputs, device="cuda")

        def plain_on_card():
            real = gs.solve_batch_group
            gs.solve_batch_group = (
                lambda *a, **kw: gs.solve_batch_group_reference(*a, group=1))
            try:
                return gs.lp_batch_group(A, *inputs, device="cuda")
            finally:
                gs.solve_batch_group = real
        runs["kernel's plain version f32 cold, cuda"] = plain_on_card
    runs["kernel's plain version f32 cold, cpu"] = lambda: gs.lp_batch_group(
        A, *inputs, device="cpu")
    for dev in ((device, "cpu") if on_card else ("cpu",)):
        runs[f"tableau f32 cold, {dev}"] = (
            lambda dev=dev: simplex.solve_batch(A, *inputs, dtype=np.float32,
                                                device=dev))
    runs["tableau f64 cold, cpu"] = lambda: simplex.solve_batch(
        A, *inputs, dtype=np.float64, device="cpu")
    if parent is not None:
        runs["dual f64 from the parent basis, cpu"] = lambda: dual(
            np.float64, "cpu", parent)
    runs["dual f64 from the recorded LP's final basis, cpu"] = lambda: dual(
        np.float64, "cpu", own)

    out = []
    for name, fn in runs.items():
        res = fn()
        y = rec.ystar(call, res, 0)
        out.append(dict(
            route=name, status=int(res.status[0]), obj=float(res.obj[0]),
            iters=int(res.iters[0]), ystar=y.tolist(),
            normal=_unit(rec.normal(y))[0].tolist(),
            same_basis_as_recorded=bool(
                res.basis is not None
                and np.array_equal(np.sort(res.basis[0]), np.sort(own[0])))))
    return out


def _origin(rec, j):
    """The solve and batch row behind the recorded dual vertex ``j``."""
    v, ci, row = rec.added[j]
    call = rec.calls[ci]
    parent = rec.parent_basis(call, row)
    return dict(
        lower_vertex=v.tolist(), normal=_unit(rec.normal(v))[0].tolist(),
        call=ci, phase=call["phase"], round=call["round"],
        in_loop=call["in_loop"], solve_no=call["solve_no"],
        batch=int(call["extra_ub"].shape[0]), row=row,
        frontier_vertex=(call["vertices"][row] if call["vertices"]
                         else None),
        route=call["route"], extra_ub=call["extra_ub"][row].tolist(),
        status=int(call["res"].status[row]), obj=float(call["res"].obj[row]),
        iters=int(call["res"].iters[row]),
        ystar_match=float(np.abs(
            rec.ystar(call, call["res"], row) - v).max()),
        parent_basis=None if parent is None else
        np.asarray(parent[0]).tolist(),
        parent_at_upper=None if parent is None else
        np.flatnonzero(parent[1]).tolist(),
        basis=np.asarray(call["res"].basis[row]).tolist(),
        at_upper=np.flatnonzero(call["res"].at_upper[row]).tolist())


def trace(rec, far_dirs, ref_dirs):
    """For each far direction d: the recorded dual vertices whose
    upper-image halfspace bounds d (normal n with n'd = 0), how far each
    normal lies outside the float64 run's cone of facet normals (the NNLS
    residual against phase 1's R there; a normal outside it cuts into
    the true recession cone and can leave a ray on one of its faces), and
    the LP behind each."""
    R = _unit(rec.rh["R"])
    normals = _unit([rec.normal(v) for v, _, _ in rec.added])
    ref_R = ref_dirs["R"]
    found = []
    for d in far_dirs:
        u = _unit(d)[0]
        entry = dict(direction=u.tolist(),
                     deg_to_nearest_phase1_H=float(degrees_to_nearest(
                         u[None], rec.rh["H"])[0]),
                     phase1_R_bounding=[r.tolist() for r in R
                                        if abs(r @ u) < 1e-6],
                     bounding=[])
        for j in np.flatnonzero(np.abs(normals @ u) < 1e-6):
            o = _origin(rec, j)
            o["normal_outside_f64_R"] = float(cone_residuals(
                normals[j:j + 1], ref_R)[0])
            entry["bounding"].append(o)
        found.append(entry)
    return found


def run_once(name, device, ref, far_deg, resolve=True, max_resolve=4):
    from bensolve_tpu_torch import examples, solve
    from bensolve_tpu_torch.vlp.options import Options

    with _Recorder() as rec:
        t0 = time.perf_counter()
        r = solve(getattr(examples, name)(),
                  Options(write_files=False, device=device, **F32_KW))
        wall = time.perf_counter() - t0
    dirs = r.primal_directions
    ang = degrees_to_nearest(dirs, ref["directions"])
    far = dirs[ang > far_deg]
    out = dict(status=r.status.name, wall_s=wall, lps=r.stats.lps,
               rounds=r.stats.rounds, directions=dirs.tolist(),
               degrees_to_f64=ang.tolist(),
               cone_residual=cone_residuals(dirs,
                                            ref["directions"]).tolist(),
               R=rec.rh["R"].tolist(), H=rec.rh["H"].tolist(),
               calls=[dict(phase=c["phase"], round=c["round"],
                           solve_no=c["solve_no"],
                           batch=int(c["extra_ub"].shape[0]),
                           route=c["route"], pivots=int(c["res"].iters.sum()))
                      for c in rec.calls],
               far=trace(rec, far, ref))
    if resolve:
        # the LPs of the bounding cuts whose normals lie outside the
        # float64 cone of facet normals, farthest first
        todo = sorted((o for e in out["far"] for o in e["bounding"]
                       if o["normal_outside_f64_R"] > 1e-12),
                      key=lambda o: -o["normal_outside_f64_R"])
        done = {}
        for o in todo:
            key = (o["call"], o["row"])
            if key not in done and len(done) < max_resolve:
                done[key] = _resolve_routes(rec, rec.calls[o["call"]],
                                            o["row"], device)
            o["resolved"] = done.get(key, [])
    return out


def _print(run_no, out):
    print(f"run {run_no}: {out['status']} in {out['wall_s']:.2f} s, "
          f"{out['lps']} LPs, {out['rounds']} rounds, "
          f"{len(out['directions'])} directions; worst angle to float64 "
          f"{max(out['degrees_to_f64'], default=0):.3g} deg; worst NNLS "
          f"cone residual {max(out['cone_residual'], default=0):.2e}; "
          f"{len(out['far'])} far; phase 1's R has {len(out['R'])} "
          f"generators, H {len(out['H'])}", flush=True)
    routes = {}
    for c in out["calls"]:
        key = f"phase {c['phase']} {c['route']}"
        routes[key] = routes.get(key, 0) + 1
    print(f"  solves by phase and route: {routes}")
    for e in out["far"]:
        print(f"  far {np.round(e['direction'], 6).tolist()}: "
              f"{e['deg_to_nearest_phase1_H']:.3g} deg from phase 1's "
              f"nearest H generator; bounded by {len(e['bounding'])} "
              f"recorded cuts", flush=True)
        for o in e["bounding"]:
            print(f"    normal {np.round(o['normal'], 9).tolist()} "
                  f"(outside the float64 run's cone of R by "
                  f"{o['normal_outside_f64_R']:.2e}) of the dual vertex "
                  f"{np.round(o['lower_vertex'], 9).tolist()}, phase "
                  f"{o['phase']} round {o['round']} "
                  f"({'loop' if o['in_loop'] else 'initial batch'}), "
                  f"frontier vertex {o['frontier_vertex']}, row {o['row']} "
                  f"of {o['batch']} (solve {o['solve_no']}), route "
                  f"{o['route']}; status {o['status']} obj {o['obj']:.6e} "
                  f"pivots {o['iters']}; y* recomputed within "
                  f"{o['ystar_match']:.1e}; row bounds "
                  f"{np.round(o['extra_ub'], 9).tolist()}", flush=True)
            for s in o.get("resolved", []):
                print(f"      {s['route']}: status {s['status']} obj "
                      f"{s['obj']:.6e} pivots {s['iters']} y* "
                      f"{np.round(s['ystar'], 9).tolist()} normal "
                      f"{np.round(s['normal'], 9).tolist()}; same basis "
                      f"{s['same_basis_as_recorded']}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--example", default="example10")
    ap.add_argument("--far-deg", type=float, default=1e-2)
    ap.add_argument("--out", help="write the JSON record here")
    a = ap.parse_args(argv)
    torch.set_num_threads(int(os.environ.get("WITNESS_THREADS", "1")))
    if torch.device(a.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    from bensolve_tpu_torch import examples, solve
    from bensolve_tpu_torch.vlp.options import Options

    with _Recorder() as rec:
        r64 = solve(getattr(examples, a.example)(),
                    Options(write_files=False, device=a.device))
    ref = dict(directions=r64.primal_directions, R=rec.rh["R"])
    print(f"{a.example} float64 on {a.device}: {r64.status.name}, "
          f"{len(ref['directions'])} directions "
          f"{np.round(ref['directions'], 6).tolist()}; phase 1's R "
          f"{np.round(ref['R'], 6).tolist()}", flush=True)
    runs = []
    for i in range(a.runs):
        out = run_once(a.example, a.device, ref, a.far_deg)
        _print(i, out)
        runs.append(out)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(dict(example=a.example, device=a.device,
                           f64_directions=ref["directions"].tolist(),
                           f64_R=ref["R"].tolist(), runs=runs), fh)
        print(f"wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
