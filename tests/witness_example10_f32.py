"""example10 at float32: which extreme directions each route finds.

    JAX_PLATFORMS=cpu python tests/witness_example10_f32.py --side jax --dtype float32 --out jax32.json
    python tests/witness_example10_f32.py --side port --dtype float32 --out port32.json
    BENSOLVE_FORCE_PALLAS=1 python tests/witness_example10_f32.py --side port --dtype float32 --out kernel32.json
    python tests/witness_example10_f32.py --side port --dtype float64 --out port64.json
    python tests/witness_example10_f32.py --side port --dtype float32 --jax-f32-finish --out port32_jaxfinish.json
    python tests/witness_example10_f32.py --compare port64.json jax32.json port32.json kernel32.json

One solve of ``example10()`` (or ``--example``) per call, with the options of
``chip_smoke.F32_KW`` at float32 (epsilon 1e-4 in both phases) and the
defaults at float64, through the JAX package (``--side jax``, its XLA
route on the CPU) or the port (``--side port``, on ``--device``, the
CPU by default; with BENSOLVE_FORCE_PALLAS=1 the float32 batches take
the kernel's route, whose plain PyTorch version runs off the card).  It
writes the status, the counts, the wall time and the upper image's
points and directions as JSON.  On the port's side it also watches
every ``torch.linalg.lu_factor_ex`` / ``lu_solve`` call and records, per
calling function, the calls given an empty batch or non-finite entries,
and the factorizations that return a pivot index out of range.
``--jax-f32-finish`` ends float32 kept-tableau chains as the JAX package
does (LU-free), where the port refactorizes them (ROADMAP Queue 3 f).
``WITNESS_THREADS`` sets the port's intra-op threads (default 1).

``--compare`` takes the float64 file first and prints, for each other
file, every direction's angle to the nearest float64 direction (and
each float64 direction's angle to the nearest of that file's).

Not a pytest module: the port's float32 solve takes minutes on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

F32_KW = dict(lp_dtype="float32", eps_benson_phase1=1e-4,
              eps_benson_phase2=1e-4)


def _options(mod, dtype, device):
    kw = dict(F32_KW) if dtype == "float32" else {}
    if device is not None:
        kw["device"] = device
    return mod.Options(write_files=False, **kw)


def _watch_lu(trace):
    """Wrap torch.linalg's LU calls; anomalies are counted per caller."""
    import torch

    real_f, real_s = torch.linalg.lu_factor_ex, torch.linalg.lu_solve

    def caller():
        f = sys._getframe(2)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"

    def factor(A, *a, **kw):
        out = real_f(A, *a, **kw)
        key = caller()
        trace[key]["factor_calls"] += 1
        if A.numel() == 0:
            trace[key]["factor_empty"] += 1
        elif not bool(torch.isfinite(A).all()):
            trace[key]["factor_nonfinite_input"] += 1
            trace[key]["nonfinite_matrices"] += int(
                (~torch.isfinite(A.reshape(A.shape[0], -1)).all(1)).sum())
        piv = out[1]
        if piv.numel() and bool(((piv < 1) | (piv > A.shape[-1])).any()):
            trace[key]["factor_pivot_out_of_range"] += 1
        return out

    def solve(LU, piv, B, *a, **kw):
        key = caller()
        trace[key]["solve_calls"] += 1
        if LU.numel() == 0 or B.numel() == 0:
            trace[key]["solve_empty"] += 1
        elif not bool(torch.isfinite(LU).all()):
            trace[key]["solve_nonfinite_LU"] += 1
        elif not bool(torch.isfinite(B).all()):
            trace[key]["solve_nonfinite_rhs"] += 1
        return real_s(LU, piv, B, *a, **kw)

    torch.linalg.lu_factor_ex, torch.linalg.lu_solve = factor, solve


def run(side, dtype, device, jax_f32_finish=False, name="example10"):
    trace = collections.defaultdict(collections.Counter)
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from bensolve_tpu import examples, solve
        from bensolve_tpu.vlp import options as jopt

        opt = _options(jopt, dtype, None)
    else:
        import torch
        torch.set_num_threads(int(os.environ.get("WITNESS_THREADS", "1")))
        from bensolve_tpu_torch import examples, solve
        from bensolve_tpu_torch.lp import dual_simplex
        from bensolve_tpu_torch.vlp import options as topt

        if jax_f32_finish:
            _take_jax_f32_finish(dual_simplex)

        opt = _options(topt, dtype, device)
        _watch_lu(trace)
    vlp = getattr(examples, name)()
    t0 = time.perf_counter()
    r = solve(vlp, opt)
    wall = time.perf_counter() - t0
    return {
        "example": name, "side": side, "dtype": dtype, "device": device,
        "force_kernel": os.environ.get("BENSOLVE_FORCE_PALLAS") == "1",
        "jax_f32_finish": jax_f32_finish,
        "status": r.status.name, "wall_s": wall,
        "lps": r.stats.lps, "rounds": r.stats.rounds,
        "points": r.primal_points.tolist(),
        "directions": r.primal_directions.tolist(),
        "dual_points": len(r.dual_points),
        "dual_directions": len(r.dual_directions),
        "lu_trace": {k: dict(v) for k, v in trace.items()},
    }


def _take_jax_f32_finish(dual_simplex):
    """Replace dual_simplex._solve_dual_segmented with a copy that ends a
    kept-tableau chain LU-free at float32 too, under the float64 rule's
    conditions, as the JAX package does (the port refactorizes float32
    chains, ROADMAP Queue 3 f)."""
    import torch

    from bensolve_tpu_torch.lp import simplex as sx

    def segmented(A, c, lb, ub, basis0, at_upper0, max_iter,
                  state_warm=None, keep_state=False):
        age0 = 0
        if state_warm is not None:
            ks, idx = state_warm
            age0 = ks.age
            st = sx._start_from_state(
                A, c, lb, ub, ks, torch.as_tensor(idx, device=c.device).long())
        else:
            st = sx._initial_state(A, c, lb, ub, basis0, at_upper0)
        st = dual_simplex._mark_dual_lost(A, c, lb, ub, st)
        st = sx._run_segmented(dual_simplex._dstep, A, c, lb, ub, st,
                               max_iter)
        status = st.status.cpu().numpy()
        max_piv = int(st.iters.max())
        age = (age0 + max_piv) if state_warm is not None else max_piv
        cap = (sx.STATE_WARM_MAX_AGE
               if c.dtype == torch.float64 else sx.STATE_WARM_MAX_AGE // 4)
        if (state_warm is not None and age <= cap
                and (status == sx.OPTIMAL).all()):
            out = sx._cheap_finish(A, c, lb, ub, st)
        else:
            out = sx._finish(A, c, lb, ub, st)
        kept = sx._keep_state(st, age) if keep_state else None
        return out, kept

    dual_simplex._solve_dual_segmented = segmented


def _unit(d):
    d = np.atleast_2d(np.asarray(d, float))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def angles(dirs, ref):
    """Degrees from each row of ``dirs`` to the nearest row of ``ref``."""
    if not len(dirs) or not len(ref):
        return []
    cos = np.clip(_unit(dirs) @ _unit(ref).T, -1.0, 1.0)
    return np.degrees(np.arccos(cos.max(axis=1))).tolist()


def compare(paths):
    runs = []
    for p in paths:
        with open(p) as fh:
            runs.append(json.load(fh))
    ref = runs[0]
    print(f"reference {paths[0]}: {ref.get('example', 'example10')} "
          f"{ref['side']} {ref['dtype']}, "
          f"{len(ref['directions'])} directions {ref['directions']}")
    for p, r in zip(paths[1:], runs[1:]):
        to_ref = angles(r["directions"], ref["directions"])
        from_ref = angles(ref["directions"], r["directions"])
        print(f"{p}: {r['side']} {r['dtype']} force_kernel="
              f"{r['force_kernel']} jax_f32_finish="
              f"{r.get('jax_f32_finish', False)} {r['status']} in "
              f"{r['wall_s']:.1f} s, "
              f"{len(r['points'])} points, {len(r['directions'])} directions, "
              f"{r['lps']} LPs, {r['rounds']} rounds")
        for d, a in zip(r["directions"], to_ref):
            print(f"    {np.round(d, 6).tolist()}: {a:.3g} deg to the "
                  f"nearest float64 direction")
        print(f"    float64 directions to this list's nearest: "
              f"{[round(a, 4) for a in from_ref]} deg")
        for k, v in r.get("lu_trace", {}).items():
            bad = {n: c for n, c in v.items() if not n.endswith("_calls")}
            print(f"    lu {k}: {v.get('factor_calls', 0)} factor / "
                  f"{v.get('solve_calls', 0)} solve calls; {bad or 'clean'}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", choices=("jax", "port"))
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out")
    ap.add_argument("--jax-f32-finish", action="store_true")
    ap.add_argument("--example", default="example10")
    ap.add_argument("--compare", nargs="+")
    a = ap.parse_args(argv)
    if a.compare:
        compare(a.compare)
        return 0
    out = run(a.side, a.dtype, a.device if a.side == "port" else None,
              a.jax_f32_finish, a.example)
    text = json.dumps(out)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(text)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("points",)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
