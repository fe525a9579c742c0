"""Where a meshed solve's time goes: one example solved four ways.

    python3 tests/witness_mesh_split.py                      # example10 float64 on the card
    python3 tests/witness_mesh_split.py --dtype float32 --cases 1,2,3
    python3 tests/witness_mesh_split.py --device cpu --example example05

The four runs, in this order:

1. plain: the default options (the dual warm route and the kept-tableau
   chain on);
2. no warm routes: BENSOLVE_NO_DUAL_WARM=1 and BENSOLVE_NO_STATE_WARM=1,
   which switch off what a mesh switches off, on one device, no threads;
3. mesh of 1: ``mesh_axes=("dp",), mesh_devices=1``, one shard on one
   thread and stream;
4. mesh of ``--entries`` (4): the chip_smoke.py mesh phase's setting.

Per run it prints the wall, LPs, rounds, pivots, the number of batched
LP solves, the seconds inside them (host clock, synchronised), and the
tableau pivot loop's lockstep steps summed over the solves (each shard
counts its own).  Not a pytest module: example10 takes minutes on the
CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

F32_KW = dict(lp_dtype="float32", eps_benson_phase1=1e-4,
              eps_benson_phase2=1e-4)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(name, device, dtype, env=None, **kw):
    import bensolve_tpu_torch as bt
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs import templates
    from bensolve_tpu_torch.lp import simplex

    counts = {"solves": 0, "solve_s": 0.0, "steps": 0}
    real_run, real_seg = templates._TemplateBase._run, simplex._run_segmented

    def timed_run(self, *a, **k):
        if k.get("_chunked"):
            return real_run(self, *a, **k)
        _sync(device)
        t0 = time.perf_counter()
        out = real_run(self, *a, **k)
        _sync(device)
        counts["solves"] += 1
        counts["solve_s"] += time.perf_counter() - t0
        return out

    def counted(step_fn, *a):
        def step(*s):
            counts["steps"] += 1
            return step_fn(*s)
        return real_seg(step, *a)

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    templates._TemplateBase._run = timed_run
    simplex._run_segmented = counted
    try:
        opt = bt.Options(write_files=False, device=device,
                         **(F32_KW if dtype == "float32" else {}), **kw)
        _sync(device)
        t0 = time.perf_counter()
        r = bt.solve(examples.ALL[name](), opt)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        templates._TemplateBase._run = real_run
        simplex._run_segmented = real_seg
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return r, wall, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--example", default="example10")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entries", type=int, default=4)
    ap.add_argument("--cases", default="1,2,3,4",
                    help="which of the four runs, by number")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda":
        print(f"device {torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
    cases = [
        ("plain", {}, {}),
        ("no warm routes", {"BENSOLVE_NO_DUAL_WARM": "1",
                            "BENSOLVE_NO_STATE_WARM": "1"}, {}),
        ("mesh of 1", {}, dict(mesh_axes=("dp",), mesh_devices=1)),
        (f"mesh of {a.entries}", {}, dict(mesh_axes=("dp",),
                                          mesh_devices=a.entries)),
    ]
    picked = {int(k) for k in a.cases.split(",")}
    for k, (label, env, kw) in enumerate(cases, 1):
        if k not in picked:
            continue
        r, wall, c = run(a.example, a.device, a.dtype, env, **kw)
        print(f"{a.example} {a.dtype} {label}: {r.status.name} in "
              f"{wall:.2f} s; LPs {r.stats.lps} rounds {r.stats.rounds} "
              f"pivots {r.stats.pivots}; {c['solves']} batched LP solves "
              f"taking {c['solve_s']:.2f} s, {c['steps']} tableau lockstep "
              f"steps", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
