"""One run of one cell of the benchmark of ``bensolve_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json.  The cell is an
entry of BENCHMARK.json's ``workloads``: a configuration (its file under
``configs/``: the instance's generator in ``instances/``, its reference
in ``reference/``, the program's options it states) and a traffic mix
(``traffic/<name>.json``); the cell's own file ``workloads/<cell>.json``
holds the numbers that decide ``correct``.  Everything is found by name,
so a new cell, configuration or metric is new files and entries.

The run, in one process: set-up (imports, the card, the polytope engine,
the instance, the mix's warm-up solves, which capture the CUDA graphs),
then a window of ``--seconds`` in which one client calls
``bensolve_tpu_torch.solve`` in a closed loop, each solve on the next
relabelling of the mix's fixed pool from a start drawn from ``--seed``,
until the time is up (the last solve started is finished and counted),
then the check of the window's answers against the reference, and one
JSON line last on standard output.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` wraps the layers' entries in the
probes its per-layer metrics name, and after the window traces the card
over a few more solves with torch.profiler, the probes then
synchronising nothing, and reports the per-layer metrics; a device trace
that lost records is tried again, and where no attempt comes back
complete the metrics that read it, its busy and window seconds and its
breakdown are left out (``device_trace.py``).  The numbers
compared, each beside its limit, are the last lines on standard error
and the last key of the result line.  ``--control`` solves the window
on the control's path (``control.py``).

Exits without a result: 2 where the card or the native polytope engine
is missing, 3 where the process has loaded JAX or the JAX package, 4
where a window input was one the warm-up solved.
"""

import time

T_START = time.perf_counter()   # the process's start, as near as it goes

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    # run as a script: find the benchmark's modules as benchmark.*, and
    # let none of them shadow a module of the same name elsewhere
    sys.path[0] = ROOT
# one process, one host thread for the program's CPU-side kernels and
# BLAS calls: the host work of a solve is serial, and spare threads that
# spin between small calls only add noise to the runs
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
# top-level module names that must never load in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "bensolve_tpu")
# the control: the program's own float32 path, the nearest precision
# below the float64 that the configurations state (``--control``)
CONTROL = {"lp_dtype": "float32"}
# solves traced on the device after the window of a traced run (a
# workload file may set "trace_solves"): the profiler keeps every kernel
# of every replayed graph, so a whole window of pivot loops would not fit
TRACE_SOLVES = 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark (a metric's name may hold
    dots, so by path)."""
    import importlib.util

    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(spec: dict, name: str):
    """The cell, its configuration, its mix, its own file and the
    metrics it reports, by name."""
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT, conf["file"])
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    own = load_json(HERE, "workloads", name + ".json")

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return cell, config, mix, own, e2e, layer


def forbidden_loaded() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def options(opts: dict, device: str):
    """The program's Options from a configuration's and a mix's names."""
    import dataclasses
    import enum

    from bensolve_tpu_torch import Options

    kw = dict(write_files=False, device=device, message_level=0,
              lp_message_level=0)
    for f in dataclasses.fields(Options):
        if f.name in opts:
            v = opts[f.name]
            if isinstance(f.default, enum.Enum):
                v = type(f.default)(v)
            kw[f.name] = v
    return Options(**kw)


def problem(inst: dict):
    from bensolve_tpu_torch import VLPProblem

    return VLPProblem.from_arrays(
        A=inst["A"], a=inst["row_lb"], b=inst["row_ub"], l=inst["col_lb"],
        s=inst["col_ub"], P=inst["P"], Y=inst.get("Y"), c=inst.get("c"),
        opt_dir=inst.get("opt_dir", 1))


def answer(r) -> dict:
    """What the reference judges: the status and the four point sets."""
    ok = r.status.name == "OPTIMAL" and r.pair is not None
    return dict(status=r.status.name,
                **{k: (getattr(r, f) if ok else None) for k, f in (
                    ("V", "primal_points"), ("D", "primal_directions"),
                    ("W", "dual_points"), ("Dd", "dual_directions"))})


def finite_or_none(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def main(argv=None, device: str = "cuda") -> int:
    """One run; ``device`` "cpu" skips the look for a card (the tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="solve the window on the control's path "
                    "(CONTROL's options); the benchmark's runs never do")
    args = ap.parse_args(argv)

    for var in THREAD_ENV:
        os.environ[var] = "1"
    if args.trace and device == "cuda":
        # kineto then logs its count of the records it lost, which the
        # device trace reads (INFO; set before torch loads kineto)
        os.environ["KINETO_LOG_LEVEL"] = "1"
    spec = load_json(ROOT, "BENCHMARK.json")
    cell, config, mix, own, e2e, layer = find_cell(spec, args.workload)

    import torch

    torch.set_num_threads(1)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        log(f"error: the cell needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2

    from benchmark import check
    from benchmark.traffic import Traffic, digest
    from bensolve_tpu_torch import solve
    from bensolve_tpu_torch.native import lib

    if lib() is None:
        # the pure-Python engine is another program, many times slower
        log("error: the native polytope engine did not build or load")
        return 2
    base = module("instances", config["instance"]).build(
        **config.get("instance_args", {}))
    tr = Traffic(mix, config, base, args.seed)
    opt = options(tr.options, device)
    win_opt = (options({**tr.options, **CONTROL}, device) if args.control
               else opt)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    warmed = set()
    for i in range(tr.warmup_solves):
        inst = tr.instance("warmup", i)
        warmed.add(digest(inst))
        t0 = time.perf_counter()
        r = solve(problem(inst), opt)
        sync()
        log(f"# warm-up solve {i}: {r.status.name} in "
            f"{time.perf_counter() - t0:.3f} s, {r.stats.lps} LPs")

    probes = {}
    if args.trace:
        names = {p for m in layer for p in module("metrics", m["name"]).PROBES}
        for name in sorted(names):
            probes[name] = __import__(f"benchmark.probes.{name}",
                                      fromlist=["Probe"]).Probe()
            probes[name].install()
    for p in probes.values():
        p.start()

    def one(i, spans=None):
        """Window solve i: its record, its instance, its result (None if
        it raised) and the traceback."""
        inst = tr.instance("window", i)
        t0 = time.perf_counter()
        r, err = None, None
        try:
            r = solve(problem(inst), win_opt)
            sync()
        except Exception:   # a solve that raises is a failed answer
            err = traceback.format_exc()
        t1 = time.perf_counter()
        if spans is not None:
            spans.append((t0, t1))
        rec = dict(wall_s=t1 - t0,
                   ok=r is not None and r.status.name == "OPTIMAL",
                   lps=r.stats.lps if r else 0,
                   rounds=r.stats.rounds if r else 0)
        return rec, inst, r, err

    results, solves, cases, errors = [], [], [], []
    t_win = time.perf_counter()
    setup_s = t_win - T_START
    end = t_win + args.seconds
    while not solves or t1 < end:
        rec, inst, r, err = one(len(solves))
        t1 = time.perf_counter()
        solves.append(rec)
        results.append(r)
        cases.append(inst)
        errors.append(err)
    window_s = t1 - t_win
    for p in probes.values():
        p.stop()

    trace, tail_failed, traced = None, 0, []
    if args.trace and device == "cuda":
        # the device trace: a few more solves after the window, under
        # the profiler, with the probes in their trace mode (host
        # intervals only, no synchronise); each attempt at them is one
        # profiler session, until one is complete (device_trace.py)
        from benchmark.device_trace import DeviceTrace

        for p in probes.values():
            p.trace(True)
        dtrace, solve_spans = DeviceTrace(), []
        while dtrace.wants():
            spans = []
            dtrace.start()
            for _ in range(int(own.get("trace_solves", TRACE_SOLVES))):
                rec, inst, _, err = one(len(solves) + len(traced), spans)
                tail_failed += not rec["ok"]
                errors.append(err)
                traced.append(inst)
            dtrace.stop((spans[0][0], spans[-1][1]))
            solve_spans += spans
        for p in probes.values():
            p.trace(False)
        host = {}
        for p in probes.values():
            host.update(p.intervals())
        host["solve"] = solve_spans
        trace = dtrace.result(host)
    for p in probes.values():
        p.remove()

    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    served = [digest(inst) for inst in cases + traced]
    cases = [(inst, answer(r) if r is not None else dict(status="RAISED"))
             for inst, r in zip(cases, results)]
    del results, r
    if device == "cuda":
        torch.cuda.empty_cache()
    if mix.get("relabel") and warmed & set(served):
        # a mix that relabels promises the window inputs the set-up
        # never saw
        log("error: an input of the window was solved in the warm-up; a "
            "cache of answers could serve it")
        return 4
    failed = sum(1 for s in solves if not s["ok"]) + tail_failed
    first_error = next((e for e in errors if e), None)
    if first_error:
        log("# first failed solve:\n" + first_error)

    run = types.SimpleNamespace(solves=solves, window_s=window_s,
                                setup_s=setup_s, probes=probes, trace=trace)
    metrics = {}
    for m in (layer if args.trace else e2e):
        v = module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    walls = sorted(s["wall_s"] for s in solves)
    log(f"# window: {len(solves)} solves of {len(set(served))} distinct "
        f"inputs in {window_s:.4f} s "
        f"({window_s / len(solves):.4f} s per solve; walls "
        f"{walls[0]:.4f} .. {walls[-1]:.4f} s), {failed} failed; "
        f"set-up {setup_s:.4f} s")

    reference = __import__(f"benchmark.reference.{config['reference']}",
                           fromlist=["judge"])
    chk = own["check"]
    correct, numbers = check.run_check(
        reference, cases, failed, chk["limits"], args.seed,
        int(chk.get("solves", 1)), int(chk.get("workers", 1)))

    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=torch.cuda.get_device_name(0) if device == "cuda"
               else device, count=cell["chips"], memory_peak_bytes=peak)
    line = dict(correct=bool(correct), attempted=len(solves), failed=failed,
                metrics=metrics, device=dev)
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace["busy_s"], trace["window_s"]
        line["breakdown"] = {k: trace[k] for k in ("device_ops", "idle_gaps")}
    line["checked"] = {k: {"value": finite_or_none(e["value"]),
                           "limit": e["limit"]} for k, e in numbers.items()}

    bad = forbidden_loaded()
    if bad:
        log(f"error: the run loaded {', '.join(bad)}")
        return 3
    for k, e in numbers.items():
        log(f"{k} {e['value']!r} limit {e['limit']!r}")
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
