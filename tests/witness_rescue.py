"""ROADMAP Queue 3 s: what the interior-point route's rescue pass
resolves, in the port and in the JAX package.

    python3 tests/witness_rescue.py flow                  # CPU, both
    python3 tests/witness_rescue.py card --device cuda \\
        --save chiprun_out/stragglers.npz [--rounds K]      # the port
    python3 tests/witness_rescue.py replay PATH           # CPU, both

With the host HiGHS fallback off (``BENSOLVE_HOST_FALLBACK=0``), an IPM
call re-runs the LPs its straggler cap cut off in one nested
``solve_batch_ipm(..., _rescue=True)`` call at full budget, and that
call hands the LPs it leaves ITLIM to the float64 simplex before it
returns (``lp/ipm.py``'s rescue and fallback blocks, alike in both
packages).  Three modes:

1. ``flow``: both runners (the repo's ``slow_runner.py``, its
   ``read_vlp`` returning the VLP, and ``bensolve_tpu_torch.slow_runner``)
   on ``random_vlp(3, 20, 2000, seed=0)`` under ``CONFIGS["ex07"]`` with
   the fallback off.  Per top-level IPM call: its LPs, the LPs the
   rescue pass takes, those the rescue IPM resolves itself and those it
   leaves to the nested simplex (``witness_large_shapes.HostBound`` on
   each package's ``lp.ipm``, ``lp.simplex`` and ``lp.revised``).
2. ``card``: the port's ex07 flow at ex07's shape (``random_vlp(3, 1211,
   1143, seed=7)``, LP 1218x1147) through ``witness_large_shapes
   .ex07_shape(host="off")``, which prints the IPM's four-way split.  At
   the first rescue call with at least 8 LPs, the first 8 are kept and
   written to ``--save`` (.npz: the shared A and its sha256, c and the
   bounds, the round and vertex of each, the template's Z/R, eta and
   orientation, the rescue call's keywords and what it returned), and
   printed on ``[straggler]`` lines: per LP, the entries that differ from
   its P2 template's base bounds, as ``float.hex``.  ``--rounds K`` stops
   the flow after that capture once K Benson rounds have run;
   ``--shape Q M N --seed S`` runs another shape (a CPU rehearsal).
3. ``replay PATH``: the 8 LPs from the .npz, or rebuilt from the
   ``[straggler]`` lines of a log (the template from ``random_vlp(3,
   1211, 1143, seed=7)``, or the shape the card ran, A checked by its
   sha256), through both
   packages' ``solve_batch_ipm(..., _rescue=True, max_iter=800)`` on the
   CPU with ``BENSOLVE_HOST_FALLBACK=0`` and ``BENSOLVE_IPM_FALLBACK_M=0``
   (so the nested simplex stays out and the rescue IPM's own statuses,
   iterations and quality show), then instance 0 alone under
   ``BENSOLVE_IPM_TRACE=1``: the two per-iteration histories and the
   first iteration where they part.

Not a pytest module; it edits no package file.  ``--out PATH`` writes
the record as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
# the repo, and this directory by path: a "tests" package installed
# elsewhere would shadow the repo's tests/, which has no __init__.py
sys.path[:0] = [os.path.dirname(HERE), HERE]

import numpy as np  # noqa: E402
import witness_large_shapes as wls  # noqa: E402

FLOW = dict(q=3, m=20, n=2000, seed=0)
EX07 = dict(q=3, m=1211, n=1143, seed=7)
KEEP = 8
REPLAY_ITERS = 800
FIELDS = ("c", "row_lb", "row_ub", "col_lb", "col_ub")


def _jax_cpu():
    """The JAX package on the CPU at float64, as tests/conftest.py sets
    it."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def sha256(A) -> str:
    return hashlib.sha256(np.ascontiguousarray(A).tobytes()).hexdigest()


# --------------------------------------------------------------- flow

def flow(q, m, n, seed):
    """Both runners on random_vlp(q, m, n, seed) under CONFIGS["ex07"],
    host fallback off; a record per package."""
    _jax_cpu()
    import bensolve_tpu.algs.driver as jdriver
    import bensolve_tpu.vlp.reader as jreader
    import dataclasses

    from bensolve_tpu import examples as jexamples
    from bensolve_tpu_torch import examples as texamples
    from bensolve_tpu_torch import slow_runner as tr

    out = {}
    with tr.environ({"BENSOLVE_HOST_FALLBACK": "0",
                     "BENSOLVE_IPM_BYTES": tr.IPM_BYTES}), \
            tempfile.TemporaryDirectory() as tmp:
        import slow_runner

        real_solve, real_read = jdriver.solve, jreader.read_vlp
        real_cache = slow_runner._setup_compile_cache
        vlp = jexamples.random_vlp(q=q, m=m, n=n, seed=seed)
        jdriver.solve = lambda v, opt, resume=None: real_solve(
            v, dataclasses.replace(opt, checkpoint_path=os.path.join(
                tmp, "jax_ckpt")), resume=resume)
        jreader.read_vlp = lambda path: vlp
        slow_runner._setup_compile_cache = lambda: None
        try:
            with wls.HostBound("cpu", pkg="bensolve_tpu") as hb:
                row = slow_runner.run_one("ex07")
        finally:
            jdriver.solve, jreader.read_vlp = real_solve, real_read
            slow_runner._setup_compile_cache = real_cache
        out["jax"] = dict(row=row, **hb.record())
        with wls.HostBound("cpu") as hb:
            row, _ = tr.solve_one("ex07", "cpu", vlp=texamples.random_vlp(
                q=q, m=m, n=n, seed=seed), ckpt_dir=tmp)
        out["port"] = dict(row=row, **hb.record())
    return out


def flow_lines(rec):
    lines = []
    for pkg in ("jax", "port"):
        r = rec[pkg]
        calls = [c for c in r["per_call"] if c["rescued"]]
        lines.append(
            f"[flow] {pkg}: {r['row']['status']}, {r['row']['lps']} LPs, "
            f"{r['row']['rounds']} rounds; {r['ipm_top_calls']} top-level "
            f"IPM calls over {r['ipm_lps']} LPs; {len(calls)} with a rescue "
            f"pass: {r['rescued']} LPs taken, {r['rescue_resolved']} "
            f"resolved by the rescue IPM, {r['simplex_in_rescue']} left to "
            f"its nested simplex, {r['simplex_top']} to a top-level "
            f"simplex")
        lines.append(f"[flow] {pkg} per call with a rescue pass "
                     f"(index: LPs, taken, resolved, to the simplex): "
                     + ", ".join(
                         f"{i}: {c['lps']}, {c['rescued']}, "
                         f"{c['rescue_resolved']}, {c['simplex_in_rescue']}"
                         for i, c in enumerate(r["per_call"])
                         if c["rescued"]))
    return lines


# --------------------------------------------------------------- card

class _Stop(Exception):
    pass


class Capture:
    """Wraps the port's P2Template (its arguments, and the round of each
    solve) and ipm.solve_batch_ipm: at the first rescue call with at
    least ``keep`` LPs the first ``keep`` are kept with what the call
    returned for them.  With ``rounds``, raises _Stop after that call
    once so many P2 solves have run."""

    def __init__(self, keep=KEEP, rounds=None):
        self.keep, self.rounds = keep, rounds
        self.solves, self.current, self.kept = 0, None, None

    def __enter__(self):
        from bensolve_tpu_torch.algs import templates
        from bensolve_tpu_torch.lp import ipm

        self.saved = [(templates.P2Template, "__init__",
                       templates.P2Template.__init__),
                      (templates.P2Template, "solve",
                       templates.P2Template.solve),
                      (ipm, "solve_batch_ipm", ipm.solve_batch_ipm)]
        init, solve, real = (f for _, _, f in self.saved)
        cap = self

        def init_(t, vlp, P_eff, ZR, eta, homogeneous, *a, **kw):
            init(t, vlp, P_eff, ZR, eta, homogeneous, *a, **kw)
            t._witness_args = dict(
                flip=bool(np.array_equal(np.asarray(P_eff), -vlp.P)
                          and np.any(vlp.P)),
                ZR=np.asarray(ZR, float), eta=np.asarray(eta, float),
                homogeneous=bool(homogeneous))

        def solve_(t, *a, **kw):
            cap.solves += 1
            cap.current = (t, cap.solves)
            return solve(t, *a, **kw)

        def ipm_(A, c, row_lb, row_ub, col_lb, col_ub, **kw):
            res = real(A, c, row_lb, row_ub, col_lb, col_ub, **kw)
            n = np.atleast_2d(c).shape[0]
            if kw.get("_rescue") and cap.kept is None and n >= cap.keep:
                cap._keep(A, (c, row_lb, row_ub, col_lb, col_ub), kw, res)
                if cap.rounds is not None and cap.solves >= cap.rounds:
                    raise _Stop
            return res

        templates.P2Template.__init__ = init_
        templates.P2Template.solve = solve_
        ipm.solve_batch_ipm = ipm_
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)

    def _keep(self, A, arrays, kw, res):
        k = self.keep
        t, rnd = self.current
        arrs = {f: np.array(np.atleast_2d(a)[:k], np.float64)
                for f, a in zip(FIELDS, arrays)}
        m, q, p = t.m, t.q, t.p
        extra = arrs["row_ub"][:, m + q:m + q + p]
        # ub_j = (ZR' v)_j: the vertex back from the extra rows
        V = np.linalg.lstsq(t.ZR.T, extra.T, rcond=None)[0].T
        A = np.asarray(A, np.float64)
        self.kept = dict(
            A=A, a_sha256=sha256(A), round=np.full(k, rnd), vertex=V,
            rescue_n=np.atleast_2d(arrays[0]).shape[0],
            status=np.asarray(res.status)[:k], iters=np.asarray(
                res.iters)[:k], kwargs=json.dumps(
                {a: (np.dtype(v).name if a == "dtype" else v)
                 for a, v in kw.items() if a != "device"}),
            template=json.dumps(dict(
                    flip=t._witness_args["flip"],
                    homogeneous=t._witness_args["homogeneous"],
                    ZR=[[float(x).hex() for x in r]
                        for r in t._witness_args["ZR"]],
                    eta=[float(x).hex() for x in t._witness_args["eta"]])),
            **arrs)
        self.base = _base_inputs(t)


def _base_inputs(t):
    """The template's inputs of one LP with every extra row inactive: the
    base that a straggler's printed entries differ from."""
    return {f: np.asarray(a, np.float64)[0] for f, a in zip(
        FIELDS, t.build_inputs(np.full((1, t.p), np.inf)))}


def straggler_lines(kept, base):
    """The kept LPs as printable lines: one for the template and A, one
    per LP with its entries that differ from ``base``, in float.hex."""
    lines = ["[straggler-template] " + json.dumps(dict(
        a_sha256=kept["a_sha256"], a_shape=list(kept["A"].shape),
        kwargs=json.loads(kept["kwargs"]),
        rescue_n=int(kept["rescue_n"]), vlp=json.loads(kept["vlp"]),
        **json.loads(kept["template"])))]
    for i in range(kept["c"].shape[0]):
        diffs = {}
        for f in FIELDS:
            row, b = kept[f][i], base[f]
            idx = np.flatnonzero(~((row == b) | (np.isnan(row)
                                                 & np.isnan(b))))
            diffs[f] = {int(j): float(row[j]).hex() for j in idx}
        lines.append("[straggler] " + json.dumps(dict(
            k=i, round=int(kept["round"][i]),
            vertex=[float(x).hex() for x in kept["vertex"][i]],
            card_status=int(kept["status"][i]),
            card_iters=int(kept["iters"][i]), diffs=diffs)))
    return lines


def card(device, save, rounds, vlp=EX07):
    """The ex07 flow on random_vlp(**vlp) (default: ex07's shape) with
    the capture; the record."""
    rec = {}
    with Capture(rounds=rounds) as cap, \
            tempfile.TemporaryDirectory() as ckpt:
        try:
            flow_rec, _ = wls.ex07_shape(device, vlp["q"], vlp["m"],
                                         vlp["n"], seed=vlp["seed"],
                                         host="off", ckpt_dir=ckpt)
            rec["ex07"] = flow_rec
            print(f"[ex07 shape] {wls.ex07_line(flow_rec)}", flush=True)
        except _Stop:
            rec["stopped_after_round"] = cap.solves
    if cap.kept is None:
        raise AssertionError(f"no rescue call took {KEEP} LPs or more")
    cap.kept["vlp"] = json.dumps(vlp)
    for line in straggler_lines(cap.kept, cap.base):
        print(line, flush=True)
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        np.savez_compressed(save, **cap.kept)
    rec["kept"] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in cap.kept.items() if k not in ("A",) + FIELDS}
    return rec


# ------------------------------------------------------------- replay

def load(path):
    """(A, [c, row_lb, row_ub, col_lb, col_ub], meta) from the .npz, or
    from a log's [straggler] lines rebuilt on random_vlp(EX07)'s
    template."""
    if path.endswith(".npz"):
        z = np.load(path)
        A = z["A"]
        if sha256(A) != str(z["a_sha256"]):
            raise AssertionError("A does not match its sha256")
        return A, [z[f] for f in FIELDS], dict(
            kwargs=json.loads(str(z["kwargs"])), round=z["round"].tolist(),
            card_status=z["status"].tolist(), card_iters=z["iters"].tolist())
    from bensolve_tpu_torch.algs.templates import P2Template
    from bensolve_tpu_torch.examples import random_vlp

    with open(path) as f:
        text = f.read()
    head = json.loads(re.search(r"^\[straggler-template\] (.*)$", text,
                                re.M).group(1))
    rows = [json.loads(s) for s in re.findall(r"^\[straggler\] (.*)$", text,
                                               re.M)]
    vlp = random_vlp(**head["vlp"])
    P_eff = (-vlp.P if head["flip"] else vlp.P).astype(float)
    ZR = np.array([[float.fromhex(x) for x in r] for r in head["ZR"]])
    eta = np.array([float.fromhex(x) for x in head["eta"]])
    t = P2Template(vlp, P_eff, ZR, eta, head["homogeneous"])
    A = np.asarray(t.A_lp, np.float64)
    if sha256(A) != head["a_sha256"]:
        raise AssertionError("the rebuilt template's A does not match the "
                             "card's sha256")
    base = _base_inputs(t)
    arrs = {f: np.tile(base[f], (len(rows), 1)) for f in FIELDS}
    for i, r in enumerate(rows):
        for f in FIELDS:
            for j, v in r["diffs"][f].items():
                arrs[f][i, int(j)] = float.fromhex(v)
    return A, [arrs[f] for f in FIELDS], dict(
        kwargs=head["kwargs"], round=[r["round"] for r in rows],
        card_status=[r["card_status"] for r in rows],
        card_iters=[r["card_iters"] for r in rows])


def _trace(lines):
    """The per-iteration rows of BENSOLVE_IPM_TRACE's output."""
    pat = re.compile(r"^ipm it=(\d+) (.*)$")
    out = []
    for ln in lines.splitlines():
        mt = pat.match(ln)
        if mt:
            out.append({k: float(v) for k, v in (
                kv.split("=") for kv in mt.group(2).split())})
    return out


def _rescue_solve(pkg, A, arrays, kw):
    if pkg == "jax":
        from bensolve_tpu.lp import ipm
        extra = {}
    else:
        from bensolve_tpu_torch.lp import ipm
        extra = dict(device="cpu")
    return ipm.solve_batch_ipm(A, *arrays, **kw, **extra)


def replay(path, trace=True):
    _jax_cpu()
    from bensolve_tpu_torch.slow_runner import environ
    A, arrays, meta = load(path)
    kw = {k: v for k, v in meta["kwargs"].items()
          if k in ("verbose", "polish", "max_chunk")}
    kw.update(max_iter=REPLAY_ITERS, _rescue=True,
              dtype=np.dtype(meta["kwargs"].get("dtype", "float32")).type)
    # the budget also through BENSOLVE_IPM_MAXIT, which overrides max_iter
    env = {"BENSOLVE_HOST_FALLBACK": "0", "BENSOLVE_IPM_FALLBACK_M": "0",
           "BENSOLVE_IPM_MAXIT": str(REPLAY_ITERS), "BENSOLVE_IPM_TRACE": "0"}
    rec = dict(meta, lps=int(arrays[0].shape[0]), max_iter=REPLAY_ITERS)
    with environ(env):
        for pkg in ("jax", "port"):
            res = _rescue_solve(pkg, A, arrays, kw)
            rec[pkg] = dict(status=np.asarray(res.status).tolist(),
                            iters=np.asarray(res.iters).tolist(),
                            quality=(None if res.quality is None else
                                     np.asarray(res.quality).tolist()),
                            obj=np.asarray(res.obj).tolist())
    if trace:
        hist = {}
        with environ(dict(env, BENSOLVE_IPM_TRACE="1")):
            for pkg in ("jax", "port"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    _rescue_solve(pkg, A, [a[:1] for a in arrays], kw)
                hist[pkg] = _trace(buf.getvalue())
        rec["trace"] = hist
        rec["parted"] = _parted(hist["jax"], hist["port"])
    return rec


def _parted(h1, h2, rel=1e-2):
    """The first iteration whose printed values differ at all, and the
    first where one differs by more than ``rel`` relative (the trace
    prints four significant digits; float32 rounding stays below)."""
    first_any = first_rel = None
    for k, (a, b) in enumerate(zip(h1, h2)):
        for f in a:
            x, y = a[f], b.get(f)
            if y is None:
                continue
            if first_any is None and x != y:
                first_any = (k, f, x, y)
            if first_rel is None and abs(x - y) > rel * max(abs(x), abs(y),
                                                            1e-30):
                first_rel = (k, f, x, y)
    return dict(lengths=[len(h1), len(h2)], first_any=first_any,
                first_beyond=first_rel, rel=rel)


def replay_lines(rec):
    lines = [f"[replay] {rec['lps']} stragglers (rounds {rec['round']}), "
             f"rescue IPM alone (max_iter {rec['max_iter']}, nested "
             f"simplex off); on the card the rescue pass returned "
             f"{rec['card_status']} in {rec['card_iters']} iterations "
             f"(with its nested simplex)"]
    for pkg in ("jax", "port"):
        r = rec[pkg]
        lines.append(f"[replay] {pkg}: status {r['status']} iterations "
                     f"{r['iters']} quality {r['quality']}")
    if "parted" in rec:
        p = rec["parted"]
        lines.append(f"[replay] instance 0's history: {p['lengths']} "
                     f"iterations (jax, port); first printed difference "
                     f"{p['first_any']}; first beyond {p['rel']:g} relative "
                     f"{p['first_beyond']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    f = sub.add_parser("flow")
    f.add_argument("--shape", type=int, nargs=3,
                   default=(FLOW["q"], FLOW["m"], FLOW["n"]),
                   metavar=("Q", "M", "N"))
    f.add_argument("--seed", type=int, default=FLOW["seed"])
    c = sub.add_parser("card")
    c.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    c.add_argument("--save", help="write the kept LPs here (.npz)")
    c.add_argument("--rounds", type=int, default=None)
    c.add_argument("--shape", type=int, nargs=3,
                   default=(EX07["q"], EX07["m"], EX07["n"]),
                   metavar=("Q", "M", "N"))
    c.add_argument("--seed", type=int, default=EX07["seed"])
    r = sub.add_parser("replay")
    r.add_argument("path", help="the card's .npz, or a log holding its "
                   "[straggler] lines")
    r.add_argument("--no-trace", action="store_true")
    for p in (f, c, r):
        p.add_argument("--out", help="write the record as JSON here")
    a = ap.parse_args(argv)
    if a.mode == "flow":
        rec = flow(*a.shape, a.seed)
        lines = flow_lines(rec)
    elif a.mode == "card":
        rec = card(a.device, a.save, a.rounds, dict(
            q=a.shape[0], m=a.shape[1], n=a.shape[2], seed=a.seed))
        lines = []
    else:
        rec = replay(a.path, trace=not a.no_trace)
        lines = replay_lines(rec)
    for ln in lines:
        print(ln, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rec, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
