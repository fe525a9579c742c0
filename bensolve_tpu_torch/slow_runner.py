"""Run the large reference examples (ex07 / ex09 / ex10) end to end on a
torch device with the reference's own flags, and record status, wall,
LP counts and the support oracle's verdict: the port of the repo's
``slow_runner.py``.

    python -m bensolve_tpu_torch.slow_runner [ex ...] [--device cuda|cpu]
        [--ex-dir DIR] [--out PATH]

Examples default to ex10 ex07 ex09, read from ``<ex-dir>/<ex>.vlp``.
ex10 is built by ``examples.example10()`` where its file is absent; a
missing ex07 or ex09 file is an error that names it (their data ships
only inside the reference's .vlp files).  Each run prints one JSON row
on stdout; ``--out PATH`` also merges the rows into a markdown table
with the columns of ``SLOW_RESULTS.md`` (rows keyed by example and
backend).  The device defaults to the card and raises without one.

Flags per example mirror the reference's recommendations
(ex/example07.m:9, example09.m:10): loose epsilons and float32 LP
arithmetic for ex07/ex09, whose scalar LPs go through the interior-point
route (``lp_ipm_min``); ex10 runs at defaults.  Every phase-2 round
writes a checkpoint to ``<tmp>/bensolve_ckpt_<ex>``; with
``BENSOLVE_RESUME=1`` a run resumes from it.  ``BENSOLVE_IPM_BYTES``
(the interior-point chunk budget) defaults to 6e9 inside a run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

from bensolve_tpu_torch.examples import REFERENCE_EX, example10

IPM_BYTES = "6000000000"

CONFIGS = {
    "ex07": dict(eps_benson_phase2=0.05, lp_dtype="float32",
                 message_level=2, lp_ipm_min=2000, env={}),
    "ex09": dict(eps_benson_phase2=1e-2, lp_dtype="float32",
                 message_level=2, lp_message_level=2, lp_ipm_min=2000,
                 # short device pass (easy majority converges in
                 # ~60-120 iterations) + exact host HiGHS for the rest
                 env={"BENSOLVE_IPM_MAXIT": "180",
                      "BENSOLVE_HOST_FALLBACK_MAX": "64"}),
    "ex10": dict(message_level=2, env={}),
}
# the support oracle's tolerance per example (8 samples)
SUPPORT_TOL = {"ex07": 0.05, "ex09": 1e-2, "ex10": 1e-4}

TABLE_HEAD = ["| ex | backend | status | wall (s) | LPs | rounds | points "
              "| dirs | support oracle | loose cuts |",
              "|---|---|---|---|---|---|---|---|---|---|"]


def run_env(ex):
    """The environment a run of ``ex`` sets: its CONFIGS entry's, and
    BENSOLVE_IPM_BYTES unless the caller set it."""
    return {"BENSOLVE_IPM_BYTES": os.environ.get("BENSOLVE_IPM_BYTES",
                                                 IPM_BYTES),
            **CONFIGS[ex]["env"]}


@contextlib.contextmanager
def environ(env):
    """``env`` set inside the block, the previous values restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def solve_one(ex, device="cuda", ex_dir=REFERENCE_EX, vlp=None,
              ckpt_dir=None):
    """Solve ``ex`` under CONFIGS[ex] and its environment (restored
    after) on ``device``; ``vlp`` stands in for ``<ex_dir>/<ex>.vlp``.
    Returns (row, result)."""
    from bensolve_tpu_torch.algs.driver import solve
    from bensolve_tpu_torch.bench import check_support, smi_line
    from bensolve_tpu_torch.lp.simplex import resolve_device
    from bensolve_tpu_torch.vlp.options import Options
    from bensolve_tpu_torch.vlp.reader import read_vlp

    dev = resolve_device(device)
    cfg = {k: v for k, v in CONFIGS[ex].items() if k != "env"}
    with environ(run_env(ex)):
        if vlp is None:
            path = os.path.join(ex_dir, f"{ex}.vlp")
            if os.path.isfile(path):
                vlp, source = read_vlp(path), path
            elif ex == "ex10":
                vlp, source = example10(), "examples.example10()"
            else:
                raise FileNotFoundError(
                    f"{path}: no such file ({ex}'s data ships only inside "
                    f"the reference's {ex}.vlp)")
        else:
            source = "the caller's VLP"
        print(f"== {ex}: q={vlp.q} m={vlp.m} n={vlp.n} backend={dev.type} "
              f"source={source}", flush=True)
        # phase-2 round snapshots, so a run cut by a wall clock can be
        # resumed (solve(..., resume=ckpt))
        ckpt_dir = ckpt_dir or tempfile.gettempdir()
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt = os.path.join(ckpt_dir, f"bensolve_ckpt_{ex}")
        resume = ckpt if (os.environ.get("BENSOLVE_RESUME") == "1"
                          and os.path.exists(ckpt)) else None
        t0 = time.time()
        r = solve(vlp, Options(write_files=False, checkpoint_path=ckpt,
                               device=str(dev), **cfg), resume=resume)
        wall = time.time() - t0
        tol = SUPPORT_TOL[ex]
        sup = "n/a"
        if r.status.name == "OPTIMAL":
            try:
                check_support(r, n_samples=8, tol=tol)
                sup = f"pass@{tol}"
            except AssertionError:
                sup = f"FAIL@{tol}"
        row = dict(ex=ex, status=r.status.name, wall_s=wall,
                   lps=r.stats.lps, rounds=r.stats.rounds,
                   points=len(r.primal_points),
                   directions=len(r.primal_directions),
                   support=sup, backend=dev.type,
                   loose_cuts=getattr(r.stats, "loose_cuts", 0),
                   loose_deferred=getattr(r.stats, "loose_deferred", 0))
        if dev.type == "cuda":
            row["card"] = smi_line()
        print(json.dumps(row), flush=True)
        return row, r


def run_one(ex, device="cuda", ex_dir=REFERENCE_EX, vlp=None,
            ckpt_dir=None):
    """The row of one run (solve_one without the result)."""
    return solve_one(ex, device, ex_dir, vlp, ckpt_dir)[0]


def table_line(row):
    """A row as a line of the results table; the card joins the
    backend cell."""
    backend = row["backend"] + (f" ({row['card']})" if "card" in row
                                else "")
    return (f"| {row['ex']} | {backend} | {row['status']} "
            f"| {row['wall_s']:.1f} | {row['lps']} | {row['rounds']} "
            f"| {row['points']} | {row['directions']} "
            f"| {row['support']} | {row['loose_cuts']} "
            f"({row['loose_deferred']} deferred) |")


def write_table(path, rows):
    """Merge ``rows`` into the table at ``path`` (rows keyed by example
    and backend cell; a new row replaces an older one)."""
    prev = {}
    if os.path.exists(path):
        for ln in open(path):
            if ln.startswith("| ex0") or ln.startswith("| ex1"):
                cells = ln.split("|")
                prev[(cells[1].strip(), cells[2].strip())] = ln.rstrip()
    for row in rows:
        ln = table_line(row)
        cells = ln.split("|")
        prev[(cells[1].strip(), cells[2].strip())] = ln
    stamp = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())
    lines = ["# Large reference examples through bensolve_tpu_torch",
             "",
             f"Last updated {stamp} (`python -m "
             "bensolve_tpu_torch.slow_runner`).  Flags per",
             "example follow the reference's own advice",
             "(`ex/example07.m:9`, `ex/example09.m:10`).",
             ""] + TABLE_HEAD + [prev[k] for k in sorted(prev)] + [""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ex", nargs="*", choices=sorted(CONFIGS),
                    help="examples to run (default: ex10 ex07 ex09)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ex-dir", default=REFERENCE_EX,
                    help="directory of ex07.vlp, ex09.vlp, ex10.vlp")
    ap.add_argument("--out", help="markdown table to merge the rows into")
    a = ap.parse_args(argv)
    rows = [run_one(ex, a.device, a.ex_dir)
            for ex in (a.ex or ["ex10", "ex07", "ex09"])]
    if a.out:
        write_table(a.out, rows)
        print(f"wrote {a.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
