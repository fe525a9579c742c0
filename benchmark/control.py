"""The control of ``correct``, on the card: whole runs of a cell with the
window on the control's path (``run.py --control``: the program's own
float32 path, the nearest precision below the float64 that the
configurations state), one process per seed, each judged by the
harness's own check.  Each has to come out not correct; a run that
crashes or overruns ``--limit`` gives no number and has failed too.

    python3 benchmark/control.py --workload <cell> --seeds 3 --seconds 3

One JSON line per seed on standard output: the exit code, ``correct``
and the numbers compared.  The benchmark's runs never run this."""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(workload: str, seed: int, seconds: float, limit: float) -> dict:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", "0", "--control"]
    try:
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=limit)
    except subprocess.TimeoutExpired:
        return dict(seed=seed, rc=None, correct=None, note="over the limit")
    lines = out.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if out.returncode == 0 and lines else {}
    return dict(seed=seed, rc=out.returncode, correct=line.get("correct"),
                attempted=line.get("attempted"), failed=line.get("failed"),
                checked=line.get("checked"),
                note=out.stderr.strip().splitlines()[-1:] if not line
                else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_100_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--limit", type=float, default=360.0)
    args = ap.parse_args(argv)
    bad = 0
    for k in range(args.seeds):
        got = one(args.workload, args.first_seed + 7919 * k, args.seconds,
                  args.limit)
        bad += got["correct"] is True
        print(json.dumps(got), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
