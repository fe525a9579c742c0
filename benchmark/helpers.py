"""What the benchmark's tests share: a run of the harness in this
process, on the CPU, and its result line."""

import contextlib
import io
import json

from benchmark import run


def run_cpu(workload: str, seconds: float = 0.5, trace: int = 0,
            seed: int = 3_000_000_019, extra=()):
    """run.main on the CPU (no look for a card), ``extra`` arguments
    added; (exit code, the result line as a dict or None, standard
    error)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace),
                       *extra],
                      device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
