"""Decides ``correct``: the window's answers against the plain reference.

Every solve of the window counts for ``failed`` (it raised, or returned
a status other than OPTIMAL).  A sample of the window's solves, drawn
from the seed, is judged by the configuration's reference
(``reference/<name>.py``, ``judge(instance, answer, executor)``) on the
instance that solve was given; each number is the largest over the
sample and is held to the cell's limit (``workloads/<cell>.json``)."""

from __future__ import annotations

import sys

import numpy as np

from benchmark import traffic


def sample(seed: int, n: int, k: int) -> list[int]:
    """k of the n window solves, drawn from the seed, in order."""
    k = min(k, n)
    return sorted(traffic.rng(seed, "check").choice(n, k, replace=False)
                  .tolist())


def run_check(reference, cases, failed: int, limits: dict, seed: int,
              k: int, workers: int) -> tuple[bool, dict]:
    """``cases``: (instance, answer) of every window solve.  Returns
    (correct, {name: {"value", "limit"}}), ``failed`` first."""
    import concurrent.futures as cf
    import multiprocessing as mp

    numbers = {"failed": {"value": failed, "limit": limits.get("failed", 0)}}
    worst: dict = {}
    picks = sample(seed, len(cases), k)
    pool = (cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"))
            if workers > 1 else None)
    try:
        for i in picks:
            inst, ans = cases[i]
            got = reference.judge(inst, ans, pool)
            print(f"# check solve {i}: " + " ".join(
                f"{n} {v!r}" for n, v in got.items()), file=sys.stderr)
            for name, v in got.items():
                worst[name] = max(worst.get(name, -np.inf), float(v))
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    for name, limit in limits.items():
        if name == "failed":
            continue
        v = worst.get(name, np.inf) if picks else np.inf
        numbers[name] = {"value": v, "limit": limit}
    ok = all(e["value"] <= e["limit"] for e in numbers.values())
    return ok, numbers
