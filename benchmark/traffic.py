"""The one traffic generator: it reads a mix from ``traffic/<name>.json``
and makes, from the run's seed, the instance of every solve.

A mix gives the program's options that it sets (the Benson algorithm of
each phase, as a user's ``-A``/``-a`` flags), the number of untimed
warm-up solves, which relabellings to draw, and the size of the pool
the window draws from.  A relabelling is an independent permutation of
the variables (the columns of A and P and the variable bounds) and of
the constraint rows (the rows of A and the row bounds).  The upper image
and the lower image of the geometric dual stay those of the instance;
the order in which the program meets the data, and so its tie-breaks
and its count of LPs, changes as a user's own ordering would change
them.

The window serves a fixed pool of ``pool`` relabellings, the same for
every seed (drawn from POOL_SEED), in one fixed cyclic order; the run's
seed picks where in that cycle the window starts.  The pool is larger
than a window's count of solves, so no input comes twice in a window,
and every seed serves the same kind of work.  The warm-up solves
relabellings of a stream of their own, the same for every seed, that
the window never serves (``run.py`` checks it by the arrays' digests);
where the mix sets ``warmup_published``, the first warm-up solve is the
instance as published (the identity relabelling, which reaches shapes
that few relabellings reach).  ``warmup_solves`` of them reach the
graph shapes the pool reaches."""

from __future__ import annotations

import hashlib

import numpy as np

STREAMS = {"window": 1, "warmup": 2, "check": 3, "order": 4}
# the pool of the window's relabellings is the same for every seed
POOL_SEED = 20261017


def rng(seed: int, stream: str, i: int = 0) -> np.random.Generator:
    """The generator of item i of a stream, from any whole-number seed."""
    return np.random.default_rng([seed % 2 ** 64, STREAMS[stream], i])


def relabel(inst: dict, g: np.random.Generator, what) -> dict:
    """``inst`` with its variables and/or rows permuted by ``g``."""
    m, n = np.shape(inst["A"])
    cols = g.permutation(n) if "variables" in what else np.arange(n)
    rows = g.permutation(m) if "rows" in what else np.arange(m)
    out = dict(inst)
    out["A"] = np.asarray(inst["A"])[np.ix_(rows, cols)]
    out["P"] = np.asarray(inst["P"])[:, cols]
    out["row_lb"], out["row_ub"] = (np.asarray(inst[k])[rows]
                                    for k in ("row_lb", "row_ub"))
    out["col_lb"], out["col_ub"] = (np.asarray(inst[k])[cols]
                                    for k in ("col_lb", "col_ub"))
    return out


def digest(inst: dict) -> str:
    """A digest of the arrays a solve is given: equal inputs, equal
    digests."""
    h = hashlib.sha1()
    for k in ("A", "P", "row_lb", "row_ub", "col_lb", "col_ub"):
        h.update(np.ascontiguousarray(inst[k], np.float64).tobytes())
    return h.hexdigest()


class Traffic:
    """A mix applied to one configuration's instance, from one seed."""

    def __init__(self, mix: dict, config: dict, base: dict, seed: int):
        self.mix, self.base, self.seed = mix, base, seed
        self.options = {**config.get("options", {}),
                        **mix.get("options", {})}
        self.warmup_solves = int(mix.get("warmup_solves", 1))
        self.published = bool(mix.get("warmup_published", False))
        self.pool = int(mix.get("pool", 1))
        self.first = int(rng(seed, "order").integers(self.pool))

    def instance(self, stream: str, i: int) -> dict:
        """Solve i of the window (pool entry (first + i) mod pool) or of
        the warm-up."""
        if stream == "warmup" and self.published:
            if i == 0:
                return dict(self.base)
            i -= 1
        k = (self.first + i) % self.pool if stream == "window" else i
        return relabel(self.base, rng(POOL_SEED, stream, k),
                       self.mix.get("relabel", ()))
