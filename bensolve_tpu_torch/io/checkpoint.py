"""Round-level checkpoint / resume.

The reference has no checkpointing: a run is all-or-nothing and output
exists only after phase 2 completes (SURVEY.md section 5).  Here the
outer-approximation state is a serializable dense structure (vertex /
halfspace arrays, masks, adjacency/incidence lists), so the solver can
snapshot it at any Benson round boundary and resume phase 2 later.

Format: a single .npz with the polytope pair arrays (ragged lists
stored flat + offsets) plus the solution-context arrays and phase tag.
The keys are those of ``bensolve_tpu/io/checkpoint.py``, which this
module ports: a snapshot written by either package resumes in the
other.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json

import numpy as np

from bensolve_tpu_torch.algs.solution import CDir, SolStatus, SolutionContext
from bensolve_tpu_torch.poly.polytope import (PolytopePair, cone_polar_v2h,
                                        make_lower_to_upper_v2h,
                                        make_upper_to_lower_v2h)


def _ragged_pack(lists: list[list[int]]):
    flat = np.array([x for lst in lists for x in lst], dtype=np.int64)
    offs = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(lst) for lst in lists], out=offs[1:])
    return flat, offs


def _ragged_unpack(flat: np.ndarray, offs: np.ndarray) -> list[list[int]]:
    return [flat[offs[i]:offs[i + 1]].tolist() for i in range(len(offs) - 1)]


def _poly_arrays(prefix: str, poly, out: dict) -> None:
    n = poly.cnt
    out[f"{prefix}_data"] = poly.data[:n]
    out[f"{prefix}_primg"] = poly.primg[:n]
    out[f"{prefix}_used"] = poly.used[:n]
    out[f"{prefix}_ideal"] = poly.ideal[:n]
    out[f"{prefix}_sltn"] = poly.sltn[:n]
    for name, lists in (("adj", poly.adj), ("inc", poly.inc)):
        flat, offs = _ragged_pack(lists[:n])
        out[f"{prefix}_{name}_flat"] = flat
        out[f"{prefix}_{name}_offs"] = offs
    out[f"{prefix}_dim_primg"] = np.int64(poly.dim_primg)


def _poly_restore(prefix: str, poly, z) -> None:
    data = z[f"{prefix}_data"]
    n = data.shape[0]
    while poly.cap < n:
        poly._grow()
    poly.cnt = n
    poly.data[:n] = data
    primg = z[f"{prefix}_primg"]
    if primg.shape[1] > poly.primg.shape[1]:
        poly.primg = np.zeros((poly.cap, primg.shape[1]))
        if poly.native:
            poly._rebind()
    poly.primg[:n, : primg.shape[1]] = primg
    poly.used[:n] = z[f"{prefix}_used"]
    poly.ideal[:n] = z[f"{prefix}_ideal"]
    poly.sltn[:n] = z[f"{prefix}_sltn"]
    adj = _ragged_unpack(z[f"{prefix}_adj_flat"], z[f"{prefix}_adj_offs"])
    inc = _ragged_unpack(z[f"{prefix}_inc_flat"], z[f"{prefix}_inc_offs"])
    for i in range(n):
        poly.adj[i] = adj[i]
        poly.inc[i] = inc[i]
    poly.dim_primg = int(z[f"{prefix}_dim_primg"])


_V2H_KINDS = {"lower2upper": make_lower_to_upper_v2h,
              "upper2lower": make_upper_to_lower_v2h}


def save_checkpoint(path: str, *, sol: SolutionContext, pair: PolytopePair,
                    phase: str, v2h_kind: str, round_no: int = 0,
                    lps: int = 0) -> None:
    """Snapshot the solver state at a round boundary of ``phase``.
    ``v2h_kind``: 'lower2upper' (primal algorithm) or 'upper2lower'
    (dual algorithm)."""
    out: dict = {}
    _poly_arrays("primal", pair.primal, out)
    _poly_arrays("dual", pair.dual, out)
    meta = {
        "phase": phase,
        "v2h_kind": v2h_kind,
        "dim": pair.dim,
        "eps": pair.eps,
        "initialised": pair.initialised,
        "round": round_no,
        "lps": lps,
        "c_dir": sol.c_dir.value,
        "status": sol.status.name,
    }
    out["meta_json"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    for name in ("Y", "Z", "c", "eta"):
        out[f"sol_{name}"] = getattr(sol, name)
    for name in ("R", "H", "c_out"):
        v = getattr(sol, name)
        if v is not None:
            out[f"sol_{name}"] = v
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **out)


def load_checkpoint(path: str):
    """Restore (sol, pair, meta) from a snapshot.  The pair's v2h is
    rebuilt from the stored kind and duality parameter."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    c = z["sol_c"]
    sol = SolutionContext(
        q=int(meta["dim"]), Y=z["sol_Y"], Z=z["sol_Z"], c=c,
        c_dir=CDir(meta["c_dir"]), eta=z["sol_eta"],
        status=SolStatus[meta["status"]],
        R=z["sol_R"] if "sol_R" in z else None,
        H=z["sol_H"] if "sol_H" in z else None,
        c_out=z["sol_c_out"] if "sol_c_out" in z else None,
    )
    v2h = _V2H_KINDS[meta["v2h_kind"]](c)
    pair = PolytopePair(int(meta["dim"]), eps=float(meta["eps"]),
                        dual_v2h=v2h)
    # drop the constructor's initial dual vertex; restore will overwrite
    pair.dual.cnt = 0
    _poly_restore("primal", pair.primal, z)
    _poly_restore("dual", pair.dual, z)
    pair.initialised = bool(meta["initialised"])
    return sol, pair, meta
