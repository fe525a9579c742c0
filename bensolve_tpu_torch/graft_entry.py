"""The port of the repo-root ``__graft_entry__.py``: the batched P2 solve
that stands for the flagship compute path, and its dry run over a
("dp", "tp") device mesh.

``entry(device)``            (fn, args): ``fn(A, c, lb, ub)`` is one
                             whole batched P2 scalarization-LP solve of
                             8 LPs at float32 (``max_iter=256``) on
                             ``args``' device, the tableau pivot loop to
                             termination; it returns the 9-tuple of the
                             JAX package's ``_solve_batch_jit``.
``dryrun_multichip(n, device)``  one full sharded Benson-round step on an
                             n-entry mesh (dp x tp when n >= 4, else dp
                             only): the same batch through
                             ``solve_batch_sharded``, the round with its
                             bound assembly ``V @ ZR`` through
                             ``benson_round_sharded``, and an uneven
                             P2-scale batch (M = 512, N = 1024, 3 LPs per
                             dp shard, ``max_iter=48``); a record.

    python -m bensolve_tpu_torch.graft_entry [n] [--device cuda|cpu]

The problem is ex01's P2 template (``examples.example01()``; a
``.vlp`` file for ``_example_problem``), padded as the JAX package pads
it.  Both entry points run
on ``device`` (default "cuda") and raise without a card; on one card the
mesh's entries repeat ``cuda:0``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from bensolve_tpu_torch.lp import simplex as sx
from bensolve_tpu_torch.parallel import mesh as pmesh

B = 8
MAX_ITER = 256
MESH_MAX_ITER = 128
# the P2-scale batch of the dry run (M, N, LPs per dp shard, steps)
P2_SCALE = (512, 1024, 3, 48)
N_EXTRA_OFFSET = 4


def _example_problem(dtype, vlp=None):
    """A tiny P2-shaped LP batch (ex01-like, padded shapes): A (Mp, Np)
    and c, lb, ub (B, Mp + Np) as numpy arrays of ``dtype``; ``vlp`` a
    .vlp path in place of example01."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu_torch.lp.simplex import _bucket
    from bensolve_tpu_torch.vlp.reader import read_vlp

    vlp = examples.example01() if vlp is None else read_vlp(vlp)
    q = vlp.q
    Z = np.eye(q)
    eta = np.array([0.5, 0.5])
    t2 = P2Template(vlp, vlp.P.astype(float), Z, eta, INHOMOGENEOUS)
    M, N = t2.A_lp.shape
    Mp, Np = _bucket(M), _bucket(N)
    A = np.zeros((Mp, Np), dtype)
    A[:M, :N] = t2.A_lp
    c = np.zeros((B, Mp + Np), dtype)
    c[:, Mp + N - 1] = 1.0
    lb = np.full((B, Mp + Np), -np.inf, dtype)
    ub = np.full((B, Mp + Np), np.inf, dtype)
    # VLP rows/cols
    lb[:, :M] = np.concatenate([t2.row_lb_vlp, np.zeros(q),
                                np.full(t2.p + 1, -np.inf)])
    ub[:, :M] = np.concatenate([t2.row_ub_vlp, np.zeros(q),
                                np.full(t2.p + 1, np.inf)])
    rng = np.random.default_rng(0)
    ub[:, t2.m + q:t2.m + q + t2.p] = rng.random((B, t2.p)) * 4
    lb[:, Mp:Mp + N] = np.concatenate([t2.col_lb_vlp, np.full(q + 1, -np.inf)])
    ub[:, Mp:Mp + N] = np.concatenate([t2.col_ub_vlp, np.full(q + 1, np.inf)])
    # padding columns fixed at zero
    lb[:, Mp + N:] = 0.0
    ub[:, Mp + N:] = 0.0
    return A, c, lb, ub


def entry(device="cuda"):
    """(fn, args): ``args`` the example batch's four tensors on
    ``device``, ``fn(A, c, lb, ub)`` one whole batched P2 solve
    returning (status, obj, x, s, row_dual, col_dual, iters, basis,
    at_upper) as tensors on that device."""
    dev = sx.resolve_device(device)
    args = tuple(sx._put(a, dev) for a in _example_problem(np.float32))

    def fn(A, c, lb, ub):
        with sx._tf32_off():
            return sx._solve_tableau_segmented(A, c, lb, ub, None, None,
                                               MAX_ITER)

    return fn, args


def _padded(c, lb, ub, dp):
    """The batch padded to a multiple of dp by repeating its first LP
    (the JAX dry run's rule)."""
    Bn = c.shape[0]
    if Bn % dp:
        Bn = dp * (Bn // dp + 1)
        c, lb, ub = (np.broadcast_to(a[:1], (Bn,) + a.shape[1:]).copy()
                     for a in (c, lb, ub))
    return c, lb, ub


def p2_scale_batch(dp, dtype=np.float32):
    """The dry run's P2-scale batch: a random feasible M x N LP shared by
    3 LPs per dp shard (A, c, lb, ub)."""
    Mp, Np, per, _ = P2_SCALE
    rng = np.random.default_rng(2)
    B2 = per * dp
    A2 = (rng.standard_normal((Mp, Np)) / np.sqrt(Np)).astype(dtype)
    x0 = rng.random((B2, Np)).astype(dtype)
    b2 = (x0 @ A2.T + 0.5).astype(dtype)
    c2 = np.zeros((B2, Mp + Np), dtype)
    c2[:, Mp:] = rng.standard_normal((B2, Np)).astype(dtype)
    lb2 = np.concatenate([np.full((B2, Mp), -np.inf, dtype),
                          np.zeros((B2, Np), dtype)], axis=1)
    ub2 = np.concatenate([b2, np.full((B2, Np), 10.0, dtype)], axis=1)
    return A2, c2, lb2, ub2


def round_inputs(A, c, lb, ub, dtype=np.float32):
    """The arguments of the dry run's benson_round_sharded call after A:
    (obj, V, ZR, base_row_lb, base_row_ub, col_lb, col_ub)."""
    q = 2
    V = np.asarray(np.random.default_rng(1).random((c.shape[0], q)), dtype)
    ZR = np.asarray(np.eye(q), dtype)
    M = A.shape[0]
    return (np.asarray(c[0], dtype), V, ZR, np.asarray(lb[0, :M], dtype),
            np.asarray(ub[0, :M], dtype), np.asarray(lb[0, M:], dtype),
            np.asarray(ub[0, M:], dtype))


def step_inputs(dp, dtype=np.float32):
    """The dry run's three LP batches for a mesh of ``dp`` rows, as
    {step: (A, c, lb, ub, max_iter)} host arrays; the round's bounds are
    assembled from round_inputs as benson_round_sharded assembles them
    (ub_j = (ZR' v)_j at rows N_EXTRA_OFFSET on)."""
    A, c, lb, ub = _example_problem(dtype)
    c, lb, ub = _padded(c, lb, ub, dp)
    obj, V, ZR, rlb, rub, clb, cub = round_inputs(A, c, lb, ub, dtype)
    Bn = V.shape[0]
    row_ub = np.tile(rub, (Bn, 1))
    row_ub[:, N_EXTRA_OFFSET:N_EXTRA_OFFSET + ZR.shape[1]] = V @ ZR
    round_lb = np.concatenate([np.tile(rlb, (Bn, 1)), np.tile(clb, (Bn, 1))],
                              1)
    round_ub = np.concatenate([row_ub, np.tile(cub, (Bn, 1))], 1)
    return {"solve_batch_sharded": (A, c, lb, ub, MESH_MAX_ITER),
            "benson_round_sharded": (A, np.tile(obj, (Bn, 1)), round_lb,
                                     round_ub, MESH_MAX_ITER),
            "p2_scale": p2_scale_batch(dp, dtype) + (P2_SCALE[3],)}


def solve_unsharded(A, c, lb, ub, max_iter, device="cuda"):
    """The port's one-device solve of a dry-run batch: the tableau loop
    on ``device``, the 9-tuple as numpy arrays."""
    dev = sx.resolve_device(device)
    with sx._tf32_off():
        out = sx._solve_tableau_segmented(
            *(sx._put(a, dev) for a in (A, c, lb, ub)), None, None,
            max_iter)
    return tuple(o.cpu().numpy() for o in out)


def _sync(mesh):
    for d in dict.fromkeys(mesh.devices.flat):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _step(mesh, name, fn):
    _sync(mesh)
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, dict(step=name, status=out[0], iters=out[6], basis=out[7],
                     wall_s=time.perf_counter() - t0)


def _check_shape(out, Bn):
    if np.asarray(out[0]).shape != (Bn,):
        raise AssertionError(f"status shape {np.asarray(out[0]).shape}, "
                             f"expected ({Bn},)")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full sharded Benson-round step on an ``n_devices``-entry mesh
    of ``device``'s cards (dp x tp when n_devices >= 4, else dp only);
    asserts the status shapes, as the JAX dry run does, and returns a
    record: the mesh's shape and entries, and per step its status,
    iterations, basis and wall seconds."""
    axes = ("dp", "tp") if n_devices >= 4 else ("dp",)
    m = pmesh.make_mesh(n_devices, axes, device=device)
    dp_size = m.devices.shape[0]
    dtype = np.float32
    batches = step_inputs(dp_size, dtype)
    steps = []

    A, c, lb, ub, it = batches["solve_batch_sharded"]
    out, rec = _step(m, "solve_batch_sharded", lambda: (
        pmesh.solve_batch_sharded(m, A, c, lb, ub, max_iter=it)))
    _check_shape(out, c.shape[0])
    steps.append(rec)

    # full-round variant: bound assembly (V @ ZR) before the solve;
    # V (B, q) -> extra_ub (B, q) written at row offset m+q (ex01: m=q=2)
    out, rec = _step(m, "benson_round_sharded", lambda: (
        pmesh.benson_round_sharded(m, A, *round_inputs(A, c, lb, ub, dtype),
                                   n_extra_offset=N_EXTRA_OFFSET,
                                   max_iter=it)))
    steps.append(rec)

    # the P2-scale batch with an uneven dp split (3 LPs per dp shard), so
    # padded-bucket x dp-shard x tp-panel interactions are covered; a
    # small max_iter: this runs the sharding, not to convergence
    A2, c2, lb2, ub2, it2 = batches["p2_scale"]
    out, rec = _step(m, "p2_scale", lambda: pmesh.solve_batch_sharded(
        m, A2, c2, lb2, ub2, max_iter=it2))
    _check_shape(out, c2.shape[0])
    steps.append(rec)
    return dict(n=n_devices, axes=axes, shape=dict(m.shape), dp=dp_size,
                entries=[str(d) for d in m.devices.flat], steps=steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="mesh entries of the dry run (default 8)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    print("entry:", [tuple(o.shape) for o in fn(*args)])
    dryrun_multichip(a.n, a.device)
    print("dryrun_multichip: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
