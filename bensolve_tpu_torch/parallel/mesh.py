"""Multi-device execution: shard the scalarization-LP batch over a mesh of
torch devices.

The port of ``bensolve_tpu/parallel/mesh.py``.  Each Benson round's
frontier is a batch axis of independent LPs (SURVEY.md section 2.2):

* ``dp`` (data parallel): the padded batch is cut into contiguous shards,
  one per entry of the dp axis.  Each shard is solved on a thread of its
  own, inside a CUDA stream of its own on its entry's device (on the
  CPU, the thread alone), and the results are joined in order on the
  host.  The shared constraint matrix lives once on each distinct
  device; the callers prepare it there before the threads start.  An LP
  of the tableau simplex pivots alike in any shard, so the joined result
  is the one-device result.  (The revised simplex decides its exact
  pricing passes and refactorizations over the whole batch it is given,
  as the JAX package does, so a dp shard of it may take other, equally
  valid, pivots.)  Batched LU calls on the card take turns across the
  shard threads (``simplex._lu_turn``: torch runs them through MAGMA,
  and shards entering it at once changed results, ROADMAP Queue 3 o).
  A shard that raises makes the whole call raise.
* ``tp`` (tensor parallel), the one departure from the JAX package.
  There, ``tp`` splits A's columns, A^T's rows and the minor axis of
  every LP's basis inverse or tableau over its devices, and XLA inserts
  the collectives.  On one card there is nothing to split: the per-LP
  kernel already slices columns over the CTAs of a cluster.  The port
  accepts the axis and keeps every LP whole on its dp entry: the LPs of a
  dp row all go to that row's first tp entry.  A real column split needs
  more than one card (ROADMAP Queue 1).

Entries may repeat a device: ``make_mesh(4, device="cuda")`` on a
one-card machine gives four entries ``cuda:0``, i.e. four streams on one
card, as JAX's virtual CPU devices repeat one host.  Results come back to
the host as numpy arrays, so no collective (and no NCCL) is involved.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bensolve_tpu_torch.lp import simplex as sx


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ordered grid of torch devices with one name per axis, read as
    ``jax.sharding.Mesh`` is: ``mesh.shape["dp"]``, ``mesh.devices.flat``."""

    devices: np.ndarray      # object array of torch.device, one axis per name
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _visible(device) -> list:
    """The devices of ``device``'s type that this process sees."""
    dev = sx.resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_mesh(n_devices: int | None = None, axes: tuple = ("dp",),
              device="cuda") -> Mesh:
    """A mesh of ``n_devices`` entries (default: every visible device of
    ``device``'s type) over 1 or 2 named axes.  With two axes the count
    is split as evenly as possible, the first axis major: 8 -> (4, 2),
    6 -> (3, 2).  Past the visible devices the entries repeat them
    round-robin.  A CUDA device that is not there raises."""
    axes = tuple(axes)
    if len(axes) not in (1, 2):
        raise ValueError("1 or 2 mesh axes supported")
    vis = _visible(device)
    n = len(vis) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if len(axes) == 1:
        shape = (n,)
    else:
        dp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                dp = n // cand
                break
        shape = (dp, n // dp)
    devs = np.empty(n, dtype=object)
    devs[:] = [vis[i % len(vis)] for i in range(n)]
    return Mesh(devs.reshape(shape), axes)


def shard_entries(mesh: Mesh, axis) -> list:
    """The devices along ``axis``, each at index 0 of the other axis; a
    mesh without ``axis`` gives its first device alone."""
    if axis not in mesh.axis_names:
        return [mesh.devices.flat[0]]
    idx = [0] * mesh.devices.ndim
    idx[mesh.axis_names.index(axis)] = slice(None)
    return list(mesh.devices[tuple(idx)])


def padded_batch(Bp: int, n: int) -> int:
    """The padded batch, grown until ``n`` shards divide it: doubled, as
    the JAX package does, when ``n`` is a power of two; otherwise rounded
    up to a multiple of ``n`` (doubling a power of two never reaches a
    multiple of 3)."""
    if n & (n - 1) == 0:
        while Bp % n:
            Bp *= 2
        return Bp
    return -(-Bp // n) * n


def on_own_stream(dev, fn, *args, after=None):
    """fn(*args) on ``dev``: inside a fresh CUDA stream, which first
    waits for the stream ``after`` (so what the caller queued there, an
    upload of the shared matrix, is complete), or plainly on the CPU.
    On the card the calling thread's LU calls take turns with other such
    threads' (``simplex._lu_turn``) while fn runs."""
    if dev.type != "cuda":
        return fn(*args)
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream(device=dev)
        if after is not None:
            stream.wait_stream(after)
        sx._SHARD_THREAD.on = True
        try:
            with torch.cuda.stream(stream):
                return fn(*args)
        finally:
            sx._SHARD_THREAD.on = False


def map_shards(entries: list, batched: tuple, solve) -> tuple:
    """Solve one padded LP batch in contiguous shards, one per entry, on
    one thread each.  ``batched``: host arrays whose first axis is the
    padded batch (None stays None); a shard's slices reach its device on
    its own thread and stream.  ``solve(device, *tensors)`` returns a
    tuple of tensors, read back on the same stream.  Returns the joined
    tuple of numpy arrays; the first shard failure is raised once every
    thread has ended."""
    n = len(entries)
    Bp = next(a.shape[0] for a in batched if a is not None)
    if Bp % n:
        raise ValueError(f"a batch of {Bp} does not divide over {n} shards")
    size = Bp // n
    ambient = {d: torch.cuda.current_stream(d)
               for d in dict.fromkeys(entries) if d.type == "cuda"}

    def shard(dev, k):
        sl = slice(k * size, (k + 1) * size)
        ts = [None if a is None else sx._put(a[sl], dev) for a in batched]
        return [o.cpu().numpy() for o in solve(dev, *ts)]

    with ThreadPoolExecutor(max_workers=n) as pool:
        futs = [pool.submit(on_own_stream, d, shard, d, k,
                            after=ambient.get(d))
                for k, d in enumerate(entries)]
    parts = [f.result() for f in futs]
    return tuple(np.concatenate(cols) for cols in zip(*parts))


def solve_batch_sharded(mesh: Mesh, A, c, lb, ub, *, max_iter: int):
    """The batched tableau simplex with the batch axis sharded over the
    mesh's first axis.

    Arguments are the PADDED dense arrays of a one-device solve: ``A``
    (M, N) shared, ``c``/``lb``/``ub`` (B, M+N), in ``A``'s dtype.  B must
    divide by the first axis's size.  Returns (status, obj, x, s,
    row_dual, col_dual, iters, basis, at_upper) as numpy arrays over the
    padded dimensions, joined on the host."""
    entries = shard_entries(mesh, mesh.axis_names[0])
    A = np.asarray(A)
    A_on = {d: sx._put(A, d) for d in dict.fromkeys(entries)}

    def solve(dev, c_t, lb_t, ub_t):
        return sx._solve_tableau_segmented(A_on[dev], c_t, lb_t, ub_t, None,
                                           None, max_iter)

    return map_shards(entries, tuple(np.asarray(x, A.dtype)
                                     for x in (c, lb, ub)), solve)


def benson_round_sharded(mesh: Mesh, A_lp, obj, V, ZR, base_row_lb,
                         base_row_ub, col_lb, col_ub, n_extra_offset: int,
                         *, max_iter: int):
    """One primal Benson round over the mesh: from the frontier vertex
    batch V (B, q), build the P2 row-bound batch ub_j = (ZR' v)_j, solve
    every LP with the batch sharded over the first axis, and return the
    tuple of solve_batch_sharded.  The template arrays are shared by
    every LP; the per-LP rows are built on the host in ``A_lp``'s
    dtype."""
    A_lp = np.asarray(A_lp)
    dt = A_lp.dtype
    V, ZR = np.asarray(V, dt), np.asarray(ZR, dt)
    B = V.shape[0]
    row_ub = np.tile(np.asarray(base_row_ub, dt), (B, 1))
    row_ub[:, n_extra_offset:n_extra_offset + ZR.shape[1]] = V @ ZR
    row_lb = np.tile(np.asarray(base_row_lb, dt), (B, 1))
    c = np.tile(np.asarray(obj, dt), (B, 1))
    lb = np.concatenate([row_lb, np.tile(np.asarray(col_lb, dt), (B, 1))], 1)
    ub = np.concatenate([row_ub, np.tile(np.asarray(col_ub, dt), (B, 1))], 1)
    return solve_batch_sharded(mesh, A_lp, c, lb, ub, max_iter=max_iter)
