"""Multi-device execution: shard the scalarization-LP batch over a mesh of
torch devices, and split each LP's columns into panels.

The port of ``bensolve_tpu/parallel/mesh.py``.  Each Benson round's
frontier is a batch axis of independent LPs (SURVEY.md section 2.2):

* ``dp`` (data parallel): the padded batch is cut into contiguous shards,
  one per row of the mesh along its dp axis.  Each shard is solved on a
  thread of its own, inside a CUDA stream of its own on each device of
  its row (on the CPU, the thread alone), and the results are joined in
  order on the host.  The shared constraint matrix lives once on each
  distinct device; the callers prepare it there before the threads
  start.  An LP of the tableau simplex pivots alike in any shard, so the
  joined result is the one-device result.  (The revised simplex decides
  its exact pricing passes and refactorizations over the whole batch it
  is given, as the JAX package does, so a dp shard of it may take other,
  equally valid, pivots.)  Batched LU calls on the card take turns
  across the shard threads (``simplex._lu_turn``: torch runs them
  through MAGMA, and shards entering it at once changed results, ROADMAP
  Queue 3 o).  A shard that raises makes the whole call raise.
* ``tp`` (tensor parallel): every LP of a dp row is split into T column
  panels, one per tp entry of the row (``PanelLayout``), as the JAX
  package shards A's columns, A^T's rows and the minor axis of every
  LP's tableau or basis inverse over its tp devices.  Panel k owns an
  equal slice of the slack columns and an equal slice of the structural
  columns of the padded variable axis; it holds those columns of the
  tableau (or, on the revised route, those columns of B^-1 and of the
  basis rows) and the matching columns of A.  The row's thread drives
  its T panels in lockstep, one pivot at a time; the per-pivot
  exchanges between panels (``combine_best``, ``select_by_owner``,
  ``to_all``, ``all_gather``, ``all_reduce``) are tensor copies between
  the entries' devices, reduced on the row's first entry (its lead),
  with no host read.  Basis indices stay global, in the padded
  numbering; the (B, M) basis vectors, the ratio test and the status
  live on the lead.  lp/simplex.py and lp/revised.py hold the two
  routes' panel steps.

Entries may repeat a device: ``make_mesh(4, device="cuda")`` on a
one-card machine gives four entries ``cuda:0``, i.e. four streams (dp)
or four panels (tp) on one card, as JAX's virtual CPU devices repeat one
host.  Results come back to the host as numpy arrays; nothing uses
torch.distributed or NCCL: one process drives every entry.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bensolve_tpu_torch import spans
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


def mesh_rows(mesh: Mesh) -> list:
    """The mesh's dp rows, each a tuple of its tp entries (the first is
    the row's lead): one row per dp entry, one entry per row without a
    "tp" axis, and the first row alone without a "dp" axis."""
    names = mesh.axis_names
    devs = mesh.devices
    if "tp" in names:
        devs = np.moveaxis(devs, names.index("tp"), -1)
    else:
        devs = devs[..., None]
    rows = [tuple(r) for r in devs.reshape(-1, devs.shape[-1])]
    return rows if "dp" in names else rows[:1]


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


# ------------------------------------------------------------ tp panels

@dataclasses.dataclass(frozen=True)
class PanelLayout:
    """The split of an LP's padded variable axis (Mp slack columns, then
    Np structural ones) into T panels.  Panel k owns slack columns
    [k*ms, (k+1)*ms) and structural columns Mp + [k*ns, (k+1)*ns), with
    ms = ceil(Mp/T), ns = ceil(Np/T); its local columns are its slacks,
    then its structurals, each ascending, ``width`` = ms + ns in all.
    Where T does not divide Mp or Np the last panels end in pad columns:
    fixed at lb = ub = 0, zero in E, never eligible, numbered from
    Mp + Np up, so no real index moves.  A's columns (A^T's rows) follow
    the structural slices, and the minor axis of B^-1 the slack ones."""

    Mp: int
    Np: int
    T: int

    @property
    def ms(self) -> int:
        return -(-self.Mp // self.T)

    @property
    def ns(self) -> int:
        return -(-self.Np // self.T)

    @property
    def width(self) -> int:
        return self.ms + self.ns

    def gidx(self, k: int, device) -> torch.Tensor:
        """(width,) global index of each local column of panel k."""
        s = torch.arange(k * self.ms, (k + 1) * self.ms, device=device)
        a = torch.arange(k * self.ns, (k + 1) * self.ns, device=device)
        NT = self.Mp + self.Np
        pad = NT + torch.arange(self.width, device=device)
        g = torch.cat([s, self.Mp + a])
        real = torch.cat([s < self.Mp, a < self.Np])
        return torch.where(real, g, pad)

    def local(self, g: torch.Tensor, k: int):
        """Global indices ``g`` (any shape) -> (local index in panel k,
        clamped into range, and whether panel k owns the column)."""
        slack = g < self.Mp
        j = torch.where(slack, g, g - self.Mp)
        size = torch.where(slack, self.ms, self.ns)
        owned = (j // size) == k
        loc = torch.where(slack, j - k * self.ms, self.ms + j - k * self.ns)
        return loc.clamp(0, self.width - 1), owned

    def _parts(self, x, fill):
        """x (..., Mp + Np) -> its slack and structural parts, padded to
        T*ms and T*ns columns with ``fill``."""
        lead = x.shape[:-1]
        s = x.new_full(lead + (self.T * self.ms,), fill)
        a = x.new_full(lead + (self.T * self.ns,), fill)
        s[..., :self.Mp] = x[..., :self.Mp]
        a[..., :self.Np] = x[..., self.Mp:]
        return s, a

    def split(self, x, fill=0) -> list:
        """x (..., Mp + Np) -> its T panels (..., width), pad columns at
        ``fill``; on x's device."""
        s, a = self._parts(x, fill)
        ms, ns = self.ms, self.ns
        return [torch.cat([s[..., k * ms:(k + 1) * ms],
                           a[..., k * ns:(k + 1) * ns]], dim=-1)
                for k in range(self.T)]

    def join(self, parts) -> torch.Tensor:
        """The inverse of ``split``: T panels (..., width), on one device,
        -> (..., Mp + Np)."""
        ms = self.ms
        s = torch.cat([p[..., :ms] for p in parts], dim=-1)[..., :self.Mp]
        a = torch.cat([p[..., ms:] for p in parts], dim=-1)[..., :self.Np]
        return torch.cat([s, a], dim=-1)

    def rows(self, v, k: int) -> torch.Tensor:
        """Panel k's slice of the slack axis of ``v`` (..., Mp) -> (...,
        ms), zero past Mp: the entries that meet its B^-1 columns."""
        lo, hi = k * self.ms, min((k + 1) * self.ms, self.Mp)
        out = v.new_zeros(v.shape[:-1] + (self.ms,))
        out[..., :hi - lo] = v[..., lo:hi]
        return out

    def place_rows(self, v, k: int) -> torch.Tensor:
        """The inverse of ``rows``: (..., ms) -> (..., Mp), zero outside
        panel k's slice."""
        lo, hi = k * self.ms, min((k + 1) * self.ms, self.Mp)
        out = v.new_zeros(v.shape[:-1] + (self.Mp,))
        out[..., lo:hi] = v[..., :hi - lo]
        return out

    def eye(self, k: int, dtype, device) -> torch.Tensor:
        """(Mp, ms): panel k's columns of the identity (its slack columns
        of E, its columns of B^-1 at the slack basis)."""
        eye = torch.eye(self.Mp, dtype=dtype, device=device)
        return self.rows(eye, k)

    def a_panel(self, A_host: np.ndarray, k: int) -> np.ndarray:
        """Panel k's (Mp, ns) columns of the padded host matrix A, zero
        past Np."""
        lo, hi = k * self.ns, min((k + 1) * self.ns, self.Np)
        out = np.zeros((A_host.shape[0], self.ns), A_host.dtype)
        out[:, :hi - lo] = A_host[:, lo:hi]
        return out


def a_panels(prep, lay: PanelLayout, rows: list, transposed=False) -> dict:
    """Each row's A panels on their devices, {(k, device): (A_k, A_k^T or
    None)}: cut from the padded host matrix of ``prep`` (a
    simplex._PreparedA) and cached on it, so no device holds the whole A
    and later rounds upload nothing.  Called before the row threads
    start."""
    out = {}
    with sx._A_CACHE_LOCK:
        for row in rows:
            for k, dev in enumerate(row):
                key = (lay.T, k, str(dev))
                hit = prep.panels.get(key)
                if hit is None:
                    hit = [sx._put(lay.a_panel(prep.host, k), dev), None]
                    prep.panels[key] = hit
                if transposed and hit[1] is None:
                    hit[1] = hit[0].T.contiguous()
                out[(k, dev)] = tuple(hit)
    return out


# per-pivot exchanges between the panels of one dp row: copies between
# the entries' devices (no-ops where an entry repeats the lead's device),
# reduced on the lead in panel order, so every panel reads the same sums

def to_all(x, devs) -> list:
    """Broadcast: ``x`` on every device of ``devs``."""
    return [x.to(d, non_blocking=True) for d in devs]


def all_gather(parts, devs) -> list:
    """All-gather: the panels' (..., n) slices, concatenated in panel
    order, on every device of ``devs``."""
    full = torch.cat([p.to(devs[0], non_blocking=True) for p in parts],
                     dim=-1)
    return to_all(full, devs)


def all_reduce(parts, devs) -> list:
    """All-reduce (sum) of the panels' partial results, summed on the
    lead in panel order, on every device of ``devs``."""
    total = parts[0].to(devs[0], non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(devs[0], non_blocking=True)
    return to_all(total, devs)


def combine_best(values, gidx, dev):
    """The argmax combine over panels: each panel's best value (B,) and
    its global index (B,) -> (winning panel, global index), on ``dev``.
    The winner has the largest value, and on equal values the smallest
    global index, which is what ``torch.argmax`` over the unsplit row
    returns (each panel's candidate is its own first maximum).  A row
    with no eligible column (every value -inf) gets index 0, as argmax
    does.  NaN counts as +inf."""
    v = torch.stack([x.to(dev, non_blocking=True) for x in values])
    g = torch.stack([x.to(dev, non_blocking=True) for x in gidx])
    v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")), v)
    best = v.max(dim=0).values
    big = torch.iinfo(g.dtype).max
    g = torch.where(v == best, g, torch.full_like(g, big))
    q = g.min(dim=0).values
    winner = (g == q).to(torch.int8).argmax(dim=0)
    return winner, q


def select_by_owner(parts, winner, dev) -> torch.Tensor:
    """The winner's part per LP: ``parts`` (B, K) from every panel,
    ``winner`` (B,) -> (B, K) on ``dev`` (the gathering half of the
    entering column's broadcast; ``to_all`` sends it on)."""
    P = torch.stack([p.to(dev, non_blocking=True) for p in parts])
    idx = winner[None, :, None].expand(1, P.shape[1], P.shape[2])
    return P.gather(0, idx)[0]


# the last tp solve of each route, for the tests and chip_smoke.py:
# {"T": panels, "steps": pivot steps, "panel_bytes": bytes per panel}
LAST_SPLIT: dict = {}


def record_split(route: str, panels, steps: int) -> None:
    """Note a finished tp solve: its panel count, steps and each panel's
    bytes (every tensor the panel holds, its A columns included)."""
    LAST_SPLIT[route] = {
        "T": len(panels), "steps": int(steps),
        "panel_bytes": [p.nbytes for p in panels]}


def on_own_stream(dev, fn, *args, after=None):
    """fn(*args) on ``dev`` (a device, or a dp row's tuple of devices, the
    first its lead): inside a fresh CUDA stream on each distinct device,
    which first waits for that device's stream in ``after`` (a stream,
    or a dict of streams by device: what the caller queued there, an
    upload of the shared matrix, is complete), or plainly on the CPU.
    The lead's stream is entered last, so its device is current.  On
    the card the calling thread's LU calls take turns with other such
    threads' (``simplex._lu_turn``) while fn runs."""
    devs = dev if isinstance(dev, tuple) else (dev,)
    cuda = list(dict.fromkeys(d for d in reversed(devs) if d.type == "cuda"))
    if not cuda:
        return fn(*args)
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.cuda.device(devs[0]))
        for d in cuda:
            stream = torch.cuda.Stream(device=d)
            wait = after.get(d) if isinstance(after, dict) else after
            if wait is not None:
                stream.wait_stream(wait)
            stack.enter_context(torch.cuda.stream(stream))
        sx._SHARD_THREAD.on = True
        try:
            return fn(*args)
        finally:
            sx._SHARD_THREAD.on = False


def map_shards(entries: list, batched: tuple, solve) -> tuple:
    """Solve one padded LP batch in contiguous shards, one per entry, on
    one thread each.  An entry is a device, or a dp row's tuple of tp
    entries (``mesh_rows``), whose shard reaches its lead.  ``batched``:
    host arrays whose first axis is the padded batch (None stays None);
    a shard's slices reach its device on its own thread and stream.
    ``solve(entry, *tensors)`` returns a tuple of tensors, read back on
    the same stream.  Returns the joined tuple of numpy arrays; the
    first shard failure is raised once every thread has ended."""
    n = len(entries)
    Bp = next(a.shape[0] for a in batched if a is not None)
    if Bp % n:
        raise ValueError(f"a batch of {Bp} does not divide over {n} shards")
    size = Bp // n
    devs = [d for e in entries for d in (e if isinstance(e, tuple) else (e,))]
    ambient = {d: torch.cuda.current_stream(d)
               for d in dict.fromkeys(devs) if d.type == "cuda"}
    parent = spans.current()   # the shards' spans are this thread's

    def shard(entry, k):
        lead = entry[0] if isinstance(entry, tuple) else entry
        sl = slice(k * size, (k + 1) * size)
        ts = [None if a is None else sx._put(a[sl], lead) for a in batched]
        with spans.within(parent):
            return [spans.read(o) for o in solve(entry, *ts)]

    with ThreadPoolExecutor(max_workers=n) as pool:
        futs = [pool.submit(on_own_stream, e, shard, e, k, after=ambient)
                for k, e in enumerate(entries)]
    parts = [f.result() for f in futs]
    return tuple(np.concatenate(cols) for cols in zip(*parts))


def solve_batch_sharded(mesh: Mesh, A, c, lb, ub, *, max_iter: int):
    """The batched tableau simplex with the batch axis sharded over the
    mesh's first axis and, with a second axis, every LP's columns split
    into panels over it (the JAX package's P(dp, tp)).

    Arguments are the PADDED dense arrays of a one-device solve: ``A``
    (M, N) shared, ``c``/``lb``/``ub`` (B, M+N), in ``A``'s dtype.  B must
    divide by the first axis's size.  Returns (status, obj, x, s,
    row_dual, col_dual, iters, basis, at_upper) as numpy arrays over the
    padded dimensions, joined on the host."""
    A = np.asarray(A)
    batched = tuple(np.asarray(x, A.dtype) for x in (c, lb, ub))
    rows = [tuple(r) for r in mesh.devices.reshape(mesh.devices.shape[0], -1)]
    if len(rows[0]) > 1:
        lay = PanelLayout(A.shape[0], A.shape[1], len(rows[0]))
        panels = {(k, d): (sx._put(lay.a_panel(A, k), d), None)
                  for row in rows for k, d in enumerate(row)}
        return map_shards(rows, batched,
                          lambda row, c_t, lb_t, ub_t: sx._solve_tableau_tp(
                              lay, row, panels, c_t, lb_t, ub_t, None, None,
                              max_iter))
    entries = [r[0] for r in rows]
    A_on = {d: sx._put(A, d) for d in dict.fromkeys(entries)}

    def solve(dev, c_t, lb_t, ub_t):
        return sx._solve_tableau_segmented(A_on[dev], c_t, lb_t, ub_t, None,
                                           None, max_iter)

    return map_shards(entries, batched, solve)


def benson_round_sharded(mesh: Mesh, A_lp, obj, V, ZR, base_row_lb,
                         base_row_ub, col_lb, col_ub, n_extra_offset: int,
                         *, max_iter: int):
    """One primal Benson round over the mesh: from the frontier vertex
    batch V (B, q), build the P2 row-bound batch ub_j = (ZR' v)_j, solve
    every LP with the batch sharded over the first axis (and its columns
    over the second, if any), and return the
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
