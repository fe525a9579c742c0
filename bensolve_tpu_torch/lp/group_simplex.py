"""Per-LP primal simplex kernel for Hopper, its plain PyTorch version,
and the solve_batch-compatible wrapper around both.

The port of ``bensolve_tpu/lp/pallas_simplex.py``.  The Pallas kernel
there pivots a GROUP of LPs to termination with their tableaus held in
VMEM; here ``csrc/group_simplex.cu`` gives every LP a thread-block
cluster that holds its whole tableau in shared memory and loops over all
its pivots inside one launch ("cluster"); for tableaux no cluster holds,
a 16-CTA cluster that keeps as many rows as fit in shared memory and the
rest in an L2-resident workspace ("spill"); for shapes neither takes, one
thread block with the tableau in global memory ("global").  See the note
at the top of that file for what bounds each on the H100.  ``plan``
picks the variant and the cluster size from the shape alone.

* ``solve_batch_group``: the wrapper.  It launches a CUDA kernel for
  CUDA tensors and runs the plain version only for CPU tensors.
* ``solve_batch_group_reference``: the plain version, a line-by-line
  torch transcription of the Pallas kernel's loop, including the
  group-wide pricing pass for any ``group`` (the CUDA kernels are the
  ``group=1`` case).
* ``lp_batch_group``: padding, +-BIG encoding, the shared warm tableau
  and the primal/dual recovery, mirroring ``lp_batch_pallas``.

Float32 only, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bensolve_tpu_torch import spans
from bensolve_tpu_torch.lp import simplex as sx

BIG = 1e30  # stands in for +-inf inside the kernel (inf breaks 0*inf)
TOL_BND = 1e-5
TOL_DJ = 1e-5
TOL_PIV = 1e-6

# kernel launches on CUDA tensors, per variant; CALLS is their sum.  A
# run that should have gone through the kernel reads them
CALLS = 0
CALLS_CLUSTER = 0
CALLS_SPILL = 0
CALLS_GLOBAL = 0
# lp_batch_group calls, on any device: the kernel's ROUTE was taken
# (on the CPU that runs the plain version)
ROUTED = 0

# bytes allowed for one chunk's (B, Mp, NT) float32 tableau workspace
# (the global-memory variant's; the spill variant's is smaller)
WORKSPACE_BYTES_BUDGET = 2 << 30
# dynamic shared memory a block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
MAX_CHUNK = 256
# threads per CTA of the cluster variant, kThreads in csrc/group_simplex.cu
THREADS = 384
# cluster sizes tried in order; 16 is the H100's non-portable maximum
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# group_simplex_cluster_f32's return when no cluster of the size fits
NO_CLUSTER_FITS = -2
# the spill variant's cluster size and ring slots per thread (kSpillC,
# kStages in csrc/group_simplex.cu)
SPILL_C = 16
SPILL_STAGES = 4


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def smem_bytes(Mp: int, NT: int, C: int, rows: int | None = None) -> int:
    """Dynamic shared memory of one CTA, kept in step with
    group_simplex_smem_bytes_f32 in csrc/group_simplex.cu: of a C-CTA
    cluster for C >= 1 keeping ``rows`` rows of its slice in shared
    memory (all Mp by default: the cluster variant; fewer: the spill
    variant) (a (rows, NT/C + 4) slice of W; where rows are spilled, a
    ring of SPILL_STAGES 16-byte slots per thread; four mbarriers; two
    buffers of exchange entries, 16 bytes for each warp of the cluster,
    and of the entering column's 64 bytes of values; two column buffers
    of Mp; seven column and six row vectors; pricing partials; reduction
    scratch; basis; two byte flags per column), of the global-memory
    variant for C == 0."""
    if C == 0:
        return (7 * NT + 7 * Mp) * 4 + Mp * 4 + 2 * NT
    rows = Mp if rows is None else rows
    S = NT // C
    n_float = (rows * (S + 4) + 2 * Mp + 7 * S + 6 * Mp + 4 * THREADS
               + 3 * 64)
    ring = SPILL_STAGES * THREADS * 16 if rows < Mp else 0
    n_int = Mp + 3 * 96
    exchange = 4 * 8 + 2 * C * (THREADS // 32) * 16 + 2 * 64
    return n_float * 4 + ring + exchange + n_int * 4 + 2 * S


def spill_rows(Mp: int, NT: int) -> int | None:
    """Rows of the tableau the spill variant keeps in shared memory: all
    Mp where a SPILL_C-CTA cluster holds them, else the largest multiple
    of 4 that fits beside the ring and the vectors (0 included); None
    where even those do not fit, or rows or slices are not in fours."""
    if Mp % 4 or NT % (4 * SPILL_C):
        return None
    if smem_bytes(Mp, NT, SPILL_C) <= SMEM_LIMIT:
        return Mp
    free = SMEM_LIMIT - smem_bytes(Mp, NT, SPILL_C, rows=0)
    if free < 0:
        return None
    return free // ((NT // SPILL_C + 4) * 4) // 4 * 4


def plan(Mp: int, NT: int) -> tuple[str, int] | None:
    """The kernel variant for a padded shape: ("cluster", C) with the
    smallest C whose CTAs hold the tableau in shared memory, else
    ("spill", SPILL_C) where the spill variant's vectors fit (its rows
    from ``spill_rows``), else ("global", 0) when the global-memory
    variant takes it, else None.  The cluster variants move rows and
    columns in groups of four, so they need Mp and NT / C divisible by 4
    (padded shapes always are)."""
    for C in CLUSTER_SIZES:
        if (Mp % 4 == 0 and NT % (4 * C) == 0
                and smem_bytes(Mp, NT, C) <= SMEM_LIMIT):
            return "cluster", C
    if Mp * NT * 4 > WORKSPACE_BYTES_BUDGET:
        return None
    if spill_rows(Mp, NT) is not None:
        return "spill", SPILL_C
    if smem_bytes(Mp, NT, 0) <= SMEM_LIMIT:
        return "global", 0
    return None


def padded_shape(M: int, N: int) -> tuple[int, int]:
    """(Mp, NT): rows bucketed as in the tableau path, columns padded
    to a multiple of 128."""
    Mp = sx._bucket(M)
    return Mp, _pad128(Mp + sx._bucket(N))


def shape_supported(M: int, N: int) -> bool:
    """True when a kernel variant takes the padded shape (``plan``)."""
    return plan(*padded_shape(M, N)) is not None


def _pick_chunk(Mp: int, NT: int) -> int:
    """Largest power-of-two batch whose workspace fits the budget."""
    cap = max(1, WORKSPACE_BYTES_BUDGET // (Mp * NT * 4))
    return min(MAX_CHUNK, 1 << (cap.bit_length() - 1))


def _max_loop(max_iter: int) -> int:
    """Bound on loop steps per LP.  A step that neither pivots nor
    finishes leaves the state unchanged, so without a bound it would
    spin forever; at 2*max_iter + 256 the LP reports ITLIM."""
    return 2 * max_iter + 256


def _check(W0, c, lb, ub, basis0, at_upper0):
    M, NT = W0.shape
    B = c.shape[0]
    dev = W0.device
    for name, t, shape, dtype in (
            ("W0", W0, (M, NT), torch.float32),
            ("c", c, (B, NT), torch.float32),
            ("lb", lb, (B, NT), torch.float32),
            ("ub", ub, (B, NT), torch.float32),
            ("basis0", basis0, (M,), torch.int32),
            ("at_upper0", at_upper0, (B, NT), torch.bool)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, W0 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, M, NT


def solve_batch_group(W0, c, lb, ub, basis0, at_upper0, max_iter, *,
                      variant: str | None = None, smem_rows: int | None = None,
                      work=None):
    """Run the per-LP primal simplex over the batch.

    ``W0``: (Mp, NT) float32 shared starting tableau, E for a cold start
    or Binv @ E of a shared warm basis.  ``c``/``lb``/``ub``: (B, NT)
    float32 with +-inf encoded as +-BIG.  ``basis0``: (Mp,) int32 basis
    matching W0.  ``at_upper0``: (B, NT) bool nonbasic bound pattern.
    Returns (status (B,) int32, basis (B, Mp) int32, at_upper (B, NT)
    bool, iters (B,) int32) on the inputs' device.

    CUDA tensors launch the kernel variant ``plan`` picks (a failed
    build or launch raises); ``variant="spill"`` or ``"global"`` forces
    that variant where it takes the shape, for measurement, and
    ``smem_rows`` (spill only; a multiple of 4) the rows the spill
    variant keeps in shared memory, by default ``spill_rows``.  ``work``,
    a (B, 3) int32 CUDA tensor, receives the cluster or spill kernel's
    loop steps, pricing passes and rank-1 updates per LP.  CPU tensors
    run the plain version whatever the variant."""
    global CALLS, CALLS_CLUSTER, CALLS_SPILL, CALLS_GLOBAL
    B, M, NT = _check(W0, c, lb, ub, basis0, at_upper0)
    if variant not in (None, "spill", "global"):
        raise ValueError(f"unknown kernel variant {variant!r}")
    if smem_rows is not None and variant != "spill":
        raise ValueError("smem_rows: for variant='spill' only")
    dev = W0.device
    if dev.type == "cpu":
        return solve_batch_group_reference(W0, c, lb, ub, basis0, at_upper0,
                                           max_iter, group=1)
    if dev.type != "cuda":
        raise ValueError(f"group simplex kernel: unsupported device {dev}")
    chosen = ((variant, SPILL_C if variant == "spill" else 0) if variant
              else plan(M, NT))
    rows = M
    if chosen is not None and chosen[0] == "spill":
        rows = spill_rows(M, NT) if smem_rows is None else int(smem_rows)
        if rows is None or rows % 4 or not 0 <= rows <= M:
            raise ValueError(f"spill variant: {rows} rows in shared memory "
                             f"at Mp={M}, NT={NT} (a multiple of 4 in "
                             f"[0, Mp] where its vectors fit)")
    if (chosen is None
            or smem_bytes(M, NT, chosen[1], rows) > SMEM_LIMIT):
        raise ValueError(f"group simplex kernel: no variant takes the shape "
                         f"(Mp={M}, NT={NT}, variant {chosen}, rows {rows})")
    kind, C = chosen
    if work is not None and (kind == "global" or work.shape != (B, 3)
                             or work.dtype != torch.int32
                             or work.device != dev):
        raise ValueError("work: a (B, 3) int32 tensor on the inputs' device, "
                         "for the cluster or spill variant")
    if kind != "global" and W0.data_ptr() % 16:
        raise ValueError("W0 must be 16-byte aligned (vector loads)")
    lib = _library()
    if lib.group_simplex_smem_bytes_f32(M, NT, C, rows) != smem_bytes(
            M, NT, C, rows):
        raise RuntimeError("smem_bytes disagrees with the built kernel's")
    with torch.cuda.device(dev):
        status = torch.empty(B, dtype=torch.int32, device=dev)
        basis = torch.empty((B, M), dtype=torch.int32, device=dev)
        at_upper = torch.empty((B, NT), dtype=torch.bool, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (W0.data_ptr(), c.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                basis0.data_ptr(), at_upper0.data_ptr())
        outs = (status.data_ptr(), basis.data_ptr(), at_upper.data_ptr(),
                iters.data_ptr())
        work_p = 0 if work is None else work.data_ptr()
        loop = (int(max_iter), _max_loop(int(max_iter)), stream)
        if kind == "cluster":
            err = lib.group_simplex_cluster_f32(*ptrs, *outs, work_p, B, M,
                                                NT, C, *loop)
        elif kind == "spill":
            # one (M - rows, NT) region per LP, in C slices of NT / C
            Wsp = torch.empty(max(1, B * (M - rows) * NT),
                              dtype=torch.float32, device=dev)
            err = lib.group_simplex_spill_f32(*ptrs, Wsp.data_ptr(), *outs,
                                              work_p, B, M, NT, rows, *loop)
        else:
            W = torch.empty((B, M, NT), dtype=torch.float32, device=dev)
            err = lib.group_simplex_global_f32(*ptrs, W.data_ptr(), *outs, B,
                                               M, NT, *loop)
        if err == NO_CLUSTER_FITS:
            raise RuntimeError(f"group_simplex_{kind}_f32: no cluster of {C} "
                               f"CTAs fits the card at Mp={M}, NT={NT} "
                               f"(cudaOccupancyMaxActiveClusters is 0)")
        if err != 0:
            raise RuntimeError(f"group_simplex {kind} launch failed: CUDA "
                               f"error {err} (B={B}, Mp={M}, NT={NT}, C={C}, "
                               f"rows={rows})")
        CALLS += 1
        if kind == "cluster":
            CALLS_CLUSTER += 1
        elif kind == "spill":
            CALLS_SPILL += 1
        else:
            CALLS_GLOBAL += 1
    return status, basis, at_upper, iters


def max_active_clusters(Mp: int, NT: int, C: int,
                        rows: int | None = None) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel with C-CTA
    clusters at this shape, or with ``rows`` of the spill kernel's (C is
    then SPILL_C)."""
    lib = _library()
    out = ctypes.c_int(0)
    if rows is None:
        err = lib.group_simplex_max_active_clusters_f32(Mp, NT, C,
                                                        ctypes.byref(out))
    else:
        err = lib.group_simplex_spill_max_active_clusters_f32(
            Mp, NT, rows, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA "
                           f"error {err} (Mp={Mp}, NT={NT}, C={C}, "
                           f"rows={rows})")
    return out.value


def _library():
    from bensolve_tpu_torch.lp import _build

    lib = _build.load("group_simplex")
    if not hasattr(lib, "_bound"):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.group_simplex_cluster_f32.argtypes = [p] * 11 + [i] * 5 + [ll, p]
        lib.group_simplex_cluster_f32.restype = ctypes.c_int
        lib.group_simplex_spill_f32.argtypes = [p] * 12 + [i] * 5 + [ll, p]
        lib.group_simplex_spill_f32.restype = ctypes.c_int
        lib.group_simplex_global_f32.argtypes = [p] * 11 + [i] * 4 + [ll, p]
        lib.group_simplex_global_f32.restype = ctypes.c_int
        lib.group_simplex_smem_bytes_f32.argtypes = [i, i, i, i]
        lib.group_simplex_smem_bytes_f32.restype = ctypes.c_size_t
        for name, n_int in (("group_simplex_max_active_clusters_f32", 3),
                            ("group_simplex_spill_max_active_clusters_f32",
                             3)):
            getattr(lib, name).argtypes = [i] * n_int + [
                ctypes.POINTER(ctypes.c_int)]
            getattr(lib, name).restype = ctypes.c_int
        lib._bound = True
    return lib


def solve_batch_group_reference(W0, c, lb, ub, basis0, at_upper0, max_iter,
                                group: int = 1):
    """Plain PyTorch version of the kernel: the Pallas kernel's loop
    written out in torch ops, all groups of ``group`` consecutive LPs in
    lockstep.  A group's pricing pass runs while any member is running
    and infeasible or when k % 128 == 0, as in the Pallas kernel; steps
    taken after a group finished leave its outputs unchanged."""
    B, M, NT = c.shape[0], W0.shape[0], W0.shape[1]
    if B % group:
        raise ValueError(f"batch {B} is not a multiple of group {group}")
    dev = W0.device
    f = W0.dtype
    zero, one = W0.new_zeros(()), W0.new_ones(())
    big = W0.new_tensor(BIG)
    lane_f = torch.arange(NT, dtype=f, device=dev)
    W = W0.expand(B, M, NT).clone()

    lb_f = lb > -BIG
    ub_f = ub < BIG
    lo = torch.where(lb_f, lb, torch.where(ub_f, ub, zero))
    hi = torch.where(ub_f, ub, torch.where(lb_f, lb, zero))

    basis = basis0.long().expand(B, M).clone()
    basis_f = basis.to(f)
    in_basis = torch.zeros(B, NT, dtype=torch.bool, device=dev)
    in_basis[:, basis0.long()] = True
    at_upper = at_upper0 & ~in_basis
    lbB, ubB, cB = lb.gather(1, basis), ub.gather(1, basis), c.gather(1, basis)

    zn0 = torch.where(in_basis, zero, torch.where(at_upper, hi, lo))
    xb = -(W * zn0[:, None, :]).sum(dim=2)
    d2 = c - (W * cB[:, :, None]).sum(dim=1)
    gamma = torch.ones_like(c)
    crossed = (lb > ub).any(dim=1)
    status = torch.where(crossed, sx.INFEASIBLE, sx.RUNNING).to(torch.int32)
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    k = 0
    while (bool(spans.read((status == sx.RUNNING).any()))
           and k < _max_loop(max_iter)):
        running = status == sx.RUNNING
        viol_lo = xb < lbB - TOL_BND
        viol_up = xb > ubB + TOL_BND
        feasible = ~(viol_lo | viol_up).any(dim=1)

        need = (running & ~feasible).view(B // group, group).any(dim=1)
        run_pass = need.repeat_interleave(group) | (k % 128 == 0)
        cB1 = torch.where(viol_up, one, zero) + torch.where(viol_lo, -one, zero)
        cB_eff = torch.where(feasible[:, None], cB, cB1)
        d_full = (torch.where(feasible[:, None], c, zero)
                  - (W * cB_eff[:, :, None]).sum(dim=1))
        d = torch.where(run_pass[:, None], d_full, d2)
        d2 = torch.where(feasible[:, None], d, d2)

        val = torch.where(at_upper, hi, lo)
        nonbasic = ~in_basis
        elig_inc = nonbasic & (val < ub) & (d < -TOL_DJ)
        elig_dec = nonbasic & (val > lb) & (d > TOL_DJ)
        eligible = elig_inc | elig_dec
        use_bland = stall > sx.BLAND_AFTER
        q_dtz = torch.where(eligible, d * d / gamma, -big).argmax(dim=1)
        q_bld = torch.where(eligible, -lane_f, -big).argmax(dim=1)
        q = torch.where(use_bland, q_bld, q_dtz)
        has_entering = eligible.any(dim=1)

        sigma = torch.where(sx._take(elig_inc, q), one, -one)
        alpha = W.gather(2, q[:, None, None].expand(B, M, 1))[:, :, 0]
        rate = -sigma[:, None] * alpha

        inc = rate > TOL_PIV
        dec = rate < -TOL_PIV
        target_inc = torch.where(viol_lo, lbB, ubB)
        target_dec = torch.where(viol_up, ubB, lbB)
        t_inc = torch.where(viol_up, big, (target_inc - xb) / rate)
        t_dec = torch.where(viol_lo, big, (target_dec - xb) / rate)
        t = torch.where(inc, t_inc, torch.where(dec, t_dec, big))
        t = torch.clamp(t, 0.0, BIG)
        tmin = t.min(dim=1).values

        cand = t <= (tmin + 1e-12)[:, None]
        r_stab = torch.where(cand, rate.abs(), -one).argmax(dim=1)
        r_bld = torch.where(cand, -basis_f, -big).argmax(dim=1)
        r = torch.where(use_bland, r_bld, r_stab)

        lb_q = torch.where(sx._take(lb_f, q), sx._take(lb, q), -big)
        ub_q = torch.where(sx._take(ub_f, q), sx._take(ub, q), big)
        span = ub_q - lb_q
        do_flip = span < tmin
        t_star = torch.where(do_flip, span, tmin)

        finish = torch.where(feasible, sx.OPTIMAL, sx.INFEASIBLE)
        unbounded = has_entering & feasible & (t_star >= BIG)
        stat_next = torch.where(
            ~has_entering, finish,
            torch.where(unbounded, sx.UNBOUNDED,
                        torch.where(it + 1 >= max_iter, sx.ITLIM,
                                    sx.RUNNING)))
        status = torch.where(running, stat_next, status).to(torch.int32)
        act = running & has_entering & (t_star < BIG)

        delta = torch.where(act, sigma * t_star, zero)
        xb_new = xb - delta[:, None] * alpha

        do_pivot = act & ~do_flip
        alpha_r = sx._take(alpha, r)
        alpha_r = torch.where(alpha_r.abs() < TOL_PIV,
                              torch.where(alpha_r < 0, -TOL_PIV * one,
                                          TOL_PIV * one), alpha_r)

        # rank-1 tableau update of the pivoting LPs, in place: W_i -=
        # alpha_i * w_r_scaled for every row, then row r := w_r_scaled
        w_r = W.gather(1, r[:, None, None].expand(B, 1, NT))[:, 0, :]
        w_r_scaled = w_r / alpha_r[:, None]
        coef = torch.where(do_pivot[:, None], alpha, zero)
        W.sub_(coef[:, :, None] * w_r_scaled[:, None, :])
        pv = rows[do_pivot]
        W[pv, r[pv]] = w_r_scaled[pv]

        leaving = sx._take(basis, r)
        val_q = sx._take(val, q)
        xq_new = val_q + delta
        xb_new = sx._set_at(xb_new, r, xq_new, do_pivot)
        basis = sx._set_at(basis, r, q, do_pivot)
        basis_f = sx._set_at(basis_f, r, q.to(f), do_pivot)
        lbB = sx._set_at(lbB, r, lb_q, do_pivot)
        ubB = sx._set_at(ubB, r, ub_q, do_pivot)
        cB = sx._set_at(cB, r, sx._take(c, q), do_pivot)

        true = torch.ones_like(do_pivot)
        in_basis_new = sx._set_at(in_basis, leaving, ~true, do_pivot)
        in_basis_new = sx._set_at(in_basis_new, q, true, do_pivot)

        rate_r = sx._take(rate, r)
        leave_at_upper = torch.where(rate_r > 0, ~sx._take(viol_lo, r),
                                     sx._take(viol_up, r))
        q_at_upper = sx._take(at_upper, q)
        at_upper = sx._set_at(at_upper, leaving, leave_at_upper, do_pivot)
        at_upper = sx._set_at(at_upper, q, ~q_at_upper, act & do_flip)
        in_basis = in_basis_new

        # carried reduced-cost row: d2' = d2 - d2_q * new_row_r
        d2_q = sx._take(d2, q)
        d2 = torch.where(do_pivot[:, None],
                         d2 - d2_q[:, None] * w_r_scaled, d2)

        # devex weights (Forrest-Goldfarb reference framework)
        gamma_q = sx._take(gamma, q)
        g_upd = torch.maximum(gamma, w_r_scaled * w_r_scaled * gamma_q[:, None])
        g_leave = torch.clamp(gamma_q / (alpha_r * alpha_r), min=1.0)
        g_upd = g_upd.scatter(1, leaving[:, None], g_leave[:, None])
        gamma = torch.where(do_pivot[:, None], g_upd, gamma)
        gamma = torch.where(gamma > 1e8, one, gamma)

        degen = act & (t_star < TOL_BND)
        stall = torch.where(act, torch.where(degen, stall + 1, 0),
                            stall).to(torch.int32)
        it = it + act.to(torch.int32)
        xb = xb_new
        k += 1

    status = torch.where(status == sx.RUNNING, sx.ITLIM, status).to(torch.int32)
    return status, basis.to(torch.int32), at_upper, it


def try_solve_batch(A, c, row_lb, row_ub, col_lb, col_ub, *,
                    max_iter=None, dtype=np.float32, start_basis=None,
                    max_chunk=None, group=None, device="cuda"):
    """solve_batch-compatible entry used by solve_batch_auto: returns
    None when this backend cannot take the call (per-instance warm
    starts), so the caller falls through to the tableau path."""
    if start_basis is not None:
        b0 = start_basis[0] if isinstance(start_basis, tuple) \
            else start_basis
        if np.asarray(b0).ndim != 1:
            return None   # per-instance warm bases: tableau path only
    return lp_batch_group(A, c, row_lb, row_ub, col_lb, col_ub,
                          max_iter=max_iter, start_basis=start_basis,
                          group=group, device=device)


def lp_batch_group(A, c, row_lb, row_ub, col_lb, col_ub, *,
                   max_iter: int | None = None, start_basis=None,
                   group: int | None = None,
                   device="cuda") -> sx.LPResult:
    """solve_batch-compatible wrapper around the kernel (float32; M
    padded as in the tableau path, NT to 128s, the batch to a power-of-
    two multiple of the group).  ``group``: LPs per pricing group of the
    plain version (CPU only; the CUDA kernels are group 1).  Batches
    larger than the workspace budget allows are solved in chunks."""
    global ROUTED
    if group is None:
        group = 1
    if torch.device(device).type == "cuda" and group != 1:
        raise ValueError("the CUDA kernels run one LP per block or cluster "
                         "(group=1)")
    dev = sx.resolve_device(device)
    dtype = np.float32
    prep = sx._prepare_A(A, dtype, dev)
    M, N, Mp = prep.M, prep.N, prep.Mp
    NT = _pad128(Mp + sx._bucket(N))
    Np = NT - Mp
    c = np.atleast_2d(np.asarray(c, dtype))
    B = c.shape[0]
    chunk = _pick_chunk(Mp, NT)
    if B > chunk:
        parts = []
        for s in range(0, B, chunk):
            sl = slice(s, s + chunk)
            parts.append(lp_batch_group(
                prep, c[sl], np.asarray(row_lb)[sl], np.asarray(row_ub)[sl],
                np.asarray(col_lb)[sl], np.asarray(col_ub)[sl],
                max_iter=max_iter, start_basis=start_basis, group=group,
                device=dev))
        return sx.concat_results(parts)
    ROUTED += 1
    Bp = max(group, group * (1 << max(0, (-(-B // group)) - 1).bit_length()))
    if max_iter is None:
        max_iter = 50 * (Mp + Np) + 500

    def _pad(arr, k, kp, fill):
        arr = np.asarray(arr, dtype)
        out = np.full((Bp, kp), fill, dtype)
        out[:B, :k] = arr
        if Bp > B:
            out[B:, :k] = arr[:1]
        return out

    full_c = np.concatenate(
        [np.zeros((Bp, Mp), dtype), _pad(c, N, Np, 0.0)], axis=1)
    lb = np.concatenate(
        [_pad(row_lb, M, Mp, -BIG), _pad(col_lb, N, Np, 0.0)], axis=1)
    ub = np.concatenate(
        [_pad(row_ub, M, Mp, BIG), _pad(col_ub, N, Np, 0.0)], axis=1)
    lb = np.clip(np.nan_to_num(lb, posinf=BIG, neginf=-BIG), -BIG, BIG
                 ).astype(dtype)
    ub = np.clip(np.nan_to_num(ub, posinf=BIG, neginf=-BIG), -BIG, BIG
                 ).astype(dtype)
    A_p = np.zeros((Mp, Np), dtype)
    A_p[:M, :N] = np.asarray(prep.A, dtype)
    A_t = sx._put(A_p, dev)
    E = sx._E(A_t)

    if start_basis is None:
        basis0 = np.arange(Mp, dtype=np.int32)
        atup_pattern = np.zeros(NT, bool)
        W0 = E
    else:
        if isinstance(start_basis, tuple):
            b0, u0 = start_basis
        else:
            b0, u0 = start_basis, np.zeros(NT, bool)
        basis0 = np.asarray(b0, np.int32)
        u0 = np.asarray(u0, bool)
        atup_pattern = np.zeros(NT, bool)
        atup_pattern[: u0.size] = u0
        # W0 = Binv @ E for the shared warm basis (one float32 LU)
        b0_t = sx._put(basis0.astype(np.int64), dev)
        LU, piv = sx._lu_factor(sx._batched_basis_matrices(A_t, b0_t[None]))
        W0 = sx._lu_solve(LU, piv, E[None])[0].contiguous()

    # default nonbasic rest pattern: only-upper-bounded rest at ub
    in_b = np.zeros(NT, bool)
    in_b[basis0] = True
    atup_full = ((atup_pattern[None, :] | ((lb <= -BIG) & (ub < BIG)))
                 & (ub < BIG) & ~in_b[None, :])

    c_t = sx._put(full_c, dev)
    lb_t = sx._put(lb, dev)
    ub_t = sx._put(ub, dev)
    status, basis, at_upper, iters = solve_batch_group(
        W0.contiguous(), c_t, lb_t, ub_t, sx._put(basis0, dev),
        sx._put(atup_full, dev), max_iter)

    # accurate recovery via the shared final-solution path (float32 LU)
    basis_l = basis.long()
    in_basis = torch.zeros((Bp, NT), dtype=torch.bool, device=dev)
    in_basis.scatter_(1, basis_l, True)
    inf = lb_t.new_tensor(float("inf"))
    lbj = torch.where(lb_t <= -BIG, -inf, lb_t)
    ubj = torch.where(ub_t >= BIG, inf, ub_t)
    obj, x, s_act, row_dual, col_dual = sx._final_solutions(
        A_t, c_t, lbj, ubj, basis_l, in_basis, at_upper,
        c_t.gather(1, basis_l))
    out = [spans.read(t) for t in (status, obj, x, s_act, row_dual,
                                   col_dual, iters, basis, at_upper)]
    status, obj, x, s_act, row_dual, col_dual, iters, basis, at_upper = out
    return sx.LPResult(status[:B], obj[:B], x[:B, :N], s_act[:B, :M],
                       row_dual[:B, :M], col_dual[:B, :N], iters[:B],
                       basis[:B], at_upper[:B])
