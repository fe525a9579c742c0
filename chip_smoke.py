"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one output line (or block) each:

1. environment: torch/CUDA versions, the card's name and power limit,
   nvcc, triton, the native polytope engine; TF32 matmuls switched off;
2. build: the per-LP simplex kernel from lp/csrc/group_simplex.cu, with
   ptxas' registers and spills of both variants (cluster, global), their
   shared-memory bytes and cudaOccupancyMaxActiveClusters at example10's
   P2 shape;
3. kernel vs its plain PyTorch version on the card: each variant at its
   shape (clusters of 1, 2, 4, 8 and 16 CTAs, the global-memory variant
   at M=N=700), cold, and shared-warm at M=N=16 and at example10's P2
   shape (Mp=384, NT=768, B=256), where the cluster and the global
   variant are also timed in turns on the same inputs (CUDA events) and
   the roofline bound is computed from the cluster kernel's own counts
   of pricing passes and rank-1 updates;
4. the main path at float32 (the kernel's route): solve() on example01,
   05, 08 and 10, with the launch counts of both variants reset just
   before and read just after (per example), the kernel's share of the
   phase wall, and the support-function oracle at 1e-3;
   then the same on random_vlp(q=2, m=700, n=256), whose LPs no cluster
   holds: the global-memory variant's path, its launches counted alone;
5. the main path at the default float64 (torch ops) on example10, held
   to the support oracle at 1e-4;
6. the dual Benson algorithm (-A dual -a dual) at float64 on example10:
   the support oracle at 1e-4, and the same upper-image points as
   phase 5 within 1e-6;
7. the dual algorithm at float32 on example01, 05, 08 and 10, the
   kernel's warm route (every P1 round starts from one shared basis):
   each variant's launches counted over this phase alone (per example),
   and the kernel's share of the phase's wall time from CUDA events
   around the launches;
8. a tall VLP (every LP has N >= 4M; random_vlp(q=2, m=50, n=500),
   cut from m=100, n=1000 to keep the script inside its time limit)
   through the revised simplex at float64 with both algorithms: the revised route taken, the tableau
   and the kernel untouched, the oracle at 1e-4, and the two upper
   images equal within 1e-6 (support functions at 4096 weights; their
   vertex lists may differ along nearly straight stretches);
9. the revised simplex on the card against the CPU on two random
   batches (float64 to 1e-9, float32 to 1e-3);
10. the interior-point method at BASELINE config #4's full width
   (random_vlp(q=5, m=1000, n=2000), P2 LP 1011x2006, B=128), bench.py's
   round pattern through the port's P2 template with ipm_min=2000: one
   cold solve and three warm rounds from the template's carried
   interior point, at float32 and at float64.  The host HiGHS fallback
   is capped at 0 LPs (the reference's 32 would take 12-22 s per LP):
   the LPs it would take are counted, ITLIM ones solved by HiGHS here,
   and up to two loose ones per dtype held to HiGHS.  Per round: wall
   and device seconds, IPM iterations, statuses, quality, polish, the
   LPs bound for the host, whether the round meets the criterion of
   >= 90% resolved on the device and <= 10% to the host, chunks; ms per
   iteration of the full batch beside the bounds of the work needed and
   of the work done, and its split into the S build, the two Choleskys
   and the solves; 4 LPs held to scipy/HiGHS (1e-3 relative at float32,
   1e-6 at float64).  Fails unless every LP ends OPTIMAL and the
   float32 cold round meets the criterion (the warm rounds and float64
   do not meet it in the JAX package either: PERF.md, Findings);
11. solve() through the interior-point route at float64: example05, 08
   and 11 with lp_ipm_min=1 (the oracle at 1e-4, upper-image points
   within 1e-6 of the simplex route's), then random_vlp(q=2, m=150,
   n=300) with lp_ipm_min=450 (its P2 LP 155x303 takes the route; m and
   n halved from 300 and 600, which took 293 s);
12. the interior-point method on the card against the CPU on the random
   batches of tests/test_ipm.py (float64 to 1e-9, float32 to 1e-3);
13. the result lines.

The second-to-last line is one JSON object with the kernel's two
variants (name, route, source, the TPU kernel it replaces, launches on
its main path: the examples of phase 4 for the cluster variant, the
large VLP of phase 4 for the global one; launches_dual_f32 in phase 7;
max |obj kernel - plain|,
kernel, plain and bound times at example10's P2 shape, cold, and the
kernel's time warm); the last line is {"ok": true, "device": {...}}.  Any failed phase raises and exits non-zero before
those lines.  Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.

``--only 10 12`` runs just the named phases after phase 1 and prints no
result lines (for iterating on one phase).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

F32_KW = dict(lp_dtype="float32", eps_benson_phase1=1e-4,
              eps_benson_phase2=1e-4)
DUAL_KW = dict(alg_phase1="dual", alg_phase2="dual")
# the tall phase's VLP: examples.random_vlp(q, m, n); its P2 LP is
# (m+q+q+1) x (n+q+1), tall by a factor of about n/m
TALL = (2, 50, 500)
# the large phase's VLP: its P2 and P1 LPs (705x259, 703x258) pad to
# Mp=768, NT=1152, a 3.5 MB float32 tableau that no cluster holds, so
# its kernel launches take the global-memory variant
LARGE = (2, 700, 256)
KERNEL_SOURCE = "bensolve_tpu_torch/lp/csrc/group_simplex.cu"
KERNEL_REPLACES = "bensolve_tpu/lp/pallas_simplex.py:55"
REL_TOL = 1e-4       # float32 kernel vs plain: other summation orders
EX10_P2 = (350, 347)  # example10's P2 LP, padded to Mp=384, NT=768
# BASELINE config #4 (bench.py make_p2_instances): random_vlp(q, m, n,
# seed), B LPs per round, through the interior-point route
IPM_CONFIG = dict(q=5, m=1000, n=2000, seed=7)
IPM_B = 128
IPM_MIN = 2000
# the interior-point phase's mid-size VLP: random_vlp(q, m, n), whose P2
# LP (m+2q+1) x (n+q+1) has M + N >= IPM_VLP_MIN
IPM_VLP = (2, 150, 300)
IPM_VLP_MIN = 450
# published H100 SXM peaks (float32 without TF32; float64 tensor cores)
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
HBM_BYTES_PER_S = 3.35e12


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_environment():
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(smi_line())
    from bensolve_tpu_torch.lp import _build

    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[env] nvcc {nvcc}: {ver[-1]}")
    try:
        import triton
        log(f"[env] import triton: ok ({triton.__version__})")
    except ImportError as e:
        log(f"[env] import triton: failed ({e})")
    from bensolve_tpu_torch import native
    log(f"[env] native polytope engine loaded: {native.lib() is not None}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    log(f"[env] torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")


def phase_build():
    from bensolve_tpu_torch.lp import _build, group_simplex as gs

    t0 = time.perf_counter()
    gs._library()
    seconds, nvcc_log = _build.build_info("group_simplex")
    per_kernel, name = {}, None
    for ln in nvcc_log.splitlines():
        if "Compiling entry function" in ln:
            name = ("cluster" if "group_simplex_cluster_kernel" in ln
                    else "global")
        elif name and ("registers" in ln or "spill" in ln):
            per_kernel.setdefault(name, []).append(ln.split(":", 1)[-1]
                                                   .strip())
    log(f"[build] group_simplex for sm_90a: nvcc {seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("cluster", "global"):
        if name not in per_kernel:
            raise AssertionError(f"ptxas reported no {name} kernel")
        log(f"[build] {name} kernel: " + " | ".join(per_kernel[name]))
    Mp, NT = gs.padded_shape(*EX10_P2)
    kind, C = gs.plan(Mp, NT)
    if (kind, C) != ("cluster", 8):
        raise AssertionError(f"example10's P2 shape plans {kind} C={C}")
    active = gs.max_active_clusters(Mp, NT, C)
    log(f"[build] example10 P2 (Mp={Mp}, NT={NT}): cluster C={C}, "
        f"{gs.smem_bytes(Mp, NT, C)} B dynamic shared memory per CTA, "
        f"cudaOccupancyMaxActiveClusters {active}; global variant "
        f"{gs.smem_bytes(Mp, NT, 0)} B per block plus a "
        f"{Mp * NT * 4} B tableau per LP in global memory")
    if active < 1:
        raise AssertionError("no cluster fits at example10's P2 shape")


def make(M, N, B, seed):
    """The random-batch recipe of tests/test_pallas_simplex.py::make."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32)
    x0 = rng.random((B, N)).astype(np.float32)
    b = (x0 @ A.T + 0.5 + rng.random((B, M))).astype(np.float32)
    c = rng.standard_normal((B, N)).astype(np.float32)
    rlb = np.full((B, M), -np.inf, np.float32)
    clb = np.zeros((B, N), np.float32)
    cub = np.full((B, N), 10.0, np.float32)
    return A, c, rlb, b, clb, cub


def _time_ms(fn, reps):
    """CUDA-event time per call; the caller has just run ``fn`` once on
    the same inputs, which serves as the warm-up."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _launches():
    from bensolve_tpu_torch.lp import group_simplex as gs

    return {"cluster": gs.CALLS_CLUSTER, "global": gs.CALLS_GLOBAL}


def _errors(name, ker, plain, same_basis):
    """Relative and absolute obj / x / row_dual differences, raising past
    REL_TOL: obj on every optimal LP; x and row_dual where both ended in
    the same basis (an LP that is dual degenerate within the float32
    tolerance has several optimal vertices with one objective value)."""
    ok = ker.status == 1
    errs = {}
    for field, rows in (("obj", ok), ("x", ok & same_basis),
                        ("row_dual", ok & same_basis)):
        a = getattr(ker, field)[rows]
        b = getattr(plain, field)[rows]
        scale = np.maximum(1.0, np.abs(b).max(axis=-1, keepdims=True)
                           if b.ndim == 2 else np.abs(b))
        rel = float((np.abs(a - b) / scale).max()) if a.size else 0.0
        errs[field] = (rel, float(np.abs(a - b).max()) if a.size else 0.0)
        if rel > REL_TOL:
            raise AssertionError(f"{name}: {field} differs by {rel:.2e} "
                                 f"relative (limit {REL_TOL})")
    return errs


def _bound_ms(inputs, work):
    """The least time the card could take for this batch: every input
    read once and every output written once at 3.35 TB/s, against the
    flops this run's data needs at the 67 TFLOP/s float32 peak (2 Mp NT
    for each of the initial xb and d2 sums, each pricing pass and each
    rank-1 update, from the kernel's own counts).  (ms, bound_by, mean
    loop steps, pricing-pass share of the steps)."""
    W0, c = inputs[0], inputs[1]
    Mp, NT = W0.shape
    B = c.shape[0]
    steps, passes, pivots = work.cpu().numpy().astype(np.int64).T
    nbytes = (Mp * NT * 4 + B * NT * (3 * 4 + 1) + Mp * 4
              + B * (4 + Mp * 4 + NT + 4))
    flops = 2.0 * Mp * NT * float((2 + passes + pivots).sum())
    t_bytes, t_flops = nbytes / 3.35e12, flops / 67e12
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations",
            float(steps.mean()), float(passes.sum() / max(1, steps.sum())))


def _compare(name, args, start_basis, reps, variant=None, ab=False):
    """The kernel (the planned variant, or the forced one) and the plain
    version on the same device inputs: equal status per LP, obj / x /
    row_dual within REL_TOL relative, the launch on the expected variant,
    timings.  With ``ab`` the two variants are timed in turns (cluster,
    global, global, cluster) on these inputs and the roofline bound is
    computed.  Returns a dict of the numbers."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    dev = torch.device("cuda")
    inputs = {}
    real_wrapper = gs.solve_batch_group

    def capture(*a, **kw):
        inputs["a"] = a
        return real_wrapper(*a, variant=variant)

    gs.solve_batch_group = capture
    before = _launches()
    try:
        ker = gs.lp_batch_group(*args, start_basis=start_basis, device=dev)
    finally:
        gs.solve_batch_group = real_wrapper
    torch.cuda.synchronize()
    W0, c, lb, ub, basis0, atup, max_iter = inputs["a"]
    kind, C = ("global", 0) if variant else gs.plan(*W0.shape)
    after = _launches()
    launched = {k: after[k] - before[k] for k in after}
    if launched != {"cluster": int(kind == "cluster"),
                    "global": int(kind == "global")}:
        raise AssertionError(f"{name}: launches {launched}, expected one "
                             f"{kind}")
    st_p, basis_p, atup_p, it_p = gs.solve_batch_group_reference(
        *inputs["a"], group=1)
    torch.cuda.synchronize()
    if not (ker.status == st_p.cpu().numpy()[:ker.status.size]).all():
        raise AssertionError(f"{name}: kernel status {ker.status} != plain "
                             f"{st_p.cpu().numpy()}")
    # the plain version's solutions, recovered exactly as the wrapper does
    plain = _recover(gs, args, start_basis, st_p, basis_p, atup_p, it_p, dev)
    B = args[1].shape[0]
    it_k, it_p = ker.iters, plain.iters
    same_basis = (ker.basis == plain.basis).all(axis=1)
    errs = _errors(name, ker, plain, same_basis)
    band = float(np.abs(it_k - it_p).max())
    if band > 0.25 * max(1, it_p.max()) + 16:
        raise AssertionError(f"{name}: iteration counts differ by {band}")
    out = {"err": errs["obj"][1], "kind": kind, "C": C}
    run = lambda v=variant: gs.solve_batch_group(*inputs["a"], variant=v)
    extra = ""
    if ab:
        work = torch.zeros(c.shape[0], 3, dtype=torch.int32,
                           device=dev)
        gs.solve_batch_group(*inputs["a"], work=work)
        out["bound_ms"], out["bound_by"], steps, pass_share = _bound_ms(
            inputs["a"], work)
        g_out = gs.solve_batch_group(*inputs["a"], variant="global")
        g = _recover(gs, args, start_basis, *g_out, dev)
        if not (g.status == plain.status).all():
            raise AssertionError(f"{name}: global variant status "
                                 f"{g.status} != plain {plain.status}")
        out["err_global"] = _errors(name + " (global)", g, plain,
                                    (g.basis == plain.basis).all(axis=1)
                                    )["obj"][1]
        runs = {"cluster": [], "global": []}
        for v in ("cluster", "global", "global", "cluster"):
            runs[v].append(_time_ms(lambda: run(None if v == "cluster"
                                                else "global"),
                                    reps if v == "cluster" else 1))
        out["ms"] = float(np.mean(runs["cluster"]))
        out["ms_global"] = float(np.mean(runs["global"]))
        extra = (f"; in turns cluster {runs['cluster'][0]:.3f}, global "
                 f"{runs['global'][0]:.3f}, {runs['global'][1]:.3f}, "
                 f"cluster {runs['cluster'][1]:.3f} ms; global variant "
                 f"status equal, obj within {out['err_global']:.1e}; "
                 f"bound {out['bound_ms']:.3f} ms ({out['bound_by']}; mean "
                 f"loop steps {steps:.1f}, pricing passes on "
                 f"{pass_share:.3f} of steps) = "
                 f"{out['bound_ms'] / out['ms']:.4f} of the cluster "
                 f"kernel's time")
    else:
        out["ms"] = _time_ms(run, reps)
    out["plain_ms"] = _time_ms(lambda: gs.solve_batch_group_reference(
        *inputs["a"], group=1), max(1, reps // 4))
    log(f"[kernel] {name}: {kind} C={C} B={B} Mp={W0.shape[0]} "
        f"NT={W0.shape[1]} status equal on {B}/{B} LPs "
        f"({int((ker.status == 1).sum())} optimal); rel err obj "
        f"{errs['obj'][0]:.1e} x {errs['x'][0]:.1e} row_dual "
        f"{errs['row_dual'][0]:.1e}; identical basis+iters on "
        f"{np.mean(same_basis & (it_k == it_p)):.3f} of LPs (x and row_dual "
        f"compared on the {int(same_basis.sum())} with equal basis); iters "
        f"max |kernel-plain| {band:.0f} (band 0.25*max+16); mean iters "
        f"kernel {it_k.mean():.1f} plain {it_p.mean():.1f}; kernel "
        f"{out['ms']:.3f} ms plain {out['plain_ms']:.3f} ms per solve"
        + extra)
    return out


def _recover(gs, args, start_basis, status, basis, at_upper, iters, dev):
    """lp_batch_group's recovery applied to given kernel outputs."""
    real = gs.solve_batch_group
    gs.solve_batch_group = lambda *a, **kw: (
        torch.as_tensor(status, device=dev), basis, at_upper, iters)
    try:
        return gs.lp_batch_group(*args, start_basis=start_basis, device=dev)
    finally:
        gs.solve_batch_group = real


def phase_kernel():
    """Each variant against the plain version at its shape; returns the
    numbers at example10's P2 shape, cold and warm, and the global
    variant's obj error at its own shape."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    small = make(16, 16, 8, 0)
    cold = gs.lp_batch_group(*small, device="cuda")
    i0 = int(np.flatnonzero(cold.status == 1)[0])
    _compare("M=N=16 cold", small, None, 20)
    _compare("M=N=16 shared warm", small,
             (cold.basis[i0], cold.at_upper[i0]), 20)
    for M, B in ((160, 16), (200, 16), (500, 8)):
        _compare(f"M=N={M} cold", make(M, M, B, 0), None, 3)
    glob = _compare("M=N=700 cold", make(700, 700, 4, 0), None, 1)
    big = make(*EX10_P2, 256, 1)
    assert gs.padded_shape(*EX10_P2) == (384, 768)
    ex10 = _compare("ex10 P2 shape cold", big, None, 3, ab=True)
    warm = gs.lp_batch_group(*big, device="cuda")
    j0 = int(np.flatnonzero(warm.status == 1)[0])
    ex10_w = _compare("ex10 P2 shape shared warm", big,
                      (warm.basis[j0], warm.at_upper[j0]), 3, ab=True)
    return ex10, ex10_w, glob


def canonical(result):
    """P and the solution points/directions of the canonical min
    problem (undo the sign flips of bslv_vlp.c:856-861 and the output
    transforms)."""
    vlp, sol = result.vlp, result.sol
    flip = (sol.c_dir.value < 0) == (vlp.optdir == 1)
    P_eff = (-vlp.P if flip else vlp.P).astype(float)
    pts, dirs = result.primal_points.copy(), result.primal_directions.copy()
    pos = sol.c_dir.value > 0
    if (pos and vlp.optdir == -1) or (not pos and vlp.optdir == 1):
        pts, dirs = -pts, -dirs
    return P_eff, pts, dirs


def check_support(result, tol, n_samples=64):
    """Support-function oracle (the method of tests/test_e2e.py): for
    sampled w in the interior of C*, min over the solution points of
    w'y equals min over the feasible set of w'P x (scipy/HiGHS) within
    tol * (1 + |h|).  Returns the worst relative gap."""
    from scipy.optimize import linprog

    vlp, sol = result.vlp, result.sol
    P_eff, pts, dirs = canonical(result)
    assert pts.shape[0] > 0
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(vlp.m):
        lo, hi = vlp.rows.lb[i], vlp.rows.ub[i]
        if np.isfinite(lo) and lo == hi:
            A_eq.append(vlp.A[i]); b_eq.append(lo)
        else:
            if np.isfinite(hi):
                A_ub.append(vlp.A[i]); b_ub.append(hi)
            if np.isfinite(lo):
                A_ub.append(-vlp.A[i]); b_ub.append(-lo)
    kw = {}
    if A_ub:
        kw["A_ub"], kw["b_ub"] = np.array(A_ub), np.array(b_ub)
    if A_eq:
        kw["A_eq"], kw["b_eq"] = np.array(A_eq), np.array(b_eq)
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(n_samples):
        w = sol.Z @ (rng.random(sol.p) + 1e-3)
        w = w / np.abs(w).sum()
        lp = linprog(w @ P_eff, bounds=list(zip(vlp.cols.lb, vlp.cols.ub)),
                     method="highs", **kw)
        h_hat = float(np.min(pts @ w))
        if dirs.size and np.min(dirs @ w) < -1e-9:
            h_hat = -np.inf
        if lp.status == 3:
            assert not np.isfinite(h_hat), "oracle: unbounded missed"
            continue
        assert lp.status == 0, lp.message
        gap = abs(h_hat - lp.fun) / (1 + abs(lp.fun))
        worst = max(worst, gap)
        if not gap <= tol:
            raise AssertionError(f"support oracle: gap {gap:.2e} > {tol} "
                                 f"at w={w}")
    return worst


def _options(**kw):
    from bensolve_tpu_torch.vlp.options import Alg, Options

    for k in ("alg_phase1", "alg_phase2"):
        if k in kw:
            kw[k] = Alg(kw[k])
    return Options(write_files=False, device="cuda", **kw)


def _solve(name, opt, vlp=None):
    from bensolve_tpu_torch import examples, solve

    vlp = examples.ALL[name]() if vlp is None else vlp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve(vlp, opt)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def _set_distance(a, b):
    """(largest max-norm distance from a point of either set to the
    nearest point of the other, number of points farther than 1e-6)."""
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    near_a, near_b = d.min(axis=1), d.min(axis=0)
    worst = float(max(near_a.max(), near_b.max()))
    return worst, int((near_a > 1e-6).sum() + (near_b > 1e-6).sum())


def _sets_close(a, b, tol):
    worst, _ = _set_distance(a, b)
    if not worst <= tol:
        raise AssertionError(f"point sets differ by {worst:.2e} > {tol}")
    return worst


def _images_close(ra, rb, tol, n_samples=4096):
    """Largest relative gap between the support functions (min over the
    points of w'y) of two solutions' upper images, at sampled w in the
    interior of C*: the weights of check_support, many more of them.
    Two epsilon-solutions of one VLP agree here even where their vertex
    lists differ: along a nearly straight stretch of the boundary one
    algorithm may keep a vertex the other never visits."""
    _, pa, _ = canonical(ra)
    _, pb, _ = canonical(rb)
    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(n_samples // 1024):
        W = ra.sol.Z @ (rng.random((ra.sol.p, 1024)) + 1e-3)
        W /= np.abs(W).sum(axis=0)
        ha, hb = (pa @ W).min(axis=0), (pb @ W).min(axis=0)
        worst = max(worst, float((np.abs(ha - hb) / (1 + np.abs(hb))).max()))
    if not worst <= tol:
        raise AssertionError(f"upper images differ by {worst:.2e} > {tol}")
    return worst


def _report(tag, name, r, wall, tol):
    if r.status.name != "OPTIMAL":
        raise AssertionError(f"{tag} {name}: status {r.status}")
    gap = check_support(r, tol)
    log(f"[{tag}] {name}: OPTIMAL in {wall:.2f} s, points "
        f"{len(r.primal_points)} directions {len(r.primal_directions)} "
        f"LPs {r.stats.lps} rounds {r.stats.rounds} pivots "
        f"{r.stats.pivots}; support oracle worst gap {gap:.1e} "
        f"(limit {tol:g})")


class _KernelClock:
    """Wraps the kernel's wrapper with CUDA events around every launch
    and resets the launch counts of both variants; ``launches`` holds
    them per solve."""

    def __init__(self):
        from bensolve_tpu_torch.lp import group_simplex as gs

        self.gs, self.real, self.events = gs, gs.solve_batch_group, []
        self.launches = {}

    def __enter__(self):
        def timed(*a, **kw):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = self.real(*a, **kw)
            t1.record()
            self.events.append((t0, t1))
            return out

        self.gs.solve_batch_group = timed
        self.gs.CALLS = self.gs.CALLS_CLUSTER = self.gs.CALLS_GLOBAL = 0
        return self

    def __exit__(self, *exc):
        self.gs.solve_batch_group = self.real

    def solve(self, name, opt, vlp=None):
        before = _launches()
        r, wall = _solve(name, opt, vlp=vlp)
        after = _launches()
        self.launches[name] = {k: after[k] - before[k] for k in after}
        return r, wall

    def seconds(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3

    def total(self):
        return {k: sum(v[k] for v in self.launches.values())
                for k in ("cluster", "global")}

    def report(self, tag, phase_wall, variant="cluster"):
        kernel_s = self.seconds()
        per = "; ".join(f"{n} {v['cluster']}/{v['global']}"
                        for n, v in self.launches.items())
        tot = self.total()
        log(f"[{tag}] group_simplex launches cluster/global: {per}; total "
            f"{tot['cluster']}/{tot['global']} (CALLS {self.gs.CALLS}); "
            f"kernel {kernel_s:.3f} s of {phase_wall:.2f} s phase wall "
            f"({kernel_s / phase_wall:.3f}, CUDA events around the "
            f"launches)")
        if tot[variant] <= 0:
            raise AssertionError(f"{tag}: the {variant} kernel was launched "
                                 f"0 times")
        if self.gs.CALLS != tot["cluster"] + tot["global"]:
            raise AssertionError(f"{tag}: CALLS is not the variants' sum")
        return tot


def phase_main_f32():
    """The float32 main path; returns each variant's launch count."""
    from bensolve_tpu_torch.lp import dual_simplex
    from bensolve_tpu_torch.vlp.options import Options

    kept_devices = set()
    real_dual = dual_simplex.solve_batch_dual

    def watch(*a, **kw):
        out = real_dual(*a, **kw)
        if kw.get("keep_state") and out[1] is not None:
            kept_devices.add(out[1].W.device.type)
        return out

    dual_simplex.solve_batch_dual = watch
    runs = []
    try:
        with _KernelClock() as clock:
            for name in ("example01", "example05", "example08", "example10"):
                r, wall = clock.solve(name, Options(
                    write_files=False, device="cuda", **F32_KW))
                runs.append((name, r, wall))
    finally:
        dual_simplex.solve_batch_dual = real_dual
    for name, r, wall in runs:
        if r.status.name != "OPTIMAL":
            raise AssertionError(f"{name} float32: status {r.status}")
        gap = check_support(r, 1e-3)
        log(f"[main f32] {name}: OPTIMAL in {wall:.2f} s, points "
            f"{len(r.primal_points)} directions {len(r.primal_directions)} "
            f"LPs {r.stats.lps} rounds {r.stats.rounds} pivots "
            f"{r.stats.pivots}; support oracle worst gap {gap:.1e} "
            f"(limit 1e-3)")
    if kept_devices != {"cuda"}:
        raise AssertionError(f"kept tableau devices {kept_devices}")
    log(f"[main f32] kept tableau device: {sorted(kept_devices)}")
    return clock.report("main f32", sum(w for _, _, w in runs))


def phase_large_f32():
    """The float32 main path on a VLP whose LPs no cluster holds; returns
    each variant's launch count."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.lp import group_simplex as gs

    q, m, n = LARGE
    for shape in ((m + 2 * q + 1, n + q + 1), (m + q + 1, n + q)):
        if gs.plan(*gs.padded_shape(*shape)) != ("global", 0):
            raise AssertionError(f"large phase: LP {shape} plans "
                                 f"{gs.plan(*gs.padded_shape(*shape))}")
    name = f"random_vlp(q={q}, m={m}, n={n})"
    with _KernelClock() as clock:
        r, wall = clock.solve(name, _options(**F32_KW),
                              vlp=examples.random_vlp(q=q, m=m, n=n))
    _report("large f32", name, r, wall, 1e-3)
    return clock.report("large f32", wall, variant="global")


def phase_main_f64():
    """The default float64 path on example10; returns its result."""
    r, wall = _solve("example10", _options())
    _report("main f64", "example10", r, wall, 1e-4)
    return r


def phase_dual_f64(primal):
    """The dual algorithm at float64 on example10, held to the primal
    algorithm's points of phase 5."""
    r, wall = _solve("example10", _options(**DUAL_KW))
    _report("dual f64", "example10", r, wall, 1e-4)
    dist = _sets_close(r.primal_points, primal.primal_points, 1e-6)
    log(f"[dual f64] example10: upper-image points within {dist:.1e} of "
        f"the primal algorithm's ({len(primal.primal_points)} points; "
        f"limit 1e-6)")


def phase_dual_f32():
    """The dual algorithm at float32, the kernel's warm route; returns
    each variant's launch count in this phase."""
    runs = []
    with _KernelClock() as clock:
        torch.cuda.synchronize()
        t_phase = time.perf_counter()
        for name in ("example01", "example05", "example08", "example10"):
            r, wall = clock.solve(name, _options(**F32_KW, **DUAL_KW))
            runs.append((name, r, wall))
        torch.cuda.synchronize()
        phase_wall = time.perf_counter() - t_phase
    for name, r, wall in runs:
        _report("dual f32", name, r, wall, 1e-3)
    return clock.report("dual f32", phase_wall)


def phase_tall():
    """A tall VLP through the revised simplex with both algorithms."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.lp import (dual_simplex, group_simplex, revised,
                                       simplex)

    q, m, n = TALL
    counts = {"tableau": 0, "dual tableau": 0}
    real = (simplex.solve_batch, dual_simplex.solve_batch_dual)

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    real_rv = revised._solve_revised_segmented
    solve_s = []

    def timed(*a, **kw):
        # the revised LP layer: one batched device solve, host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_rv(*a, **kw)
        torch.cuda.synchronize()
        solve_s[-1].append(time.perf_counter() - t0)
        return res

    simplex.solve_batch = counting("tableau", real[0])
    dual_simplex.solve_batch_dual = counting("dual tableau", real[1])
    revised._solve_revised_segmented = timed
    revised.CALLS = 0
    group_simplex.CALLS = group_simplex.ROUTED = 0
    out = {}
    try:
        for alg in ("primal", "dual"):
            vlp = examples.random_vlp(q=q, m=m, n=n)
            solve_s.append([])
            out[alg] = _solve(None, _options(alg_phase1=alg, alg_phase2=alg),
                              vlp=vlp)
    finally:
        simplex.solve_batch, dual_simplex.solve_batch_dual = real
        revised._solve_revised_segmented = real_rv
    if revised.CALLS <= 0:
        raise AssertionError("tall phase: the revised simplex ran 0 times")
    others = dict(counts, kernel=group_simplex.ROUTED)
    if any(others.values()):
        raise AssertionError(f"tall phase: other LP backends ran {others}")
    shape = (m + 2 * q + 1, n + q + 1)
    for (alg, (r, wall)), secs in zip(out.items(), solve_s):
        _report("tall f64", f"random_vlp(q={q}, m={m}, n={n}) {alg}", r,
                wall, 1e-4)
        log(f"[tall f64] {alg}: revised LP layer {sum(secs):.2f} s of "
            f"{wall:.2f} s wall in {len(secs)} batched solves (mean "
            f"{np.mean(secs):.3f} s, max {max(secs):.3f} s; host clock "
            f"with syncs)")
    (rp, _), (rd, _) = out["primal"], out["dual"]
    gap = _images_close(rp, rd, 1e-6)
    dist, n_apart = _set_distance(rp.primal_points, rd.primal_points)
    log(f"[tall f64] P2 LP {shape[0]}x{shape[1]} (N/M = "
        f"{shape[1] / shape[0]:.1f}); revised batched solves "
        f"{revised.CALLS}, tableau/dual tableau/kernel "
        f"{counts['tableau']}/{counts['dual tableau']}/0; primal and dual "
        f"upper images within {gap:.1e} (support functions at 4096 "
        f"weights; limit 1e-6); vertex lists {len(rp.primal_points)} and "
        f"{len(rd.primal_points)}, {n_apart} points farther than 1e-6 "
        f"from the other list (worst {dist:.1e})")


def _tall_batch(seed, M, N, B):
    """The random-instance recipe of tests/test_revised.py."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    c = rng.standard_normal((B, N))
    row_ub = x0 @ A.T + 0.3 + rng.random((B, M))
    return (A, c, np.full((B, M), -np.inf), row_ub, np.zeros((B, N)),
            np.full((B, N), 5.0))


def phase_revised_vs_cpu():
    from bensolve_tpu_torch.lp import revised

    for shape, dtype, tol in (((0, 6, 30, 8), np.float64, 1e-9),
                              ((11, 48, 320, 4), np.float32, 1e-3)):
        args = _tall_batch(*shape)
        card = revised.solve_batch_revised(*args, dtype=dtype, device="cuda")
        cpu = revised.solve_batch_revised(*args, dtype=dtype, device="cpu")
        if not (card.status == cpu.status).all():
            raise AssertionError(f"revised {shape}: status {card.status} on "
                                 f"the card, {cpu.status} on the CPU")
        ok = cpu.status == 1
        err = float(np.abs(card.obj[ok] - cpu.obj[ok]).max()) if ok.any() \
            else 0.0
        if not err <= tol * (1 + float(np.abs(cpu.obj[ok]).max())):
            raise AssertionError(f"revised {shape}: obj differs by {err:.2e}")
        log(f"[revised] M={shape[1]} N={shape[2]} B={shape[3]} "
            f"{np.dtype(dtype).name}: status equal on the card and the CPU "
            f"({int(ok.sum())} optimal), max |obj diff| {err:.1e} (limit "
            f"{tol:g}); pivots card {card.iters.tolist()} cpu "
            f"{cpu.iters.tolist()}")


def _highs_one(A, ci, rlb, rub, clb, cub):
    """One serial HiGHS solve with the full bound-type range (the
    recipe of bench.py::_highs_one: free rows dropped)."""
    from scipy.optimize import linprog

    eq = np.isfinite(rlb) & np.isfinite(rub) & (rlb == rub)
    ub_rows = np.isfinite(rub) & ~eq
    lb_rows = np.isfinite(rlb) & ~eq
    A_ub = np.concatenate([A[ub_rows], -A[lb_rows]])
    b_ub = np.concatenate([rub[ub_rows], -rlb[lb_rows]])
    return linprog(ci, A_ub=A_ub if A_ub.size else None,
                   b_ub=b_ub if b_ub.size else None,
                   A_eq=A[eq] if eq.any() else None,
                   b_eq=rub[eq] if eq.any() else None,
                   bounds=list(zip(clb, cub)), method="highs")


def _ipm_p2_template(dtype):
    """bench.py::make_p2_instances through the port: the P2 template of
    BASELINE config #4 with ipm_min=2000, and B synthetic frontier
    bounds."""
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template
    from bensolve_tpu_torch.examples import random_vlp

    cfg = IPM_CONFIG
    q = cfg["q"]
    vlp = random_vlp(**cfg)
    Z = np.eye(q)
    Z = Z / (Z.T @ np.full(q, 1.0 / q))[None, :]
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS, dtype=dtype, ipm_min=IPM_MIN,
                    device="cuda")
    rng = np.random.default_rng(cfg["seed"] + 1)
    V = rng.random((IPM_B, q)) * 2.0 + 1.0
    return t2, V @ t2.ZR


def _iteration_bound(M, Nc, B, dtype, needed=True):
    """(ms, bound_by, flops) of one iteration for B instances: the
    operations at the dtype's peak against the bytes (A read once, ~20
    (B, K) vectors read and written) at 3.35 TB/s.  Per instance, the
    work the iteration needs: M^2 Nc for the symmetric S = W W^T (a
    SYRK), M^3/3 for one Cholesky, 10 M^2 per direction for its three
    triangular-solve pairs and two refinement products, 16 M Nc for the
    G z / G^T y products.  ``needed=False`` counts the work the port
    does instead: S as a full GEMM (2 M^2 Nc) and the boosted Cholesky
    computed every iteration (the reference factors it only on a
    failure)."""
    K = Nc + M
    s_build, chol = ((M * M * Nc, M ** 3 / 3.0) if needed
                     else (2.0 * M * M * Nc, 2 * M ** 3 / 3.0))
    flops = B * (s_build + chol + 20.0 * M * M + 16.0 * M * Nc)
    item = np.dtype(dtype).itemsize
    nbytes = (M * Nc + 40 * B * K) * item
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


class _IPMClock:
    """Wraps ipm._ipm_core with synchronised host clocks around every
    segment, and (``split``) the S build, the Cholesky pair and the
    solves of _Core with CUDA events, summed per batch width."""

    def __init__(self, split=False):
        from bensolve_tpu_torch.lp import ipm

        self.ipm, self.split = ipm, split
        self.segments = []          # (batch rows, iterations, seconds)
        self.events = {"S build": [], "Cholesky x2": [], "solves": []}

    def __enter__(self):
        ipm, real = self.ipm, self.ipm._ipm_core
        self.real = real
        self.real_parts = (ipm._Core.normal_matrix, ipm._Core.factor,
                           ipm._Core.solve)

        def timed(A, c, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(A, c, *a, **kw)
            torch.cuda.synchronize()
            self.segments.append((c.shape[0], out[1],
                                  time.perf_counter() - t0))
            return out

        ipm._ipm_core = timed
        if self.split:
            def evented(key, fn):
                def run(*a, **kw):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = fn(*a, **kw)
                    e1.record()
                    self.events[key].append((e0, e1))
                    return out
                return run

            nm, fa, so = self.real_parts
            ipm._Core.normal_matrix = evented("S build", nm)
            ipm._Core.factor = staticmethod(evented("Cholesky x2", fa))
            ipm._Core.solve = staticmethod(evented("solves", so))
        return self

    def __exit__(self, *exc):
        self.ipm._ipm_core = self.real
        nm, fa, so = self.real_parts
        self.ipm._Core.normal_matrix = nm
        self.ipm._Core.factor = staticmethod(fa)
        self.ipm._Core.solve = staticmethod(so)

    def device_seconds(self):
        return sum(s for _, _, s in self.segments)

    def per_iteration_ms(self, B):
        """(ms per iteration, iterations) over the segments at width B."""
        its = sum(n for b, n, _ in self.segments if b == B)
        secs = sum(s for b, n, s in self.segments if b == B)
        return (secs / its * 1e3 if its else float("nan")), its

    def part_ms(self, iterations):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) / max(1, iterations)
                for k, v in self.events.items()}


def phase_ipm_config4():
    """bench.py's P2 round pattern at config #4's full width through the
    port's interior-point route, at float32 and float64, with the host
    HiGHS fallback capped at 0 LPs: each LP the reference would hand to
    it (ITLIM, or OPTIMAL at quality 1 or 2) is counted and keeps the
    device's answer, and up to two of them per dtype are held to HiGHS."""
    import os

    saved = os.environ.get("BENSOLVE_HOST_FALLBACK_MAX")
    os.environ["BENSOLVE_HOST_FALLBACK_MAX"] = "0"
    try:
        highs = None
        for dtype in ("float32", "float64"):
            highs = _ipm_rounds(dtype, highs)
    finally:
        os.environ.pop("BENSOLVE_HOST_FALLBACK_MAX", None)
        if saved is not None:
            os.environ["BENSOLVE_HOST_FALLBACK_MAX"] = saved


def _ipm_rounds(dtype, highs):
    """One dtype of phase 10: the cold solve and three warm rounds (each
    started from the template's carried interior point, as in the JAX
    package), then LPs 0-3 of the cold round and up to two LPs bound
    for the host against HiGHS (LPs 0-3 solved once, ``highs``)."""
    from bensolve_tpu_torch.lp import ipm, simplex

    t2, extra_ub = _ipm_p2_template(dtype)
    M, N = t2.A_lp.shape
    if dtype == "float32":
        log(f"[ipm] config #4: random_vlp({IPM_CONFIG}) P2 LP {M}x{N}, "
            f"B={IPM_B}, ipm_min={IPM_MIN}; host HiGHS fallback capped at "
            f"0 LPs (the reference's cap is 32, at 12-22 s per LP here)")
    loose = []
    for r in range(4):
        ub = extra_ub if r == 0 else extra_ub * (1.0 - 0.002 * r)
        calls = ipm.CALLS
        with _IPMClock(split=(r == 0)) as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = t2.solve(ub)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if ipm.CALLS == calls:
            raise AssertionError("config #4: the IPM route was not taken")
        host = np.flatnonzero((res.status == simplex.ITLIM)
                              | ((res.status == simplex.OPTIMAL)
                                 & (res.quality >= 1)))
        resolved = float(((res.status == simplex.OPTIMAL)
                          & (res.quality == 0)).mean())
        st = dict(zip(*np.unique(res.status, return_counts=True)))
        qu = dict(zip(*np.unique(res.quality, return_counts=True)))
        last = dict(ipm.LAST)
        Nc = N + int(np.sum(~np.isfinite(t2.col_lb)
                            & ~np.isfinite(t2.col_ub)))
        Bfull = 1 << (IPM_B // last["chunks"] - 1).bit_length()
        ms_it, n_it = clock.per_iteration_ms(Bfull)
        bound, bound_by, flops = _iteration_bound(M, Nc, Bfull, dtype)
        done, _, flops_done = _iteration_bound(M, Nc, Bfull, dtype,
                                               needed=False)
        name = "cold" if r == 0 else f"warm {r} (carried point)"
        met = resolved >= 0.9 and host.size <= 0.1 * IPM_B
        log(f"[ipm] {dtype} {name}: wall {wall:.2f} s, device "
            f"{clock.device_seconds():.2f} s in {len(clock.segments)} "
            f"segments (synchronised host clock); IPM iterations max "
            f"{int(res.iters.max())} median {np.median(res.iters):.0f}; "
            f"statuses {{{', '.join(f'{int(k)}: {int(v)}' for k, v in st.items())}}} "
            f"quality {{{', '.join(f'{int(k)}: {int(v)}' for k, v in qu.items())}}}; "
            f"polished {last['polished']} polish-skipped "
            f"{last['polish_skipped']}; chunks {last['chunks']}; bound for "
            f"the host fallback {host.size} LPs; quality 0 on the device "
            f"{resolved:.3f} of the batch: criterion (>= 0.9 resolved, "
            f"<= 10% to the host) {'met' if met else 'NOT MET'}; "
            f"{ms_it:.2f} ms per iteration at B={Bfull} over {n_it} "
            f"iterations; bound of the work needed {bound:.3f} ms "
            f"({bound_by}, {flops / 1e9:.0f} GFLOP at "
            f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s) = "
            f"{bound / ms_it:.3f} of it; of the work done (full GEMM for "
            f"S, both Choleskys) {done:.3f} ms ({flops_done / 1e9:.0f} "
            f"GFLOP) = {done / ms_it:.3f} of it")
        if r == 0:
            parts = clock.part_ms(sum(n for _, n, _ in clock.segments))
            log(f"[ipm] {dtype} cold, per iteration (CUDA events, all "
                f"widths): " + ", ".join(f"{k} {v:.2f} ms"
                                         for k, v in parts.items()))
            cold = res
            if dtype == "float32" and not met:
                # the one round where the JAX package's method resolves
                # the batch on the device (PERF.md, Findings)
                raise AssertionError(f"config #4 float32 cold: quality "
                                     f"{qu}, {host.size} LPs to the host")
        # an ITLIM LP has no answer: solve it on the host, as the
        # reference's fallback would, so the round ends all OPTIMAL
        itlim = np.flatnonzero(res.status == simplex.ITLIM)
        t0 = time.perf_counter()
        for i in itlim:
            obj, rlb, rub, clb, cub = t2.build_inputs(ub[i:i + 1])
            h = _highs_one(t2.A_lp, obj[0], rlb[0], rub[0], clb[0], cub[0])
            if h.status != 0:
                raise AssertionError(f"HiGHS LP {i}: {h.message}")
        if itlim.size:
            log(f"[ipm] {dtype} {name}: {itlim.size} ITLIM LPs solved by "
                f"scipy/HiGHS on the host in "
                f"{time.perf_counter() - t0:.2f} s")
        if ((res.status != simplex.OPTIMAL)
                & (res.status != simplex.ITLIM)).any():
            raise AssertionError(f"config #4 {dtype} {name}: statuses "
                                 f"{st}")
        want = 1 if dtype == "float32" else 2
        if last["chunks"] != want:
            raise AssertionError(f"config #4 {dtype}: {last['chunks']} "
                                 f"chunks, expected {want}")
        bound = host[res.status[host] == simplex.OPTIMAL]
        loose += [(name, i, ub, res) for i in bound[:2 - len(loose)]]
    # 4 LPs of the cold round and up to 2 loose LPs against scipy/HiGHS
    obj, rlb, rub, clb, cub = t2.build_inputs(extra_ub)
    if highs is None:
        t0 = time.perf_counter()
        highs = ([_highs_one(t2.A_lp, obj[i], rlb[i], rub[i], clb[i],
                             cub[i]) for i in range(4)],
                 (time.perf_counter() - t0) / 4)
    tol = 1e-3 if dtype == "float32" else 1e-6
    errs = []
    for i, h in enumerate(highs[0]):
        if h.status != 0:
            raise AssertionError(f"HiGHS LP {i}: {h.message}")
        errs.append(abs(cold.obj[i] - h.fun) / (1 + abs(h.fun)))
    if not max(errs) <= tol:
        raise AssertionError(f"config #4 {dtype}: obj differs from HiGHS "
                             f"by {max(errs):.2e} > {tol}")
    log(f"[ipm] {dtype}: cold objectives of LPs 0-3 within "
        f"{max(errs):.1e} of scipy/HiGHS relative (limit {tol:g}; "
        f"HiGHS {highs[1]:.2f} s per LP on the host)")
    for name, i, ub, res in loose:
        obj, rlb, rub, clb, cub = t2.build_inputs(ub[i:i + 1])
        h = _highs_one(t2.A_lp, obj[0], rlb[0], rub[0], clb[0], cub[0])
        if h.status != 0:
            raise AssertionError(f"HiGHS LP {i}: {h.message}")
        log(f"[ipm] {dtype} {name}: LP {i} (quality {int(res.quality[i])}"
            f", bound for the host) objective within "
            f"{abs(res.obj[i] - h.fun) / (1 + abs(h.fun)):.1e} of "
            f"scipy/HiGHS relative")
    return highs


def phase_ipm_e2e():
    """solve() through the interior-point route at float64."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.lp import ipm

    for name in ("example05", "example08", "example11"):
        calls = ipm.CALLS
        r, wall = _solve(name, _options(lp_ipm_min=1))
        if ipm.CALLS == calls:
            raise AssertionError(f"{name}: the IPM route was not taken")
        _report("ipm f64", name, r, wall, 1e-4)
        ref, wall_s = _solve(name, _options())
        dist = _sets_close(r.primal_points, ref.primal_points, 1e-6)
        log(f"[ipm f64] {name}: {ipm.CALLS - calls} IPM batched solves; "
            f"upper-image points within {dist:.1e} of the simplex route's "
            f"({len(ref.primal_points)} points, {wall_s:.2f} s; limit 1e-6)")
    q, m, n = IPM_VLP
    vlp = examples.random_vlp(q=q, m=m, n=n)
    h0, calls = ipm.HOST_FALLBACK, ipm.CALLS
    r, wall = _solve(None, _options(lp_ipm_min=IPM_VLP_MIN), vlp=vlp)
    _report("ipm f64", f"random_vlp(q={q}, m={m}, n={n}) lp_ipm_min="
            f"{IPM_VLP_MIN}", r, wall, 1e-4)
    log(f"[ipm f64] P2 LP {m + 2 * q + 1}x{n + q + 1}: {ipm.CALLS - calls} "
        f"IPM batched solves, host fallback {ipm.HOST_FALLBACK - h0} LPs")


def _ipm_batch(M, N, B, seed):
    """The random-LP recipe of tests/test_ipm.py::random_lp."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = x0 @ A.T + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    return (A, c, np.full((B, M), -np.inf), b, np.zeros((B, N)),
            np.full((B, N), 10.0))


def phase_ipm_vs_cpu():
    from bensolve_tpu_torch.lp import ipm

    for shape, dtype, tol in (((24, 40, 4, 0), np.float64, 1e-9),
                              ((32, 64, 4, 11), np.float32, 1e-3)):
        args = _ipm_batch(*shape)
        if dtype == np.float32:
            args = tuple(np.asarray(a, np.float32) for a in args)
        card = ipm.solve_batch_ipm(*args, dtype=dtype, device="cuda")
        cpu = ipm.solve_batch_ipm(*args, dtype=dtype, device="cpu")
        if not (card.status == cpu.status).all():
            raise AssertionError(f"ipm {shape}: status {card.status} on the "
                                 f"card, {cpu.status} on the CPU")
        ok = cpu.status == 1
        err = float(np.abs(card.obj[ok] - cpu.obj[ok]).max()) if ok.any() \
            else 0.0
        if not err <= tol * (1 + float(np.abs(cpu.obj[ok]).max())):
            raise AssertionError(f"ipm {shape}: obj differs by {err:.2e}")
        log(f"[ipm vs cpu] M={shape[0]} N={shape[1]} B={shape[2]} "
            f"{np.dtype(dtype).name}: status equal ({int(ok.sum())} "
            f"optimal), max |obj diff| {err:.1e} (limit {tol:g}); "
            f"iterations card {card.iters.tolist()} cpu {cpu.iters.tolist()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    phase_environment()
    only = _only(sys.argv[1:])
    if only is not None:
        for k in only:
            PHASES[k]()
        return 0
    phase_build()
    ex10, ex10_w, glob = phase_kernel()
    launches = phase_main_f32()
    launches_large = phase_large_f32()
    primal = phase_main_f64()
    phase_dual_f64(primal)
    launches_dual = phase_dual_f32()
    phase_tall()
    phase_revised_vs_cpu()
    phase_ipm_config4()
    phase_ipm_e2e()
    phase_ipm_vs_cpu()
    log(smi_line())
    common = {"route": "cuda", "source": KERNEL_SOURCE,
              "replaces": KERNEL_REPLACES, "plain_ms": ex10["plain_ms"],
              "bound_ms": ex10["bound_ms"], "bound_by": ex10["bound_by"],
              "library_ms": None}
    log(json.dumps({"kernels": [
        dict(name="group_simplex_cluster", **common,
             launches=launches["cluster"],
             launches_dual_f32=launches_dual["cluster"],
             cluster_size=ex10["C"], max_abs_err=ex10["err"],
             ms=ex10["ms"], ms_warm=ex10_w["ms"]),
        dict(name="group_simplex_global", **common,
             launches=launches_large["global"],
             launches_f32_examples=launches["global"],
             launches_dual_f32=launches_dual["global"],
             max_abs_err=max(ex10["err_global"], glob["err"]),
             ms=ex10["ms_global"], ms_warm=ex10_w["ms_global"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = {"2": phase_build, "3": phase_kernel, "4": phase_main_f32,
          "5": phase_main_f64, "7": phase_dual_f32, "8": phase_tall,
          "9": phase_revised_vs_cpu, "10": phase_ipm_config4,
          "11": phase_ipm_e2e,
          "12": phase_ipm_vs_cpu}


def _only(argv):
    """The phases named after --only, or None without the flag."""
    if not argv:
        return None
    if argv[0] != "--only" or not set(argv[1:]) <= set(PHASES):
        raise SystemExit(f"usage: chip_smoke.py [--only PHASE ...] with "
                         f"PHASE in {sorted(PHASES)}")
    return argv[1:]


if __name__ == "__main__":
    sys.exit(main())
