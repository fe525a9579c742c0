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
   of pricing passes and rank-1 updates on the LP's unpadded tableau
   (M rows, N + M columns); the same at the bench's device
   shape (one launch: the first 256 of bench.make_instances(96, 96,
   4096), Mp=96, NT=256, C=1);
4. the main path at float32 (the kernel's route): solve() on example01,
   05, 08 and 10, with the launch counts of both variants reset just
   before and read just after (per example), the kernel's share of the
   phase wall, and the support-function oracle at 1e-3; example10's
   float32 extreme directions against phase 5's float64 ones (phase 5
   runs first): the worst angle either way, and the float32 ones farther
   than F32_DIR_DEG, printed, and every float32 direction in the cone of
   the float64 ones (NNLS residual at most 1e-4; ROADMAP Queue 3 m);
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
   interior point at float32, the cold solve and one warm round at
   float64 (its rounds 2 and 3 were cut to keep the script inside its
   time limit: they took 68 s and up to 144 s of host HiGHS).  The host
   HiGHS fallback is capped at 0 LPs (the reference's 32 would take
   12-22 s per LP):
   the LPs it would take are counted, ITLIM ones solved by HiGHS here,
   and up to two loose ones per dtype held to HiGHS.  Per round: wall
   and device seconds, IPM iterations, statuses, quality, polish, the
   LPs bound for the host, whether the round meets the criterion of
   >= 90% resolved on the device and <= 10% to the host, chunks; ms per
   iteration of the full batch beside the bounds of the work needed and
   of the work done, and its split into the S build, the two Choleskys
   and the solves; LPs 0-3 held to scipy/HiGHS (1e-3 relative at
   float32, 1e-6 at float64).  These HiGHS solves run in two worker
   processes while the rounds go on.  Fails unless every LP ends
   OPTIMAL and the
   float32 cold round meets the criterion (the warm rounds and float64
   do not meet it in the JAX package either: PERF.md, Findings);
11. solve() through the interior-point route at float64: example05, 08
   and 11 with lp_ipm_min=1 (the oracle at 1e-4, upper-image points
   within 1e-6 of the simplex route's), then random_vlp(q=2, m=150,
   n=300) with lp_ipm_min=450 (its P2 LP 155x303 takes the route; m and
   n halved from 300 and 600, which took 293 s);
12. the interior-point method on the card against the CPU on the random
   batches of tests/test_ipm.py (float64 to 1e-9, float32 to 1e-3);
13. many VLPs in lockstep at BASELINE config #5's scale: 10,000
   instances random_vlp(q=3, m=10, n=8, seed=s) at float64 through
   algs.many.solve_many (bounded=True), every Benson round one merged
   batch of per-instance-matrix LPs (P2 LP 17x12) through the 3-D
   tableau path.  Gates: every status OPTIMAL; 32 instances spread over
   the range equal to the serial solve() on the card within 1e-7 and
   the oracle at 1e-6; the first 64 instances on the card and on the
   CPU with equal LP and round counts and vertex sets within 1e-7; the
   largest round re-solved at max_chunk 2,048, 16,384 and 65,536 (256
   was cut for time) with identical status, iters and basis per LP.  Printed: instances/s,
   LPs/s, LPs, rounds, chunked device solves, the seconds of
   _merged_solve split into host stacking/padding/upload, device solve
   and read-back (synchronised host clock) against the host polytope
   work, and the max_chunk times.  Then three shapes x 200 instances
   through the per-group threads, 6 of them equal to serial;
14. the run-time modules on the card: checkpoint_path on example10 at
   float64, then resume= from the last snapshot to the uninterrupted
   run's vertex set within 1e-7; distributed=True on one process on
   example05 equal to the plain solve, with the oracle at 1e-7;
   profile_dir leaves a Chrome trace that holds CUDA kernel events;
15. the device mesh (parallel/mesh.py) over MESH_N = 4 entries of
   cuda:0, each shard on its own thread and CUDA stream (the sharded
   solves, threads and streams are counted): example05 at float64 with
   mesh_axes=("dp",) (oracle 1e-4, upper image equal to its unsharded
   run's within 1e-6, counts and wall beside it; example10 took 132-218
   s over the mesh); example05 at float32
   (oracle 1e-3; the kernel's launch counts unchanged, since a meshed
   batch never reaches the kernel; example10 at float32 took 379 s over
   the mesh, past the time limit); config #5 through solve_many(mesh=)
   (all OPTIMAL, 740,232 LPs in 15 rounds, every instance with phase
   13's LP and round counts, 32 instances' vertex sets within 1e-7 of
   phase 13's, rates beside phase 13's, peak device memory); phase 13's
   heterogeneous run with the mesh (its groups on entry g % 4, every
   instance with phase 13's counts and vertex set within 1e-7); then the
   "tp" column split (every LP cut into column panels, one per tp entry,
   parallel/mesh.py): example05 at float64 over ("tp",) x 4, its point
   sets within 1e-7 of its unsharded run's; BASELINE config #4's P2 LPs
   (random_vlp(q=5, m=1000, n=2000, seed=7), LP 1011x2006, MESH_TP_B of
   them, the arrays of bench.make_p2_instances) at float64 through
   simplex.solve_batch, unsharded and over ("tp",) x 4 in turn, each cut
   at MESH_TP_STEPS pivot steps (every LP then ITLIM at the basis it
   reached): statuses equal, objectives within 1e-9 relative, the LPs
   whose pivot counts or bases differ printed, ms per pivot step of both
   and each panel's bytes; a
   tall random_vlp(q=2, m=25, n=250) through the revised simplex over
   ("tp",) x 4 and over ("dp", "tp") = 2 x 2, each split asserted and its
   upper image within 1e-6 of its unsharded run's (cut from phase 8's
   m=50, n=500, which took 80 s over the mesh); with more than one card,
   example05 over the cards.  Each check is a gate, counted on the
   [total] line;
16. the port's bench (python -m bensolve_tpu_torch.bench) in a process
   of its own with every stage, at reduced depth where a stage repeats
   an earlier phase (BENCH_ARGS: p2 one warm round and no HiGHS, many
   at 1,000 instances, tall random_vlp(q=2, m=25, n=250)): it exits 0,
   its result line parses and holds every key of the repo's bench.py
   line, and its device stage launched the cluster kernel;
17. the large-example harness (bensolve_tpu_torch.slow_runner, with
   tests/witness_large_shapes.py): example10 through the runner at its
   defaults (OPTIMAL with the JAX package's recorded counts, 3,060 LPs,
   15 rounds, 1,368 points, 3 directions, its oracle verdict pass@1e-4,
   and tests/test_e2e_large.py's criteria: more than 500 points, 3
   directions, 16 samples at 1e-4); the ex07 flags (float32, eps 0.05,
   lp_ipm_min 2000) end to end on random_vlp(2, 20, 2000, seed=7), cut
   from ex07's shape, random_vlp(3, 1211, 1143), which took 778 s
   (OPTIMAL, oracle at 0.05); one phase-2 round of ex09's shape, B = 8 LPs
   4615x36943 of random_vlp(3, 4608, 36939, seed=7) at float32 under
   CONFIGS["ex09"]'s environment (every LP called OPTIMAL held to its
   float64 certificates at 1e-2, ms per iteration split into the S build,
   the Cholesky pair and the solves beside the S build's bound, peak
   device memory).  No LP goes to host HiGHS: the ex07 flow runs with the
   fallback off (its ITLIM LPs go to the IPM's rescue pass and float64
   simplex fallback on the device; capped at 0 they stay ITLIM and the
   Benson loop gives up on them) and the ex09 round with it capped at 0;
   the LPs bound for it are printed; the ex07 flow's IPM seconds split
   into four disjoint terms (the top-level calls, the rescue IPM, the
   simplex nested in the rescue pass, the simplex after it), with their
   LPs and those the rescue IPM resolved itself;
18. the driver entry (bensolve_tpu_torch.graft_entry, the port of the
   repo-root __graft_entry__.py): entry() on the card, timed by CUDA
   events, against the same solve on the CPU (status, iterations and
   basis equal, objective within 1e-5 relative); dryrun_multichip(n)
   for n = 1, 2, 4, 8 over entries of cuda:0 (("dp", "tp") for n >= 4),
   every sharded solve of its three steps against the port's own
   unsharded solve of the same batch on the card (status, iterations
   and basis equal); the kernel's launch counts unchanged over the
   phase (the path runs the torch tableau loop); per n the mesh's shape
   and wall on a {"graft": ...} line before the kernels line;
19. the result lines.

The second-to-last line is one JSON object with the kernel's two
variants (name, route, source, the TPU kernel it replaces, launches on
its main path: the examples of phase 4 for the cluster variant, the
large VLP of phase 4 for the global one; launches_dual_f32 in phase 7;
launches_bench_device in phase 16's device stage; max |obj kernel -
plain|, kernel, plain and bound times at example10's P2 shape, cold,
and the kernel's time warm; the same at the bench's device shape under
bench_shape); the line before it is phase 18's {"graft": ...}; the
last line is {"ok": true, "device": {...}}.  Any
failed phase raises and exits non-zero before those lines.  Without a
CUDA device, or without the package beside this
script, it exits non-zero and prints no result.

``--only 10 12`` runs just the named phases after phase 1 and prints no
result lines (for iterating on one phase); ``--only 15`` first makes the
unsharded runs of phase 13 that the mesh phase holds its own to.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bensolve_tpu_torch.bench import (F32_KW, MANY_LPS, MANY_ROUNDS,
                                      P2_IPM_MIN, check_support,
                                      highs_one, host_fallback_cap,
                                      images_close, make_instances,
                                      make_p2_instances, smi_line)

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
IPM_WARM_ROUNDS = {"float32": 3, "float64": 1}
# LPs of the cold round, and at most this many LPs bound for the host
# per dtype, held to HiGHS (~18 s each on the host, in HIGHS_WORKERS
# processes beside the rounds)
IPM_HIGHS_LPS = 4
IPM_LOOSE_MAX = 2
HIGHS_WORKERS = 2
# the interior-point phase's mid-size VLP: random_vlp(q, m, n), whose P2
# LP (m+2q+1) x (n+q+1) has M + N >= IPM_VLP_MIN
IPM_VLP = (2, 150, 300)
IPM_VLP_MIN = 450
# BASELINE config #5 (scale_many.py): N instances random_vlp(**MANY_VLP,
# seed=s), bounded, float64; the max_chunk settings compared on the
# largest merged round; the heterogeneous run's shapes (q, m, n) and
# seed offsets, tests/test_many.py's, HETERO_N instances of each
MANY_N = 10_000
MANY_VLP = dict(q=3, m=10, n=8)
# instances held to the serial solve()
MANY_SERIAL = 32
# 256 (78.5 s on the largest round on an H100, where the whole script
# took 1,111 s with it) was cut to keep the script well inside its time
# limit; 2,048 still splits the round into 75 chunks
MANY_CHUNKS = (2048, 16384, 65536)
HETERO = (((2, 6, 5), 0), ((3, 10, 8), 100), ((2, 4, 9), 200))
HETERO_N = 200
# the mesh phase: entries of one card per mesh (each on a stream of its
# own); its float64 and float32 examples (example10 over the mesh took
# 132-218 s at float64 and 379 s at float32 on an H100) and its tall VLP
# (phase 8's m=50, n=500 took 80 s over the mesh), cut to keep the
# script inside its time limit; config #5, the heterogeneous run and the
# tall VLP keep the mesh's paths covered
MESH_N = 4
MESH_F64_EXAMPLE = "example05"
MESH_F32_EXAMPLE = "example05"
MESH_TALL = (2, 25, 250)
# config #4's P2 LPs solved by the tableau simplex over ("tp",) x MESH_N
# (a (8, 1024, 3072) float64 tableau, 201 MB, ~50 MB per panel), cut to
# MESH_TP_STEPS pivot steps each way: solved to the end they took 33,407
# steps, 113 s unsharded and 382 s over the mesh on an H100
MESH_TP_B = 8
MESH_TP_STEPS = 2000
# the bench's device stage: make_instances(M, N, B), 16 launches of 256
BENCH_LPS = (96, 96, 4096)
# phase 16: bensolve_tpu_torch.bench with every stage, at reduced depth
# where a stage repeats an earlier phase (p2: phase 10; many: phase 13;
# tall: phase 8)
BENCH_ARGS = ("--p2-warm", "1", "--highs-k", "0", "--many", "1000",
              "--tall", "2", "25", "250")
BENCH_TIMEOUT_S = 600
# phase 17: example10 through the runner, held to the JAX package's
# record of it (SLOW_RESULTS.md); the ex07 flow's random VLP and the
# ex09-shape round (q, m, n, B), both with seed 7
RUNNER_EX10 = dict(status="OPTIMAL", lps=3060, rounds=15, points=1368,
                   directions=3, support="pass@0.0001")
# the ex07 flow at its full shape, random_vlp(3, 1211, 1143), took 778 s
# on an H100 (tests/witness_large_shapes.py; PERF.md), random_vlp(3, 20,
# 2000) 234 s and random_vlp(3, 300, 1700) more than 330 s: three
# objectives need thousands of LPs at eps 0.05, and the IPM's stragglers
# go to its rescue pass and float64 simplex fallback.  Two objectives
# keep the flags, the environment and the interior-point route (LP
# 25x2003, M + N >= 2000) at 74 LPs.
LARGE_EX07 = (2, 20, 2000)
LARGE_EX09 = (3, 4608, 36939, 8)
# phase 18: the mesh sizes of graft_entry.dryrun_multichip (the JAX
# package's records, MULTICHIP_r0*.json, ran n = 8)
GRAFT_NS = (1, 2, 4, 8)
GRAFT_OBJ_RTOL = 1e-5
# published H100 SXM peaks (float32 without TF32; float64 tensor cores)
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
HBM_BYTES_PER_S = 3.35e12
# angle (degrees) within which an extreme direction found at float32
# counts as a copy of a float64 one (phase 4 on example10): the CPU's
# float32 routes list near-copies of the true directions (2.7e-5 to
# 5.5e-5 deg off), the card also a direction farther off inside the
# true recession cone (ROADMAP Queue 3 m); phase 4 prints them
F32_DIR_DEG = 1e-2
# phase 4's gate: every float32 direction d in the cone of the float64
# ones R, the nonnegative least-squares residual of R^T l = d/|d| at
# most this
F32_CONE_RESIDUAL = 1e-4


# results of earlier phases that the mesh phase holds its runs to; a
# phase run alone (--only) computes what it lacks
_RESULTS = {}


def log(*args):
    print(*args, flush=True)


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


def _bound_ms(inputs, work, M, N):
    """The least time the card could take for this batch of M x N LPs:
    every input read once and every output written once at 3.35 TB/s,
    against the flops this run's data needs at the 67 TFLOP/s float32
    peak (2 M (N+M) on the LP's unpadded tableau for each of the initial
    xb and d2 sums, each pricing pass and each rank-1 update, from the
    kernel's own counts).  (ms, bound_by, mean loop steps, pricing-pass
    share of the steps)."""
    B = inputs[1].shape[0]
    NT = N + M
    steps, passes, pivots = work.cpu().numpy().astype(np.int64).T
    nbytes = (M * NT * 4 + B * NT * (3 * 4 + 1) + M * 4
              + B * (4 + M * 4 + NT + 4))
    flops = 2.0 * M * NT * float((2 + passes + pivots).sum())
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
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    st_p, basis_p, atup_p, it_p = gs.solve_batch_group_reference(
        *inputs["a"], group=1)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
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
            inputs["a"], work, *args[0].shape)
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
    # the plain version's torch ops need no warm-up: where one call is
    # enough, it is the call made for the comparison above
    out["plain_ms"] = (plain_ms if reps < 8 else _time_ms(
        lambda: gs.solve_batch_group_reference(*inputs["a"], group=1),
        reps // 4))
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
    numbers at example10's P2 shape, cold and warm, the global variant's
    obj error at its own shape, and the numbers at the bench's device
    shape (one launch of 256 of its LPs)."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    small = make_instances(16, 16, 8, 0)
    cold = gs.lp_batch_group(*small, device="cuda")
    i0 = int(np.flatnonzero(cold.status == 1)[0])
    _compare("M=N=16 cold", small, None, 20)
    _compare("M=N=16 shared warm", small,
             (cold.basis[i0], cold.at_upper[i0]), 20)
    for M, B in ((160, 16), (200, 16), (500, 8)):
        _compare(f"M=N={M} cold", make_instances(M, M, B, 0), None, 3)
    glob = _compare("M=N=700 cold", make_instances(700, 700, 4, 0), None, 1)
    big = make_instances(*EX10_P2, 256, 1)
    assert gs.padded_shape(*EX10_P2) == (384, 768)
    ex10 = _compare("ex10 P2 shape cold", big, None, 3, ab=True)
    warm = gs.lp_batch_group(*big, device="cuda")
    j0 = int(np.flatnonzero(warm.status == 1)[0])
    ex10_w = _compare("ex10 P2 shape shared warm", big,
                      (warm.basis[j0], warm.at_upper[j0]), 3, ab=True)
    # one launch of the bench's device stage: its first 256 LPs
    A, *rest = make_instances(*BENCH_LPS)
    bench = (A,) + tuple(x[:256] for x in rest)
    assert gs.padded_shape(*BENCH_LPS[:2]) == (96, 256)
    bench_shape = _compare("bench device shape cold (first 256 LPs)", bench,
                           None, 10, ab=True)
    return ex10, ex10_w, glob, bench_shape


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
    _f32_directions(runs[-1][1])
    if kept_devices != {"cuda"}:
        raise AssertionError(f"kept tableau devices {kept_devices}")
    log(f"[main f32] kept tableau device: {sorted(kept_devices)}")
    return clock.report("main f32", sum(w for _, _, w in runs))


def _direction_angles(dirs, ref):
    """Degrees from each direction to the nearest of ``ref``."""
    if not len(dirs):
        return np.zeros(0)
    u = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    v = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    return np.degrees(np.arccos(np.clip((u @ v.T).max(axis=1), -1, 1)))


def _f32_directions(r):
    """How example10's extreme directions at float32 lie against the
    float64 ones (phase 5's run): the angle from each to the nearest
    float64 direction, those farther than F32_DIR_DEG, and the angle from
    each float64 direction to the nearest float32 one, printed; the
    gate: every float32 direction in the cone of the float64 ones (NNLS
    residual at most F32_CONE_RESIDUAL).  A far direction inside the
    cone is a redundant generator of the right image (ROADMAP Queue 3
    m); one outside it would be a wrong image."""
    from scipy.optimize import nnls

    if "main f64" not in _RESULTS:
        _RESULTS["main f64"] = _solve("example10", _options())
    ref = _RESULTS["main f64"][0].primal_directions
    got = r.primal_directions
    to_ref, from_ref = _direction_angles(got, ref), _direction_angles(ref,
                                                                      got)
    far = [f"{np.round(d, 6).tolist()} {a:.3g} deg"
           for d, a in zip(got, to_ref) if a > F32_DIR_DEG]
    log(f"[main f32] example10: {len(got)} extreme directions at float32, "
        f"{len(ref)} at float64; float32 to the nearest float64 one: worst "
        f"{to_ref.max(initial=0):.3g} deg, {len(far)} farther than "
        f"{F32_DIR_DEG:g} deg{': ' + '; '.join(far) if far else ''}; "
        f"float64 to the nearest float32 one: worst "
        f"{from_ref.max(initial=0):.3g} deg")
    cone = (ref / np.linalg.norm(ref, axis=1, keepdims=True)).T
    resid = [nnls(cone, d / np.linalg.norm(d))[1] for d in got]
    worst = max(resid, default=0.0)
    log(f"[main f32] example10: every float32 direction in the cone of the "
        f"float64 ones: worst NNLS residual {worst:.1e} (limit "
        f"{F32_CONE_RESIDUAL:g})")
    if not worst <= F32_CONE_RESIDUAL:
        raise AssertionError(f"example10 float32: a direction lies outside "
                             f"the float64 recession cone (NNLS residual "
                             f"{worst:.2e})")


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
    _RESULTS["main f64"] = (r, wall)
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
    gap = images_close(rp, rd, 1e-6)
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


def _highs_timed(*args):
    """highs_one(*args) and its seconds (in a worker process)."""
    t0 = time.perf_counter()
    return highs_one(*args), time.perf_counter() - t0


def _ipm_p2_template(dtype):
    """bench.py::make_p2_instances through the port: the P2 template of
    BASELINE config #4 with ipm_min=2000, and B synthetic frontier
    bounds."""
    return make_p2_instances(IPM_B, **IPM_CONFIG, dtype=dtype, device="cuda")


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
    device's answer, and up to IPM_LOOSE_MAX of them per dtype are held
    to HiGHS.  The HiGHS solves run in HIGHS_WORKERS processes of their
    own while the rounds go on."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with host_fallback_cap(0), ProcessPoolExecutor(
            HIGHS_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        highs = None
        for dtype in ("float32", "float64"):
            highs = _ipm_rounds(dtype, highs, pool)


def _ipm_rounds(dtype, highs, pool):
    """One dtype of phase 10: the cold solve and IPM_WARM_ROUNDS[dtype]
    warm rounds (each started from the template's carried interior
    point, as in the JAX package), then the first IPM_HIGHS_LPS LPs of
    the cold round and up to IPM_LOOSE_MAX LPs bound for the host against
    HiGHS.  The HiGHS solves go to ``pool`` as soon as their inputs are
    known; the cold round's are submitted once (``highs``: their
    futures) and serve both dtypes."""
    from bensolve_tpu_torch.lp import ipm, simplex

    t2, extra_ub = _ipm_p2_template(dtype)
    M, N = t2.A_lp.shape
    if highs is None:
        obj, rlb, rub, clb, cub = t2.build_inputs(extra_ub)
        highs = [pool.submit(_highs_timed, t2.A_lp, obj[i], rlb[i], rub[i],
                             clb[i], cub[i]) for i in range(IPM_HIGHS_LPS)]
    if dtype == "float32":
        log(f"[ipm] config #4: random_vlp({IPM_CONFIG}) P2 LP {M}x{N}, "
            f"B={IPM_B}, ipm_min={P2_IPM_MIN}; host HiGHS fallback capped at "
            f"0 LPs (the reference's cap is 32, at 12-22 s per LP here)")
    loose = []
    for r in range(1 + IPM_WARM_ROUNDS[dtype]):
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
            h = highs_one(t2.A_lp, obj[0], rlb[0], rub[0], clb[0], cub[0])
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
        for i in bound[:IPM_LOOSE_MAX - len(loose)]:
            obj, rlb, rub, clb, cub = t2.build_inputs(ub[i:i + 1])
            loose.append((name, i, res, pool.submit(
                _highs_timed, t2.A_lp, obj[0], rlb[0], rub[0], clb[0],
                cub[0])))
    # the first LPs of the cold round and the loose LPs against HiGHS
    t0 = time.perf_counter()
    done = [f.result() for f in highs]
    tol = 1e-3 if dtype == "float32" else 1e-6
    errs = []
    for i, (h, _) in enumerate(done):
        if h.status != 0:
            raise AssertionError(f"HiGHS LP {i}: {h.message}")
        errs.append(abs(cold.obj[i] - h.fun) / (1 + abs(h.fun)))
    if not max(errs) <= tol:
        raise AssertionError(f"config #4 {dtype}: obj differs from HiGHS "
                             f"by {max(errs):.2e} > {tol}")
    log(f"[ipm] {dtype}: cold objectives of LPs 0-{IPM_HIGHS_LPS - 1} within "
        f"{max(errs):.1e} of scipy/HiGHS relative (limit {tol:g}; "
        f"HiGHS {np.mean([t for _, t in done]):.2f} s per LP in its "
        f"process)")
    for name, i, res, fut in loose:
        h, _ = fut.result()
        if h.status != 0:
            raise AssertionError(f"HiGHS LP {i}: {h.message}")
        log(f"[ipm] {dtype} {name}: LP {i} (quality {int(res.quality[i])}"
            f", bound for the host) objective within "
            f"{abs(res.obj[i] - h.fun) / (1 + abs(h.fun)):.1e} of "
            f"scipy/HiGHS relative")
    log(f"[ipm] {dtype}: {time.perf_counter() - t0:.2f} s waited for the "
        f"HiGHS processes after the rounds")
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


def _point_sets_equal(a, b, tol, what):
    """Both results OPTIMAL with equally many upper-image points, each
    within tol (max norm) of one of the other's; returns the distance."""
    if a.status.name != "OPTIMAL" or b.status.name != "OPTIMAL":
        raise AssertionError(f"{what}: status {a.status} / {b.status}")
    if a.primal_points.shape != b.primal_points.shape:
        raise AssertionError(f"{what}: {len(a.primal_points)} points "
                             f"against {len(b.primal_points)}")
    return _sets_close(a.primal_points, b.primal_points, tol)


class _ManyClock:
    """Synchronised host clocks around the many-VLP engine's stages:
    _merged_solve as a whole, inside it the device solve of every chunk
    (simplex._solve_tableau_segmented) and the read-back
    (simplex._to_result), and beside it the host stages of a round.
    Also keeps the inputs of the largest merged round.  For one
    lockstep group: the clocks are not thread-safe."""

    def __init__(self):
        from bensolve_tpu_torch.algs import many
        from bensolve_tpu_torch.lp import simplex

        self.many, self.simplex = many, simplex
        self.seconds = {k: 0.0 for k in (
            "merged", "device", "readback", "gather", "apply", "finish")}
        self.chunks = 0
        self.batches = []       # LPs per merged round
        self.largest = None     # (args, kw) of the largest round

    def _timed(self, key, fn, sync=False):
        def run(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t0
            return out
        return run

    def __enter__(self):
        many, sx = self.many, self.simplex
        self.real = {(many, n): getattr(many, n) for n in (
            "_merged_solve", "_gather_round_requests",
            "_apply_round_results", "_finish_instance")}
        self.real.update({(sx, n): getattr(sx, n) for n in (
            "_solve_tableau_segmented", "_to_result", "solve_batch")})
        many._merged_solve = self._timed("merged", many._merged_solve, True)
        many._gather_round_requests = self._timed(
            "gather", many._gather_round_requests)
        many._apply_round_results = self._timed(
            "apply", many._apply_round_results)
        many._finish_instance = self._timed("finish", many._finish_instance)
        segmented = self._timed("device", sx._solve_tableau_segmented, True)

        def counted(*a, **kw):
            self.chunks += 1
            return segmented(*a, **kw)

        sx._solve_tableau_segmented = counted
        sx._to_result = self._timed("readback", sx._to_result, True)
        real_solve = sx.solve_batch

        def recorded(*a, **kw):
            B = a[1].shape[0]
            if not self.batches or B > max(self.batches):
                self.largest = (a, kw)
            self.batches.append(B)
            return real_solve(*a, **kw)

        sx.solve_batch = recorded
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.real.items():
            setattr(mod, name, fn)


def _many_chunk_comparison(clock):
    """The largest merged round at each max_chunk, timed with a
    synchronised host clock (largest chunk first, and once more at the
    end for the spread): status, iters and basis per LP must not depend
    on the chunk."""
    from bensolve_tpu_torch.lp import simplex

    args, kw = clock.largest
    B = args[1].shape[0]
    order = sorted(MANY_CHUNKS, reverse=True)
    ref, lines = None, []
    for k in order + order[:1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simplex.solve_batch(*args, **dict(kw, max_chunk=k))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if ref is None:
            ref = res
        for f in ("status", "iters", "basis"):
            if not (getattr(res, f) == getattr(ref, f)).all():
                raise AssertionError(f"many: {f} at max_chunk {k} differs "
                                     f"from max_chunk {order[0]}")
        lines.append(f"{k}: {secs:.3f} s, {B / secs:.0f} LPs/s in "
                     f"{-(-B // k)} chunks")
    if not (ref.status == simplex.OPTIMAL).all():
        raise AssertionError("many: the recorded round is not all OPTIMAL")
    log(f"[many] max_chunk on the largest round ({B} LPs, pivots max "
        f"{int(ref.iters.max())} mean {ref.iters.mean():.1f}; status, iters "
        f"and basis identical per LP): " + "; ".join(lines)
        + f"; the 3-D default is {simplex.MAX_CHUNK_3D}")


def phase_many():
    """BASELINE config #5 through algs.many.solve_many on the card."""
    from bensolve_tpu_torch import examples, solve
    from bensolve_tpu_torch.algs import many
    from bensolve_tpu_torch.vlp.options import Options

    n_inst = MANY_N
    t0 = time.perf_counter()
    vlps = [examples.random_vlp(**MANY_VLP, seed=s) for s in range(n_inst)]
    t_make = time.perf_counter() - t0
    opt = Options(bounded=True, write_files=False, device="cuda")
    with _ManyClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = many.solve_many(vlps, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    bad = [i for i, r in enumerate(rs) if r.status.name != "OPTIMAL"]
    if bad:
        raise AssertionError(f"many: {len(bad)} of {n_inst} instances not "
                             f"OPTIMAL (first {bad[0]}: {rs[bad[0]].status})")
    lps = sum(r.stats.lps for r in rs)
    rounds = max(r.stats.rounds for r in rs)
    _RESULTS["many"] = (vlps, rs, wall)
    sec = clock.seconds
    stack = sec["merged"] - sec["device"] - sec["readback"]
    setup = wall - sum(sec[k] for k in ("merged", "gather", "apply",
                                        "finish"))
    log(f"[many] config #5: {n_inst} x random_vlp({MANY_VLP}) float64 "
        f"bounded, made in {t_make:.2f} s; all OPTIMAL in {wall:.2f} s = "
        f"{n_inst / wall:.1f} instances/s, {lps / wall:.0f} LPs/s; "
        f"{lps} LPs, {rounds} lockstep rounds (+ the seed round), "
        f"{len(clock.batches)} merged batches (largest "
        f"{max(clock.batches)} LPs) in {clock.chunks} chunked device "
        f"solves; points {sum(len(r.primal_points) for r in rs)} pivots "
        f"{sum(r.stats.pivots for r in rs)}")
    log(f"[many] _merged_solve {sec['merged']:.2f} s (synchronised host "
        f"clock) = host stacking, padding and upload {stack:.2f} s + "
        f"device solve {sec['device']:.2f} s + read-back "
        f"{sec['readback']:.2f} s; host polytope work: gathering the "
        f"frontiers {sec['gather']:.2f} s, applying the cuts "
        f"{sec['apply']:.2f} s, epilogue {sec['finish']:.2f} s, instance "
        f"set-up and the rest {setup:.2f} s; device solve "
        f"{sec['device'] / wall:.3f} of the wall, host "
        f"{1 - sec['device'] / wall:.3f}")
    _many_chunk_comparison(clock)

    # instances spread over the range against the serial solve()
    picks = sorted({int(i) for i in np.linspace(0, n_inst - 1,
                                                MANY_SERIAL)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst, gap = 0.0, 0.0
    for i in picks:
        serial = solve(vlps[i], opt)
        worst = max(worst, _point_sets_equal(rs[i], serial, 1e-7,
                                             f"many instance {i}"))
        gap = max(gap, check_support(rs[i], 1e-6))
    log(f"[many] {len(picks)} instances spread over the range: vertex sets "
        f"within {worst:.1e} of the serial solve() on the card (limit "
        f"1e-7), support oracle worst gap {gap:.1e} (limit 1e-6); "
        f"{time.perf_counter() - t0:.2f} s")

    # the first 64 instances on the card against the CPU
    t0 = time.perf_counter()
    cpu = many.solve_many(vlps[:64], Options(bounded=True, write_files=False,
                                             device="cpu"))
    t_cpu = time.perf_counter() - t0
    worst = 0.0
    for i, (a, b) in enumerate(zip(rs[:64], cpu)):
        if (a.stats.lps, a.stats.rounds) != (b.stats.lps, b.stats.rounds):
            raise AssertionError(
                f"many instance {i}: card {a.stats.lps} LPs "
                f"{a.stats.rounds} rounds, CPU {b.stats.lps} / "
                f"{b.stats.rounds}")
        worst = max(worst, _point_sets_equal(a, b, 1e-7,
                                             f"many instance {i} (CPU)"))
    log(f"[many] first {len(cpu)} instances: card and CPU give equal LP "
        f"and round counts and vertex sets within {worst:.1e} (limit "
        f"1e-7); solve_many on the CPU {t_cpu:.2f} s")
    _many_heterogeneous(opt)


def _hetero_vlps():
    from bensolve_tpu_torch import examples

    return [examples.random_vlp(q=q, m=m, n=n, seed=off + s)
            for s in range(HETERO_N) for (q, m, n), off in HETERO]


def _many_heterogeneous(opt):
    """Three shapes through the per-group threads of _run_groups_ep."""
    from bensolve_tpu_torch import solve
    from bensolve_tpu_torch.algs import many

    vlps = _hetero_vlps()
    calls = []
    real = many._run_groups_ep

    def watched(groups, *a, **kw):
        calls.append(len(groups))
        return real(groups, *a, **kw)

    many._run_groups_ep = watched
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = many.solve_many(vlps, opt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        many._run_groups_ep = real
    if calls != [len(HETERO)]:
        raise AssertionError(f"many: _run_groups_ep saw groups {calls}")
    if any(r.status.name != "OPTIMAL" for r in rs):
        raise AssertionError("many heterogeneous: not all OPTIMAL")
    _RESULTS["hetero"] = (vlps, rs, wall)
    worst = 0.0
    for i in (0, 1, 2, len(vlps) - 3, len(vlps) - 2, len(vlps) - 1):
        worst = max(worst, _point_sets_equal(
            rs[i], solve(vlps[i], opt), 1e-7, f"heterogeneous {i}"))
    lps = sum(r.stats.lps for r in rs)
    log(f"[many] heterogeneous: {len(HETERO)} shapes x {HETERO_N} "
        f"instances through {len(HETERO)} group threads, all OPTIMAL in "
        f"{wall:.2f} s ({len(vlps) / wall:.1f} instances/s, {lps} LPs); 6 "
        f"instances within {worst:.1e} of the serial solve() (limit 1e-7)")


def phase_aux():
    """Checkpoint/resume, distributed=True on one process, and the
    profiler, on the card."""
    from bensolve_tpu_torch.io import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "example10.ckpt")
        # a snapshot every 5th round: the last one lies up to 4 rounds
        # before the end, so the resumed run has LPs left to solve
        full, wall = _solve("example10", _options(checkpoint_path=ck,
                                                  checkpoint_every=5))
        _, _, meta = checkpoint.load_checkpoint(ck)
        again, wall_r = _solve_resume("example10", _options(), ck)
        dist = _point_sets_equal(full, again, 1e-7, "resume")
        log(f"[aux] checkpoint: example10 float64 with a snapshot every 5th round "
            f"{wall:.2f} s ({full.stats.rounds} rounds, {full.stats.lps} "
            f"LPs, file {os.path.getsize(ck)} B); resumed from the last "
            f"snapshot ({meta['phase']}, round {meta['round']}, "
            f"{meta['lps']} LPs) in {wall_r:.2f} s to {again.stats.lps} "
            f"LPs: upper-image points within {dist:.1e} of the "
            f"uninterrupted run's (limit 1e-7)")

        plain, _ = _solve("example05", _options())
        shard, wall = _solve("example05", _options(distributed=True))
        dist = _point_sets_equal(plain, shard, 1e-7, "distributed")
        gap = check_support(shard, 1e-7)
        log(f"[aux] distributed=True on one process: example05 in "
            f"{wall:.2f} s, upper-image points within {dist:.1e} of the "
            f"plain solve's (limit 1e-7), support oracle worst gap "
            f"{gap:.1e} (limit 1e-7)")

        prof = os.path.join(tmp, "prof")
        r, wall = _solve("example05", _options(profile_dir=prof))
        traces = glob.glob(os.path.join(prof, "*.json"))
        if r.status.name != "OPTIMAL" or len(traces) != 1:
            raise AssertionError(f"profile_dir: status {r.status}, traces "
                                 f"{traces}")
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if not kernels:
            raise AssertionError("profile_dir: the trace holds no CUDA "
                                 "kernel event")
        busy = sum(e.get("dur", 0) for e in kernels) / 1e6
        log(f"[aux] profile_dir: example05 under torch.profiler in "
            f"{wall:.2f} s; trace {os.path.getsize(traces[0])} B with "
            f"{len(events)} events, {len(kernels)} CUDA kernel events "
            f"({busy:.3f} s of kernels)")


def _solve_resume(name, opt, path):
    from bensolve_tpu_torch import examples, solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve(examples.ALL[name](), opt, resume=path)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


class _Gates:
    """Counts the checks a phase passed; a failed check raises."""

    def __init__(self, tag):
        self.tag, self.passed = tag, 0

    def __call__(self, ok, what):
        if not ok:
            raise AssertionError(f"{self.tag}: {what}")
        self.passed += 1


class _ShardWatch:
    """Counts the sharded solves of parallel/mesh.py (map_shards calls)
    and their shards, and the most distinct threads and CUDA streams
    that ran the shards of one solve."""

    def __init__(self):
        from bensolve_tpu_torch.parallel import mesh as pmesh

        self.pmesh, self.real = pmesh, pmesh.map_shards
        self.calls = self.shards = self.threads = self.streams = 0

    def __enter__(self):
        import threading

        def watched(entries, batched, solve):
            self.calls += 1
            self.shards += len(entries)
            threads, streams = set(), set()

            def seen(entry, *ts):
                threads.add(threading.get_ident())
                dev = entry[0] if isinstance(entry, tuple) else entry
                if dev.type == "cuda":
                    streams.add(torch.cuda.current_stream(dev).cuda_stream)
                return solve(entry, *ts)
            out = self.real(entries, batched, seen)
            self.threads = max(self.threads, len(threads))
            self.streams = max(self.streams, len(streams))
            return out

        self.pmesh.map_shards = watched
        return self

    def __exit__(self, *exc):
        self.pmesh.map_shards = self.real

    def line(self):
        return (f"{self.calls} sharded solves of {self.shards} shards, up "
                f"to {self.threads} threads and {self.streams} CUDA streams "
                f"per solve")


def _mesh_example(gate, name, dtype_kw, ref, tol, tag, n_devices,
                  axes=("dp",)):
    """An example over a mesh of ``axes``; held to the oracle and, with
    ``ref`` (result, wall), to that unsharded run's upper image."""
    with _ShardWatch() as watch:
        r, wall = _solve(name, _options(
            mesh_axes=axes, mesh_devices=n_devices, **dtype_kw))
    gate(r.status.name == "OPTIMAL", f"{tag}: status {r.status}")
    gate(watch.calls > 0, f"{tag}: no sharded solve ran")
    gap = check_support(r, tol)
    line = (f"[mesh] {tag}: OPTIMAL in {wall:.2f} s, LPs {r.stats.lps} "
            f"rounds {r.stats.rounds}, {watch.line()}; support oracle worst "
            f"gap {gap:.1e} (limit {tol:g})")
    if ref is not None:
        r0, wall0 = ref
        img = images_close(r, r0, 1e-6)
        gate(img <= 1e-6, f"{tag}: upper image")
        dist, n_apart = _set_distance(r.primal_points, r0.primal_points)
        line += (f"; unsharded: {wall0:.2f} s, LPs "
                 f"{r0.stats.lps} rounds {r0.stats.rounds}; upper images "
                 f"within {img:.1e} (4096 weights, limit 1e-6), vertex "
                 f"lists {len(r.primal_points)} and {len(r0.primal_points)} "
                 f"points, {n_apart} farther than 1e-6 (worst {dist:.1e})")
    log(line)
    return r


def _many_against(gate, tag, rs, rs0, picks):
    """Gates: every instance with the unsharded run's LP and round counts
    (the 3-D pivot is per LP, so a shard pivots as the whole batch does),
    and each picked instance's vertex set within 1e-7 of the unsharded
    one.  Returns the worst distance of the picked vertex sets."""
    apart = [i for i, (a, b) in enumerate(zip(rs, rs0))
             if (a.stats.lps, a.stats.rounds)
             != (b.stats.lps, b.stats.rounds)]
    gate(not apart, f"{tag}: {len(apart)} instances with LP or round "
         f"counts other than the unsharded run's (first {apart[:5]})")
    worst = 0.0
    for i in picks:
        d = _point_sets_equal(rs[i], rs0[i], 1e-7, f"{tag} instance {i}")
        gate(d <= 1e-7, f"{tag} instance {i}: vertex set")
        worst = max(worst, d)
    return worst


def _mesh_tp_config4(gate):
    """BASELINE config #4's P2 LPs at float64 through the tableau simplex
    (simplex.solve_batch), unsharded and over ("tp",) x MESH_N in the same
    run, MESH_TP_STEPS pivot steps each: statuses equal, objectives
    within 1e-9 relative; the LPs whose pivot counts or final bases
    differ are printed; ms per pivot step of both, and each panel's
    bytes."""
    from bensolve_tpu_torch.lp import simplex
    from bensolve_tpu_torch.parallel import mesh as pmesh
    from bensolve_tpu_torch.parallel.mesh import make_mesh

    t2, extra_ub = make_p2_instances(MESH_TP_B, **IPM_CONFIG,
                                     dtype=np.float64, device="cuda")
    args = (t2.A_lp,) + tuple(t2.build_inputs(extra_ub))
    M, N = t2.A_lp.shape
    steps = [0]
    real = simplex._step

    def counted(*a):
        steps[0] += 1
        return real(*a)

    simplex._step = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r0 = simplex.solve_batch(*args, dtype=np.float64, device="cuda",
                                 max_iter=MESH_TP_STEPS)
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t0
    finally:
        simplex._step = real
    mesh = make_mesh(MESH_N, ("tp",), device="cuda")
    pmesh.LAST_SPLIT.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = simplex.solve_batch(*args, dtype=np.float64, device="cuda",
                            max_iter=MESH_TP_STEPS, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = pmesh.LAST_SPLIT.get("tableau")
    gate(split is not None and split["T"] == MESH_N,
         f"config #4 over tp: split {split}")
    gate(np.array_equal(r.status, r0.status),
         f"config #4 over tp: status {r.status} against {r0.status}")
    gate(bool(np.isin(r0.status, (simplex.OPTIMAL, simplex.ITLIM)).all()),
         f"config #4: status {r0.status}")
    rel = float((np.abs(r.obj - r0.obj) / np.maximum(1.0, np.abs(r0.obj)))
                .max())
    gate(rel <= 1e-9, f"config #4 over tp: objectives {rel:.2e} apart")
    differ = np.flatnonzero((r.iters != r0.iters)
                            | (r.basis != r0.basis).any(axis=1))
    sizes = ", ".join(f"{b / 2**20:.1f}" for b in split["panel_bytes"])
    log(f"[mesh] config #4 P2 LPs (random_vlp({IPM_CONFIG}), LP {M}x{N}) "
        f"B={MESH_TP_B} float64, tableau simplex cut at {MESH_TP_STEPS} "
        f"steps: unsharded {wall0:.2f} s, "
        f"{steps[0]} steps, {1e3 * wall0 / steps[0]:.3f} ms per step; over "
        f"('tp',) x{MESH_N} {wall:.2f} s, {split['steps']} steps, "
        f"{1e3 * wall / split['steps']:.3f} ms per step; panels of "
        f"{sizes} MiB each; statuses {r.status.tolist()} equal; objectives "
        f"within {rel:.1e} relative (limit 1e-9); pivots "
        f"{r0.iters.tolist()} unsharded, {r.iters.tolist()} over tp"
        + (f"; LPs {differ.tolist()} pivot differently" if differ.size
           else "; every LP with equal pivots and final basis"))


def _mesh_tp_tall(gate, axes, r0, wall0):
    """The tall VLP through the revised simplex over ``axes``: the split
    asserted (each revised solve cut into the mesh's tp size of panels)
    and its upper image within 1e-6 of the unsharded run ``r0``."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.lp import revised
    from bensolve_tpu_torch.parallel import mesh as pmesh
    from bensolve_tpu_torch.parallel.mesh import make_mesh

    q, m, n = MESH_TALL
    T = make_mesh(MESH_N, axes, device="cuda").shape["tp"]
    shape = make_mesh(MESH_N, axes, device="cuda").shape
    calls = revised.CALLS
    pmesh.LAST_SPLIT.clear()
    with _ShardWatch() as watch:
        r, wall = _solve(None, _options(mesh_axes=axes, mesh_devices=MESH_N),
                         vlp=examples.random_vlp(q=q, m=m, n=n))
    split = pmesh.LAST_SPLIT.get("revised")
    gate(r.status.name == "OPTIMAL", f"tall {axes}: status {r.status}")
    gate(revised.CALLS > calls, f"tall {axes}: the revised simplex did "
         f"not run")
    gate(watch.calls > 0, f"tall {axes}: no sharded solve ran")
    gate(split is not None and split["T"] == T,
         f"tall {axes}: split {split}, want {T} panels")
    img = images_close(r, r0, 1e-6)
    gate(img <= 1e-6, f"tall {axes}: upper image")
    gap = check_support(r, 1e-4)
    log(f"[mesh] random_vlp(q={q}, m={m}, n={n}) float64 primal over "
        f"make_mesh({MESH_N}, {axes}) {shape}: OPTIMAL in {wall:.2f} s "
        f"(unsharded: {wall0:.2f} s), {revised.CALLS - calls} revised "
        f"batched solves, {watch.line()}; last solve {split['T']} panels "
        f"of {split['panel_bytes'][0] / 2**10:.1f} KiB, {split['steps']} "
        f"steps; LPs {r.stats.lps} rounds {r.stats.rounds} (unsharded: "
        f"{r0.stats.lps} / {r0.stats.rounds}); upper images within "
        f"{img:.1e} (limit 1e-6); support oracle worst gap {gap:.1e} "
        f"(limit 1e-4)")


def phase_mesh():
    """The device mesh (parallel/mesh.py) on the card: MESH_N entries of
    cuda:0, each shard on its own thread and CUDA stream."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs import many
    from bensolve_tpu_torch.parallel.mesh import make_mesh
    from bensolve_tpu_torch.vlp.options import Options

    gate = _Gates("mesh")
    mesh = make_mesh(MESH_N, ("dp",), device="cuda")
    log(f"[mesh] make_mesh({MESH_N}, ('dp',)): entries "
        f"{[str(d) for d in mesh.devices.flat]}; "
        f"torch.cuda.device_count() {torch.cuda.device_count()}")

    # MESH_F64_EXAMPLE at float64 against its unsharded run, and
    # MESH_F32_EXAMPLE at float32, whose batches the kernel takes without
    # a mesh (phase 4)
    ref = _solve(MESH_F64_EXAMPLE, _options())
    _mesh_example(gate, MESH_F64_EXAMPLE, {}, ref, 1e-4,
                  f"{MESH_F64_EXAMPLE} float64 dp x{MESH_N}", MESH_N)
    before = _launches()
    _mesh_example(gate, MESH_F32_EXAMPLE, F32_KW, None, 1e-3,
                  f"{MESH_F32_EXAMPLE} float32 dp x{MESH_N}", MESH_N)
    after = _launches()
    gate(after == before, f"a meshed float32 batch reached the kernel: "
         f"launches {before} -> {after}")
    log(f"[mesh] {MESH_F32_EXAMPLE} float32: kernel launches cluster/global "
        f"{before['cluster']}/{before['global']} before and "
        f"{after['cluster']}/{after['global']} after (a meshed batch takes "
        f"the tableau route, as in the JAX package)")

    # config #5 through solve_many over the mesh
    if "many" not in _RESULTS:
        vlps = [examples.random_vlp(**MANY_VLP, seed=s)
                for s in range(MANY_N)]
        opt = Options(bounded=True, write_files=False, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs0 = many.solve_many(vlps, opt)
        torch.cuda.synchronize()
        _RESULTS["many"] = (vlps, rs0, time.perf_counter() - t0)
    vlps, rs0, wall0 = _RESULTS["many"]
    opt = Options(bounded=True, write_files=False, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _ShardWatch() as watch:
        t0 = time.perf_counter()
        rs = many.solve_many(vlps, opt, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gate(all(r.status.name == "OPTIMAL" for r in rs),
         "config #5: not every instance OPTIMAL")
    gate(watch.calls > 0, "config #5: no sharded solve ran")
    lps, lps0 = (sum(r.stats.lps for r in x) for x in (rs, rs0))
    rounds, rounds0 = (max(r.stats.rounds for r in x) for x in (rs, rs0))
    pts, pts0 = (sum(len(r.primal_points) for r in x) for x in (rs, rs0))
    gate((lps, rounds) == (MANY_LPS, MANY_ROUNDS),
         f"config #5: {lps} LPs in {rounds} rounds, recorded {MANY_LPS} in "
         f"{MANY_ROUNDS}")
    gate(pts == pts0, f"config #5: {pts} points, unsharded {pts0}")
    picks = sorted({int(i) for i in np.linspace(0, MANY_N - 1, 32)})
    dist = _many_against(gate, "config #5", rs, rs0, picks)
    log(f"[mesh] config #5 over the mesh: {MANY_N} instances all OPTIMAL in "
        f"{wall:.2f} s = {MANY_N / wall:.1f} instances/s, {lps / wall:.0f} "
        f"LPs/s (unsharded: {wall0:.2f} s, {MANY_N / wall0:.1f} "
        f"instances/s, {lps0 / wall0:.0f} LPs/s); {lps} LPs, {rounds} "
        f"rounds, {pts} points (unsharded {lps0}, {rounds0}, {pts0}; "
        f"recorded {MANY_LPS}, {MANY_ROUNDS}); all {MANY_N} instances with "
        f"the unsharded LP and round counts; {len(picks)} instances' vertex "
        f"sets within {dist:.1e} of the unsharded ones (limit 1e-7); "
        f"{watch.line()}; peak torch.cuda.max_memory_allocated "
        f"{peak / 2**20:.0f} MiB")

    # the heterogeneous run: groups round-robin over the entries
    if "hetero" not in _RESULTS:
        hv = _hetero_vlps()
        _RESULTS["hetero"] = (hv, many.solve_many(hv, opt), None)
    hv, hrs0, _ = _RESULTS["hetero"]
    places = []
    real = many._merged_solve

    def watched(requests, o, place=None):
        places.append(place)
        return real(requests, o, place)

    many._merged_solve = watched
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hrs = many.solve_many(hv, opt, mesh=mesh)
        torch.cuda.synchronize()
        hwall = time.perf_counter() - t0
    finally:
        many._merged_solve = real
    gate(all(r.status.name == "OPTIMAL" for r in hrs),
         "heterogeneous: not every instance OPTIMAL")
    want = {str(d) for d in list(mesh.devices.flat)[:len(HETERO)]}
    gate(bool(places) and {str(p) for p in places} == want,
         f"heterogeneous: groups placed on {set(map(str, places))}")
    dist = _many_against(gate, "heterogeneous", hrs, hrs0, range(len(hv)))
    log(f"[mesh] heterogeneous: {len(HETERO)} shapes x {HETERO_N} instances, "
        f"group g on entry g % {MESH_N} ({len(places)} merged solves), all "
        f"OPTIMAL in {hwall:.2f} s; every instance with the unsharded LP "
        f"and round counts and its vertex set within {dist:.1e} of the "
        f"unsharded one (limit 1e-7)")

    # the tp column split: example05, config #4's LPs, the tall VLP
    r_tp = _mesh_example(gate, MESH_F64_EXAMPLE, {}, ref, 1e-4,
                         f"{MESH_F64_EXAMPLE} float64 tp x{MESH_N}", MESH_N,
                         axes=("tp",))
    dist = _point_sets_equal(r_tp, ref[0], 1e-7, "example05 over tp")
    gate(dist <= 1e-7, "example05 over tp: point sets")
    gate(_sets_close(r_tp.dual_points, ref[0].dual_points, 1e-7) <= 1e-7,
         "example05 over tp: lower image points")
    log(f"[mesh] {MESH_F64_EXAMPLE} float64 over ('tp',) x{MESH_N}: upper "
        f"and lower image points within {dist:.1e} of the unsharded run's "
        f"(limit 1e-7)")
    _mesh_tp_config4(gate)
    q, m, n = MESH_TALL
    r0, twall0 = _solve(None, _options(),
                        vlp=examples.random_vlp(q=q, m=m, n=n))
    for axes in (("tp",), ("dp", "tp")):
        _mesh_tp_tall(gate, axes, r0, twall0)
    log(f"[mesh] {smi_line()}")

    if torch.cuda.device_count() > 1:
        k = torch.cuda.device_count()
        _mesh_example(gate, MESH_F64_EXAMPLE, {}, ref, 1e-4,
                      f"{MESH_F64_EXAMPLE} float64 over the {k} cards", None)
    else:
        log("[mesh] one card: the run over several cards was not made")
    log(f"[mesh] {gate.passed} gates passed")
    return gate.passed


def phase_bench():
    """python -m bensolve_tpu_torch.bench with every stage, BENCH_ARGS
    cutting the depth of the stages that repeat earlier phases, in a
    process of its own: it must exit 0, and its last line must parse,
    hold every key of the repo's bench.py line and show the device
    stage's batch launched on the cluster kernel.  Returns that line."""
    from bensolve_tpu_torch import bench

    cmd = [sys.executable, "-m", "bensolve_tpu_torch.bench", *BENCH_ARGS]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    for ln in out.stderr.splitlines():
        if ln.startswith("#"):
            log(f"[bench] {ln[2:]}")
    if out.returncode != 0:
        raise AssertionError(f"bench exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    missing = [k for k in bench.BENCH_KEYS + bench.EXTRA_KEYS
               if k not in line]
    if missing:
        raise AssertionError(f"bench line lacks {missing}")
    if not line["device_kernel_launches"]["cluster"] > 0:
        raise AssertionError(f"bench device stage: kernel launches "
                             f"{line['device_kernel_launches']}")
    log(f"[bench] {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s; "
        f"{json.dumps(line)}")
    return line


def _witness():
    """tests/witness_large_shapes.py, loaded from its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "witness_large_shapes.py")
    spec = importlib.util.spec_from_file_location("witness_large_shapes",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_large():
    """The runner on example10, the ex07 flow at LARGE_EX07 and one
    ex09-shape round (tests/witness_large_shapes.py's functions)."""
    from bensolve_tpu_torch import slow_runner

    w = _witness()
    with tempfile.TemporaryDirectory() as ckpt:
        row, r = slow_runner.solve_one("ex10", "cuda", ckpt_dir=ckpt)
    got = {k: row[k] for k in RUNNER_EX10}
    if got != RUNNER_EX10:
        raise AssertionError(f"runner ex10: {got}, recorded {RUNNER_EX10}")
    if not (len(r.primal_points) > 500 and len(r.primal_directions) == 3):
        raise AssertionError("runner ex10: test_e2e_large's counts")
    gap = check_support(r, tol=1e-4, n_samples=16)
    log(f"[large] runner ex10 ({row['card']}): {row['status']} in "
        f"{row['wall_s']:.2f} s, {row['lps']} LPs, {row['rounds']} rounds, "
        f"{row['points']} points, {row['directions']} directions, "
        f"{row['support']} (the JAX package's recorded run: {RUNNER_EX10}); "
        f"test_e2e_large's 16 samples within {gap:.1e} (limit 1e-4)")

    q, m, n = LARGE_EX07
    if LARGE_EX07 != w.EX07:
        log(f"[large] ex07 flow cut from random_vlp{w.EX07} to "
            f"random_vlp{LARGE_EX07} (same flags, environment and route); "
            f"the full shape is recorded by tests/witness_large_shapes.py")
    with tempfile.TemporaryDirectory() as ckpt:
        rec, _ = w.ex07_shape("cuda", q, m, n, host="off", ckpt_dir=ckpt)
    log(f"[large] ex07 flow: {w.ex07_line(rec)}")
    if not w.ex07_ok(rec):
        raise AssertionError(f"ex07 flow: {rec['status']}, "
                             f"{rec['support']}")
    if rec["ipm_calls"] == 0:
        raise AssertionError("ex07 flow: the IPM route was not taken")

    q, m, n, B = LARGE_EX09
    rec, _ = w.ex09_round("cuda", q, m, n, B, clock=_IPMClock(split=True))
    log(f"[large] ex09 shape: {w.ex09_line(rec)}")
    M, Nc, width = rec["lp_shape"][0], rec["Nc"], rec["chunk_width"]
    s_bound = w.s_bound_ms(rec, PEAK_FLOPS["float32"])
    bound, bound_by, _ = _iteration_bound(M, Nc, width, "float32")
    done, _, _ = _iteration_bound(M, Nc, width, "float32", needed=False)
    ms = rec["ms_per_iteration"]
    log(f"[large] ex09 shape: {ms:.2f} ms per iteration at B={width}; S "
        f"build bound {s_bound:.2f} ms ({s_bound / width:.2f} per LP: 2 M^2 "
        f"Nc flops at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s), S build "
        f"measured {rec['parts_ms'].get('S build', float('nan')):.2f} ms; "
        f"iteration bound of the work needed {bound:.2f} ms ({bound_by}) = "
        f"{bound / ms:.3f} of it, of the work done {done:.2f} ms = "
        f"{done / ms:.3f}; {smi_line()}")
    if not w.ex09_ok(rec):
        raise AssertionError(f"ex09 shape: LPs {rec['cert_failed']} fail "
                             f"their certificates")


def phase_graft():
    """bensolve_tpu_torch.graft_entry on the card: entry() against the
    CPU, and dryrun_multichip(n) for GRAFT_NS with every sharded solve
    held to the unsharded one; the record of the {"graft": ...} line."""
    from bensolve_tpu_torch import graft_entry as ge

    gate = _Gates("graft")
    before = _launches()
    fn, args = ge.entry("cuda")
    ms = []
    for _ in range(2):    # the first call includes the warm-up
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        out = fn(*args)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    got = [o.cpu().numpy() for o in out]
    cfn, cargs = ge.entry("cpu")
    ref = [o.numpy() for o in cfn(*cargs)]
    for k, i in (("status", 0), ("iters", 6), ("basis", 7)):
        gate(np.array_equal(got[i], ref[i]),
             f"entry: {k} on the card {got[i].tolist()}, on the CPU "
             f"{ref[i].tolist()}")
    rel = float(np.max(np.abs(got[1] - ref[1]) / (1 + np.abs(ref[1]))))
    gate(rel <= GRAFT_OBJ_RTOL, f"entry: objectives {rel:.1e} apart")
    log(f"[graft] entry(): {ref[0].size} LPs {tuple(args[0].shape)} f32, "
        f"statuses {got[0].tolist()}, iterations {got[6].tolist()}, equal "
        f"to the CPU's with the bases, objectives within {rel:.1e}; "
        f"{ms[0]:.2f} ms first call, {ms[1]:.2f} ms second (CUDA events)")
    runs = []
    for n in GRAFT_NS:
        t0 = time.perf_counter()
        rec = ge.dryrun_multichip(n, "cuda")
        wall = time.perf_counter() - t0
        batches = ge.step_inputs(rec["dp"])
        for step in rec["steps"]:
            one = ge.solve_unsharded(*batches[step["step"]], device="cuda")
            for k, i in (("status", 0), ("iters", 6), ("basis", 7)):
                gate(np.array_equal(step[k], one[i]),
                     f"n={n} {step['step']}: {k} differs from the "
                     f"unsharded solve")
        steps = {s["step"]: dict(
            lps=int(s["status"].size), wall_s=s["wall_s"],
            statuses={int(k): int(v) for k, v in zip(
                *np.unique(s["status"], return_counts=True))},
            iters_max=int(s["iters"].max())) for s in rec["steps"]}
        runs.append(dict(n=n, shape=rec["shape"], entries=rec["entries"],
                         wall_s=wall, steps=steps))
        log(f"[graft] dryrun_multichip({n}) over {rec['shape']} of "
            f"{sorted(set(rec['entries']))}: {wall:.2f} s; "
            + "; ".join(f"{k} {v['lps']} LPs {v['statuses']} (iterations "
                        f"<= {v['iters_max']}) {v['wall_s']:.3f} s"
                        for k, v in steps.items())
            + "; each equal to the unsharded solve on the card")
    after = _launches()
    gate(after == before, f"kernel launches moved on the graft path: "
         f"{before} -> {after}")
    log(f"[graft] {gate.passed} gates passed; kernel launches over the "
        f"phase: {before} -> {after}; {smi_line()}")
    return dict(entry_ms=ms, entry_obj_rel=rel, launches=dict(
        before=before, after=after), dryrun=runs, gates=gate.passed)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_environment()
    only = _only(sys.argv[1:])
    if only is not None:
        for k in only:
            _timed(k, PHASES[k])
        _log_total(t_start)
        return 0
    _timed("2", phase_build)
    ex10, ex10_w, glob, bench_shape = _timed("3", phase_kernel)
    # phase 5 first: phase 4 holds its float32 directions to its run
    primal = _timed("5", phase_main_f64)
    launches = _timed("4", phase_main_f32)
    launches_large = _timed("4 large", phase_large_f32)
    _timed("6", phase_dual_f64, primal)
    launches_dual = _timed("7", phase_dual_f32)
    _timed("8", phase_tall)
    _timed("9", phase_revised_vs_cpu)
    _timed("10", phase_ipm_config4)
    _timed("11", phase_ipm_e2e)
    _timed("12", phase_ipm_vs_cpu)
    _timed("13", phase_many)
    _timed("14", phase_aux)
    _timed("15", phase_mesh)
    bench_line = _timed("16", phase_bench)
    _timed("17", phase_large)
    graft = _timed("18", phase_graft)
    _log_total(t_start)
    log(smi_line())
    log(json.dumps({"graft": graft}))
    common = {"route": "cuda", "source": KERNEL_SOURCE,
              "replaces": KERNEL_REPLACES, "plain_ms": ex10["plain_ms"],
              "bound_ms": ex10["bound_ms"], "bound_by": ex10["bound_by"],
              "library_ms": None}
    bench_launches = bench_line["device_kernel_launches"]
    log(json.dumps({"kernels": [
        dict(name="group_simplex_cluster", **common,
             launches=launches["cluster"],
             launches_dual_f32=launches_dual["cluster"],
             launches_bench_device=bench_launches["cluster"],
             cluster_size=ex10["C"], max_abs_err=ex10["err"],
             ms=ex10["ms"], ms_warm=ex10_w["ms"],
             bench_shape=_shape_numbers(bench_shape, "ms")),
        dict(name="group_simplex_global", **common,
             launches=launches_large["global"],
             launches_f32_examples=launches["global"],
             launches_dual_f32=launches_dual["global"],
             launches_bench_device=bench_launches["global"],
             max_abs_err=max(ex10["err_global"], glob["err"]),
             ms=ex10["ms_global"], ms_warm=ex10_w["ms_global"],
             bench_shape=_shape_numbers(bench_shape, "ms_global"))]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _shape_numbers(out, ms_key):
    """A variant's numbers at the bench's device shape (phase 3)."""
    return {"C": out["C"], "ms": out[ms_key], "plain_ms": out["plain_ms"],
            "bound_ms": out["bound_ms"], "bound_by": out["bound_by"],
            "max_abs_err": out["err" if ms_key == "ms" else "err_global"]}


PHASES = {"2": phase_build, "3": phase_kernel, "4": phase_main_f32,
          "5": phase_main_f64, "7": phase_dual_f32, "8": phase_tall,
          "9": phase_revised_vs_cpu, "10": phase_ipm_config4,
          "11": phase_ipm_e2e,
          "12": phase_ipm_vs_cpu, "13": phase_many, "14": phase_aux,
          "15": phase_mesh, "16": phase_bench, "17": phase_large,
          "18": phase_graft}
# seconds per phase, and the mesh phase's passed gates, for [total]
_PHASE_S = {}


def _timed(key, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    _PHASE_S[key] = time.perf_counter() - t0
    if key == "15":
        _PHASE_S["mesh gates"] = out
    return out


def _log_total(t_start):
    gates = _PHASE_S.pop("mesh gates", None)
    per = ", ".join(f"{k} {v:.0f} s" for k, v in _PHASE_S.items())
    log(f"[total] {time.perf_counter() - t_start:.0f} s (phases: {per})"
        + ("" if gates is None else f"; mesh phase gates passed {gates}"))


def _only(argv):
    """The phases named after --only, or None without the flag."""
    if not argv:
        return None
    if argv[0] != "--only" or not set(argv[1:]) <= set(PHASES):
        raise SystemExit(f"usage: chip_smoke.py [--only PHASE ...] with "
                         f"PHASE in {sorted(PHASES, key=int)}")
    return argv[1:]


if __name__ == "__main__":
    sys.exit(main())
