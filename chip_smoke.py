"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one output line (or block) each:

1. environment: torch/CUDA versions, the card's name and power limit,
   nvcc, triton, the native polytope engine; TF32 matmuls switched off;
2. build: the per-LP simplex kernel from lp/csrc/group_simplex.cu, with
   ptxas' registers and spills of its three variants (cluster, spill,
   global), their shared-memory bytes and cudaOccupancyMaxActiveClusters
   at example10's P2 shape and at phase 4's spill shape (768, 1152);
3. kernel vs its plain PyTorch version on the card: each variant at its
   shape (clusters of 1, 2, 4, 8 and 16 CTAs), cold, and shared-warm at
   M=N=16 and at example10's P2 shape (Mp=384, NT=768, B=256), where the
   cluster and the global variant are also timed in turns on the same
   inputs (CUDA events) and the roofline bound is computed from the
   cluster kernel's own counts of pricing passes and rank-1 updates on
   the LP's unpadded tableau (M rows, N + M columns); the same at the
   bench's device shape (one launch: the first 256 of
   bench.make_instances(96, 96, 4096), Mp=96, NT=256, C=1); the spill
   variant (16-CTA clusters, rows past shared memory in an L2-resident
   workspace) against the plain version at the band shapes (768, 1152)
   (B = 8 cold and shared-warm, B = 128 cold) and (768, 1536) (B = 8
   cold), timed in turns with the global variant, with LPs per launch
   and the bound from its own counts; the pair at config #4's f32 P2
   shape (1024, 3072), above the band, cut at 1,000 pivots, where plan's
   choice between them is made; and at M=N=500 (Mp=512, NT=1024, a 16-CTA
   cluster holds it) the spill variant with 256 and with 512 rows in
   shared memory against the cluster variant: status, basis, at_upper,
   iterations and work counts equal on every LP, cold and shared-warm,
   timed in turns, and the spill traffic's rate;
4. the main path at float32 (the kernel's route): solve() on example01,
   05, 08 and 10, with the launch counts of the variants reset just
   before and read just after (per example), the kernel's share of the
   phase wall, and the support-function oracle at 1e-3; example10's
   float32 extreme directions against phase 5's float64 ones (phase 5
   runs first): the worst angle either way, and the float32 ones farther
   than F32_DIR_DEG, printed, and every float32 direction in the cone of
   the float64 ones (NNLS residual at most 1e-4; ROADMAP Queue 3 m);
   then the same on random_vlp(q=2, m=700, n=256), whose LPs no cluster
   holds: the spill variant's path, its launches and their LPs counted
   alone;
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
   vertex lists may differ along nearly straight stretches); its pivot
   loops replay CUDA graphs of the revised step (lp/segments.py), and
   the inputs of its largest batched solve are kept for phase 19;
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
   iteration of the full batch (by replayed graphs) beside the bounds of
   the work needed and of the work done (phase 19 splits an eager
   iteration into the S build, the two Choleskys and the solves); LPs
   0-3 held to scipy/HiGHS (1e-3 relative at
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
   float64 certificates at 1e-2, ms per iteration by graph beside the S
   build's bound, peak device memory).  No LP goes to host HiGHS: the
   ex07 flow runs with the fallback off (its ITLIM LPs go to the IPM's rescue pass and float64
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
19. the pivot segments as CUDA graphs (lp/segments.py) against the eager
   loop, each pair run in turns (eager, graph, graph, eager) on the same
   inputs, float64: 256 P2 LPs of example10 (padded 384x768) to their
   end; config #4's 8 P2 LPs (padded 1024x3072) cut at SEG_STEPS
   pivots; the largest warm dual chain of phase 5's example10 solve,
   re-run from its KeptState; the ex07 fallback's chunk, 64 cold P2 LPs
   of random_vlp(3, 1211, 1143, seed=7) (padded 1280x2560) cut at
   SEG_STEPS; config #5's largest round of phase 13 through the 3-D
   path; then the revised loop (revised._run): phase 8's largest
   batched solve to its end, and B = 2 P2 LPs of ex09's shape
   (random_vlp(3, 4608, 36939, seed=7), LP 4615x36943, padded
   5120x40960, exact bounds) through revised._run alone, cut at
   SEG_EX09_STEPS pivots, each beside its byte bound per step.  Per
   run: ms per pivot step (a synchronised host clock around every pivot
   loop, over the counted steps), captures and their seconds; every
   run's final loop states (every field, W or B^-1, basis, at_upper,
   status and iters among them, and the revised loop's returned step)
   equal bit for bit to the first eager run's.  Then the interior-point
   iterations (ipm._ipm_core, graphs of _Core.step), each pair one
   solve_batch_ipm call with the host fallback capped at 0: config #4's
   P2 LPs at float32, B = 128 and B = 8 (a compaction tail's width), cut
   at SEG_IPM_ITERS iterations without polish; the 155x303 P2 LP of
   random_vlp(2, 150, 300) at float64, B = 64, to the end; B = 8 P2 LPs
   of ex09's shape (the revised pair's instance) at float32, cut at
   SEG_IPM_EX09_ITERS.  Per run: ms per iteration (a synchronised host
   clock around every segment) beside phase 10's iteration bound,
   captures and their seconds, peak device memory, and the last eager
   run's split into the S build, the Cholesky pair and the solves
   (CUDA events); every segment's carry, all 16 entries, bit for bit
   the first eager run's;
20. the tableau pivot step's two kernels (lp/tableau_step.py: the
   primal or dual choice kernel, then the update kernel), run right
   after phase 3: example10 with both algorithms and example11 with the
   primal one at float64 on the main path (each solved once just
   before, so that its graphs are captured), segments' counters reset
   just before each counted solve: KERNEL_STEPS equal to the tableau and dual
   loops' steps (graph and eager) in all and per loop, none in the
   revised and interior-point loops, the f32 group kernel not launched,
   one pricing per loop; per solve the kernels' launches, and the pivot
   loops' time (a synchronised host clock around each) beside the bound
   benchmark/roofline.py gives for their steps on the unpadded LPs.
   Then, from the first start state of every (step, Mp, NT, Bp) those
   loops reached (ex10's (384, 768) at Bp 8 to 256, ex11's (48, 64) and
   (80, 96) among them), one kernel step against one plain torch step
   (simplex._step_plain, dual_simplex._dstep_plain), and again after
   up to STEP_ADVANCE plain steps (the last state with an LP running):
   fed the kernel's prices (through simplex._reduced_costs), the plain
   step gives basis, in_basis, at_upper, status, stall, iters, the basic
   bounds and costs, W, xb and gamma bit for bit on every LP; the
   kernel's prices before the step and the reduced costs it carries
   after it lie within STEP_D_TOL of their sum's scale from a fresh
   c_eff - cB_eff W; the LPs that the plain step with its own cuBLAS
   prices steps otherwise (near-ties of the pricing that sums in other
   orders break apart) are printed.  At ex10's (384, 768) with Bp 8, 64
   and 256 and ex11's shapes at Bp 8, the kernel step and the plain step
   each as a replayed graph of STEP_GRAPH_K steps (CUDA events), each
   kernel's share from torch.profiler, and the bound on the padded
   tableau;
21. the result lines.

After phases 5, 6, 8, 10, 11, 13, 17's example10 run, 17 and 18 a
[segments] line prints the counters of lp/segments.py over that phase
(captures and their seconds, replays, steps by graph and eager, in all
and per loop: tableau, dual, revised, ipm; the graph sets held, their
static buffers and memory pools); phases 5, 6, 8, 10, 13 and 17 fail
unless they replayed graphs, phase 8 graphs of the revised loop and
phases 10 and 17 of the interior-point loop.

The second-to-last line is one JSON object with the kernel's three
variants (name, route, source, the TPU kernel it replaces, launches on
its main path: the examples of phase 4 for the cluster variant, the
large VLP of phase 4 for the spill one, none for the global one, which
no padded shape plans since the spill variant; launches_dual_f32 in
phase 7; launches_bench_device in phase 16's device stage; max |obj
kernel - plain|, kernel, plain and bound times: the cluster variant's at
example10's P2 shape, cold, and its time warm, and at the bench's device
shape under bench_shape; the spill and the global variant's at (768,
1152), cold, B = 8, with every phase-3 shape of theirs under shapes);
then the three kernels of lp/csrc/tableau_step.cu (launches on phase
20's main-path solves, per solve beside the pivot loops' ms and bound;
their own, the kernel step's and the plain step's ms and the bound at
example10's (384, 768) Bp 256, every timed shape, the worst carried
reduced cost); the line before it is phase 18's {"graft": ...}; the
last line is {"ok": true, "device": {...}}.  Any
failed phase raises and exits non-zero before those lines.  Without a
CUDA device, or without the package beside this
script, it exits non-zero and prints no result.

``--only 10 12`` runs just the named phases after phase 1 and prints no
result lines (for iterating on one phase); ``--only 15`` first makes the
unsharded runs of phase 13 that the mesh phase holds its own to, and
``--only 19`` the example10 solve, the config #5 run and phase 8's tall
solves it takes its dual chain, its 3-D round and its revised batch
from.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# its kernel launches take the spill variant
LARGE = (2, 700, 256)
LARGE_P2 = (705, 259)
# phase 3's spill shapes, (name, M, N, B, warm too): phase 4's P2 LP,
# padded (768, 1152), at 8 and 128 LPs per launch; M=N=700, padded (768,
# 1536) (its shared-warm run, 23.6 s of plain version on an H100, is
# left to tests/test_torch_cuda.py)
SPILL_SHAPES = (("band (768, 1152)", 705, 259, 8, True),
                ("band (768, 1152)", 705, 259, 128, False),
                ("band (768, 1536)", 700, 700, 8, False))
# above the band: config #4's f32 P2 LP, padded (1024, 3072), B LPs, where
# plan's choice between spill and global is made; both cut at ABOVE_STEPS
# pivots (to the end, the global variant took 157.3 s and the plain
# version 97.0 s on an H100, the spill variant 2.77 s)
ABOVE_BAND = (1011, 2006, 8)
ABOVE_STEPS = 1000
# phase 3's equality gate: a shape a 16-CTA cluster holds, padded (512,
# 1024), with half its rows forced into the spill workspace
SPILL_GATE = (500, 500, 8)
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
# phase 19: pivots at which config #4's P2 LPs and the ex07 fallback's
# chunk are cut (to the end, config #4's took 33,407 steps, 113 s eagerly
# on an H100); the ex07 chunk: random_vlp(q, m, n, seed) and its LPs
SEG_STEPS = 2000
SEG_EX07 = dict(q=3, m=1211, n=1143, seed=7)
SEG_EX07_B = 64
SEG_EX10_B = 256
# phase 19's revised pair at ex09's shape: random_vlp(q, m, n, seed)'s
# P2 LPs, SEG_EX09_B of them, cut at SEG_EX09_STEPS pivots
SEG_EX09 = dict(q=3, m=4608, n=36939, seed=7)
SEG_EX09_B = 2
SEG_EX09_STEPS = 1000
# phase 19's interior-point pairs: config #4's P2 LPs at float32, B =
# IPM_B and SEG_IPM_TAIL_B (a compaction tail's width), cut at
# SEG_IPM_ITERS iterations; the P2 LP of random_vlp(*IPM_VLP) at float64,
# B = SEG_IPM_VLP_B, to the end; SEG_IPM_EX09_B P2 LPs of ex09's shape
# (SEG_EX09, the revised pair's instance) at float32, cut at
# SEG_IPM_EX09_ITERS
SEG_IPM_ITERS = 10
SEG_IPM_TAIL_B = 8
SEG_IPM_VLP_B = 64
SEG_IPM_EX09_B = 8
SEG_IPM_EX09_ITERS = 5
# the phases after which the segment counters are printed, and those
# that must have replayed graphs (phase 8: of the revised loop; phases
# 10 and 17: of the interior-point loop)
SEGMENT_PHASES = ("5", "6", "8", "10", "11", "13", "17", "18")
SEGMENT_REPLAY_GATE = ("5", "6", "8", "10", "13", "17")
SEGMENT_LOOP_GATE = {"8": "revised", "10": "ipm", "17": "ipm"}
# phase 20: the main path's float64 solves whose pivot loops it records
# (label, example, algorithm); the (step, Mp, NT[, Bp]) their loops must
# reach (ex10's at Bp 8 and 256, ex11's two shapes); the fields a kernel
# step gives bit for bit as the plain step fed the same prices (none of
# them is a sum: the kernels compute each with the torch step's
# operations and roundings);
# the carried reduced costs' limit, relative to the scale of their sum
# (cuBLAS and the update kernel sum in different orders); the plain
# steps taken from a loop start before its second comparison; the
# (Mp, NT, Bp) timed as graphs of STEP_GRAPH_K steps, STEP_REPS replays;
# the kernels' names in the device trace
STEP_SOLVES = (("example10 primal", "example10", {}),
               ("example10 dual", "example10", DUAL_KW),
               ("example11 primal", "example11", {}))
STEP_NEEDED = (("primal", 384, 768, 8), ("primal", 384, 768, 256),
               ("dual", 384, 768, 8), ("dual", 384, 768, 256),
               ("primal", 48, 64), ("dual", 48, 64), ("primal", 80, 96),
               ("dual", 80, 96))
STEP_EXACT = ("basis", "in_basis", "at_upper", "status", "stall", "iters",
              "lbB", "ubB", "cB", "W", "xb", "gamma")
STEP_D_TOL = 1e-13
STEP_ADVANCE = 16
STEP_TIMED = ((384, 768, 8), (384, 768, 64), (384, 768, 256), (48, 64, 8),
              (80, 96, 8))
STEP_GRAPH_K = 64
STEP_REPS = 5
STEP_KERNELS = ("primal_choice_kernel", "dual_choice_kernel",
                "tableau_update_kernel")
TABLEAU_SOURCE = "bensolve_tpu_torch/lp/csrc/tableau_step.cu"
TABLEAU_REPLACES = {"primal_choice_kernel": "bensolve_tpu/lp/simplex.py:304",
                    "dual_choice_kernel":
                        "bensolve_tpu/lp/dual_simplex.py:37",
                    "tableau_update_kernel":
                        "bensolve_tpu/lp/simplex.py:304, "
                        "bensolve_tpu/lp/dual_simplex.py:37"}
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
            name = ("spill" if "group_simplex_spill_kernel" in ln
                    else "cluster" if "group_simplex_cluster_kernel" in ln
                    else "global")
        elif name and ("registers" in ln or "spill stores" in ln):
            per_kernel.setdefault(name, []).append(ln.split(":", 1)[-1]
                                                   .strip())
    log(f"[build] group_simplex for sm_90a: nvcc {seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("cluster", "spill", "global"):
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
    Mp, NT = gs.padded_shape(*LARGE_P2)
    rows = gs.spill_rows(Mp, NT)
    if gs.plan(Mp, NT) != ("spill", 16):
        raise AssertionError(f"({Mp}, {NT}) plans {gs.plan(Mp, NT)}")
    active = gs.max_active_clusters(Mp, NT, 16, rows=rows)
    log(f"[build] phase 4's P2 LP (Mp={Mp}, NT={NT}): spill C=16, {rows} "
        f"of {Mp} rows in shared memory, "
        f"{gs.smem_bytes(Mp, NT, 16, rows)} B dynamic shared memory per "
        f"CTA, {(Mp - rows) * NT * 4} B spilled per LP, "
        f"cudaOccupancyMaxActiveClusters {active}")
    if active < 1:
        raise AssertionError("no spill cluster fits at phase 4's P2 shape")


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


def _event_ms(fn):
    """(fn(), its CUDA-event milliseconds): one call, no warm-up."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _launches():
    from bensolve_tpu_torch.lp import group_simplex as gs

    return {"cluster": gs.CALLS_CLUSTER, "spill": gs.CALLS_SPILL,
            "global": gs.CALLS_GLOBAL}


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
    timings.  With ``ab`` the planned variant and the global one are
    timed in turns (planned, global, planned) on these inputs, the global
    launch also held to the plain version, and the roofline bound is
    computed from the planned variant's own counts.
    Returns a dict of the numbers."""
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
    if launched != {k: int(k == kind) for k in after}:
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
        # in turns (planned, global, planned): one global launch takes
        # up to seconds, and it is the one held to the plain version
        t1 = _time_ms(run, reps)
        g_out, t_g = _event_ms(lambda: run("global"))
        t2 = _time_ms(run, reps)
        g = _recover(gs, args, start_basis, *g_out, dev)
        if not (g.status == plain.status).all():
            raise AssertionError(f"{name}: global variant status "
                                 f"{g.status} != plain {plain.status}")
        out["err_global"] = _errors(name + " (global)", g, plain,
                                    (g.basis == plain.basis).all(axis=1)
                                    )["obj"][1]
        out["ms"] = (t1 + t2) / 2
        out["ms_global"] = t_g
        extra = (f"; in turns {kind} {t1:.3f}, global {t_g:.3f}, {kind} "
                 f"{t2:.3f} ms ({kind} / global "
                 f"{out['ms'] / out['ms_global']:.4f}); global variant "
                 f"status equal, obj within {out['err_global']:.1e}; "
                 f"bound {out['bound_ms']:.3f} ms ({out['bound_by']}; mean "
                 f"loop steps {steps:.1f}, pricing passes on "
                 f"{pass_share:.3f} of steps) = "
                 f"{out['bound_ms'] / out['ms']:.4f} of the {kind} "
                 f"kernel's time, {out['bound_ms'] / out['ms_global']:.4f} "
                 f"of the global's")
    else:
        out["ms"] = _time_ms(run, reps)
    # the plain version's torch ops need no warm-up: where one call is
    # enough, it is the call made for the comparison above
    out["plain_ms"] = (plain_ms if reps < 8 else _time_ms(
        lambda: gs.solve_batch_group_reference(*inputs["a"], group=1),
        reps // 4))
    out["B"] = B
    log(f"[kernel] {name}: {kind} C={C} B={B} LPs per launch "
        f"Mp={W0.shape[0]} NT={W0.shape[1]}"
        + (f" ({gs.spill_rows(*W0.shape)} rows in shared memory)"
           if kind == "spill" else "")
        + f"; status equal on {B}/{B} LPs "
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
    numbers at example10's P2 shape, cold and warm, those of the spill
    and the global variant at the spill shapes (by name), and the numbers
    at the bench's device shape (one launch of 256 of its LPs)."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    small = make_instances(16, 16, 8, 0)
    cold = gs.lp_batch_group(*small, device="cuda")
    i0 = int(np.flatnonzero(cold.status == 1)[0])
    _compare("M=N=16 cold", small, None, 20)
    _compare("M=N=16 shared warm", small,
             (cold.basis[i0], cold.at_upper[i0]), 20)
    for M, B in ((160, 16), (200, 16), (500, 8)):
        _compare(f"M=N={M} cold", make_instances(M, M, B, 0), None, 3)
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
    spill = {}
    for name, M, N, B, warm in SPILL_SHAPES:
        args = make_instances(M, N, B, 0)
        if gs.plan(*gs.padded_shape(M, N)) != ("spill", 16):
            raise AssertionError(f"{name}: plans "
                                 f"{gs.plan(*gs.padded_shape(M, N))}")
        key = f"{name} B={B}"
        spill[f"{key} cold"] = _compare(f"{key} cold", args, None, 2,
                                        ab=True)
        if warm:
            cold = gs.lp_batch_group(*args, device="cuda")
            j0 = int(np.flatnonzero(cold.status == 1)[0])
            spill[f"{key} shared warm"] = _compare(
                f"{key} shared warm", args,
                (cold.basis[j0], cold.at_upper[j0]), 2)
    spill["above the band (1024, 3072)"] = _above_band()
    _spill_gate()
    return ex10, ex10_w, spill, bench_shape


def _above_band():
    """ABOVE_BAND's LPs (padded (1024, 3072)): the spill and the global
    variant in turns (spill, global, spill), each cut at ABOVE_STEPS
    pivots, with equal statuses and iterations per LP and ms per loop
    step from the spill kernel's own counts: the times plan's choice
    above the band rests on."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    dev = torch.device("cuda")
    args = make_instances(*ABOVE_BAND, 0)
    inputs = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        inputs["a"] = a
        return real(*a, **kw)

    gs.solve_batch_group = capture
    try:
        gs.lp_batch_group(*args, device=dev, max_iter=ABOVE_STEPS)
    finally:
        gs.solve_batch_group = real
    a = inputs["a"]
    Mp, NT = a[0].shape
    B = a[1].shape[0]
    if gs.plan(Mp, NT) != ("spill", 16):
        raise AssertionError(f"({Mp}, {NT}) plans {gs.plan(Mp, NT)}")
    work = torch.zeros(B, 3, dtype=torch.int32, device=dev)
    s_out = [t.cpu() for t in gs.solve_batch_group(*a, work=work)]
    bound, bound_by, steps, _ = _bound_ms(a, work, *args[0].shape)
    t_s1 = _time_ms(lambda: gs.solve_batch_group(*a), 1)
    g_out, t_g = _event_ms(lambda: gs.solve_batch_group(*a,
                                                        variant="global"))
    t_s2 = _time_ms(lambda: gs.solve_batch_group(*a), 1)
    g_out = [t.cpu() for t in g_out]
    for what, i in (("status", 0), ("iterations", 3)):
        if not torch.equal(s_out[i], g_out[i]):
            raise AssertionError(f"above the band: {what} spill "
                                 f"{s_out[i].tolist()} global "
                                 f"{g_out[i].tolist()}")
    ms = (t_s1 + t_s2) / 2
    log(f"[kernel] above the band (Mp={Mp}, NT={NT}): spill C=16 "
        f"({gs.spill_rows(Mp, NT)} rows in shared memory, "
        f"{(Mp - gs.spill_rows(Mp, NT)) * NT * 4} B spilled per LP) and "
        f"global, B={B} LPs per launch cut at {ABOVE_STEPS} pivots "
        f"(statuses {s_out[0].tolist()} and iterations equal); in turns "
        f"spill {t_s1:.3f}, global {t_g:.3f}, spill {t_s2:.3f} ms (spill / "
        f"global {ms / t_g:.4f}); mean loop steps {steps:.1f}: "
        f"{ms / steps * 1e3:.2f} us per step spill, "
        f"{t_g / steps * 1e3:.2f} global; bound {bound:.3f} ms "
        f"({bound_by}) = {bound / ms:.4f} of the spill kernel's time, "
        f"{bound / t_g:.4f} of the global's")
    return {"C": 16, "B": B, "ms": ms, "ms_global": t_g, "plain_ms": None,
            "bound_ms": bound, "bound_by": bound_by, "err": None,
            "err_global": None}


def _spill_gate():
    """At SPILL_GATE's shape, which a 16-CTA cluster holds: the spill
    variant with half the rows and with all of them in shared memory
    against the cluster variant, cold and from one shared warm basis:
    status, basis, at_upper, iterations and work counts equal on every
    LP.  Cold, the three are timed in turns, and the spill traffic of the
    half-spilled launch (each rank-1 update reads and writes the spilled
    rows, each pricing pass and the initial sums read them) over its
    extra time gives the rate the workspace was streamed at."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    dev = torch.device("cuda")
    args = make_instances(*SPILL_GATE, 3)
    starts = [None]
    cold = gs.lp_batch_group(*args, device=dev)
    j0 = int(np.flatnonzero(cold.status == 1)[0])
    starts.append((cold.basis[j0], cold.at_upper[j0]))
    for start in starts:
        inputs = {}
        real = gs.solve_batch_group

        def capture(*a, **kw):
            inputs["a"] = a
            return real(*a, **kw)

        gs.solve_batch_group = capture
        try:
            gs.lp_batch_group(*args, start_basis=start, device=dev)
        finally:
            gs.solve_batch_group = real
        a = inputs["a"]
        Mp, NT = a[0].shape
        B = a[1].shape[0]
        if gs.plan(Mp, NT) != ("cluster", 16):
            raise AssertionError(f"spill gate: ({Mp}, {NT}) plans "
                                 f"{gs.plan(Mp, NT)}")

        def run(**kw):
            work = torch.zeros(B, 3, dtype=torch.int32, device=dev)
            out = gs.solve_batch_group(*a, work=work, **kw)
            return [t.cpu() for t in out] + [work.cpu()]

        ref = run()
        half = Mp // 2
        for rows in (half, Mp):
            got = run(variant="spill", smem_rows=rows)
            for what, x, y in zip(("status", "basis", "at_upper", "iters",
                                   "work"), got, ref):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"spill gate ({'warm' if start else 'cold'}): "
                        f"{what} differs from the cluster variant's with "
                        f"{rows} of {Mp} rows in shared memory")
        steps, passes, pivots = ref[4].numpy().astype(np.int64).T
        line = (f"[kernel] spill gate M=N={SPILL_GATE[0]} (Mp={Mp}, "
                f"NT={NT}, B={B}) {'shared warm' if start else 'cold'}: "
                f"spill with {half} and with {Mp} of {Mp} rows in shared "
                f"memory gives the cluster variant's status, basis, "
                f"at_upper, iterations and work counts on {B}/{B} LPs "
                f"(statuses {ref[0].tolist()}, iterations "
                f"{ref[3].tolist()})")
        if start is None:
            order = (("cluster", {}), ("spill 0 rows out",
                                       dict(variant="spill", smem_rows=Mp)),
                     ("spill half out", dict(variant="spill",
                                             smem_rows=half)))
            times = {k: [] for k, _ in order}
            for k, kw in order + order[::-1]:
                times[k].append(_time_ms(
                    lambda: gs.solve_batch_group(*a, **kw), 3))
            ms = {k: float(np.mean(v)) for k, v in times.items()}
            moved = float((2 + passes + 2 * pivots).sum()) * (
                (Mp - half) * NT * 4)
            extra = ms["spill half out"] - ms["spill 0 rows out"]
            line += ("; in turns " + ", ".join(
                f"{k} {v[0]:.3f}" for k, v in times.items()) + ", " +
                ", ".join(f"{k} {v[1]:.3f}" for k, v in
                          reversed(list(times.items()))) +
                f" ms; the half-spilled launch moves {moved / 1e9:.3f} GB "
                f"of workspace in {extra:.3f} ms more than the unspilled "
                f"one: {moved / max(extra, 1e-9) / 1e6:.0f} GB/s (HBM "
                f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s); {smi_line()}")
        log(line)


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
    and resets the launch counts of the variants; ``launches`` holds
    them per solve, ``lps`` the LPs of every launch."""

    def __init__(self):
        from bensolve_tpu_torch.lp import group_simplex as gs

        self.gs, self.real, self.events = gs, gs.solve_batch_group, []
        self.launches, self.lps = {}, []

    def __enter__(self):
        def timed(*a, **kw):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = self.real(*a, **kw)
            t1.record()
            self.events.append((t0, t1))
            self.lps.append(int(a[1].shape[0]))
            return out

        self.gs.solve_batch_group = timed
        self.gs.CALLS = self.gs.CALLS_CLUSTER = 0
        self.gs.CALLS_SPILL = self.gs.CALLS_GLOBAL = 0
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
                for k in ("cluster", "spill", "global")}

    def report(self, tag, phase_wall, variant="cluster"):
        kernel_s = self.seconds()
        per = "; ".join(f"{n} {v['cluster']}/{v['spill']}/{v['global']}"
                        for n, v in self.launches.items())
        tot = self.total()
        ms = [a.elapsed_time(b) for a, b in self.events]
        log(f"[{tag}] group_simplex launches cluster/spill/global: {per}; "
            f"total {tot['cluster']}/{tot['spill']}/{tot['global']} (CALLS "
            f"{self.gs.CALLS}); LPs per launch {self.lps}; ms per launch "
            f"{[round(t, 3) for t in ms] if len(ms) <= 16 else '...'}; "
            f"kernel {kernel_s:.3f} s of {phase_wall:.2f} s phase wall "
            f"({kernel_s / phase_wall:.3f}, CUDA events around the "
            f"launches)")
        if tot[variant] <= 0:
            raise AssertionError(f"{tag}: the {variant} kernel was launched "
                                 f"0 times")
        if self.gs.CALLS != sum(tot.values()):
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
        if gs.plan(*gs.padded_shape(*shape)) != ("spill", 16):
            raise AssertionError(f"large phase: LP {shape} plans "
                                 f"{gs.plan(*gs.padded_shape(*shape))}")
    name = f"random_vlp(q={q}, m={m}, n={n})"
    with _KernelClock() as clock:
        r, wall = clock.solve(name, _options(**F32_KW),
                              vlp=examples.random_vlp(q=q, m=m, n=n))
    _report("large f32", name, r, wall, 1e-3)
    return clock.report("large f32", wall, variant="spill")


class _DualChains:
    """Keeps the arguments of the largest warm dual chain (a
    dual_simplex._solve_dual_segmented call started from a KeptState)
    of the solves it wraps, for phase 19."""

    def __enter__(self):
        from bensolve_tpu_torch.lp import dual_simplex

        self.mod, self.real = dual_simplex, dual_simplex._solve_dual_segmented
        self.largest = None

        def recorded(*a, **kw):
            B = a[1].shape[0]
            if kw.get("state_warm") is not None and (
                    self.largest is None or B > self.largest[0][1].shape[0]):
                self.largest = (a, kw)
            return self.real(*a, **kw)

        dual_simplex._solve_dual_segmented = recorded
        return self

    def __exit__(self, *exc):
        self.mod._solve_dual_segmented = self.real


def phase_main_f64():
    """The default float64 path on example10; returns its result."""
    with _DualChains() as chains:
        r, wall = _solve("example10", _options())
    _report("main f64", "example10", r, wall, 1e-4)
    _RESULTS["main f64"] = (r, wall)
    _RESULTS["dual chain"] = chains.largest
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
        # the revised LP layer: one batched device solve, host clock;
        # the largest batch's inputs (copies: a warm solve updates its
        # basis rows in place) kept for phase 19
        kept = _RESULTS.get("tall largest")
        if kept is None or a[2].shape[0] > kept[0][2].shape[0]:
            _RESULTS["tall largest"] = (tuple(
                x.clone() if isinstance(x, torch.Tensor) else x
                for x in a), dict(kw))
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
    segment (``keep``: and keeps the carry each returned), and
    (``split``) the S build, the Cholesky pair and the solves of _Core
    with CUDA events, summed per batch width.  A replayed graph makes no
    Python call to time, so ``split`` runs the IPM eagerly
    (segments.eager_loop)."""

    def __init__(self, split=False, keep=False):
        from bensolve_tpu_torch.lp import ipm

        self.ipm, self.split, self.keep = ipm, split, keep
        self.segments = []          # (batch rows, iterations, seconds)
        self.carries = []
        self.events = {"S build": [], "Cholesky x2": [], "solves": []}
        self.eager = contextlib.ExitStack()

    def __enter__(self):
        from bensolve_tpu_torch.lp import segments

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
            if self.keep:
                self.carries.append(out[0])
            return out

        ipm._ipm_core = timed
        if self.split:
            self.eager.enter_context(segments.eager_loop())
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
        self.eager.close()
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
                for k, v in self.events.items() if v}


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
        with _IPMClock() as clock:
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
            f"{last['polish_skipped']}; chunks {last['chunks']}; "
            f"iterations past the JAX package's stop {last['past_stop']}; "
            f"bound for "
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
    _RESULTS["many largest"] = clock.largest
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

    from bensolve_tpu_torch.lp import segments

    t2, extra_ub = make_p2_instances(MESH_TP_B, **IPM_CONFIG,
                                     dtype=np.float64, device="cuda")
    args = (t2.A_lp,) + tuple(t2.build_inputs(extra_ub))
    M, N = t2.A_lp.shape
    before = segments.counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r0 = simplex.solve_batch(*args, dtype=np.float64, device="cuda",
                             max_iter=MESH_TP_STEPS)
    torch.cuda.synchronize()
    wall0 = time.perf_counter() - t0
    # the unsharded loop replays graphs (lp/segments.py)
    steps = (segments.GRAPH_STEPS + segments.EAGER_STEPS
             - before["graph_steps"] - before["eager_steps"])
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
        f"{steps} steps, {1e3 * wall0 / steps:.3f} ms per step; over "
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
    _segment_line("17 (runner ex10)")
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
    rec, _ = w.ex09_round("cuda", q, m, n, B, clock=_IPMClock())
    log(f"[large] ex09 shape: {w.ex09_line(rec)}")
    M, Nc, width = rec["lp_shape"][0], rec["Nc"], rec["chunk_width"]
    s_bound = w.s_bound_ms(rec, PEAK_FLOPS["float32"])
    bound, bound_by, _ = _iteration_bound(M, Nc, width, "float32")
    done, _, _ = _iteration_bound(M, Nc, width, "float32", needed=False)
    ms = rec["ms_per_iteration"]
    log(f"[large] ex09 shape: {ms:.2f} ms per iteration at B={width} by "
        f"graph (phase 19's eager pair splits it); S build bound "
        f"{s_bound:.2f} ms ({s_bound / width:.2f} per LP: 2 M^2 Nc flops at "
        f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s); iteration bound of the work needed {bound:.2f} ms ({bound_by}) = "
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


def _segment_line(tag, gate=False):
    """The segment counters since the phase began; with ``gate``, fail
    unless the phase replayed graphs."""
    from bensolve_tpu_torch.lp import segments

    c = segments.counts()
    per = "; ".join(
        f"{k} {v['replays']} replays, {v['graph_steps']} by graph, "
        f"{v['eager_steps']} eager" for k, v in c["by_loop"].items()
        if v["replays"] or v["eager_steps"])
    pools = segments.cached_pool_bytes()
    log(f"[segments] phase {tag}: {c['captures']} captures in "
        f"{c['capture_s']:.2f} s, {c['replays']} replays, "
        f"{c['graph_steps']} steps by graph, {c['eager_steps']} eager "
        f"({per or 'no loop ran'}); "
        f"{segments.cached_sets()} graph sets cached, "
        f"{(segments.cached_bytes() - pools) / 2**20:.1f} MiB of static "
        f"buffers and {pools / 2**20:.1f} MiB of memory pools")
    if gate and c["replays"] == 0:
        raise AssertionError(f"phase {tag}: the pivot loops replayed no "
                             f"graph")
    loop = SEGMENT_LOOP_GATE.get(tag)
    if gate and loop and c["by_loop"][loop]["replays"] == 0:
        raise AssertionError(f"phase {tag}: the {loop} loop replayed no "
                             f"graph")


class _LoopClock:
    """A synchronised host clock around every call of a pivot loop, by
    graph or eager: simplex._run_segmented (``revised`` False) or
    revised._run; and what the loops returned (a final state, or the
    revised loop's (state, step))."""

    def __init__(self, revised=False):
        self.revised = revised

    def __enter__(self):
        from bensolve_tpu_torch.lp import revised, simplex

        self.mod, self.name = ((revised, "_run") if self.revised
                               else (simplex, "_run_segmented"))
        self.real = getattr(self.mod, self.name)
        self.seconds, self.states = 0.0, []

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.states.append(out)
            return out

        setattr(self.mod, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def _bits(t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _segment_pair(gate, name, solve, revised=False):
    """solve() with the eager loop and with graphs in turns (eager, graph,
    graph, eager): ms per pivot step of each, the captures and their
    seconds; every run's final loop states bit for bit the first eager
    run's (``revised``: the revised loops', and their returned steps).
    Returns the runs."""
    from bensolve_tpu_torch.lp import segments
    from bensolve_tpu_torch.lp.revised import RSTATE_FIELDS

    fields = RSTATE_FIELDS if revised else segments.FIELDS
    runs, ref = [], None
    for mode in ("eager", "graph", "graph", "eager"):
        segments.reset_counts()
        eager = mode == "eager"
        with (segments.eager_loop() if eager else contextlib.nullcontext()), \
                _LoopClock(revised) as clock:
            solve()
        c = segments.counts()
        steps = c["eager_steps"] if eager else c["graph_steps"]
        gate(steps > 0 and (c["graph_steps"] == 0 if eager
                            else c["eager_steps"] == 0 and c["replays"] > 0),
             f"{name}: a {mode} run took the other loop ({c})")
        if ref is None:
            ref = clock.states
        else:
            gate(len(clock.states) == len(ref),
                 f"{name}: {len(clock.states)} loops against {len(ref)}")
            for i, (a, b) in enumerate(zip(ref, clock.states)):
                if revised:
                    gate(a[1] == b[1], f"{name}: loop {i} returned step "
                         f"{b[1]} against {a[1]}, {mode} run {len(runs)}")
                    a, b = a[0], b[0]
                for f in fields:
                    x, y = getattr(a, f), getattr(b, f)
                    gate(x.shape == y.shape and torch.equal(_bits(x),
                                                            _bits(y)),
                         f"{name}: loop {i}'s {f} differs, {mode} run "
                         f"{len(runs)} against the first eager run")
        runs.append(dict(mode=mode, seconds=clock.seconds, steps=steps,
                         loops=len(clock.states),
                         ms_per_step=1e3 * clock.seconds / steps,
                         captures=c["captures"], capture_s=c["capture_s"],
                         replays=c["replays"]))
    eager_ms = [r["ms_per_step"] for r in runs if r["mode"] == "eager"]
    replay_ms = runs[2]["ms_per_step"]
    log(f"[segments] {name}: ms per pivot step eager {eager_ms[0]:.4f}, "
        f"graph {runs[1]['ms_per_step']:.4f} (with {runs[1]['captures']} "
        f"captures in {runs[1]['capture_s']:.2f} s), graph {replay_ms:.4f} "
        f"({runs[2]['captures']} captures, {runs[2]['replays']} replays), "
        f"eager {eager_ms[1]:.4f}; {runs[0]['steps']} steps in "
        f"{runs[0]['loops']} loops; replayed graph / eager "
        f"{replay_ms / np.mean(eager_ms):.3f}; final states bit for bit "
        f"equal in every run ({len(fields)} fields"
        f"{' and the returned step' if revised else ''})")
    return runs


def _ex10_p2(B, seed=0):
    """B P2 LPs of example10: its P2 template, the row bounds of random
    frontier vertices (float64)."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs.templates import INHOMOGENEOUS, P2Template

    vlp = examples.example10()
    q = vlp.q
    Z = np.eye(q) / (np.eye(q).T @ np.full(q, 1.0 / q))[None, :]
    t2 = P2Template(vlp, vlp.P.astype(float), Z, np.full(q, 1.0 / q),
                    INHOMOGENEOUS, device="cuda")
    V = np.random.default_rng(seed).random((B, q)) * 2.0 + 1.0
    return (t2.A_lp,) + tuple(t2.build_inputs(V @ t2.ZR))


def _many_largest():
    """Phase 13's largest merged round, or, run alone, config #5's."""
    if "many largest" not in _RESULTS:
        from bensolve_tpu_torch import examples
        from bensolve_tpu_torch.algs import many
        from bensolve_tpu_torch.vlp.options import Options

        vlps = [examples.random_vlp(**MANY_VLP, seed=s)
                for s in range(MANY_N)]
        with _ManyClock() as clock:
            many.solve_many(vlps, Options(bounded=True, write_files=False,
                                          device="cuda"))
        _RESULTS["many largest"] = clock.largest
    return _RESULTS["many largest"]


def phase_segments():
    """The pivot segments as CUDA graphs against the eager loop, in
    turns, at the shapes of the main path (see the module's docstring)."""
    from bensolve_tpu_torch.lp import dual_simplex, simplex

    gate = _Gates("segments")
    f64 = dict(dtype=np.float64, device="cuda")
    out = {}
    args = _ex10_p2(SEG_EX10_B)
    M, N = args[0].shape
    out["example10 P2"] = _segment_pair(
        gate, f"example10 P2 LPs ({M}x{N}, padded "
        f"{simplex._bucket(M)}x{simplex._bucket(M) + simplex._bucket(N)}) "
        f"B={SEG_EX10_B} to the end", lambda: simplex.solve_batch(*args,
                                                                  **f64))
    t2, extra_ub = make_p2_instances(MESH_TP_B, **IPM_CONFIG,
                                     dtype=np.float64, device="cuda")
    args = (t2.A_lp,) + tuple(t2.build_inputs(extra_ub))
    out["config #4"] = _segment_pair(
        gate, f"config #4 P2 LPs B={MESH_TP_B} cut at {SEG_STEPS}",
        lambda: simplex.solve_batch(*args, max_iter=SEG_STEPS, **f64))
    if _RESULTS.get("dual chain") is None:
        phase_main_f64()
    gate(_RESULTS["dual chain"] is not None,
         "example10's solve ran no warm dual chain")
    a, kw = _RESULTS["dual chain"]
    out["dual chain"] = _segment_pair(
        gate, f"example10's largest warm dual chain (B={a[1].shape[0]}, "
        f"padded NT={a[1].shape[1]}, from a KeptState of age "
        f"{kw['state_warm'][0].age})",
        lambda: dual_simplex._solve_dual_segmented(*a, **kw))
    t7, extra_ub = make_p2_instances(SEG_EX07_B, **SEG_EX07,
                                     dtype=np.float64, device="cuda")
    args7 = (t7.A_lp,) + tuple(t7.build_inputs(extra_ub))
    M, N = t7.A_lp.shape
    out["ex07 chunk"] = _segment_pair(
        gate, f"ex07 fallback chunk: {SEG_EX07_B} cold P2 LPs of "
        f"random_vlp({SEG_EX07}) ({M}x{N}) cut at {SEG_STEPS}",
        lambda: simplex.solve_batch(*args7, max_iter=SEG_STEPS, **f64))
    del t7, args7
    a, kw = _many_largest()
    out["config #5 round"] = _segment_pair(
        gate, f"config #5's largest round ({a[1].shape[0]} LPs "
        f"{a[0].shape[1]}x{a[0].shape[2]}, 3-D)",
        lambda: simplex.solve_batch(*a, **kw))
    del a, kw
    out.update(_revised_pairs(gate))
    out.update(_ipm_pairs(gate))
    log(f"[segments] {gate.passed} gates passed; {smi_line()}")
    return out


def _revised_bound_ms(M, N, B, itemsize):
    """The bytes a revised pivot step must move, at HBM's rate, in ms:
    four passes over B^-1 (y = cB B^-1, alpha = B^-1 E_q, and the
    rank-1 update's read and write) and one read of A (the pivot row
    b_r E for the devex weights and the carried costs), on the LP's
    unpadded M x N; a step that reprices exactly reads A once more."""
    return (4 * B * M * M + M * N) * itemsize / HBM_BYTES_PER_S * 1e3


def _revised_pair_line(name, runs, M, N, B, itemsize):
    bound = _revised_bound_ms(M, N, B, itemsize)
    eager = np.mean([r["ms_per_step"] for r in runs if r["mode"] == "eager"])
    replay = runs[2]["ms_per_step"]
    log(f"[segments] {name}: revised ms per step eager {eager:.4f}, "
        f"replayed {replay:.4f}, bound {bound:.4g} (bytes: 4 passes over "
        f"B^-1 and one read of A at 3.35 TB/s); replayed / bound "
        f"{replay / bound:.2f}, eager / bound {eager / bound:.2f}")
    return dict(runs=runs, bound_ms=bound, M=M, N=N, B=B)


def _revised_pairs(gate):
    """Phase 19's revised pairs: phase 8's largest batched solve to its
    end, and ex09's shape through revised._run alone, cut."""
    from bensolve_tpu_torch.lp import revised, simplex

    out = {}
    if "tall largest" not in _RESULTS:
        phase_tall()
    a, kw = _RESULTS["tall largest"]

    def tall():
        revised._solve_revised_segmented(*(
            x.clone() if isinstance(x, torch.Tensor) else x for x in a),
            **kw)

    M, N = a[0].shape
    q, m, n = TALL
    with simplex._tf32_off():
        runs = _segment_pair(
            gate, f"tall random_vlp(q={q}, m={m}, n={n})'s largest revised "
            f"batch (B={a[2].shape[0]}, padded {M}x{a[2].shape[1]}) to the "
            f"end", tall, revised=True)
    lp = (m + 2 * q + 1, n + q + 1)
    out["tall largest"] = _revised_pair_line(
        "tall largest batch", runs, *lp, a[2].shape[0], 8)
    del a, kw

    A9, *rest = _ex09_p2()
    c, rlb, rub, clb, cub = (x[:SEG_EX09_B] for x in rest)
    M9, N9 = A9.shape
    sc = revised._prepare_scaled(A9, np.float64, torch.device("cuda"))
    r, cv = sc.rscale, sc.cscale
    prep = sc.prep
    AT = prep.transposed()
    Bp = simplex._bucket_batch(SEG_EX09_B, prep.Mp)
    put = lambda x: simplex._put(x, "cuda")  # noqa: E731
    c_t, lb_t, ub_t = (put(x) for x in simplex._pad_batch_inputs(
        prep, c * cv[None, :], rlb * r[None, :], rub * r[None, :],
        clb / cv[None, :], cub / cv[None, :], Bp, np.float64))
    every = revised._refactor_interval(prep.Mp, c_t.shape[1], c_t.dtype)
    with simplex._tf32_off():
        st0 = revised._initial_rstate(prep.dev, c_t, lb_t, ub_t)

        def ex09():
            st = dataclasses.replace(st0, **{
                f: getattr(st0, f).clone() for f in revised.RSTATE_FIELDS})
            revised._run(prep.dev, AT, c_t, lb_t, ub_t, st, 0,
                         SEG_EX09_STEPS, every)

        runs = _segment_pair(
            gate, f"ex09's shape: {Bp} P2 LPs of random_vlp({SEG_EX09}) "
            f"({M9}x{N9}, padded {prep.Mp}x{c_t.shape[1]}), exact bounds, "
            f"revised._run cut at {SEG_EX09_STEPS} (refactorization every "
            f"{every})", ex09, revised=True)
    out["ex09 shape"] = _revised_pair_line("ex09 shape", runs, M9, N9, Bp,
                                           8)
    del st0, prep, sc, AT, c_t, lb_t, ub_t
    revised._S_CACHE.clear()
    return out


def _ex09_p2():
    """The P2 LPs of ex09's shape, random_vlp(**SEG_EX09), made once for
    phase 19's revised pair (its first SEG_EX09_B) and interior-point
    pair (its first SEG_IPM_EX09_B): (A, c, row_lb, row_ub, col_lb,
    col_ub)."""
    if "ex09 p2" not in _RESULTS:
        t9, extra_ub = make_p2_instances(max(SEG_EX09_B, SEG_IPM_EX09_B),
                                         **SEG_EX09, dtype=np.float64,
                                         device="cuda")
        _RESULTS["ex09 p2"] = (t9.A_lp,) + tuple(t9.build_inputs(extra_ub))
    return _RESULTS["ex09 p2"]


def _ipm_pair(gate, name, solve, M, Nc, B, dtype):
    """solve() (one solve_batch_ipm call) with the eager loop and with
    graphs in turns (eager, graph, graph, eager): ms per iteration (a
    synchronised host clock around every _ipm_core segment, over the
    iterations the segments ran), captures and their seconds, peak
    device memory; every segment's returned carry, all 16 entries, bit
    for bit the first eager run's.  The last eager run also splits its
    iterations by CUDA events (the S build, the Cholesky pair, the
    solves; the first run pays the libraries' first calls).  Returns
    the runs and the iteration bound at B."""
    from bensolve_tpu_torch.lp import ipm, segments

    runs, ref = [], None
    for mode in ("eager", "graph", "graph", "eager"):
        eager = mode == "eager"
        segments.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with (segments.eager_loop() if eager else contextlib.nullcontext()), \
                _IPMClock(split=len(runs) == 3, keep=True) as clock:
            solve()
        peak = torch.cuda.max_memory_allocated()
        c = segments.counts()["by_loop"]["ipm"]
        its = sum(n for _, n, _ in clock.segments)
        gate(its > 0 and (c["graph_steps"] == 0 and c["eager_steps"] == its
                          if eager else c["eager_steps"] == 0
                          and c["graph_steps"] == its and c["replays"] > 0),
             f"{name}: a {mode} run took the other loop ({c}, {its} "
             f"iterations)")
        if ref is None:
            ref = clock.carries
        else:
            gate(len(clock.carries) == len(ref),
                 f"{name}: {len(clock.carries)} segments against {len(ref)}")
            for i, (a, b) in enumerate(zip(ref, clock.carries)):
                gate(len(a) == len(b) == 16, f"{name}: carry entries")
                for k, (x, y) in enumerate(zip(a, b)):
                    gate(x.shape == y.shape and torch.equal(_bits(x),
                                                            _bits(y)),
                         f"{name}: segment {i}'s carry[{k}] differs, {mode} "
                         f"run {len(runs)} against the first eager run")
        runs.append(dict(mode=mode, seconds=clock.device_seconds(),
                         iterations=its, segments=len(clock.segments),
                         past_stop=ipm.LAST["past_stop"],
                         widths=sorted({b for b, _, _ in clock.segments},
                                       reverse=True),
                         ms_per_iteration=1e3 * clock.device_seconds() / its,
                         captures=c["captures"], capture_s=c["capture_s"],
                         replays=c["replays"], peak_mib=peak / 2**20,
                         parts_ms=clock.part_ms(its)))
    bound, bound_by, _ = _iteration_bound(M, Nc, B, dtype)
    eager_ms = [r["ms_per_iteration"] for r in runs if r["mode"] == "eager"]
    replay = runs[2]["ms_per_iteration"]
    parts = ", ".join(f"{k} {v:.3f} ms"
                      for k, v in runs[3]["parts_ms"].items())
    log(f"[segments] IPM {name}: ms per iteration eager {eager_ms[0]:.3f}, "
        f"graph {runs[1]['ms_per_iteration']:.3f} (with {runs[1]['captures']}"
        f" captures in {runs[1]['capture_s']:.2f} s), graph {replay:.3f} "
        f"({runs[2]['captures']} captures, {runs[2]['replays']} replays), "
        f"eager {eager_ms[1]:.3f}; {runs[0]['iterations']} iterations in "
        f"{runs[0]['segments']} segments at widths {runs[0]['widths']}, "
        f"{runs[0]['past_stop']} of them past the JAX package's stop; "
        f"replayed / eager {replay / np.mean(eager_ms):.3f}; phase 10's "
        f"iteration bound at B={B} {bound:.4g} ms ({bound_by}) = "
        f"{bound / replay:.3f} of the replayed, "
        f"{bound / np.mean(eager_ms):.3f} of the eager; peak device memory "
        f"MiB " + ", ".join(f"{r['mode']} {r['peak_mib']:.0f}" for r in runs)
        + f"; last eager run per iteration ({parts}); every segment's "
        f"carry bit for bit equal in every run (16 entries)")
    return dict(runs=runs, bound_ms=bound, bound_by=bound_by, B=B, M=M,
                Nc=Nc)


def _ipm_pairs(gate):
    """Phase 19's interior-point pairs (see SEG_IPM_ITERS), each one
    solve_batch_ipm call with the host HiGHS fallback capped at 0 and,
    where cut, no host polish (at ex09's shape the route polishes
    nothing anyway)."""
    from bensolve_tpu_torch.lp import ipm

    out = {}
    f32 = dict(dtype=np.float32, device="cuda")

    def free_cols(clb, cub):
        return int(np.sum(~np.isfinite(clb).any(axis=0)
                          & ~np.isfinite(cub).any(axis=0)))

    with host_fallback_cap(0):
        t2, extra_ub = make_p2_instances(IPM_B, **IPM_CONFIG,
                                         dtype=np.float32, device="cuda")
        args = (t2.A_lp,) + tuple(t2.build_inputs(extra_ub))
        M, N = t2.A_lp.shape
        Nc = N + free_cols(args[4], args[5])
        for B in (IPM_B, SEG_IPM_TAIL_B):
            a = (args[0],) + tuple(x[:B] for x in args[1:])
            out[f"config #4 B={B}"] = _ipm_pair(
                gate, f"config #4 P2 LPs ({M}x{N}) B={B} float32 cut at "
                f"{SEG_IPM_ITERS} iterations",
                lambda a=a: ipm.solve_batch_ipm(
                    *a, max_iter=SEG_IPM_ITERS, polish=False, **f32),
                M, Nc, B, "float32")
        del t2, args, a
        q, m, n = IPM_VLP
        tv, extra_ub = make_p2_instances(SEG_IPM_VLP_B, q=q, m=m, n=n,
                                         seed=0, dtype=np.float64,
                                         device="cuda")
        args = (tv.A_lp,) + tuple(tv.build_inputs(extra_ub))
        M, N = tv.A_lp.shape
        out["random_vlp P2"] = _ipm_pair(
            gate, f"random_vlp{IPM_VLP} P2 LPs ({M}x{N}) "
            f"B={SEG_IPM_VLP_B} float64 to the end",
            lambda: ipm.solve_batch_ipm(*args, dtype=np.float64,
                                        device="cuda"),
            M, N + free_cols(args[4], args[5]), SEG_IPM_VLP_B, "float64")
        A9, *rest = _ex09_p2()
        a = (A9,) + tuple(x[:SEG_IPM_EX09_B] for x in rest)
        M, N = A9.shape
        out["ex09 shape"] = _ipm_pair(
            gate, f"ex09's shape: P2 LPs of random_vlp({SEG_EX09}) "
            f"({M}x{N}) B={SEG_IPM_EX09_B} float32 cut at "
            f"{SEG_IPM_EX09_ITERS} iterations",
            lambda: ipm.solve_batch_ipm(*a, max_iter=SEG_IPM_EX09_ITERS,
                                        polish=False, **f32),
            M, N + free_cols(a[4], a[5]), SEG_IPM_EX09_B, "float32")
    del a, A9, rest
    _RESULTS.pop("ex09 p2", None)
    ipm._CACHE.clear()
    return out


class _StepRecorder:
    """Wraps simplex._pad_batch_inputs and simplex._run_segmented while
    the main path solves: the first loop start of each (step, Mp, NT,
    Bp) with its c, lb and ub (``starts``, cloned contiguous, as the
    loop steps them), and per loop call (``loops``) its key, the LPs
    asked for and their unpadded M and N (from the padding call just
    before, as benchmark/probes/pivot_clock.py takes them), the steps it
    ran, the kernel steps among them and a synchronised host clock
    around it; ``prices`` counts tableau_step.price calls (one update
    kernel launch each)."""

    def __enter__(self):
        from bensolve_tpu_torch.lp import segments, simplex, tableau_step

        self.sx, self.ts = simplex, tableau_step
        self.real = (simplex._pad_batch_inputs, simplex._run_segmented,
                     tableau_step.price)
        self.starts, self.loops, self.prices = {}, [], 0
        self._shape = None
        real_pad, real_run, real_price = self.real

        def pad(prep, c, *a, **kw):
            self._shape = (np.atleast_2d(np.asarray(c)).shape[0], prep.M,
                           prep.N)
            return real_pad(prep, c, *a, **kw)

        def run(step_fn, A, c, lb, ub, st, max_iter):
            dual = getattr(step_fn, "dual", False)
            Bp, Mp, NT = st.W.shape
            key = ("dual" if dual else "primal", Mp, NT, Bp)
            if key not in self.starts:
                self.starts[key] = (c.contiguous().clone(),
                                    lb.contiguous().clone(),
                                    ub.contiguous().clone(),
                                    _clone_state(st))
            shape, self._shape = self._shape, None
            s0 = segments.GRAPH_STEPS + segments.EAGER_STEPS
            k0 = segments.KERNEL_STEPS
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_run(step_fn, A, c, lb, ub, st, max_iter)
            torch.cuda.synchronize()
            self.loops.append(dict(
                key=key, shape=shape, dtype=str(c.dtype).split(".")[-1],
                steps=segments.GRAPH_STEPS + segments.EAGER_STEPS - s0,
                kernel_steps=segments.KERNEL_STEPS - k0,
                seconds=time.perf_counter() - t0))
            return out

        def price(*a, **kw):
            self.prices += 1
            return real_price(*a, **kw)

        simplex._pad_batch_inputs, simplex._run_segmented = pad, run
        tableau_step.price = price
        return self

    def __exit__(self, *exc):
        (self.sx._pad_batch_inputs, self.sx._run_segmented,
         self.ts.price) = self.real


def _clone_state(st):
    """A contiguous copy of every field of a tableau loop state."""
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone(
            memory_format=torch.contiguous_format)
        for f in dataclasses.fields(st) if getattr(st, f.name) is not None})


def _d_error(gate, tag, dual, c, st):
    """The worst distance of ``st.d`` from a fresh c_eff - cB_eff W, over
    the scale of that sum (|c_eff| + |cB_eff| |W|); fails past
    STEP_D_TOL."""
    from bensolve_tpu_torch.lp import simplex

    if dual:
        feas, cbe = torch.ones_like(st.status, dtype=torch.bool), st.cB
    else:
        _, _, feas, cbe = simplex._phase_costs(st)
    ce = torch.where(feas[:, None], c, torch.zeros_like(c))
    d = ce - torch.bmm(cbe[:, None, :], st.W)[:, 0, :]
    scale = ce.abs() + torch.bmm(cbe.abs()[:, None, :], st.W.abs())[:, 0, :]
    err = (st.d - d).abs()
    gate(bool((err <= STEP_D_TOL * scale).all()),
         f"{tag}: reduced costs {float((err / scale).max())} of their scale "
         f"from a fresh c_eff - cB_eff W (limit {STEP_D_TOL})")
    return float((err / scale.clamp_min(1e-300)).max())


def _rows_differ(x, y):
    """(B,) True where the rows of two state fields differ in any bit."""
    if x is None or y is None:
        return None if x is y else True
    return (_bits(x) != _bits(y)).reshape(x.shape[0], -1).any(1)


def _step_compare(gate, tag, dual, c, lb, ub, st):
    """One kernel step (tableau_step.price, then step) from ``st`` against
    the plain torch step from the same state, twice.  Fed the kernel's
    own prices (simplex._reduced_costs handing it the priced d), the
    plain step must give every STEP_EXACT field bit for bit on every LP.
    With its own (cuBLAS) prices, the LPs it steps otherwise are
    counted: there the two sums, in other orders, broke a near-tie of
    the pricing apart.  The kernel's prices before the step and the
    reduced costs it carries after it lie within STEP_D_TOL of their
    sums' scale from a fresh c_eff - cB_eff W.  Returns (the worst such
    ratio, LPs running before the step, LPs whose iterations or status
    it changed, the LPs stepped otherwise under cuBLAS's prices)."""
    from bensolve_tpu_torch.lp import dual_simplex, simplex, tableau_step

    plain = dual_simplex._dstep_plain if dual else simplex._step_plain
    priced = tableau_step.price(c, _clone_state(st), dual)
    worst = _d_error(gate, f"{tag}, before the step", dual, c, priced)
    prices, real = priced.d.clone(), simplex._reduced_costs
    simplex._reduced_costs = lambda *a: prices.clone()
    try:
        fed = plain(None, c, lb, ub, _clone_state(st))
    finally:
        simplex._reduced_costs = real
    own = plain(None, c, lb, ub, _clone_state(st))
    got = tableau_step.step(c, lb, ub, priced, dual)
    torch.cuda.synchronize()
    other = torch.zeros_like(st.status, dtype=torch.bool)
    for f in STEP_EXACT:
        x, y = getattr(fed, f), getattr(got, f)
        rows = _rows_differ(x, y)
        if rows is not None and rows is not True and bool(rows.any()):
            log(f"[tableau step] {tag}: {f} differs on LPs "
                f"{torch.nonzero(rows).flatten().tolist()[:16]}")
        gate(rows is None or (rows is not True and not bool(rows.any())),
             f"{tag}: {f} differs from the plain step's fed the same "
             f"prices")
        rows = _rows_differ(getattr(own, f), y)
        if rows is not None:
            other |= rows
    worst = max(worst, _d_error(gate, f"{tag}, after the step", dual, c,
                                got))
    running = int((st.status == simplex.RUNNING).sum())
    changed = (got.iters != st.iters) | (got.status != st.status)
    return (worst, running, int(changed.sum()),
            torch.nonzero(other).flatten().tolist())


def _graph_step_ms(step, c, lb, ub, st, profile=False):
    """ms per step of a CUDA graph of STEP_GRAPH_K steps of ``step`` from
    a copy of ``st``, replayed STEP_REPS times (CUDA events); with
    ``profile``, also each tableau_step kernel's device ms per step in
    one more replay (torch.profiler; {} where it sees no device time)."""
    st = _clone_state(st)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x = _clone_state(st)
        for _ in range(3):
            x = step(None, c, lb, ub, x)
    torch.cuda.current_stream().wait_stream(side)
    del x
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x = st
        for _ in range(STEP_GRAPH_K):
            x = step(None, c, lb, ub, x)
    graph.replay()
    torch.cuda.synchronize()
    ms = _time_ms(graph.replay, STEP_REPS) / STEP_GRAPH_K
    per = {}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        with prof(activities=[ProfilerActivity.CUDA]) as p:
            graph.replay()
            torch.cuda.synchronize()
        for ev in p.key_averages():
            t = (getattr(ev, "device_time_total", 0)
                 or getattr(ev, "cuda_time_total", 0))
            for name in STEP_KERNELS:
                if name in ev.key and t:
                    per[name] = per.get(name, 0.0) + t / 1e3 / STEP_GRAPH_K
    graph.reset()
    return ms, per


def phase_tableau_step():
    """The tableau pivot step's two kernels (lp/tableau_step.py) on the
    main path (see the module's docstring)."""
    from benchmark.roofline import pivot_step_least_s
    from bensolve_tpu_torch.lp import (dual_simplex, group_simplex, segments,
                                       simplex, tableau_step)

    gate = _Gates("tableau step")
    t0 = time.perf_counter()
    tableau_step._library()
    log(f"[tableau step] library built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    main = {}
    with _StepRecorder() as rec:
        for label, name, kw in STEP_SOLVES:
            # once first, so that the counted solve replays the graphs
            # this one captured (as every solve after a process's first)
            _solve(name, _options(**kw))
            n0 = len(rec.loops)
            p0 = rec.prices
            g0 = group_simplex.CALLS
            segments.reset_counts()
            r, wall = _solve(name, _options(**kw))
            c = segments.counts()
            by = c["by_loop"]
            loops = rec.loops[n0:]
            steps = {k: by[k]["graph_steps"] + by[k]["eager_steps"]
                     for k in ("tableau", "dual")}
            gate(r.status.name == "OPTIMAL", f"{label}: {r.status}")
            gate(c["kernel_steps"] == sum(steps.values()) > 0,
                 f"{label}: KERNEL_STEPS {c['kernel_steps']} against the "
                 f"loops' {steps}")
            for k in ("tableau", "dual"):
                gate(by[k]["kernel_steps"] == steps[k],
                     f"{label}: {k} loop kernel steps {by[k]}")
            gate(by["revised"]["kernel_steps"] == by["ipm"]["kernel_steps"]
                 == 0, f"{label}: kernel steps outside the tableau loops")
            gate(group_simplex.CALLS == g0,
                 f"{label}: the f32 group kernel was launched")
            gate(rec.prices - p0 == len(loops),
                 f"{label}: {rec.prices - p0} pricings for {len(loops)} "
                 f"loops")
            gate(all(lp["shape"] is not None for lp in loops),
                 f"{label}: a loop without its padding call")
            bound = 1e3 * sum(
                lp["steps"] * pivot_step_least_s(*lp["shape"], lp["dtype"])
                for lp in loops)
            loop_ms = 1e3 * sum(lp["seconds"] for lp in loops)
            main[label] = dict(
                launches_primal_choice=by["tableau"]["kernel_steps"],
                launches_dual_choice=by["dual"]["kernel_steps"],
                launches_update=c["kernel_steps"] + rec.prices - p0,
                loops=len(loops), loop_ms=loop_ms, bound_ms=bound,
                wall_s=wall)
            log(f"[tableau step] {label}: {r.status.name} in {wall:.2f} s; "
                f"KERNEL_STEPS {c['kernel_steps']} = tableau "
                f"{steps['tableau']} + dual {steps['dual']} steps "
                f"(graph + eager); {len(loops)} loops, each priced once; "
                f"update kernel launches {main[label]['launches_update']}; "
                f"pivot loops {loop_ms:.1f} ms (synchronised host clock) "
                f"against a bound of {bound:.2f} ms "
                f"({100 * bound / loop_ms:.1f}%); group_simplex launches "
                f"unchanged")
    keys = sorted(rec.starts, key=lambda k: (k[1], k[3], k[0]))
    compared = {}
    for key in keys:
        dual = key[0] == "dual"
        c, lb, ub, st = rec.starts[key]
        tag = f"{key[0]} ({key[1]}, {key[2]}) Bp {key[3]}"
        worst, running, moved, other = _step_compare(
            gate, tag + " loop start", dual, c, lb, ub, st)
        plain = dual_simplex._dstep_plain if dual else simplex._step_plain
        ahead = 0
        while ahead < STEP_ADVANCE:
            nxt = plain(None, c, lb, ub, st)
            if not bool((nxt.status == simplex.RUNNING).any()):
                break
            st, ahead = nxt, ahead + 1
        w2, r2, m2, o2 = _step_compare(gate, f"{tag} after {ahead} steps",
                                       dual, c, lb, ub, st)
        gate(moved + m2 > 0, f"{tag}: neither step changed an LP")
        compared[key] = dict(worst_d=max(worst, w2), running=(running, r2),
                             changed=(moved, m2), ahead=ahead,
                             other_under_cublas=(other, o2))
        log(f"[tableau step] {tag}: one step from the loop start "
            f"({running} LPs running, {moved} changed) and after {ahead} "
            f"plain steps ({r2} running, {m2} changed): "
            f"{', '.join(STEP_EXACT)} bit for bit the plain step's fed the "
            f"same prices; the prices within {max(worst, w2):.1e} of their "
            f"scale (limit {STEP_D_TOL}); LPs stepped otherwise under "
            f"cuBLAS's prices {other} and {o2}")
    timed = {}
    for key in keys:
        if (key[1], key[2], key[3]) not in STEP_TIMED:
            continue
        dual = key[0] == "dual"
        c, lb, ub, st = rec.starts[key]
        plain = dual_simplex._dstep_plain if dual else simplex._step_plain
        kern = dual_simplex._dstep if dual else simplex._step
        plain_ms, _ = _graph_step_ms(plain, c, lb, ub, st)
        kernel_ms, per = _graph_step_ms(
            kern, c, lb, ub, tableau_step.price(c, _clone_state(st), dual),
            profile=True)
        bound = 1e3 * pivot_step_least_s(key[3], key[1], key[2] - key[1],
                                         "float64")
        timed[key] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                          per_kernel_ms=per)
        log(f"[tableau step] {key[0]} ({key[1]}, {key[2]}) Bp {key[3]}: "
            f"kernel step {kernel_ms:.5f} ms ("
            + (", ".join(f"{k} {v:.5f}" for k, v in per.items())
               or "the profiler saw no device time")
            + f"), plain step {plain_ms:.5f} ms, both as replayed graphs "
            f"of {STEP_GRAPH_K} steps (CUDA events); bound {bound:.5f} ms "
            f"on the padded tableau: {100 * bound / kernel_ms:.1f}% of "
            f"it, {plain_ms / kernel_ms:.1f}x the plain step")
    del rec
    torch.cuda.empty_cache()
    for need in STEP_NEEDED:
        gate(any(k[0] == need[0] and k[1:3] == need[1:3]
                 and (len(need) == 3 or k[3] == need[3]) for k in keys),
             f"no recorded loop of {need}")
    log(f"[tableau step] {gate.passed} gates passed; {smi_line()}")
    return dict(main=main, compared=compared, timed=timed)


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
    ex10, ex10_w, spill, bench_shape = _timed("3", phase_kernel)
    tableau = _timed("20", phase_tableau_step)
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
    _timed("19", phase_segments)
    _log_total(t_start)
    log(smi_line())
    log(json.dumps({"graft": graft}))
    base = {"route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "library_ms": None}
    bench_launches = bench_line["device_kernel_launches"]
    band = spill["band (768, 1152) B=8 cold"]
    band_w = spill["band (768, 1152) B=8 shared warm"]
    ab = [v for v in spill.values() if "ms_global" in v]

    def launch_counts(kind):
        return dict(launches=launches_large[kind] if kind == "spill"
                    else launches[kind],
                    launches_f32_examples=launches[kind],
                    launches_large_f32=launches_large[kind],
                    launches_dual_f32=launches_dual[kind],
                    launches_bench_device=bench_launches[kind])

    log(json.dumps({"kernels": [
        dict(name="group_simplex_cluster", **base, **launch_counts("cluster"),
             cluster_size=ex10["C"], max_abs_err=ex10["err"],
             ms=ex10["ms"], ms_warm=ex10_w["ms"],
             plain_ms=ex10["plain_ms"], bound_ms=ex10["bound_ms"],
             bound_by=ex10["bound_by"],
             bench_shape=_shape_numbers(bench_shape, "ms")),
        dict(name="group_simplex_spill", **base, **launch_counts("spill"),
             cluster_size=16, max_abs_err=max(
                 v["err"] for v in spill.values() if v["err"] is not None),
             ms=band["ms"], ms_warm=band_w["ms"], plain_ms=band["plain_ms"],
             bound_ms=band["bound_ms"], bound_by=band["bound_by"],
             shapes={k: _shape_numbers(v, "ms") for k, v in spill.items()}),
        dict(name="group_simplex_global", **base, **launch_counts("global"),
             max_abs_err=max([ex10["err_global"], ex10_w["err_global"],
                              bench_shape["err_global"]]
                             + [v["err_global"] for v in ab
                                if v["err_global"] is not None]),
             ms=band["ms_global"], plain_ms=band["plain_ms"],
             bound_ms=band["bound_ms"], bound_by=band["bound_by"],
             shapes={k: _shape_numbers(v, "ms_global") for k, v in
                     spill.items() if "ms_global" in v},
             ex10_shape=dict(ms=ex10["ms_global"],
                             ms_warm=ex10_w["ms_global"],
                             plain_ms=ex10["plain_ms"],
                             bound_ms=ex10["bound_ms"]),
             bench_shape=_shape_numbers(bench_shape, "ms_global"))]
        + [_tableau_entry(tableau, name) for name in STEP_KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _tableau_entry(out, name):
    """A kernel of lp/csrc/tableau_step.cu on the kernels line: its
    launches on phase 20's main-path solves (KERNEL_STEPS by loop, and
    for the update kernel the loops' pricings too), per solve with the
    pivot loops' ms beside their bound; at ex10's (384, 768) Bp 256 its
    own device ms (profiler; None where it saw none), the kernel step's
    and the plain step's ms, and the step's bound; every timed shape of
    its step; the worst carried reduced cost from the comparisons."""
    key = {"primal_choice_kernel": "launches_primal_choice",
           "dual_choice_kernel": "launches_dual_choice",
           "tableau_update_kernel": "launches_update"}[name]
    step = "dual" if name.startswith("dual") else "primal"
    steps = (step,) if name != "tableau_update_kernel" else ("primal",
                                                             "dual")
    ex10 = out["timed"].get((step, 384, 768, 256), {})
    return dict(
        name=name, route="cuda", source=TABLEAU_SOURCE,
        replaces=TABLEAU_REPLACES[name], library_ms=None,
        launches=sum(v[key] for v in out["main"].values()),
        launches_by_solve={k: v[key] for k, v in out["main"].items()},
        main_path={k: dict(loop_ms=v["loop_ms"], bound_ms=v["bound_ms"])
                   for k, v in out["main"].items()},
        ms=ex10.get("per_kernel_ms", {}).get(name), step_ms=ex10.get("ms"),
        plain_ms=ex10.get("plain_ms"), bound_ms=ex10.get("bound_ms"),
        shapes={f"{k[0]} ({k[1]}, {k[2]}) Bp {k[3]}": v
                for k, v in out["timed"].items() if k[0] in steps},
        max_rel_err_d=max(v["worst_d"] for k, v in out["compared"].items()
                          if k[0] in steps))


def _shape_numbers(out, ms_key):
    """A variant's numbers at one phase-3 shape: its time (``ms_key``),
    the plain version's, the bound and LPs per launch where measured."""
    return {"C": out["C"] if ms_key == "ms" else 0, "B": out["B"],
            "ms": out[ms_key], "plain_ms": out["plain_ms"],
            "bound_ms": out.get("bound_ms"), "bound_by": out.get("bound_by"),
            "max_abs_err": out["err" if ms_key == "ms" else "err_global"]}


def _phase_4():
    """Phase 4 alone (--only 4): the examples, then the large VLP."""
    phase_main_f32()
    phase_large_f32()


PHASES = {"2": phase_build, "3": phase_kernel, "4": _phase_4,
          "5": phase_main_f64, "7": phase_dual_f32, "8": phase_tall,
          "9": phase_revised_vs_cpu, "10": phase_ipm_config4,
          "11": phase_ipm_e2e,
          "12": phase_ipm_vs_cpu, "13": phase_many, "14": phase_aux,
          "15": phase_mesh, "16": phase_bench, "17": phase_large,
          "18": phase_graft, "19": phase_segments,
          "20": phase_tableau_step}
# seconds per phase, and the mesh phase's passed gates, for [total]
_PHASE_S = {}


def _timed(key, fn, *args):
    from bensolve_tpu_torch.lp import segments

    segments.reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    _PHASE_S[key] = time.perf_counter() - t0
    if key in SEGMENT_PHASES:
        _segment_line(key, gate=key in SEGMENT_REPLAY_GATE)
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
