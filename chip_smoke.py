"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one output line (or block) each:

1. environment: torch/CUDA versions, the card's name and power limit,
   nvcc, triton, the native polytope engine; TF32 matmuls switched off;
2. build: the per-LP simplex kernel from lp/csrc/group_simplex.cu;
3. kernel vs its plain PyTorch version on the card, cold and shared-warm
   random batches at M=N=16 (B=8) and at example10's P2 shape (Mp=384,
   NT=768, B=256), timed with CUDA events;
4. the main path at float32 (the kernel's route): solve() on example01,
   05, 08 and 10, with the kernel's launch count reset just before and
   read just after, held to the support-function oracle at 1e-3;
5. the main path at the default float64 (torch ops) on example10, held
   to the support oracle at 1e-4;
6. the result line.

The second-to-last line is one JSON object with the kernels of the path
(name, route, source, the TPU kernel it replaces, launches in phase 4,
max |kernel - plain| on the phase-3 batch, kernel and plain times); the
last line is {"ok": true, "device": {...}}.  Any failed phase raises and
exits non-zero before those lines.  Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
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
KERNEL_SOURCE = "bensolve_tpu_torch/lp/csrc/group_simplex.cu"
KERNEL_REPLACES = "bensolve_tpu/lp/pallas_simplex.py:55"
REL_TOL = 1e-4       # float32 kernel vs plain: other summation orders


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
    from bensolve_tpu_torch.lp import _build, group_simplex

    t0 = time.perf_counter()
    group_simplex._library()
    seconds, nvcc_log = _build.build_info("group_simplex")
    ptxas = [ln for ln in nvcc_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[build] group_simplex for sm_90a: nvcc {seconds:.1f} s, load "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(ptxas))


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
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _compare(name, args, start_basis, reps):
    """Kernel and plain version on the same device inputs: equal status
    per LP, obj / x / row_dual within REL_TOL relative, timings."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    dev = torch.device("cuda")
    inputs = {}
    real_wrapper = gs.solve_batch_group

    def capture(*a):
        inputs["a"] = a
        return real_wrapper(*a)

    gs.solve_batch_group = capture
    try:
        ker = gs.lp_batch_group(*args, start_basis=start_basis, device=dev)
    finally:
        gs.solve_batch_group = real_wrapper
    W0, c, lb, ub, basis0, atup, max_iter = inputs["a"]
    st_k, basis_k, atup_k, it_k = gs.solve_batch_group(*inputs["a"])
    st_p, basis_p, atup_p, it_p = gs.solve_batch_group_reference(
        *inputs["a"], group=1)
    torch.cuda.synchronize()
    st_k, st_p = st_k.cpu().numpy(), st_p.cpu().numpy()
    if not (st_k == st_p).all():
        raise AssertionError(f"{name}: kernel status {st_k} != plain {st_p}")
    # the plain version's solutions, recovered exactly as the wrapper does
    plain = _recover(gs, args, start_basis, st_p, basis_p, atup_p, it_p, dev)
    B = args[1].shape[0]
    it_k, it_p = it_k.cpu().numpy()[:B], it_p.cpu().numpy()[:B]
    same_basis = (basis_k.cpu().numpy()[:B] == basis_p.cpu().numpy()[:B]
                  ).all(axis=1)
    ok = ker.status == 1
    # obj on every optimal LP; x and row_dual where both ended in the same
    # basis (an LP that is dual degenerate within the float32 tolerance
    # has several optimal vertices with one objective value)
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
    band = float(np.abs(it_k - it_p).max())
    if band > 0.25 * max(1, it_p.max()) + 16:
        raise AssertionError(f"{name}: iteration counts differ by {band}")
    ms = _time_ms(lambda: gs.solve_batch_group(*inputs["a"]), reps)
    plain_ms = _time_ms(lambda: gs.solve_batch_group_reference(
        *inputs["a"], group=1), max(1, reps // 4))
    log(f"[kernel] {name}: B={B} Mp={W0.shape[0]} NT={W0.shape[1]} "
        f"status equal on {B}/{B} LPs ({int(ok.sum())} optimal); "
        f"rel err obj {errs['obj'][0]:.1e} x {errs['x'][0]:.1e} "
        f"row_dual {errs['row_dual'][0]:.1e}; identical basis+iters on "
        f"{np.mean(same_basis & (it_k == it_p)):.3f} of LPs (x and row_dual "
        f"compared on the {int(same_basis.sum())} with equal basis); iters "
        f"max |kernel-plain| {band:.0f} (band 0.25*max+16); mean iters "
        f"kernel {it_k.mean():.1f} plain {it_p.mean():.1f}; "
        f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms per solve")
    return errs["obj"][1], ms, plain_ms


def _recover(gs, args, start_basis, status, basis, at_upper, iters, dev):
    """lp_batch_group's recovery applied to the plain version's output."""
    real = gs.solve_batch_group
    gs.solve_batch_group = lambda *a: (torch.as_tensor(status, device=dev),
                                       basis, at_upper, iters)
    try:
        return gs.lp_batch_group(*args, start_basis=start_basis, device=dev)
    finally:
        gs.solve_batch_group = real


def phase_kernel():
    """Returns (max |obj err|, kernel ms, plain ms) at the ex10 shape."""
    from bensolve_tpu_torch.lp import group_simplex as gs

    small = make(16, 16, 8, 0)
    cold = gs.lp_batch_group(*small, device="cuda")
    i0 = int(np.flatnonzero(cold.status == 1)[0])
    _compare("M=N=16 cold", small, None, 20)
    _compare("M=N=16 shared warm", small,
             (cold.basis[i0], cold.at_upper[i0]), 20)
    big = make(350, 347, 256, 1)
    assert gs.padded_shape(350, 347) == (384, 768)
    err, ms, plain_ms = _compare("ex10 P2 shape cold", big, None, 3)
    warm = gs.lp_batch_group(*big, device="cuda")
    j0 = int(np.flatnonzero(warm.status == 1)[0])
    _compare("ex10 P2 shape shared warm", big,
             (warm.basis[j0], warm.at_upper[j0]), 3)
    return err, ms, plain_ms


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


def _solve(name, opt):
    from bensolve_tpu_torch import examples, solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve(examples.ALL[name](), opt)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_main_f32():
    """The float32 main path; returns the kernel's launch count."""
    from bensolve_tpu_torch.lp import dual_simplex, group_simplex
    from bensolve_tpu_torch.vlp.options import Options

    kept_devices = set()
    real_dual = dual_simplex.solve_batch_dual

    def watch(*a, **kw):
        out = real_dual(*a, **kw)
        if kw.get("keep_state") and out[1] is not None:
            kept_devices.add(out[1].W.device.type)
        return out

    dual_simplex.solve_batch_dual = watch
    group_simplex.CALLS = 0
    runs = []
    try:
        for name in ("example01", "example05", "example08", "example10"):
            r, wall = _solve(name, Options(write_files=False, device="cuda",
                                           **F32_KW))
            runs.append((name, r, wall))
    finally:
        dual_simplex.solve_batch_dual = real_dual
    launches = group_simplex.CALLS
    for name, r, wall in runs:
        if r.status.name != "OPTIMAL":
            raise AssertionError(f"{name} float32: status {r.status}")
        gap = check_support(r, 1e-3)
        log(f"[main f32] {name}: OPTIMAL in {wall:.2f} s, points "
            f"{len(r.primal_points)} directions {len(r.primal_directions)} "
            f"LPs {r.stats.lps} rounds {r.stats.rounds} pivots "
            f"{r.stats.pivots}; support oracle worst gap {gap:.1e} "
            f"(limit 1e-3)")
    if launches <= 0:
        raise AssertionError("float32 main path launched the kernel 0 times")
    if kept_devices != {"cuda"}:
        raise AssertionError(f"kept tableau devices {kept_devices}")
    log(f"[main f32] group_simplex kernel launches: {launches}; kept "
        f"tableau device: {sorted(kept_devices)}")
    return launches


def phase_main_f64():
    from bensolve_tpu_torch.vlp.options import Options

    r, wall = _solve("example10", Options(write_files=False, device="cuda"))
    if r.status.name != "OPTIMAL":
        raise AssertionError(f"example10 float64: status {r.status}")
    gap = check_support(r, 1e-4)
    log(f"[main f64] example10: OPTIMAL in {wall:.2f} s, points "
        f"{len(r.primal_points)} directions {len(r.primal_directions)} "
        f"LPs {r.stats.lps} rounds {r.stats.rounds} pivots "
        f"{r.stats.pivots}; support oracle worst gap {gap:.1e} "
        f"(limit 1e-4)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 1
    phase_environment()
    phase_build()
    err, ms, plain_ms = phase_kernel()
    launches = phase_main_f32()
    phase_main_f64()
    log(json.dumps({"kernels": [{
        "name": "group_simplex", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
