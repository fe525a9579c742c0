"""The pivot step's CUDA kernels (lp/tableau_step.py,
lp/csrc/tableau_step.cu) as far as the CPU sees them.  Required:

* on CPU tensors simplex._step and dual_simplex._dstep are the plain
  torch steps, bit for bit, and no pivot loop prices or counts a kernel
  step (segments.KERNEL_STEPS stays 0);
* importing the port and solving on the CPU neither builds nor loads the
  kernels' library;
* a graph set counts, per replay, the kernel steps its capture launched
  (not the warm-up's), and an eager segment those it launched, on the
  stand-in backend of tests/torch_graph_standin.py;
* the update kernel's tile: one tile for ex11's LPs, tiles one warp wide
  for ex10's, within the block's threads at every bucketed shape;
* the source and its binding agree on the entry points, the pointer
  count and the status codes.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bensolve_tpu_torch.lp import dual_simplex as tdx
from bensolve_tpu_torch.lp import segments
from bensolve_tpu_torch.lp import simplex as tsx
from bensolve_tpu_torch.lp import tableau_step
from tests.test_ipm import random_lp
from tests.torch_graph_standin import StandIn, bits, standing_in

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _empty_cache():
    segments.clear()
    yield
    segments.clear()


def _no_kernel(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CUDA step ran on CPU tensors")

    monkeypatch.setattr(tableau_step, "step", refuse)
    monkeypatch.setattr(tableau_step, "price", refuse)


def _start(seed=3):
    A, c, rlb, rub, clb, cub = random_lp(20, 24, 6, seed=seed)
    prep = tsx._prepare_A(A, np.float64, "cpu")
    Bp = tsx._bucket_batch(6, prep.Mp)
    full_c, lb, ub = tsx._pad_batch_inputs(prep, c, rlb, rub, clb, cub, Bp,
                                           np.float64)
    c_t, lb_t, ub_t = (tsx._put(x, "cpu") for x in (full_c, lb, ub))
    return prep.dev, c_t, lb_t, ub_t, tsx._initial_state(prep.dev, c_t,
                                                         lb_t, ub_t)


@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_cpu_step_is_the_plain_step(dual, monkeypatch):
    """Three steps of _step / _dstep on CPU tensors equal three of
    _step_plain / _dstep_plain bit for bit, without the CUDA step."""
    _no_kernel(monkeypatch)
    A, c, lb, ub, st = _start()
    step, plain = ((tdx._dstep, tdx._dstep_plain) if dual
                   else (tsx._step, tsx._step_plain))
    a = b = st
    for _ in range(3):
        a = step(A, c, lb, ub, tsx._State(**{
            f: getattr(a, f).clone() for f in segments.FIELDS}))
        b = plain(A, c, lb, ub, tsx._State(**{
            f: getattr(b, f).clone() for f in segments.FIELDS}))
    for f in segments.FIELDS:
        assert torch.equal(bits(getattr(a, f)), bits(getattr(b, f))), f
    assert a.d is None and b.d is None


def test_cpu_solves_count_no_kernel_step(monkeypatch):
    """A primal solve and a dual chain on the CPU, eagerly and through
    the stand-in graphs: no CUDA step, KERNEL_STEPS 0 in every loop."""
    _no_kernel(monkeypatch)
    A, c, rlb, rub, clb, cub = random_lp(20, 24, 6, seed=9)
    segments.reset_counts()
    cold = tsx.solve_batch(A, c, rlb, rub, clb, cub, device="cpu")
    tdx.solve_batch_dual(A, c, rlb, rub * 0.99, clb, cub,
                         start_basis=(cold.basis, cold.at_upper),
                         device="cpu")
    assert segments.EAGER_STEPS > 0
    with standing_in():
        tsx.solve_batch(A, c, rlb, rub, clb, cub, device="cpu")
    counts = segments.counts()
    assert counts["graph_steps"] > 0
    assert counts["kernel_steps"] == 0
    assert all(v["kernel_steps"] == 0 for v in counts["by_loop"].values())


def test_import_and_cpu_solve_neither_build_nor_load_the_kernel():
    """A fresh process imports the port and solves example01 on the CPU
    with the library's build and load refused: the solve ends, no
    library was loaded and no kernel step counted."""
    code = (
        "from bensolve_tpu_torch.lp import _build\n"
        "def refuse(*a, **kw):\n"
        "    raise SystemExit('a library was built or loaded: %r' % (a,))\n"
        "_build.build = _build.load = refuse\n"
        "import bensolve_tpu_torch as bt\n"
        "from bensolve_tpu_torch import examples\n"
        "from bensolve_tpu_torch.lp import segments, tableau_step\n"
        "bt.solve(examples.example01(), bt.Options(device='cpu',\n"
        "                                          write_files=False))\n"
        "assert segments.EAGER_STEPS > 0, segments.counts()\n"
        "assert segments.KERNEL_STEPS == 0, segments.counts()\n"
        "assert tableau_step._LIB is None and not _build._LOADED\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


class _Tracing(StandIn):
    """The stand-in, with a capture that runs the segment's Python once,
    as a CUDA capture does (which records the kernels it launches; here
    the steps also run, on the static buffers: a count is all this
    backend is for)."""

    def capture(self, fn, pool, stream):
        fn()
        return super().capture(fn, pool, stream)


def test_graph_sets_count_the_kernel_steps_their_captures_launched():
    """A step that tallies a kernel step as the CUDA step does: each
    replay adds its capture's count (k for a graph of k steps; the
    warm-up's steps are not counted), and an eager segment the steps it
    ran, so KERNEL_STEPS equals the loop's steps both ways."""
    def tallied(*a):
        segments.tally_kernel_step()
        return tsx._step_plain(*a)

    A, c, lb, ub, st = _start(seed=5)
    segments.reset_counts()
    with segments.eager_loop():
        tsx._run_segmented(tallied, A, c, lb, ub, st, 40)
    assert segments.KERNEL_STEPS == segments.EAGER_STEPS > 0
    A, c, lb, ub, st = _start(seed=5)
    segments.reset_counts()
    segments.BACKENDS["cpu"] = _Tracing()
    try:
        t0 = segments.tally()
        tsx._run_segmented(tallied, A, c, lb, ub, st, 40)
    finally:
        segments.clear()
        del segments.BACKENDS["cpu"]
    by = segments.counts()["by_loop"]["tableau"]
    assert by["graph_steps"] > 0 and by["eager_steps"] == 0
    assert by["kernel_steps"] == by["graph_steps"] == segments.KERNEL_STEPS
    # the tally also saw the warm-up and the replays' Python calls
    assert segments.tally() - t0 > by["graph_steps"]


def test_update_tiles_adapt_to_the_shape():
    """ex11's LPs, (48, 64) and (80, 96), are one tile each; ex10's
    (384, 768) splits into 24 tiles one warp wide with 16 row groups; at
    every bucketed shape a block has at most THREADS_UPDATE threads and
    no more row groups than rows, and the tiles cover every column."""
    assert tableau_step.plan(48, 64) == (64, 8)
    assert tableau_step.plan(80, 96) == (96, 5)
    assert tableau_step.plan(384, 768) == (32, 16)
    for M in range(1, 1200, 7):
        for N in (1, 5, 40, 347, 1000):
            Mp, NT = tsx._bucket(M), tsx._bucket(M) + tsx._bucket(N)
            tile, rows = tableau_step.plan(Mp, NT)
            assert 1 <= rows <= Mp
            assert tile * rows <= tableau_step.THREADS_UPDATE
            assert tile == NT or tile == tableau_step.WARP
            assert -(-NT // tile) * tile >= NT


def test_kernel_source_agrees_with_its_binding():
    """csrc/tableau_step.cu exports the entry points tableau_step.py
    binds, unpacks STEP_PTRS pointers, and numbers the statuses as
    simplex.py does."""
    with open(os.path.join(ROOT, "bensolve_tpu_torch", "lp", "csrc",
                           "tableau_step.cu")) as f:
        src = f.read()
    for name in ("tableau_choice_f64",
                 "tableau_choice_f32", "tableau_update_f64",
                 "tableau_update_f32"):
        assert re.search(rf"^int {name}\(", src, re.M), name
    assert f"kStepPtrs = {tableau_step.STEP_PTRS};" in src
    unpack = src[src.index("Step<T> unpack_step"):]
    unpack = unpack[:unpack.index("return s;")]
    used = sorted({int(i) for i in re.findall(r"p\[(\d+)\]", unpack)})
    assert used == list(range(tableau_step.STEP_PTRS))
    for name in ("RUNNING", "OPTIMAL", "INFEASIBLE", "UNBOUNDED"):
        assert f"constexpr int {name} = {getattr(tsx, name)};" in src
