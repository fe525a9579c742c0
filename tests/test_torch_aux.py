"""The port's run-time modules against the JAX package's, on the CPU:
checkpoint/resume (io/checkpoint.py and its plumbing in phases.py and
driver.py), the single-process side of parallel/distributed.py and
``Options.distributed``, the profiler (``Options.profile_dir``), the
OFF/INST plots (io/plot.py, CLI ``--plot``) and the .vlp writer
(vlp/writer.py).

Vertex sets are compared within 1e-7, plot files number by number within
1e-9, written .vlp files byte for byte.  A snapshot written by either
package must resume in the other.
"""

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu import __main__ as jax_cli
from bensolve_tpu import examples
from bensolve_tpu.algs.driver import solve as jax_solve
from bensolve_tpu.parallel import distributed as jdist
from bensolve_tpu.vlp.options import Alg as JaxAlg
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu.vlp.reader import read_vlp as jax_read_vlp
from bensolve_tpu.vlp.writer import write_vlp as jax_write_vlp
from bensolve_tpu_torch import __main__ as torch_cli
from bensolve_tpu_torch.convert import (problem_from_reference,
                                        problems_from_reference)
from bensolve_tpu_torch.io import checkpoint as tckpt
from bensolve_tpu_torch.parallel import distributed as tdist
from bensolve_tpu_torch.vlp.options import Alg
from bensolve_tpu_torch.vlp.reader import read_vlp
from bensolve_tpu_torch.vlp.writer import write_vlp
from tests.test_e2e import check_support

ALGS = {"primal": {}, "dual": dict(alg_phase1="dual", alg_phase2="dual")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(cls, alg_cls, device=None, **kw):
    for k in ("alg_phase1", "alg_phase2"):
        if k in kw:
            kw[k] = alg_cls(kw[k])
    if device:
        kw["device"] = device
    return cls(write_files=False, **kw)


def jopt(**kw):
    return _opts(JaxOptions, JaxAlg, **kw)


def topt(**kw):
    return _opts(bt.Options, Alg, device="cpu", **kw)


def assert_sets_close(a, b, tol=1e-7):
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    assert a.shape == b.shape, (a, b)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=2)
    assert (d.min(axis=1) <= tol).all() and (d.min(axis=0) <= tol).all()


def assert_same_images(a, b):
    assert a.status.name == b.status.name == "OPTIMAL"
    assert_sets_close(a.primal_points, b.primal_points)
    assert_sets_close(a.dual_points, b.dual_points)


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("name,alg", [("example05", "primal"),
                                      ("example01", "dual"),
                                      ("example05", "dual")])
def test_checkpoint_resume_matches_uninterrupted(name, alg, tmp_path):
    """The last snapshot of a run resumes to the run's own result, with
    the LP and round counts carried on from the snapshot."""
    ck = str(tmp_path / "state.ckpt")
    vlp = problem_from_reference(getattr(examples, name)())
    full = bt.solve(vlp, topt(checkpoint_path=ck, **ALGS[alg]))
    assert os.path.exists(ck)
    _, _, meta = tckpt.load_checkpoint(ck)
    assert meta["phase"] == ("phase2_dual" if alg == "dual"
                             else "phase2_primal")
    again = bt.solve(vlp, topt(**ALGS[alg]), resume=ck)
    assert_same_images(full, again)
    assert again.swap == full.swap
    assert again.stats.lps >= meta["lps"] > 0
    assert again.stats.rounds >= meta["round"] > 0


def test_phase1_checkpoint_resume(tmp_path, monkeypatch):
    """tests/test_checkpoint.py's simulated crash right after the first
    phase-1 snapshot, in the port: the resumed run finishes phase 1 from
    the snapshot and equals the uninterrupted one."""
    ck = str(tmp_path / "p1.ckpt")
    vlp = problem_from_reference(examples.example05())
    ref = bt.solve(vlp, topt())
    real = tckpt.save_checkpoint

    def crash_after_first_phase1(path, **kw):
        real(path, **kw)
        if kw["phase"].startswith("phase1"):
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(tckpt, "save_checkpoint", crash_after_first_phase1)
    with pytest.raises(RuntimeError, match="simulated crash"):
        bt.solve(vlp, topt(checkpoint_path=ck))
    monkeypatch.setattr(tckpt, "save_checkpoint", real)
    assert tckpt.load_checkpoint(ck)[2]["phase"] == "phase1_primal"
    assert_same_images(ref, bt.solve(vlp, topt(), resume=ck))


def test_checkpoint_every_counts_rounds(tmp_path, monkeypatch):
    saved = []
    monkeypatch.setattr(tckpt, "save_checkpoint",
                        lambda path, **kw: saved.append(kw["round_no"]))
    vlp = problem_from_reference(examples.example05())
    r = bt.solve(vlp, topt(checkpoint_path="unused", checkpoint_every=2))
    assert r.status.name == "OPTIMAL"
    every = list(saved)
    saved.clear()
    bt.solve(vlp, topt(checkpoint_path="unused"))
    assert len(saved) > len(every) > 0


def _early_snapshot(solve_fn, ckpt_mod, monkeypatch, path, phase):
    """Run ``solve_fn`` keeping only the FIRST snapshot of ``phase`` (a
    mid-run state: most of the phase's rounds are still to come)."""
    real = ckpt_mod.save_checkpoint
    state = {"done": False}

    def first_only(p, **kw):
        if kw["phase"] == phase and not state["done"]:
            state["done"] = True
            real(p, **kw)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", first_only)
    out = solve_fn()
    monkeypatch.setattr(ckpt_mod, "save_checkpoint", real)
    assert state["done"]
    return out


@pytest.mark.parametrize("alg", ["primal", "dual"])
def test_jax_snapshot_resumes_in_the_port(alg, tmp_path, monkeypatch):
    from bensolve_tpu.io import checkpoint as jckpt

    ck = str(tmp_path / "jax.ckpt")
    vlp = examples.example05()
    phase = "phase2_dual" if alg == "dual" else "phase2_primal"
    ref = _early_snapshot(
        lambda: jax_solve(vlp, jopt(checkpoint_path=ck, **ALGS[alg])),
        jckpt, monkeypatch, ck, phase)
    got = bt.solve(problem_from_reference(vlp), topt(**ALGS[alg]),
                   resume=ck)
    assert_same_images(ref, got)
    check_support(got, tol=1e-7)


@pytest.mark.parametrize("alg", ["primal", "dual"])
def test_port_snapshot_resumes_in_jax(alg, tmp_path, monkeypatch):
    ck = str(tmp_path / "torch.ckpt")
    vlp = examples.example05()
    phase = "phase2_dual" if alg == "dual" else "phase2_primal"
    ref = _early_snapshot(
        lambda: bt.solve(problem_from_reference(vlp),
                         topt(checkpoint_path=ck, **ALGS[alg])),
        tckpt, monkeypatch, ck, phase)
    got = jax_solve(vlp, jopt(**ALGS[alg]), resume=ck)
    assert_same_images(ref, got)


def test_snapshot_keys_are_the_jax_packages(tmp_path):
    """Same .npz keys and the same meta fields from both packages at the
    same point of the same run."""
    vlp = examples.example05()
    a, b = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    jax_solve(vlp, jopt(checkpoint_path=a))
    bt.solve(problem_from_reference(vlp), topt(checkpoint_path=b))
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    ma, mb = (json.loads(bytes(z["meta_json"]).decode()) for z in (za, zb))
    assert ma == mb
    for key in za.files:
        if key != "meta_json":
            np.testing.assert_allclose(zb[key], za[key], rtol=0, atol=1e-7,
                                       err_msg=key)


# ------------------------------------------------------------ distributed

@pytest.mark.parametrize("n,pid,pcount", [(7, 0, 2), (7, 1, 2), (3, 3, 4),
                                          (0, 0, 2), (10, 2, 3)])
def test_shard_indices_equal_the_jax_function(n, pid, pcount):
    np.testing.assert_array_equal(
        tdist.shard_indices(n, process_id=pid, process_count=pcount),
        jdist.shard_indices(n, process_id=pid, process_count=pcount))


def test_single_process_degenerates_to_local():
    tdist.initialize()           # no coordinator address: a no-op
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(tdist.shard_indices(5), np.arange(5))
    rows = np.arange(12.0).reshape(4, 3)
    assert tdist.allgather_rows(rows, total=4) is rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canonical_order_equals_the_jax_function(seed):
    rng = np.random.default_rng(seed)
    cuts = np.round(rng.standard_normal((9, 3)), 1)
    cuts[4] = cuts[1]                       # ties
    cuts[7, 0] = cuts[2, 0] + 1e-14         # equal after rounding
    np.testing.assert_array_equal(tdist.canonical_order(cuts),
                                  jdist.canonical_order(cuts))
    assert tdist.canonical_order(np.zeros((0, 3))).size == 0


@pytest.mark.parametrize("alg", ["primal", "dual"])
def test_distributed_single_process_parity(alg):
    """distributed=True on one process: the same run twice gives
    bit-identical points, the JAX package's run gives the same set and
    the same counts, and the oracle holds."""
    vlp = examples.example05()
    ref = jax_solve(vlp, jopt(distributed=True, **ALGS[alg]))
    got = bt.solve(problem_from_reference(vlp),
                   topt(distributed=True, **ALGS[alg]))
    again = bt.solve(problem_from_reference(vlp),
                     topt(distributed=True, **ALGS[alg]))
    np.testing.assert_array_equal(got.primal_points, again.primal_points)
    np.testing.assert_array_equal(got.dual_points, again.dual_points)
    assert_same_images(ref, got)
    assert (got.stats.lps, got.stats.rounds, got.stats.cuts) == (
        ref.stats.lps, ref.stats.rounds, ref.stats.cuts)
    check_support(got, tol=1e-7)
    plain = bt.solve(problem_from_reference(vlp), topt(**ALGS[alg]))
    assert_sets_close(got.primal_points, plain.primal_points, 1e-6)


def test_distributed_preimages_parity():
    """solution=True under distributed=True: the gathered rows carry the
    pre-images too."""
    vlp = examples.example05()
    ref = jax_solve(vlp, jopt(distributed=True, solution=True))
    got = bt.solve(problem_from_reference(vlp),
                   topt(distributed=True, solution=True))
    assert_same_images(ref, got)
    for pj, pt in ((ref.pair.primal, got.pair.primal),
                   (ref.pair.dual, got.pair.dual)):
        assert pt.dim_primg == pj.dim_primg > 0
        a = {tuple(np.round(pj.data[i], 6)): pj.primg[i, :pj.dim_primg]
             for i in pj.live()}
        b = {tuple(np.round(pt.data[i], 6)): pt.primg[i, :pt.dim_primg]
             for i in pt.live()}
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9, atol=1e-9)


# --------------------------------------------------------------- profiler

def test_profile_dir_leaves_a_trace(tmp_path):
    prof = tmp_path / "prof"
    vlp = problem_from_reference(examples.example01())
    r = bt.solve(vlp, topt(profile_dir=str(prof)))
    assert r.status.name == "OPTIMAL"
    assert r.opt.profile_dir == ""       # the inner, unprofiled run
    traces = glob.glob(str(prof / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    plain = bt.solve(vlp, topt())
    np.testing.assert_array_equal(r.primal_points, plain.primal_points)


# ------------------------------------------------------------------ plots

_NUM = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def assert_files_equal_numerically(path_a, path_b, tol=1e-9):
    with open(path_a) as fa, open(path_b) as fb:
        ta, tb = fa.read().split(), fb.read().split()
    assert len(ta) == len(tb), (path_a, path_b)
    for x, y in zip(ta, tb):
        if _NUM.match(x) and _NUM.match(y):
            assert abs(float(x) - float(y)) <= tol * (1 + abs(float(y))), \
                (path_a, x, y)
        else:
            # the INST wrapper names its own OFF file
            assert x == y or x.endswith(".off") and y.endswith(".off"), \
                (path_a, x, y)


@pytest.mark.parametrize("alg", ["primal", "dual"])
def test_cli_plot_writes_the_same_off_and_inst_files(alg, tmp_path):
    src = tmp_path / "ex05.vlp"
    jax_write_vlp(examples.example05(), str(src))
    base_j, base_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    flags = ["-m", "0", "--plot"]
    if alg == "dual":
        flags += ["-A", "dual", "-a", "dual"]
    assert jax_cli.main([str(src), "-o", base_j] + flags) == 0
    assert torch_cli.main([str(src), "-o", base_t, "--device", "cpu"]
                          + flags) == 0
    for suffix in ("_p.off", "_d.off", "_p.inst", "_d.inst"):
        assert os.path.getsize(base_t + suffix) > 0
        assert_files_equal_numerically(base_j + suffix, base_t + suffix)
    for suffix in ("_img_p.sol", "_img_d.sol"):
        with open(base_j + suffix) as fj, open(base_t + suffix) as ft:
            assert ft.read() == fj.read(), suffix


def test_plot_option_keeps_the_solution():
    """plot=True saves the swapped pair and leaves the result as it is
    without it; q != 3 saves nothing."""
    vlp = problem_from_reference(examples.example05())
    plain = bt.solve(vlp, topt())
    plotted = bt.solve(vlp, topt(plot=True))
    assert plotted.plot_swap_pair is not None
    assert plain.plot_swap_pair is None
    np.testing.assert_array_equal(plain.primal_points,
                                  plotted.primal_points)
    r2 = bt.solve(problem_from_reference(examples.example01()),
                  topt(plot=True))
    assert r2.plot_swap_pair is None


# ------------------------------------------------------------ .vlp writer

@pytest.mark.parametrize("name", ["example01", "example05", "example06"])
def test_write_vlp_round_trip_and_jax_writer_parity(name, tmp_path):
    ref_vlp = getattr(examples, name)()
    vlp = problem_from_reference(ref_vlp)
    a, b = str(tmp_path / "jax.vlp"), str(tmp_path / "torch.vlp")
    jax_write_vlp(ref_vlp, a)
    write_vlp(vlp, b)
    with open(a) as fa, open(b) as fb:
        assert fb.read() == fa.read()
    back = read_vlp(b)
    np.testing.assert_array_equal(back.A, vlp.A)
    np.testing.assert_array_equal(back.P, vlp.P)
    for side in ("rows", "cols"):
        for field in ("types", "lb", "ub"):
            np.testing.assert_array_equal(
                getattr(getattr(back, side), field),
                getattr(getattr(vlp, side), field))
    assert back.optdir == vlp.optdir
    # the cone fields as the JAX reader reads them from the JAX file
    ref_back = jax_read_vlp(a)
    assert back.cone_gen.value == ref_back.cone_gen.value
    for field in ("gen", "c"):
        x, y = getattr(back, field), getattr(ref_back, field)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_problems_from_reference_converts_a_list():
    refs = [examples.example01(), examples.example05()]
    out = problems_from_reference(refs)
    assert [type(v).__module__ for v in out] == [
        "bensolve_tpu_torch.vlp.problem"] * 2
    for r, v in zip(refs, out):
        np.testing.assert_array_equal(v.A, r.A)
        np.testing.assert_array_equal(v.P, r.P)
