"""The port's large-example runner (bensolve_tpu_torch.slow_runner) against
the repo's slow_runner.py on the CPU, and the slow, data-gated
counterparts of tests/test_e2e_large.py.

The JAX runner reads ``/<reference>/<ex>.vlp`` through
``bensolve_tpu.vlp.reader.read_vlp`` at call time; here that name returns
a VLP the repo builds, and the port's runner is given the same VLP.
Required:

* ``CONFIGS["ex10"]`` on example05 (float64): the rows equal (status,
  LPs, rounds, points, directions, support verdict, loose cuts), and the
  upper-image points, directions and lower-image points within 1e-7;
* ``CONFIGS["ex07"]`` on ``random_vlp(q=2, m=20, n=2000, seed=7)``, whose
  LPs (25 x 2003) pass M + N >= 2000 and take the interior-point route
  in both packages at float32: equal status, rounds, directions and
  support verdict (pass@0.05), and the two upper images within the ex07
  eps of each other (support functions at 4096 weights).  The LP and
  point counts are not equal: the packages' float32 IPMs round apart
  (XLA against torch) and Benson's eps decisions then take other cuts
  (ROADMAP Queue 3 q); they are held within 5% of each other.

Also: the environment is restored after a run, on success and on
failure; a run cut after its first phase-2 snapshot and resumed under
BENSOLVE_RESUME=1 equals the uninterrupted one; a missing ex07 or ex09
file raises and names the file; the results table keeps
SLOW_RESULTS.md's columns; the witness's ex09-shape round, at a small
shape, passes its certificates with the host fallback capped at 0 and
builds no sparse matrix for HiGHS.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bensolve_tpu.algs.driver as jdriver
import bensolve_tpu.vlp.reader as jreader
from bensolve_tpu import examples as jexamples
from bensolve_tpu.lp import ipm as jipm
from bensolve_tpu_torch import examples as texamples
from bensolve_tpu_torch import slow_runner as tr
from bensolve_tpu_torch.bench import check_support, images_close
from bensolve_tpu_torch.io import checkpoint as tckpt
from bensolve_tpu_torch.lp import ipm as tipm
from bensolve_tpu_torch.vlp.writer import write_vlp
from tests.test_torch_e2e import _norm, assert_sets_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of a row both runners fill alike (wall and the card aside)
ROW_KEYS = ("ex", "status", "lps", "rounds", "points", "directions",
            "support", "backend", "loose_cuts", "loose_deferred")
ENV = ("BENSOLVE_IPM_BYTES", "BENSOLVE_IPM_MAXIT",
       "BENSOLVE_HOST_FALLBACK_MAX", "BENSOLVE_RESUME")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_runner(monkeypatch, tmp_path):
    """run(ex, vlp) -> (row, result) through slow_runner.run_one, with
    the VLP in place of the reference's file, its checkpoints under
    tmp_path and no compile-cache set-up."""
    # slow_runner.py sets this default when imported
    monkeypatch.setenv("BENSOLVE_IPM_BYTES", tr.IPM_BYTES)
    import slow_runner

    monkeypatch.setattr(slow_runner, "_setup_compile_cache", lambda: None)
    results = []
    real = jdriver.solve

    def solve(vlp, opt, resume=None):
        opt = dataclasses.replace(
            opt, checkpoint_path=str(tmp_path / "jax_ckpt"))
        results.append(real(vlp, opt, resume=resume))
        return results[-1]

    monkeypatch.setattr(jdriver, "solve", solve)

    def run(ex, vlp):
        monkeypatch.setattr(jreader, "read_vlp", lambda path: vlp)
        row = slow_runner.run_one(ex)
        return row, results[-1]

    return run


CASES = {
    "ex10-example05": ("ex10", "example05", {}),
    "ex07-random_vlp": ("ex07", "random_vlp", dict(q=2, m=20, n=2000,
                                                   seed=7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_matches_the_jax_runner(case, jax_runner, tmp_path,
                                       monkeypatch):
    ex, gen, kw = CASES[case]
    jcalls, real = [], jipm.solve_batch_ipm
    monkeypatch.setattr(jipm, "solve_batch_ipm",
                        lambda *a, **k: jcalls.append(1) or real(*a, **k))
    t0 = tipm.CALLS
    jrow, jr = jax_runner(ex, getattr(jexamples, gen)(**kw))
    trow, r = tr.solve_one(ex, "cpu", vlp=getattr(texamples, gen)(**kw),
                           ckpt_dir=str(tmp_path))
    assert trow["status"] == jrow["status"] == "OPTIMAL"
    if ex == "ex10":
        assert {k: trow[k] for k in ROW_KEYS} == {k: jrow[k] for k in ROW_KEYS}
        assert_sets_close(r.primal_points, jr.primal_points, 1e-7)
        assert_sets_close(_norm(r.primal_directions),
                          _norm(jr.primal_directions), 1e-7)
        assert_sets_close(r.dual_points, jr.dual_points, 1e-7)
        assert tipm.CALLS == t0 and not jcalls
        return
    # ex07's flags: float32 LPs through both packages' IPMs
    assert tipm.CALLS > t0 and jcalls
    for k in ("status", "rounds", "directions", "support", "backend"):
        assert trow[k] == jrow[k], k
    assert trow["support"] == "pass@0.05"
    assert_sets_close(_norm(r.primal_directions),
                      _norm(jr.primal_directions), 1e-3)
    images_close(r, jr, tr.CONFIGS["ex07"]["eps_benson_phase2"])
    print(f"LPs {trow['lps']} / {jrow['lps']}, points {trow['points']} / "
          f"{jrow['points']} (port / JAX)")
    for k in ("lps", "points"):
        assert abs(trow[k] - jrow[k]) <= 0.05 * jrow[k], (k, trow, jrow)


def test_runner_sets_and_restores_the_environment(monkeypatch, tmp_path):
    """ex09's environment holds during the run and the caller's after
    it, on success and when the run raises."""
    import bensolve_tpu_torch.algs.driver as tdriver

    monkeypatch.setenv("BENSOLVE_IPM_MAXIT", "77")
    seen = []
    real = tdriver.solve

    def solve(vlp, opt, resume=None):
        seen.append({k: os.environ.get(k) for k in ENV})
        return real(vlp, opt, resume=resume)

    monkeypatch.setattr(tdriver, "solve", solve)
    row = tr.run_one("ex09", "cpu", vlp=texamples.example05(),
                     ckpt_dir=str(tmp_path))
    assert row["status"] == "OPTIMAL"
    assert seen == [{"BENSOLVE_IPM_BYTES": "6000000000",
                     "BENSOLVE_IPM_MAXIT": "180",
                     "BENSOLVE_HOST_FALLBACK_MAX": "64",
                     "BENSOLVE_RESUME": None}]
    after = {"BENSOLVE_IPM_BYTES": None, "BENSOLVE_IPM_MAXIT": "77",
             "BENSOLVE_HOST_FALLBACK_MAX": None, "BENSOLVE_RESUME": None}
    assert {k: os.environ.get(k) for k in ENV} == after

    def crash(vlp, opt, resume=None):
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(tdriver, "solve", crash)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tr.run_one("ex09", "cpu", vlp=texamples.example05(),
                   ckpt_dir=str(tmp_path))
    assert {k: os.environ.get(k) for k in ENV} == after


def test_resumed_run_equals_the_uninterrupted_one(monkeypatch, tmp_path):
    """The run is cut right after its first phase-2 snapshot; rerun under
    BENSOLVE_RESUME=1 it continues from that snapshot to the
    uninterrupted run's row and sets."""
    vlp = texamples.example05()
    row0, r0 = tr.solve_one("ex10", "cpu", vlp=vlp,
                            ckpt_dir=str(tmp_path / "full"))
    real = tckpt.save_checkpoint

    def crash_after_first_phase2(path, **kw):
        real(path, **kw)
        if kw["phase"].startswith("phase2"):
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(tckpt, "save_checkpoint", crash_after_first_phase2)
    with pytest.raises(RuntimeError, match="simulated crash"):
        tr.run_one("ex10", "cpu", vlp=vlp, ckpt_dir=str(tmp_path))
    monkeypatch.setattr(tckpt, "save_checkpoint", real)
    ckpt = tmp_path / "bensolve_ckpt_ex10"
    meta = tckpt.load_checkpoint(str(ckpt))[2]
    assert meta["phase"].startswith("phase2") and meta["round"] >= 1
    monkeypatch.setenv("BENSOLVE_RESUME", "1")
    resumed = []
    real_load = tckpt.load_checkpoint
    monkeypatch.setattr(tckpt, "load_checkpoint",
                        lambda p: resumed.append(p) or real_load(p))
    row1, r1 = tr.solve_one("ex10", "cpu", vlp=vlp, ckpt_dir=str(tmp_path))
    assert resumed == [str(ckpt)]
    assert {k: row1[k] for k in ROW_KEYS} == {k: row0[k] for k in ROW_KEYS}
    assert_sets_close(r1.primal_points, r0.primal_points, 1e-7)
    assert_sets_close(r1.dual_points, r0.dual_points, 1e-7)


@pytest.mark.parametrize("ex", ["ex07", "ex09"])
def test_missing_vlp_raises_and_names_the_file(ex, tmp_path):
    path = os.path.join(str(tmp_path), f"{ex}.vlp")
    with pytest.raises(FileNotFoundError, match=path):
        tr.run_one(ex, "cpu", ex_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match=path):
        getattr(texamples, f"example{ex[2:]}")(str(tmp_path))


def test_main_reads_the_file_and_writes_the_table(tmp_path, capsys):
    """``main`` reads <ex-dir>/ex10.vlp (example05 here) and merges its
    row into --out under SLOW_RESULTS.md's columns."""
    write_vlp(texamples.example05(), str(tmp_path / "ex10.vlp"))
    out = tmp_path / "results.md"
    out.write_text("| ex10 | tpu | OPTIMAL | 1.0 | 1 | 1 | 1 | 1 | "
                   "pass@0.0001 | 0 (0 deferred) |\n")
    argv = ["ex10", "--device", "cpu", "--ex-dir", str(tmp_path),
            "--out", str(out)]
    assert tr.main(argv) == 0
    assert f"source={tmp_path / 'ex10.vlp'}" in capsys.readouterr().out
    lines = out.read_text().splitlines()
    with open(os.path.join(ROOT, "SLOW_RESULTS.md")) as f:
        head = [ln for ln in f if ln.startswith("| ex |")][0].rstrip()
    assert tr.TABLE_HEAD[0] == head
    rows = [ln for ln in lines if ln.startswith("| ex1")]
    assert len(rows) == 2 and rows[0].startswith("| ex10 | cpu | OPTIMAL")
    assert rows[1].startswith("| ex10 | tpu |")


def test_witness_ex09_round_certificates(monkeypatch):
    """tests/witness_large_shapes.py's ex09-shape round at a small shape
    (LP 27 x 2004, M + N >= 2000): the IPM route taken under ex09's
    environment, every LP OPTIMAL within its float64 certificates, no
    sparse matrix built for HiGHS with the fallback capped at 0, and the
    environment restored."""
    from tests import witness_large_shapes as w

    monkeypatch.setattr(tipm, "_sparse_A", lambda A: pytest.fail(
        "a sparse matrix was built for host HiGHS"))
    rec, res = w.ex09_round("cpu", q=3, m=20, n=2000, B=2)
    assert rec["statuses"] == {1: 2} and w.ex09_ok(rec)
    assert rec["max_iter"] == 180 and rec["host_lps"] == 0
    assert rec["chunks"] == 1 and rec["chunk_width"] == 2
    assert max(rec["worst"].values()) <= w.CERT_TOL
    assert {k: os.environ.get(k) for k in ENV} == dict.fromkeys(ENV)


def test_host_cap_zero_builds_no_sparse_matrix(monkeypatch):
    """With the host fallback capped at 0 the LPs bound for HiGHS keep
    the device's answer and the CSR that HiGHS would read (170 M nonzeros
    at ex09's shape) is never built."""
    from tests.test_ipm import random_lp

    args = random_lp(24, 40, 4, seed=3)
    monkeypatch.setenv("BENSOLVE_IPM_MAXIT", "4")
    monkeypatch.setenv("BENSOLVE_HOST_FALLBACK_MAX", "0")
    monkeypatch.setattr(tipm, "_sparse_A", lambda A: pytest.fail(
        "a sparse matrix was built for host HiGHS"))
    h0 = tipm.HOST_FALLBACK
    res = tipm.solve_batch_ipm(*args, dtype=np.float64, device="cpu")
    assert (res.status != 1).any() and tipm.HOST_FALLBACK == h0
    assert tipm.LAST["host_fallback"] == 0


def test_witness_split_is_disjoint_and_fills_the_ipm_time(monkeypatch):
    """tests/witness_large_shapes.py's HostBound on stubbed solvers and a
    fake clock: a top-level IPM call makes a rescue call, the rescue call
    hands 2 of its 4 LPs to the simplex, and the top-level call then
    hands 1 LP to the simplex itself.  Each of the four terms gets its
    own seconds and LPs, and together they fill the call's wall."""
    from bensolve_tpu_torch.lp import simplex as tsx
    from tests import witness_large_shapes as w

    now = [0.0]

    def tick(s):
        now[0] += s

    def result(status):
        z = np.zeros((len(status), 1))
        return tsx.LPResult(np.asarray(status), z[:, 0], z, z, z, z,
                            np.zeros(len(status), int))

    def simplex(A, c, *a, **kw):
        tick(5.0 if np.atleast_2d(c).shape[0] == 2 else 7.0)
        return result([tsx.OPTIMAL] * np.atleast_2d(c).shape[0])

    def ipm(A, c, *a, _rescue=False, **kw):
        if _rescue:                       # (b) 2 + 1, (c) 5
            tick(2.0)
            tsx.solve_batch(A, c[:2])
            tick(1.0)
            return result([tsx.OPTIMAL] * 4)
        tick(3.0)                         # (a) 3 + 1 + 4
        tipm.solve_batch_ipm(A, c[:4], _rescue=True)
        tick(1.0)
        tsx.solve_batch(A, c[:1])         # (d) 7
        tick(4.0)
        return result([tsx.OPTIMAL] * 6)

    monkeypatch.setattr(tipm, "solve_batch_ipm", ipm)
    monkeypatch.setattr(tsx, "solve_batch", simplex)
    with w.HostBound("cpu", clock=lambda: now[0]) as hb:
        tipm.solve_batch_ipm(np.eye(2), np.zeros((6, 2)))
    assert tipm.solve_batch_ipm is ipm and tsx.solve_batch is simplex
    rec = hb.record()
    assert {k: rec[k] for k in w.SPLIT} == dict(
        top_level_s=8.0, rescue_ipm_s=3.0, simplex_in_rescue_s=5.0,
        simplex_top_s=7.0)
    assert rec["ipm_s"] == rec["split_sum_s"] == 23.0
    assert rec["split_gap"] == 0.0
    assert rec["rescue_s"] == 8.0 and rec["simplex_s"] == 12.0
    assert (rec["ipm_lps"], rec["rescued"], rec["rescue_resolved"]) == (6, 4,
                                                                       2)
    assert (rec["simplex_in_rescue"], rec["simplex_top"],
            rec["simplex_fallback"]) == (2, 1, 3)
    assert rec["per_call"] == [dict(lps=6, rescued=4, rescue_resolved=2,
                                    simplex_in_rescue=2, simplex_top=1,
                                    seconds=23.0)]
    assert "IPM 23.00 s = top-level calls 8.00" in w.split_line(rec)


def test_witness_certificates_catch_a_wrong_answer():
    """The certificates hold an exact answer to 0 and flag a perturbed
    one: x off its bound, a dual of the wrong sign, a gap."""
    from tests import witness_large_shapes as w

    # min -x1 - x2 s.t. x1 + x2 <= 1, 0 <= x <= 1: x = (1, 0), y = -1
    A = np.array([[1.0, 1.0]])
    c = np.array([[-1.0, -1.0]])
    lb, ub = np.full((1, 1), -np.inf), np.ones((1, 1))
    clb, cub = np.zeros((1, 2)), np.ones((1, 2))
    ok = w.certificates(A, c, lb, ub, clb, cub, [[1.0, 0.0]], [[-1.0]])
    assert max(float(v[0]) for v in ok) == 0.0
    pres, bviol, dinf, gap = w.certificates(A, c, lb, ub, clb, cub,
                                            [[1.5, -0.2]], [[0.5]])
    assert pres[0] > 0.1 and bviol[0] > 0.1 and dinf[0] > 0.1
    gap2 = w.certificates(A, c, lb, ub, clb, cub, [[0.5, 0.0]], [[-1.0]])[3]
    assert gap2[0] > 0.1


# ---------------------------------------------------------------------------
# the slow, data-gated counterparts of tests/test_e2e_large.py


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _needs_file(ex):
    path = os.path.join(texamples.REFERENCE_EX, f"{ex}.vlp")
    if not os.path.isfile(path):
        pytest.skip(f"{path} is not present: {ex}'s data ships only inside "
                    f"the reference's .vlp file")


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("BENSOLVE_SLOW"),
                    reason="set BENSOLVE_SLOW=1 to run the large examples")
def test_ex10_bensolvehedron(tmp_path):
    row, r = tr.solve_one("ex10", _device(), ckpt_dir=str(tmp_path))
    assert r.status.name == "OPTIMAL"
    assert len(r.primal_points) > 500
    assert len(r.primal_directions) == 3
    check_support(r, n_samples=16, tol=1e-4)


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("BENSOLVE_SLOW"),
                    reason="set BENSOLVE_SLOW=1 to run the large examples")
def test_ex07_radiotherapy_loose_eps(tmp_path):
    # reference advice: -e 0.05 (ex/example07.m:9); float32 LPs through
    # the interior-point route, the runner's CONFIGS["ex07"]
    _needs_file("ex07")
    row, r = tr.solve_one("ex07", _device(), ckpt_dir=str(tmp_path))
    assert r.status.name == "OPTIMAL"
    assert len(r.primal_points) > 10
    check_support(r, n_samples=8, tol=0.05)


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("BENSOLVE_SLOW"),
                    reason="set BENSOLVE_SLOW=1 to run the large examples")
def test_ex09_huge(tmp_path):
    # reference advice: -e 1e-2 (ex/example09.m:10,21); q=3, m=4608,
    # n=36939, the runner's CONFIGS["ex09"]
    _needs_file("ex09")
    row, r = tr.solve_one("ex09", _device(), ckpt_dir=str(tmp_path))
    assert r.status.name == "OPTIMAL"
    assert len(r.primal_points) >= 3
    check_support(r, n_samples=4, tol=1e-2)
