"""The port's bench (bensolve_tpu_torch.bench) and config #5 driver
(bensolve_tpu_torch.scale_many) against the repo's bench.py and the JAX
package, on the CPU at small sizes.

Required: the instance generators equal bench.py's bit for bit; the
device stage's statuses and pivots equal the JAX package's
simplex.solve_batch and dual_simplex.solve_batch_dual called with the
arguments bench.run_device passes (run_device itself is not called: it
sets a persistent JAX compile cache); one CPU run of the bench with
every stage prints every key; a failed gate prints nothing; the bench
refuses to run without a card unless told ``--device cpu``;
scale_many's status counts and LP totals equal solve_many's in the JAX
package.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from bensolve_tpu import examples as jax_examples
from bensolve_tpu.algs.many import solve_many as jax_solve_many
from bensolve_tpu.lp import dual_simplex as jdx
from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu.vlp.options import Options as JaxOptions
from bensolve_tpu_torch import bench, scale_many
from bensolve_tpu_torch import lp as tlp
from tests.test_torch_simplex import assert_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of bench.py's result line (bench.py:285-297)
JAX_BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "p2_LPs_per_s",
                  "p2_vs_baseline", "ex11_wall_s", "benson_iters_per_s",
                  "cold_pivots_per_lp", "warm_pivots_per_lp")
# every stage at a size the CPU solves in seconds
TINY = ["--device", "cpu", "--device-lps", "12", "12", "8", "--p2", "2",
        "10", "20", "4", "--p2-warm", "1", "--highs-k", "1", "--many", "10",
        "--ex10", "2", "1", "--tall", "2", "3", "30"]
# the p2 stage alone at TINY's size
TINY_P2 = TINY[:2] + ["--stages", "p2", "--p2", "2", "10", "20", "4",
                      "--p2-warm", "1", "--highs-k", "1"]
CAPPED = ("p2_LPs_per_s_fallback_capped", "p2_vs_baseline_fallback_capped")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_instances_bit_for_bit():
    got = bench.make_instances(96, 96, 64)
    ref = jax_bench.make_instances(96, 96, 64)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_make_p2_instances_match_bench_py():
    """The P2 template of config #4 and its B = 8 frontier bounds: the
    matrix, the row bounds and every LP input equal exactly."""
    t2, ub = bench.make_p2_instances(8)
    j2, jub = jax_bench.make_p2_instances(8)
    np.testing.assert_array_equal(ub, jub)
    np.testing.assert_array_equal(t2.A_lp, j2.A_lp)
    assert t2.A_lp.shape == (1011, 2006)
    assert t2.ipm_min == j2.ipm_min == 2000
    for g, r in zip(t2.build_inputs(ub), j2.build_inputs(jub)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_device_stage_matches_jax_package():
    """run_device's cold solve, re-solves and warm re-solve at M = N =
    24, B = 16 against the JAX package's solvers with bench.run_device's
    arguments: equal statuses and pivots per LP (the dual-simplex parity
    tests' rule), hence equal pivots per LP cold and warm."""
    M, N, B = 24, 24, 16
    got = bench.run_device("cpu", M, N, B)
    A, c, rlb, rub, clb, cub = jax_bench.make_instances(M, N, B)
    dtype = np.float32

    def jsolve(cc, warm=None):
        return jsx.solve_batch(A, cc, rlb, rub, clb, cub, dtype=dtype,
                               max_chunk=B, start_basis=warm)

    cold = jsolve(c)
    assert (cold.status == jsx.OPTIMAL).all()
    assert got["cold_pivots"] == float(cold.iters.mean())
    for r in range(3):
        res = jsolve(c * (1.0 + 0.01 * (r + 1)))
    warm = (np.asarray(res.basis), np.asarray(res.at_upper))
    wres = jdx.solve_batch_dual(A, c, rlb, (rub * 0.99).astype(rub.dtype),
                                clb, cub, start_basis=warm, dtype=dtype,
                                max_chunk=B)
    assert (wres.status == jsx.OPTIMAL).all()
    assert got["warm_pivots"] == float(wres.iters.mean())
    np.testing.assert_allclose(got["obj"], cold.obj, rtol=1e-5, atol=1e-5)
    # the port's own solver calls, LP by LP
    tcold = tlp.solve_batch_auto(A, c, rlb, rub, clb, cub, dtype=dtype,
                                 max_chunk=B, device="cpu")
    assert_parity(cold, tcold, dtype)


def test_bench_cli_on_the_cpu_prints_every_key():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bensolve_tpu_torch.bench", *TINY,
         "--p2-host-cap", str(bench.REFERENCE_HOST_CAP)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(JAX_BENCH_KEYS) <= set(line)
    assert set(bench.BENCH_KEYS) == set(JAX_BENCH_KEYS)
    assert set(bench.EXTRA_KEYS) <= set(line)
    # every stage ran at the reference's host cap: only the capped p2
    # keys are null
    assert sorted(k for k, v in line.items() if v is None) == list(CAPPED)
    assert line["p2_host_fallback_cap"] == 32
    assert len(line["p2_host_bound"]) == 2
    assert line["device"] == "cpu"
    assert line["device_kernel_launches"] == {"cluster": 0, "spill": 0,
                                              "global": 0}
    assert line["ex11_lps"] == 679 and line["ex11_rounds"] == 16
    assert line["many_instances"] == 10


def test_stage_left_out_gives_null(capsys):
    bench.main(TINY[:2] + ["--stages", "ex10", "--ex10", "2", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ex10_wall_s_f64"] > 0 and line["ex10_dual_wall_s_f32"] > 0
    assert line["value"] is None and line["many_LPs_per_s"] is None


def test_p2_keys_follow_the_host_cap(capsys):
    """At the default cap of 0 the p2 rate goes under its own key and
    bench.py's keys stay null; the cap is set only inside the stage."""
    saved = os.environ.get("BENSOLVE_HOST_FALLBACK_MAX")
    bench.main(TINY_P2)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["p2_LPs_per_s"] is None and line["p2_vs_baseline"] is None
    assert line["p2_LPs_per_s_fallback_capped"] > 0
    assert line["p2_vs_baseline_fallback_capped"] > 0
    assert line["p2_host_fallback_cap"] == 0
    assert os.environ.get("BENSOLVE_HOST_FALLBACK_MAX") == saved


def test_failed_p2_warm_round_prints_nothing(monkeypatch, capsys):
    """Every LP of the p2 stage's warm round reported ITLIM: the warm
    round's gate fails and the bench prints no result line."""
    from bensolve_tpu_torch.algs.templates import P2Template

    real, calls = P2Template.solve, []

    def broken(self, *a, **kw):
        res = real(self, *a, **kw)
        calls.append(1)
        if len(calls) > 1:
            res.status[:] = jsx.ITLIM
        return res

    monkeypatch.setattr(P2Template, "solve", broken)
    with pytest.raises(bench.GateError, match="warm round 0"):
        bench.main(TINY_P2)
    assert capsys.readouterr().out == ""


def test_failed_gate_prints_nothing(monkeypatch, capsys):
    """One LP of the device stage's cold batch reported INFEASIBLE: the
    bench raises and prints no result line."""
    real = tlp.solve_batch_auto

    def broken(*a, **kw):
        res = real(*a, **kw)
        res.status[3] = jsx.INFEASIBLE
        return res

    monkeypatch.setattr(tlp, "solve_batch_auto", broken)
    with pytest.raises(bench.GateError, match="device"):
        bench.main(TINY[:2] + ["--stages", "device", "--device-lps", "12",
                               "12", "8"])
    assert capsys.readouterr().out == ""


def test_failed_oracle_prints_nothing(monkeypatch, capsys):
    """A wrong upper image (every point moved up by 1) fails the support
    oracle of the tall stage: no result line."""
    from bensolve_tpu_torch.algs import driver

    real = driver.VLPSolution.primal_points
    monkeypatch.setattr(driver.VLPSolution, "primal_points",
                        property(lambda self: real.fget(self) + 1.0))
    with pytest.raises(bench.GateError, match="support oracle"):
        bench.main(TINY[:2] + ["--stages", "tall", "--tall", "2", "3", "30"])
    assert capsys.readouterr().out == ""


def test_without_a_card_the_bench_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--stages", "ex10"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scale_many.main(["10"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mesh", [False, True])
def test_scale_many_matches_jax_solve_many(mesh):
    """N = 50 instances of config #5's shape: equal status counts, LP
    total and lockstep rounds (with --mesh, over 4 CPU entries)."""
    n = 50
    got = scale_many.run(n, mesh=mesh, device="cpu", log=lambda s: None)
    vlps = [jax_examples.random_vlp(q=3, m=10, n=8, seed=s)
            for s in range(n)]
    ref = jax_solve_many(vlps, JaxOptions(bounded=True, write_files=False))
    assert got["counts"] == dict(collections.Counter(
        r.status.name for r in ref))
    assert got["lps"] == sum(r.stats.lps for r in ref)
    assert got["rounds"] == max(r.stats.rounds for r in ref)
    assert got["instances"] == n
