"""The harness: found by name, extended by new files only, the result
line's keys, no JAX, no result without a card."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import run
from benchmark.helpers import run_cpu

ROOT = run.ROOT
SPEC = run.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell, config, mix, own, e2e, layer = run.find_cell(SPEC, name)
    assert cell["config"] == config["name"]
    base = run.module("instances", config["instance"]).build(
        **config.get("instance_args", {}))
    assert np.shape(base["P"]) == (config["q"], config["n"])
    assert np.shape(base["A"]) == (config["m"], config["n"])
    assert __import__(f"benchmark.reference.{config['reference']}",
                      fromlist=["judge"]).judge
    assert set(own["check"]["limits"]) >= {"count_diff", "facet_gap"}
    assert {m["name"] for m in e2e} == {"solve_s", "solve_p90_s", "setup_s"}
    for m in layer:
        reader = run.module("metrics", m["name"])
        assert callable(reader.read)
        for p in reader.PROBES:
            assert __import__(f"benchmark.probes.{p}",
                              fromlist=["Probe"]).Probe


def test_unknown_cell_refused():
    with pytest.raises(SystemExit):
        run.find_cell(SPEC, "no.such.cell")


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    rc, line, err = run_cpu("ex11.primal", trace=trace)
    assert rc == 0, err
    assert list(line) == KEYS + ["checked"]
    assert line["correct"] is True and line["failed"] == 0
    names = {m["name"] for m in (SPEC["per_layer"] if trace
                                 else SPEC["end_to_end"])}
    # off the card the device trace is not taken, and the metrics that
    # read it are left out
    assert set(line["metrics"]) == names - {"device_idle", "pivot_roofline"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert err.strip().splitlines()[-1].startswith("vertex_gap ")


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bensolve_tpu_torch.fake",
                        types.ModuleType("x"))
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "bensolve_tpu.lp",
                        types.ModuleType("x"))
    assert run.forbidden_loaded() == ["bensolve_tpu"]


def test_loaded_jax_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_cpu("ex11.primal")
    assert rc == 3 and line is None and "jax" in err


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.helpers import run_cpu\n"
            "rc, line, err = run_cpu('ex11.primal')\n"
            "assert rc == 0, err\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "bensolve_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "bensolve_tpu"}


def test_no_native_engine_no_result(monkeypatch):
    from bensolve_tpu_torch import native

    monkeypatch.setattr(native, "lib", lambda: None)
    rc, line, err = run_cpu("ex11.primal")
    assert rc == 2 and line is None and "polytope engine" in err


def test_window_input_solved_in_warmup_no_result(monkeypatch):
    from benchmark import traffic

    real = traffic.Traffic.instance
    monkeypatch.setattr(traffic.Traffic, "instance",
                        lambda self, stream, i: real(self, "warmup", 0))
    rc, line, err = run_cpu("ex11.primal", seconds=0.1)
    assert rc == 4 and line is None and "warm-up" in err


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "ex11.primal", "--seed", "1",
                   "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def _copy(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_only_the_benchmark_fails(tmp_path):
    _copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ex11.primal",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


NEW_INSTANCE = '''"""bensolve's ex/example01.m: two objectives, two rows."""
import numpy as np


def build():
    return dict(A=np.array([[2.0, 1.0], [1.0, 2.0]]),
                P=np.array([[1.0, -1.0], [1.0, 1.0]]),
                row_lb=np.array([6.0, 6.0]), row_ub=np.full(2, np.inf),
                col_lb=np.zeros(2), col_ub=np.full(2, np.inf))
'''

NEW_METRIC = '''"""Benson rounds per solve."""
PROBES = ()


def read(run):
    return sum(s["rounds"] for s in run.solves) / len(run.solves)
'''


def test_new_cell_by_new_files_only(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and BENCHMARK.json entries run, and no file already
    there changes."""
    _copy(tmp_path)
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "instances" / "example01.py").write_text(NEW_INSTANCE)
    config = json.loads((bench / "configs" / "bslv-ex11.json").read_text())
    config.update(name="bslv-ex01", instance="example01", q=2, m=2, n=2)
    (bench / "configs" / "bslv-ex01.json").write_text(json.dumps(config))
    shutil.copy(bench / "workloads" / "ex11.primal.json",
                bench / "workloads" / "ex01.primal.json")
    (bench / "metrics" / "rounds_per_solve.py").write_text(NEW_METRIC)
    # ex01 has four relabellings in all, so its mix serves the instance
    # as it is, every solve
    (bench / "traffic" / "fixed.json").write_text(json.dumps(dict(
        options={"alg_phase1": "primal", "alg_phase2": "primal"},
        relabel=[], warmup_solves=1, pool=1)))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][1], name="bslv-ex01",
                                file="benchmark/configs/bslv-ex01.json"))
    spec["workloads"].append(dict(spec["workloads"][1], name="ex01.primal",
                                  config="bslv-ex01", traffic="fixed"))
    spec["per_layer"].append(dict(
        name="rounds_per_solve", unit="count", better="lower",
        source="program_counter", layer="Benson driver", moves="solve_s",
        workloads=["ex01.primal"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == b for p, b in before.items())

    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from benchmark.helpers import run_cpu\n"
            "rc, line, err = run_cpu('ex01.primal', trace=1)\n"
            "assert rc == 0, err\n"
            "import json; print(json.dumps(line))" % (str(tmp_path), ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["rounds_per_solve"]["value"] > 0


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ex11.primal",
         "--seed", "3000000077", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["kind"] == card
    assert line["device"]["busy_s"] > 0
