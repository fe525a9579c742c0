"""The metrics that read the program's own spans and counters
(``probes/program_spans.py``): present where the program has them, and
left out of the line, every other metric still there, where it has not,
as on a checkout older than ``bensolve_tpu_torch/spans.py``."""

import importlib
import sys
import types

import pytest

from benchmark import run
from benchmark.helpers import run_cpu

SPEC = run.load_json(run.ROOT, "BENCHMARK.json")
NEW = {"lp_calls", "device_reads", "pivot_read_s", "pivot_host_s",
       "pivot_useful_share"}
# off the card the device trace is not taken (test_bench_harness.py)
TRACED = {m["name"] for m in SPEC["per_layer"]} - {"device_idle",
                                                   "pivot_roofline"}
# the program's modules that import spans, loaded before it is hidden
USERS = ("algs.driver", "algs.phases", "algs.templates", "lp",
         "lp.dual_simplex", "lp.group_simplex", "lp.ipm", "lp.revised",
         "lp.segments", "lp.simplex", "parallel.mesh", "poly.polytope")


@pytest.mark.parametrize("program", ["no_module", "no_names"])
def test_parent_without_spans(monkeypatch, program):
    import bensolve_tpu_torch

    for name in USERS:
        importlib.import_module(f"bensolve_tpu_torch.{name}")
    monkeypatch.delattr(bensolve_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "bensolve_tpu_torch.spans",
                        None if program == "no_module"
                        else types.ModuleType("bensolve_tpu_torch.spans"))
    rc, line, err = run_cpu("ex11.primal", trace=1)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == TRACED - NEW


def test_program_spans_read():
    rc, line, err = run_cpu("ex11.primal", trace=1)
    assert rc == 0, err
    assert line["correct"] is True
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(m) == TRACED and NEW <= set(m)
    # a batch's results come back in nine reads, after a status read
    assert m["device_reads"] > 10 * m["lp_calls"] > 0
    assert 0 < m["pivot_useful_share"] <= 100
    assert m["pivot_read_s"] > 0 and m["pivot_host_s"] > 0
    assert m["pivot_read_s"] + m["pivot_host_s"] <= m["lp_s"]
