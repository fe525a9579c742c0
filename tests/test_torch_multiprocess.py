"""REAL multi-process tests of the port's distributed path.

Spawns separate processes (tests/torch_multiproc_worker.py: Gloo over
localhost, LPs on the CPU) under one ``torch.distributed`` group and
asserts:

* ``allgather_rows`` reassembles uneven strided shards, rows in process
  order;
* a ``distributed=True`` solve of example05 produces BIT-IDENTICAL point
  arrays and equal stats on every process (the determinism contract of
  parallel/distributed.py), and the single-process vertex set within
  1e-6, with the primal and with the dual algorithm, and with more
  processes than candidates (empty shards);
* ``solve_many`` over 24 instances has disjoint strided ownership that
  covers every instance, each owned result equal to the single-process
  run's.

Every worker has a timeout and is killed in a ``finally``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import bensolve_tpu_torch as bt
from bensolve_tpu_torch import examples
from bensolve_tpu_torch.algs.many import solve_many
from bensolve_tpu_torch.vlp.options import Alg

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_multiproc_worker.py")
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(mode: str, outdir: str, nproc: int = 2):
    port = _free_port()
    # PYTHONPATH = the repo only: the worker imports the port and
    # nothing an ambient sitecustomize would add
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(port), str(nproc), str(pid),
         outdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"


def _canon(a):
    return sorted(map(tuple, np.round(a, 6)))


def test_allgather_rows_two_processes(tmp_path):
    _spawn("allgather", str(tmp_path))
    got0 = np.load(tmp_path / "allgather_0.npy")
    got1 = np.load(tmp_path / "allgather_1.npy")
    # rows gathered in process order: rank 0's strided share (0,2,4,6)
    # then rank 1's (1,3,5), NaN padding dropped
    expect = np.stack([np.arange(3.0) + 10 * i for i in (0, 2, 4, 6,
                                                         1, 3, 5)])
    np.testing.assert_array_equal(got0, expect)
    np.testing.assert_array_equal(got1, expect)


@pytest.mark.parametrize("mode,nproc", [("solve", 2), ("solve_dual", 2),
                                        ("solve", 4)])
def test_distributed_solve_bitwise_identical(mode, nproc, tmp_path):
    """With 4 processes most rounds of example05 have fewer candidates
    than processes, so several carry EMPTY shards every round."""
    _spawn(mode, str(tmp_path), nproc=nproc)
    ranks = range(nproc)
    pts = [np.load(tmp_path / f"pts_{pid}.npy") for pid in ranks]
    dpts = [np.load(tmp_path / f"dpts_{pid}.npy") for pid in ranks]
    stats = []
    for pid in ranks:
        with open(tmp_path / f"stats_{pid}.json") as fh:
            stats.append(json.load(fh))
    for pid in ranks[1:]:
        # bit-identical replicated polytopes, identical bookkeeping
        # (lps counts the global frontier on every process)
        np.testing.assert_array_equal(pts[0], pts[pid])
        np.testing.assert_array_equal(dpts[0], dpts[pid])
        assert stats[0] == stats[pid]
    assert stats[0]["status"] == "OPTIMAL"

    opt = bt.Options(distributed=True, write_files=False, device="cpu")
    if mode == "solve_dual":
        opt.alg_phase1 = opt.alg_phase2 = Alg.DUAL
    one = bt.solve(examples.example05(), opt)
    assert _canon(pts[0]) == _canon(one.primal_points)
    assert stats[0]["lps"] == one.stats.lps
    assert stats[0]["rounds"] == one.stats.rounds


def test_solve_many_two_processes(tmp_path):
    _spawn("many", str(tmp_path), nproc=2)
    idx = [np.load(tmp_path / f"many_idx_{pid}.npy") for pid in (0, 1)]
    assert idx[0].tolist() == list(range(0, 24, 2))
    assert idx[1].tolist() == list(range(1, 24, 2))
    for pid in (0, 1):
        with open(tmp_path / f"many_stats_{pid}.json") as fh:
            assert all(v == "OPTIMAL" for v in json.load(fh).values())

    vlps = [examples.random_vlp(q=2, m=6, n=5, seed=s) for s in range(24)]
    ref = solve_many(vlps, bt.Options(bounded=True, write_files=False,
                                      device="cpu"))
    for i in range(24):
        got = np.load(tmp_path / f"many_pts_{i}.npy")
        np.testing.assert_allclose(
            np.sort(got, axis=0), np.sort(ref[i].primal_points, axis=0),
            rtol=1e-9, atol=1e-10)
