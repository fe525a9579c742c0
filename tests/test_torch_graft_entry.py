"""The port's driver entry (bensolve_tpu_torch/graft_entry.py) against the
repo-root ``__graft_entry__.py`` on the CPU.

The root file reads ``/<reference>/ex01.vlp`` through
``bensolve_tpu.vlp.reader.read_vlp`` at call time; here that name returns
``bensolve_tpu.examples.example01()``, so the file runs as it is.  The
JAX package runs on conftest's 8 virtual CPU devices, the port's mesh
entries repeat the one CPU.  Required:

* ``_example_problem``: the four arrays equal bit for bit;
* ``entry()``: ``jax.jit(fn)(*args)`` against the port's ``fn`` on the
  CPU: equal status, iterations and basis, objective within
  1e-5 (1 + |obj|) (all 8 LPs OPTIMAL in 5 iterations);
* ``dryrun_multichip(n)`` for n = 1, 2, 4, 8: per step the JAX package's
  sharded solve (its ``solve_batch_sharded`` and ``benson_round_sharded``
  wrapped to record their outputs) and the port's have equal status
  shapes, statuses, iterations and bases (the ex01 batch all OPTIMAL in
  5, the P2-scale batch all ITLIM at 48), objectives within 1e-5
  (1 + |obj|); and every sharded solve of the port equals the port's
  own unsharded solve of the same batch (status, iterations, basis);
* both entry points raise without a card, and the module's command line
  runs the dry run on the CPU.
"""

import numpy as np
import pytest
import torch

import bensolve_tpu.vlp.reader as jreader
from bensolve_tpu import examples as jexamples
from bensolve_tpu.parallel import mesh as jmesh
from bensolve_tpu_torch import graft_entry as tg

STEPS = ("solve_batch_sharded", "benson_round_sharded", "p2_scale")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_graft(monkeypatch):
    """The root __graft_entry__ module, reading example01 in place of the
    reference's file."""
    import __graft_entry__

    monkeypatch.setattr(jreader, "read_vlp",
                        lambda path: jexamples.example01())
    return __graft_entry__


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_less(np.abs(a - b), 1e-5 * (1 + np.abs(b)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_example_problem_is_the_jax_one(jax_graft, dtype):
    ref = jax_graft._example_problem(dtype)
    got = tg._example_problem(dtype)
    for r, g, name in zip(ref, got, ("A", "c", "lb", "ub")):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_entry_matches_the_jax_entry(jax_graft):
    import jax

    fn, args = jax_graft.entry()
    ref = [np.asarray(o) for o in jax.jit(fn)(*args)]
    tfn, targs = tg.entry("cpu")
    assert all(t.device.type == "cpu" for t in targs)
    for t, a in zip(targs, args):
        np.testing.assert_array_equal(t.numpy(), a)
    got = [o.numpy() for o in tfn(*targs)]
    assert [g.shape for g in got] == [r.shape for r in ref]
    np.testing.assert_array_equal(got[0], ref[0])
    assert (got[0] == 1).all() and (got[6] == 5).all()
    np.testing.assert_array_equal(got[6], ref[6])
    np.testing.assert_array_equal(got[7], ref[7])
    _close(got[1], ref[1])


def _unsharded_equal(rec):
    batches = tg.step_inputs(rec["dp"])
    for step in rec["steps"]:
        one = tg.solve_unsharded(*batches[step["step"]], device="cpu")
        for k, i in (("status", 0), ("iters", 6), ("basis", 7)):
            np.testing.assert_array_equal(step[k], one[i],
                                          err_msg=f"{step['step']} {k}")


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_matches_the_jax_dryrun(jax_graft, monkeypatch, n):
    seen = []
    for name in ("solve_batch_sharded", "benson_round_sharded"):
        real = getattr(jmesh, name)

        def recorded(*a, _real=real, **kw):
            out = _real(*a, **kw)
            seen.append([np.asarray(o) for o in out])
            return out

        monkeypatch.setattr(jmesh, name, recorded)
    jax_graft.dryrun_multichip(n)
    rec = tg.dryrun_multichip(n, "cpu")
    assert rec["axes"] == (("dp", "tp") if n >= 4 else ("dp",))
    assert rec["entries"] == ["cpu"] * n
    assert [s["step"] for s in rec["steps"]] == list(STEPS)
    assert len(seen) == 3
    for ref, step in zip(seen, rec["steps"]):
        assert step["status"].shape == ref[0].shape, step["step"]
        np.testing.assert_array_equal(step["status"], ref[0])
        np.testing.assert_array_equal(step["iters"], ref[6])
        np.testing.assert_array_equal(step["basis"], ref[7])
    ex01, rnd, p2 = rec["steps"]
    assert (ex01["status"] == 1).all() and (ex01["iters"] == 5).all()
    assert (rnd["status"] == 1).all()
    assert p2["status"].shape == (3 * rec["dp"],)
    assert (p2["status"] == 4).all() and (p2["iters"] == 48).all()
    _unsharded_equal(rec)


def test_round_objectives_match_the_jax_round(jax_graft, monkeypatch):
    """The round step's objective values (the bound assembly V @ ZR
    before the solve) over ("dp", "tp") = 2 x 2."""
    seen = []
    real = jmesh.benson_round_sharded
    monkeypatch.setattr(jmesh, "benson_round_sharded", lambda *a, **kw: (
        seen.append([np.asarray(o) for o in real(*a, **kw)]) or seen[-1]))
    jax_graft.dryrun_multichip(4)
    batches = tg.step_inputs(2)
    got = tg.solve_unsharded(*batches["benson_round_sharded"],
                             device="cpu")
    np.testing.assert_array_equal(got[0], seen[0][0])
    _close(got[1], seen[0][1])


@pytest.mark.parametrize("call", ["entry", "dryrun"])
def test_cuda_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        if call == "entry":
            tg.entry()
        else:
            tg.dryrun_multichip(4)


def test_command_line_on_the_cpu(capsys):
    assert tg.main(["2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("entry: [(8,), (8,), (8, 8), (8, 8), (8, 8), (8, 8), "
                      "(8,), (8, 8), (8, 16)]")
    assert out[-1] == "dryrun_multichip: ok"
