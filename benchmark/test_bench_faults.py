"""A run with the timed path broken underneath comes out not correct, as
does the control (the program's float32 path).  Each drives the whole
harness on the CPU (no look for a card) over ex11.primal, and the
harness's own check decides.  Of the
faults a cell can have, a single-card VLP solve has no exchange
between chips to leave out."""

import dataclasses

import numpy as np
import pytest

from benchmark import run
from benchmark.helpers import run_cpu


def _window_only(monkeypatch):
    """A flag that is set once the warm-up solves are done, so that a
    fault breaks the timed path and not the set-up."""
    import bensolve_tpu_torch

    warmups = run.load_json(run.HERE, "traffic", "primal.json")[
        "warmup_solves"]
    real, calls, armed = bensolve_tpu_torch.solve, [0], [False]

    def solve(vlp, opt):
        calls[0] += 1
        armed[0] = calls[0] > warmups
        return real(vlp, opt)

    monkeypatch.setattr(bensolve_tpu_torch, "solve", solve)
    return armed


def _broken(monkeypatch, fault):
    from bensolve_tpu_torch.algs import driver, templates
    from bensolve_tpu_torch.lp import simplex

    armed = _window_only(monkeypatch)
    if fault == "state_unchanged":
        # every pivot segment returns the state it was given
        real_loop = simplex._run_segmented
        monkeypatch.setattr(
            simplex, "_run_segmented",
            lambda step_fn, A, c, lb, ub, st, n: st if armed[0]
            else real_loop(step_fn, A, c, lb, ub, st, n))
    elif fault == "half_batch":
        # the first half of each LP batch is solved and its answers
        # stand in for the second half
        real = templates._TemplateBase._run

        def half(self, A_lp, obj, row_lb, row_ub, col_lb, col_ub,
                 start_basis=None, _chunked=False):
            B = np.atleast_2d(obj).shape[0]
            if B < 2 or not armed[0]:
                return real(self, A_lp, obj, row_lb, row_ub, col_lb, col_ub,
                            start_basis, _chunked)
            h = (B + 1) // 2
            res = real(self, A_lp, np.atleast_2d(obj)[:h], row_lb[:h],
                       row_ub[:h], col_lb[:h], col_ub[:h], None, _chunked)
            idx = np.arange(B) % h
            return simplex.LPResult(*(
                None if getattr(res, f.name) is None
                else np.asarray(getattr(res, f.name))[idx]
                for f in dataclasses.fields(simplex.LPResult)))

        monkeypatch.setattr(templates._TemplateBase, "_run", half)
    elif fault == "answer_altered":
        # one upper-image vertex moved where the epilogue produces it
        real = driver._finish

        def finish(*a):
            res = real(*a)
            if res.pair is not None and armed[0]:
                poly = res.pair.dual if res.swap else res.pair.primal
                i = next(i for i in poly.live() if not poly.ideal[i])
                poly.data[i, 0] += 1e-3
            return res

        monkeypatch.setattr(driver, "_finish", finish)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "control_float32"])
def test_fault_is_not_correct(monkeypatch, fault):
    """The control is ``run.py --control``: the window on the program's
    float32 path."""
    control = fault == "control_float32"
    if not control:
        _broken(monkeypatch, fault)
    # a window of several solves: on some relabellings a half batch
    # still leads Benson's loop to the right images
    rc, line, err = run_cpu("ex11.primal", seconds=3,
                            extra=["--control"] if control else [])
    assert rc == 0, err
    assert line["correct"] is False, line["checked"]
    bad = [k for k, e in line["checked"].items()
           if e["value"] is None or e["value"] > e["limit"]]
    assert bad, line["checked"]


def test_sound_run_is_correct():
    rc, line, err = run_cpu("ex11.primal", seconds=0.3)
    assert rc == 0 and line["correct"] is True, err
