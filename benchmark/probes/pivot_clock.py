"""The host interval of every call of the tableau pivot loop
(``lp/simplex.py::_run_segmented``, which runs ``simplex._step`` and
``dual_simplex._dstep``, by replayed CUDA graph on the card) under the
device trace, with the steps each call ran (the growth of
``segments.GRAPH_STEPS + EAGER_STEPS`` across it) and the shape of its
LP batch: the LPs asked for and the LP's unpadded rows M and columns N,
taken from the ``simplex._pad_batch_inputs`` call that padded the batch
just before.  It synchronises nothing: the card's time inside each
interval comes from the trace.

``loops`` holds one (B, M, N, dtype name, steps, start, end) per call;
``intervals()`` gives them as "pivot"."""

import contextlib
import threading
import time

from benchmark.probes import BaseProbe


class Probe(BaseProbe):
    def __init__(self):
        self.loops = []
        self._traced = False
        self._pending = threading.local()
        self._stack = contextlib.ExitStack()

    def install(self):
        import numpy as np
        from benchmark.probes import patched
        from bensolve_tpu_torch.lp import segments, simplex

        def pad(real):
            def padded(prep, c, *args, **kwargs):
                B = np.atleast_2d(np.asarray(c)).shape[0]
                self._pending.shape = (B, prep.M, prep.N)
                return real(prep, c, *args, **kwargs)
            return padded

        def loop(real):
            def clocked(step_fn, A, c, lb, ub, st, max_iter):
                shape = getattr(self._pending, "shape", None)
                self._pending.shape = None
                s0 = segments.GRAPH_STEPS + segments.EAGER_STEPS
                t0 = time.perf_counter()
                out = real(step_fn, A, c, lb, ub, st, max_iter)
                t1 = time.perf_counter()
                steps = segments.GRAPH_STEPS + segments.EAGER_STEPS - s0
                if self._traced and shape is not None:
                    self.loops.append(shape + (str(c.dtype).split(".")[-1],
                                               steps, t0, t1))
                return out
            return clocked

        self._stack.enter_context(patched(simplex, "_pad_batch_inputs", pad))
        self._stack.enter_context(patched(simplex, "_run_segmented", loop))

    def trace(self, on: bool):
        self._traced = on

    def intervals(self) -> dict:
        return {"pivot": [(t0, t1) for *_, t0, t1 in self.loops]}

    def remove(self):
        self._stack.close()
