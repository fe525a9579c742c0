"""Segments of the pivot loop as CUDA graphs: the torch counterpart of
the JAX package's device-side segment programs,
``bensolve_tpu/lp/simplex.py::_tableau_run_jit`` and
``lp/dual_simplex.py::_dual_run_jit`` (each a ``lax.while_loop`` over a
pivot step that runs on the device between two host reads).

Run eagerly, every op of a pivot is a kernel launched from Python, about
60 a step.  Here k steps of ``simplex._step`` or ``dual_simplex._dstep``
are captured once into a ``torch.cuda.CUDAGraph`` and replayed with one
launch.  ``simplex._run_segmented`` keeps its schedule (segments of 1,
2, 4, ... SEGMENT_MAX steps, one host read of the status between two),
so the reads fall on the same steps as in the eager loop; a segment cut
short by ``max_iter`` replays the binary decomposition of its length
(37 = 32 + 4 + 1).

The cache holds one *graph set* per (step function, device, dtype, B,
M, NT): static buffers for every field of the loop state and for the
inputs c, lb, ub (neither step reads A, so the graphs are given None for
it), one memory pool, a side stream, and one graph per (k, TF32
setting), captured at its first use.  Graph(k) runs k steps on the
static buffers and ends by copying each new field back into them (W the
steps update in place), so the state always lives in the buffers.  A
solve copies its start state in, replays, and copies the final state
out: the tableau back into the start state's own W, the tensor that the
eager loop updates in place, and every other field into a new tensor.
So nothing a solve returns, a KeptState's W included, aliases the cache,
and no tableau is allocated for it.  The sets hold at most
``simplex.TABLEAU_BYTES_BUDGET`` bytes of static buffers (one set alone
may hold more): the least recently used set is evicted first and its
graphs are reset.

A replay launches the kernels that the eager steps launch, on the same
inputs, so it pivots bit for bit as the eager loop.  The key holds
``torch.backends.cuda.matmul.allow_tf32`` because cuBLAS bakes it into a
captured product.  Before a set's first capture under a TF32 setting,
WARMUP_STEPS steps run on scratch copies of the state on the side stream
(cuBLAS makes its handle and workspace there, and every kernel of the
step is loaded); the live state is never stepped outside a replay.
Capture runs on the calling thread, on the set's side stream, in
capture_error_mode "thread_local": work that other threads do meanwhile
neither breaks the capture nor enters it.  One thread at a time uses the
cache (``_LOCK``, held from copy-in to copy-out), and each use waits on
the card for the previous use's copy-out.

A capture that fails raises.  Nothing switches the graphs off: where
``BACKENDS`` has no entry for the device (the CPU) the loop runs
eagerly, as the plain version, and a mesh's shard threads run it eagerly
too (``simplex._run_segmented`` says why).  ``eager_loop()`` exists only
to hold the graphs to the eager loop, in the tests and chip_smoke.py.

Counters, plain integers read by chip_smoke.py: CAPTURES, REPLAYS,
GRAPH_STEPS (steps run by replays), EAGER_STEPS (steps the eager loop
ran, on any device), CAPTURE_S (seconds spent warming up and capturing).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

CAPTURES = 0
REPLAYS = 0
GRAPH_STEPS = 0
EAGER_STEPS = 0
CAPTURE_S = 0.0

# steps run on scratch copies of the state before a set's first capture
# under a TF32 setting (see above)
WARMUP_STEPS = 2

# the loop state's fields (simplex._State), each a tensor
FIELDS = ("basis", "in_basis", "at_upper", "W", "xb", "lbB", "ubB", "cB",
          "status", "stall", "iters", "gamma")

_LOCK = threading.Lock()            # one user of the cache at a time
_COUNT_LOCK = threading.Lock()      # EAGER_STEPS, counted on any thread
_SETS: collections.OrderedDict = collections.OrderedDict()
_EAGER = threading.local()


def counts() -> dict:
    return dict(captures=CAPTURES, replays=REPLAYS, graph_steps=GRAPH_STEPS,
                eager_steps=EAGER_STEPS, capture_s=CAPTURE_S)


def reset_counts() -> None:
    global CAPTURES, REPLAYS, GRAPH_STEPS, EAGER_STEPS, CAPTURE_S
    CAPTURES = REPLAYS = GRAPH_STEPS = EAGER_STEPS = 0
    CAPTURE_S = 0.0


def count_eager(n: int) -> None:
    global EAGER_STEPS
    with _COUNT_LOCK:
        EAGER_STEPS += n


@contextlib.contextmanager
def eager_loop():
    """Run this thread's pivot loops eagerly: for holding the graphs to
    the eager loop in the tests and chip_smoke.py, nowhere else."""
    prev = getattr(_EAGER, "on", False)
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = prev


def eager_only() -> bool:
    return getattr(_EAGER, "on", False)


def cached_sets() -> int:
    """The graph sets held now."""
    return len(_SETS)


def cached_bytes() -> int:
    """The bytes of static buffers the graph sets hold now."""
    return sum(s.nbytes for s in _SETS.values())


def clear() -> None:
    """Evict every graph set."""
    with _LOCK:
        while _SETS:
            _SETS.popitem(last=False)[1].release()


class _CudaGraphs:
    """The backend on a CUDA device: torch.cuda.CUDAGraph, captured on a
    side stream of the set's device."""

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def new_stream(dev):
        return torch.cuda.Stream(device=dev)

    @staticmethod
    def on_side(stream, fn):
        """fn() on the side stream, after what the caller's current
        stream holds and before what it is given next."""
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            fn()
        cur.wait_stream(stream)

    @staticmethod
    def capture(fn, pool, stream):
        graph = torch.cuda.CUDAGraph()

        def body():
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                # end the broken capture, then raise what broke it
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()

        _CudaGraphs.on_side(stream, body)
        return graph

    @staticmethod
    def fence(dev):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    @staticmethod
    def wait(fence, dev):
        torch.cuda.current_stream(dev).wait_event(fence)

    @staticmethod
    def sync(fence):
        fence.synchronize()


# the graph backend of each device type; a type without one (the CPU)
# runs the eager loop
BACKENDS = {"cuda": _CudaGraphs}


def _parts(n: int) -> list[int]:
    """The powers of two that sum to n, largest first (37: 32, 4, 1)."""
    return [1 << b for b in range(n.bit_length() - 1, -1, -1) if n >> b & 1]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _GraphSet:
    """The static buffers, pool, side stream and graphs of one key."""

    def __init__(self, backend, step_fn, st, c, lb, ub):
        self.backend, self.step_fn, self.dev = backend, step_fn, c.device
        self.state = type(st)(**{f: torch.empty_like(
            getattr(st, f), memory_format=torch.contiguous_format)
            for f in FIELDS})
        self.c, self.lb, self.ub = (torch.empty_like(
            x, memory_format=torch.contiguous_format) for x in (c, lb, ub))
        self.nbytes = _nbytes(self._buffers())
        self.pool = backend.new_pool()
        self.stream = backend.new_stream(self.dev)
        self.graphs = {}      # (k, TF32 setting) -> graph
        self.warm = set()     # TF32 settings warmed up
        self.fence = None     # the last use's copy-out, on the card

    def _buffers(self):
        return [getattr(self.state, f) for f in FIELDS] + [
            self.c, self.lb, self.ub]

    def load(self, st, c, lb, ub):
        if self.fence is not None:
            self.backend.wait(self.fence, self.dev)
        for f in FIELDS:
            getattr(self.state, f).copy_(getattr(st, f))
        for buf, x in ((self.c, c), (self.lb, lb), (self.ub, ub)):
            buf.copy_(x)

    def unload(self, st):
        """The final state: W copied into the start state's W, every
        other field into a new tensor."""
        out = type(st)(**{f: (st.W.copy_(self.state.W) if f == "W"
                              else getattr(self.state, f).clone())
                          for f in FIELDS})
        self.fence = self.backend.fence(self.dev)
        return out

    def _steps(self, st, k):
        for _ in range(k):
            st = self.step_fn(None, self.c, self.lb, self.ub, st)
        return st

    def _segment(self, k):
        def run():
            st = self._steps(self.state, k)
            for f in FIELDS:
                new, buf = getattr(st, f), getattr(self.state, f)
                if new is not buf:
                    buf.copy_(new)
        return run

    def _warm_up(self):
        scratch = type(self.state)(**{f: getattr(self.state, f).clone()
                                      for f in FIELDS})
        self._steps(scratch, WARMUP_STEPS)

    def graph(self, k):
        global CAPTURES, CAPTURE_S
        tf32 = torch.backends.cuda.matmul.allow_tf32
        graph = self.graphs.get((k, tf32))
        if graph is None:
            t0 = time.perf_counter()
            if tf32 not in self.warm:
                self.backend.on_side(self.stream, self._warm_up)
                self.warm.add(tf32)
            graph = self.backend.capture(self._segment(k), self.pool,
                                         self.stream)
            self.graphs[(k, tf32)] = graph
            CAPTURES += 1
            CAPTURE_S += time.perf_counter() - t0
        return graph

    def advance(self, n):
        """n steps: the graphs of n's binary decomposition, replayed."""
        global REPLAYS, GRAPH_STEPS
        for k in _parts(n):
            self.graph(k).replay()
            REPLAYS += 1
            GRAPH_STEPS += k

    def release(self):
        """Reset the graphs and drop the buffers, once the last use's
        copy-out is done on the card."""
        if self.fence is not None:
            self.backend.sync(self.fence)
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.state = self.c = self.lb = self.ub = None


def _set_for(step_fn, st, c, lb, ub):
    """The key's graph set, made (after evicting least recently used
    sets down to the budget) if the cache lacks it.  Holds _LOCK."""
    from bensolve_tpu_torch.lp import simplex as sx

    W = st.W
    key = (step_fn, W.device, W.dtype) + tuple(W.shape)
    gs = _SETS.get(key)
    if gs is not None:
        _SETS.move_to_end(key)
        return gs
    need = _nbytes([getattr(st, f) for f in FIELDS] + [c, lb, ub])
    while _SETS and cached_bytes() + need > sx.TABLEAU_BYTES_BUDGET:
        _SETS.popitem(last=False)[1].release()
    gs = _SETS[key] = _GraphSet(BACKENDS[W.device.type], step_fn, st, c,
                                lb, ub)
    return gs


def run(step_fn, c, lb, ub, st, max_iter: int):
    """simplex._run_segmented's loop with every segment a replayed graph
    of ``step_fn`` (simplex._step or dual_simplex._dstep); ``st`` a
    simplex._State of contiguous tensors on a device with a backend."""
    from bensolve_tpu_torch.lp import simplex as sx

    with _LOCK:
        gs = _set_for(step_fn, st, c, lb, ub)
        gs.load(st, c, lb, ub)
        step, seg = 0, 1
        while step < max_iter and bool((gs.state.status
                                        == sx.RUNNING).any()):
            n = min(seg, max_iter - step)
            gs.advance(n)
            step += n
            seg = min(2 * seg, sx.SEGMENT_MAX)
        return gs.unload(st)
