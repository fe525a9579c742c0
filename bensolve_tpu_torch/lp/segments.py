"""Segments of the device loops as CUDA graphs: the torch counterpart of
the JAX package's device-side segment programs,
``bensolve_tpu/lp/simplex.py::_tableau_run_jit``,
``lp/dual_simplex.py::_dual_run_jit``, ``lp/revised.py::_revised_run_jit``
and ``lp/ipm.py::_ipm_seg_jit`` (each a ``lax.while_loop`` over a step
that runs on the device between two host reads).

Run eagerly, every op of a step is a kernel launched from Python, about
60 a pivot and 350 an interior-point iteration.  Here k steps of a step
function are captured once into a ``torch.cuda.CUDAGraph`` and replayed
with one launch.  The loops keep their schedules, so the host reads fall
on the same steps as in the eager loop: ``simplex._run_segmented`` reads
the status between segments of 1, 2, 4, ... SEGMENT_MAX steps (``run``
below), and ``revised._run`` also every 16 steps and at every multiple
of its refactorization interval, where it decides on the host whether to
refactorize and runs the refactorization eagerly between two replays on
the set's buffers (through ``held``).  ``ipm._ipm_core`` replays one
iteration at a time and copies a flag (any instance running) to the host
after each, reading it one iteration later.  A piece of n steps between
two reads replays the binary decomposition of n (37 = 32 + 4 + 1).

The cache holds one *graph set* per key: the step function, the device,
and the shape and dtype of every field of the loop state and of every
static input (c, lb, ub for the tableau steps, which are given None for
A since neither reads it; A, A^T, c, lb, ub for the revised step; A, c,
l, u, the split pairs and the tensors derived from c, l, u for the
interior-point step).  A set holds static buffers for all of these, one
memory pool, a side stream, and one graph per (k, TF32 setting),
captured at its first use.  Graph(k) runs k steps on the static buffers
and ends by copying each new field back into them (the fields the step
updates in place, W or B^-1 and the basis rows, are already there), so
the state always lives in the buffers.  A use copies its start state and
inputs in, replays, and copies the final state out: the fields updated
in place back into the start state's own tensors, the tensors that the
eager loop updates in place, and every other field into a new tensor.
So nothing a solve returns, a KeptState's W included, aliases the cache,
and a new A of a cached shape is copied in before any replay reads it.
The sets hold at most ``simplex.TABLEAU_BYTES_BUDGET`` bytes of static
buffers and memory pools (one set alone may hold more; a pool counts
what the device's reserved memory grew by while its graphs were
captured, about one step's peak): the least recently used set is evicted
first and its graphs are reset.  The allocator's cache is emptied before
every capture, because during one it frees no cached block, so a
capture on a card full of cached memory (released pools, the warm-ups'
blocks on other sets' streams) would fail.

A replay launches the kernels that the eager steps launch, on the same
inputs, so it steps bit for bit as the eager loop.  The key holds
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
``BACKENDS`` has no entry for the device (the CPU) the loops run
eagerly, as the plain version, and a mesh's shard threads and "tp"
panels run them eagerly too (``simplex._graphs_on`` says why).
``eager_loop()`` exists only to hold the graphs to the eager loops, in
the tests and chip_smoke.py.

Counters, plain integers read by chip_smoke.py: CAPTURES, REPLAYS,
GRAPH_STEPS (steps run by replays), EAGER_STEPS (steps the eager loops
ran, on any device), CAPTURE_S (seconds spent warming up and capturing),
each over every loop, and the same split by loop in ``BY_LOOP``
("tableau", "dual", "revised", "ipm").
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch

CAPTURES = 0
REPLAYS = 0
GRAPH_STEPS = 0
EAGER_STEPS = 0
CAPTURE_S = 0.0
LOOPS = ("tableau", "dual", "revised", "ipm")
BY_LOOP = {name: dict(captures=0, replays=0, graph_steps=0, eager_steps=0,
                      capture_s=0.0) for name in LOOPS}

# steps run on scratch copies of the state before a set's first capture
# under a TF32 setting (see above)
WARMUP_STEPS = 2

# the tableau loops' state fields (simplex._State), each a tensor
FIELDS = ("basis", "in_basis", "at_upper", "W", "xb", "lbB", "ubB", "cB",
          "status", "stall", "iters", "gamma")

_LOCK = threading.Lock()            # one user of the cache at a time
_COUNT_LOCK = threading.Lock()      # EAGER_STEPS, counted on any thread
_SETS: collections.OrderedDict = collections.OrderedDict()
_EAGER = threading.local()


def counts() -> dict:
    return dict(captures=CAPTURES, replays=REPLAYS, graph_steps=GRAPH_STEPS,
                eager_steps=EAGER_STEPS, capture_s=CAPTURE_S,
                by_loop={k: dict(v) for k, v in BY_LOOP.items()})


def reset_counts() -> None:
    global CAPTURES, REPLAYS, GRAPH_STEPS, EAGER_STEPS, CAPTURE_S
    CAPTURES = REPLAYS = GRAPH_STEPS = EAGER_STEPS = 0
    CAPTURE_S = 0.0
    for v in BY_LOOP.values():
        v.update(captures=0, replays=0, graph_steps=0, eager_steps=0,
                 capture_s=0.0)


def loop_of(step_fn) -> str:
    """The counters' name of a tableau loop's step function: "dual" for
    dual_simplex._dstep, "tableau" for any other."""
    from bensolve_tpu_torch.lp import dual_simplex

    return "dual" if step_fn is dual_simplex._dstep else "tableau"


def count_eager(n: int, loop: str) -> None:
    global EAGER_STEPS
    with _COUNT_LOCK:
        EAGER_STEPS += n
        BY_LOOP[loop]["eager_steps"] += n


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
    """The bytes of static buffers and memory pools the graph sets hold
    now."""
    return sum(s.nbytes + s.pool_bytes for s in _SETS.values())


def cached_pool_bytes() -> int:
    """The bytes of the graph sets' memory pools alone."""
    return sum(s.pool_bytes for s in _SETS.values())


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
    def reserved(dev):
        return torch.cuda.memory_reserved(dev)

    @staticmethod
    def empty_cache():
        torch.cuda.empty_cache()

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
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _fields(st) -> tuple:
    """The loop state's fields: every field of its dataclass."""
    return tuple(f.name for f in dataclasses.fields(st))


def _contiguous_like(x):
    return None if x is None else torch.empty_like(
        x, memory_format=torch.contiguous_format)


class _GraphSet:
    """The static buffers, pool, side stream and graphs of one key.
    ``inputs``: the step's leading arguments (None stays None);
    ``inplace``: the fields the step updates in place."""

    def __init__(self, backend, step_fn, loop, st, inputs, inplace):
        self.backend, self.step_fn, self.loop = backend, step_fn, loop
        self.dev = st.status.device
        self.fields, self.inplace = _fields(st), inplace
        self.state = type(st)(**{f: _contiguous_like(getattr(st, f))
                                 for f in self.fields})
        self.inputs = tuple(_contiguous_like(x) for x in inputs)
        self.nbytes = _nbytes(self._buffers())
        self.pool_bytes = 0   # what the captures reserved for the pool
        self.pool = backend.new_pool()
        self.stream = backend.new_stream(self.dev)
        self.graphs = {}      # (k, TF32 setting) -> graph
        self.warm = set()     # TF32 settings warmed up
        self.fence = None     # the last use's copy-out, on the card

    def _buffers(self):
        return [getattr(self.state, f) for f in self.fields] + [
            x for x in self.inputs if x is not None]

    def load(self, st, inputs):
        if self.fence is not None:
            self.backend.wait(self.fence, self.dev)
        self.put(st)
        for buf, x in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(x)

    def put(self, st):
        """Copy the fields of ``st`` that are not the buffers already
        into them (a start state; a state the caller made from them)."""
        for f in self.fields:
            new, buf = getattr(st, f), getattr(self.state, f)
            if new is not buf:
                buf.copy_(new)

    def unload(self, st):
        """The final state: the fields updated in place copied into the
        start state's own tensors, every other field into a new one."""
        out = type(st)(**{f: (getattr(st, f).copy_(getattr(self.state, f))
                              if f in self.inplace
                              else getattr(self.state, f).clone())
                          for f in self.fields})
        self.fence = self.backend.fence(self.dev)
        return out

    def _steps(self, st, k):
        for _ in range(k):
            st = self.step_fn(*self.inputs, st)
        return st

    def _segment(self, k):
        def run():
            self.put(self._steps(self.state, k))
        return run

    def _warm_up(self):
        scratch = type(self.state)(**{f: getattr(self.state, f).clone()
                                      for f in self.fields})
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
            # a capture's allocations come only from the device, as the
            # allocator frees no cached block while a capture is under
            # way: free the blocks other sets' released pools, the
            # warm-up and eager work left cached
            self.backend.empty_cache()
            before = self.backend.reserved(self.dev)
            graph = self.backend.capture(self._segment(k), self.pool,
                                         self.stream)
            self.pool_bytes += max(0, self.backend.reserved(self.dev)
                                   - before)
            self.graphs[(k, tf32)] = graph
            _trim(self)
            dt = time.perf_counter() - t0
            CAPTURES += 1
            CAPTURE_S += dt
            BY_LOOP[self.loop]["captures"] += 1
            BY_LOOP[self.loop]["capture_s"] += dt
        return graph

    def advance(self, n):
        """n steps: the graphs of n's binary decomposition, replayed."""
        global REPLAYS, GRAPH_STEPS
        for k in _parts(n):
            self.graph(k).replay()
            REPLAYS += 1
            GRAPH_STEPS += k
            BY_LOOP[self.loop]["replays"] += 1
            BY_LOOP[self.loop]["graph_steps"] += k

    def release(self):
        """Reset the graphs and drop the buffers, once the last use's
        copy-out is done on the card."""
        if self.fence is not None:
            self.backend.sync(self.fence)
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.state = self.inputs = None


def _key(step_fn, st, inputs):
    return (step_fn, st.status.device) + tuple(
        None if x is None else (tuple(x.shape), x.dtype)
        for x in [getattr(st, f) for f in _fields(st)] + list(inputs))


def _trim(keep) -> None:
    """Evict the least recently used sets other than ``keep`` while the
    cache holds more than the budget (after ``keep``'s pool grew).
    Holds _LOCK."""
    from bensolve_tpu_torch.lp import simplex as sx

    for key in list(_SETS):
        if cached_bytes() <= sx.TABLEAU_BYTES_BUDGET:
            return
        if _SETS[key] is not keep:
            _SETS.pop(key).release()


def _set_for(step_fn, loop, st, inputs, inplace):
    """The key's graph set, made (after evicting least recently used
    sets down to the budget) if the cache lacks it.  Holds _LOCK."""
    from bensolve_tpu_torch.lp import simplex as sx

    key = _key(step_fn, st, inputs)
    gs = _SETS.get(key)
    if gs is not None:
        _SETS.move_to_end(key)
        return gs
    need = _nbytes([getattr(st, f) for f in _fields(st)] + list(inputs))
    while _SETS and cached_bytes() + need > sx.TABLEAU_BYTES_BUDGET:
        _SETS.popitem(last=False)[1].release()
    gs = _SETS[key] = _GraphSet(BACKENDS[st.status.device.type], step_fn,
                                loop, st, inputs, inplace)
    return gs


@contextlib.contextmanager
def held(step_fn, loop, st, inputs, inplace):
    """The graph set of ``step_fn(*inputs, state)`` for ``st``, loaded
    with ``st`` and ``inputs`` (tensors, or None for an argument the step
    does not read) and held by this thread until the block ends, for a
    loop whose schedule the caller runs: ``advance``, read and ``put``
    between replays, then ``unload(st)``.  ``loop`` names the counters;
    ``inplace`` the fields the step updates in place."""
    with _LOCK:
        gs = _set_for(step_fn, loop, st, inputs, inplace)
        gs.load(st, inputs)
        yield gs


def run(step_fn, c, lb, ub, st, loop):
    """simplex._run_segmented's loop, on the schedule of ``loop`` (a
    simplex._Loop), with every segment a replayed graph of ``step_fn``
    (simplex._step or dual_simplex._dstep); ``st`` a simplex._State of
    contiguous tensors on a device with a backend."""
    with held(step_fn, loop_of(step_fn), st, (None, c, lb, ub),
              ("W",)) as gs:
        while n := loop.next(gs.state.status):
            gs.advance(n)
        return gs.unload(st)
