"""A stand-in for the CUDA graph backend of
bensolve_tpu_torch/lp/segments.py, so that the segment runners run on
the CPU (tests/test_torch_segment_graphs.py,
tests/test_torch_revised_graphs.py, tests/test_torch_ipm_graphs.py).

There is no CUDA graph on the CPU, so ``StandIn`` takes the backend's
place: a capture records the segment's step calls and runs nothing (as a
capture runs nothing), and a replay runs them on the static buffers.
With it the runners' bookkeeping runs here: the cache and its keys, the
copy-in and copy-out, the schedule of segments and its binary tails,
eviction.  ``pool_per_capture`` bytes are "reserved" by every capture
(0 unless a test sets it), so that the cache's count of its memory
pools runs here too.
"""

import contextlib

import torch

from bensolve_tpu_torch.lp import segments


class _Recorded:
    """A "captured" segment: the function whose step calls it replays."""

    def __init__(self, owner, fn):
        self.owner, self.fn = owner, fn

    def replay(self):
        self.fn()
        self.owner.replays += 1

    def reset(self):
        self.fn = None
        self.owner.resets += 1


class StandIn:
    """The CPU's stand-in for the CUDA backend of lp/segments.py."""

    def __init__(self):
        self.captures = self.replays = self.resets = 0
        self.pool_per_capture = self.reserved_bytes = self.emptied = 0

    def new_pool(self):
        return None

    def new_stream(self, dev):
        return None

    def on_side(self, stream, fn):
        fn()

    def capture(self, fn, pool, stream):
        self.captures += 1
        self.reserved_bytes += self.pool_per_capture
        return _Recorded(self, fn)

    def reserved(self, dev):
        return self.reserved_bytes

    def empty_cache(self):
        self.emptied += 1

    def fence(self, dev):
        return None

    def wait(self, fence, dev):
        pass

    def sync(self, fence):
        pass


@contextlib.contextmanager
def standing_in():
    """CPU loops through the segment runners, with a fresh stand-in."""
    stand_in = StandIn()
    segments.BACKENDS["cpu"] = stand_in
    try:
        yield stand_in
    finally:
        del segments.BACKENDS["cpu"]
        segments.clear()


def bits(t):
    """A tensor's bit pattern, for equality that tells -0.0 and NaNs."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t
