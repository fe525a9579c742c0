"""The LP graph cache's capture counter (``lp/segments.py::CAPTURES``),
read when the window opens and when it closes; ``delta`` holds what
the window added.  Reads only."""

from benchmark.probes import BaseProbe


class Probe(BaseProbe):
    def __init__(self):
        self.delta = {}
        self._at_start = 0

    @staticmethod
    def _read() -> int:
        from bensolve_tpu_torch.lp import segments

        return segments.CAPTURES

    def start(self):
        self._at_start = self._read()

    def stop(self):
        self.delta = {"captures": self._read() - self._at_start}
