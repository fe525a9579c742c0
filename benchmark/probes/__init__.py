"""Instruments for the traced run, one module each, found by the name a
per-layer metric's reader lists in its ``PROBES``.

Each module defines ``Probe`` (a ``BaseProbe``) with ``install()`` (wrap
the program's layer entry functions; nothing is wrapped in an untraced
run), ``start()`` and ``stop()`` (the window opens and closes: only
what happens between them counts), ``trace(on)`` (the solves under the
device trace begin and end: a probe then synchronises nothing, so that
the trace sees the program's own overlap of host and card),
``intervals()`` (the host intervals it kept under the trace, by label,
on the host's perf_counter clock) and ``remove()`` (put the program's
functions back).  What a probe gathered is on the probe object, for
the readers."""

import contextlib


class BaseProbe:
    """A probe that does nothing at each of the harness's calls."""

    def install(self):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def trace(self, on: bool):
        pass

    def intervals(self) -> dict:
        return {}

    def remove(self):
        pass


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield real
    finally:
        setattr(owner, name, real)
