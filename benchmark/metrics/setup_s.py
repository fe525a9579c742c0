"""Seconds from the start of the process to the start of the window:
imports, the card's context, loading (and on a checkout's first run,
compiling) the polytope engine, building the instance and the warm-up
solves, which capture the cell's CUDA graphs."""

PROBES = ()


def read(run):
    return run.setup_s
