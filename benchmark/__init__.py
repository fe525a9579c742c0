"""The benchmark of ``bensolve_tpu_torch``, the PyTorch and CUDA port.

``BENCHMARK.json`` at the repository's root names its cells, metrics
and bounds; ``run.py`` runs one cell (``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``);
``control.py`` takes the readings that the limits of ``correct`` are set
from.  A cell's configuration, traffic mix and metric readers are files
of their own, found by name:

    configs/<config>.json      the instance, its options, its reference
    instances/<name>.py        the instance's generator (plain arrays)
    reference/<name>.py        the plain reference that judges answers
    traffic/<mix>.json         the mix the one generator (traffic.py) reads
    workloads/<cell>.json      the cell's sample and limits for correct
    metrics/<metric>.py        one reader per metric
    probes/<probe>.py          the instruments a traced run installs

Nothing here imports JAX or the JAX package.  The tests (``python -m
pytest benchmark -q`` from the root) run on the CPU; the one marked
``cuda`` needs the card.
"""
