"""bensolve_tpu_torch — the PyTorch/CUDA port of bensolve_tpu.

Solves vector linear programs with Benson's algorithm (primal variant):
each round's scalarization LPs are solved as one batch on a torch
device (``bensolve_tpu_torch.lp``), and the outer approximation is cut
by a polytope engine on the host (``bensolve_tpu_torch.poly``).  Float32
LP batches on a CUDA device run a hand-written CUDA kernel
(``lp/csrc/group_simplex.cu``); everything else runs torch ops.

The JAX package ``bensolve_tpu`` is the reference this port is held
against.  Importing this package imports torch and never jax, and sets
no global torch configuration.
"""

from bensolve_tpu_torch.vlp.problem import VLPProblem, Bounds
from bensolve_tpu_torch.vlp.options import Options
from bensolve_tpu_torch.vlp.reader import read_vlp
from bensolve_tpu_torch.algs.driver import solve, solve_file

__version__ = "0.1.0"

__all__ = [
    "VLPProblem",
    "Bounds",
    "Options",
    "read_vlp",
    "solve",
    "solve_file",
]
