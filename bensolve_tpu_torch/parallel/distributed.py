"""Multi-process execution of the Benson rounds, on ``torch.distributed``.

The port of ``bensolve_tpu/parallel/distributed.py``.  Each round's
frontier of scalarization LPs is sharded across processes, the
resulting cuts are all-gathered, and every process applies them to its
REPLICATED polytope in a canonical order, so every process's outer
approximation stays bit-identical.

The gathered rows are host numpy arrays (cut vectors, statuses and
pre-images read back from the LP solve), so the collective runs over
the Gloo backend on CPU tensors whatever device the LPs themselves run
on.  NCCL is not used: nothing on this path gathers device tensors, and
one card cannot host two NCCL ranks.

On a single process everything degenerates to local compute.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Process-group bring-up over Gloo (no-op without a coordinator
    address or when a process group already exists).
    ``coordinator_address``: ``host:port`` of rank 0."""
    if coordinator_address is None or _initialized():
        return
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _initialized() else 0


def _world() -> int:
    return dist.get_world_size() if _initialized() else 1


def shard_indices(n: int, *, process_id: int | None = None,
                  process_count: int | None = None) -> np.ndarray:
    """This process's strided share of a frontier of size n."""
    pid = _rank() if process_id is None else process_id
    pcount = _world() if process_count is None else process_count
    return np.arange(pid, n, pcount)


def allgather_rows(local: np.ndarray, total: int | None = None
                   ) -> np.ndarray:
    """Concatenate each process's rows, in process order (single
    process: identity).

    ``total``: global row count (known to every process: the frontier
    size).  Strided shards differ in length by one, and the collective
    needs equal shapes, so local rows are padded to ceil(total/P) with
    NaN rows that are dropped after the gather."""
    local = np.asarray(local)
    pcount = _world()
    if pcount == 1:
        return local
    if total is None:
        total = local.shape[0] * pcount
    rows_max = -(-total // pcount)
    padded = np.full((rows_max, local.shape[1]), np.nan)
    padded[:local.shape[0]] = local
    mine = torch.from_numpy(padded)
    parts = [torch.empty_like(mine) for _ in range(pcount)]
    dist.all_gather(parts, mine)
    out = torch.cat(parts).numpy()
    keep = ~np.all(np.isnan(out), axis=1)
    return out[keep]


def canonical_order(cuts: np.ndarray) -> np.ndarray:
    """Deterministic application order for a round's gathered cuts:
    lexicographic on the cut vectors, independent of which process
    produced which cut and of the frontier traversal order."""
    cuts = np.asarray(cuts)
    if cuts.size == 0:
        return np.arange(0)
    return np.lexsort(np.round(cuts.T[::-1], 12))
