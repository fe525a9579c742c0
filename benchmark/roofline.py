"""Peaks of the card and the operations and bytes of the device pivot
step, for the roofline shares.

Published peaks of one NVIDIA H100 SXM (data sheet, dense): HBM3 at
3.35 TB/s; 34 TFLOP/s in float64 and 67 TFLOP/s in float32 outside the
tensor cores, where the pivot step's rank-1 update runs (the 67 TFLOP/s
float64 rate is the tensor cores')."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"float64": 34e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}


def pivot_step_least_s(B: int, M: int, N: int, dtype: str) -> float:
    """The least time of one pivot step over B LPs of M rows and N
    columns: the unpadded tableau's B M (N + M) elements read once and
    written once at the HBM rate, or the rank-1 update's 2 B M (N + M)
    flop at the dtype's peak, whichever is longer."""
    elems = float(B) * M * (N + M)
    return max(2.0 * elems * ITEMSIZE[dtype] / HBM_BYTES_PER_S,
               2.0 * elems / FLOPS[dtype])
