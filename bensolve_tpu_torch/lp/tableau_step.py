"""The tableau pivot step on a CUDA device: two hand-written kernels a
step (``csrc/tableau_step.cu``) in place of the torch ops of
``simplex._step_plain`` and ``dual_simplex._dstep_plain``.

* the choice kernel, one block per LP, decides the step (entering and
  leaving variables, statuses, the new basis metadata) and writes a
  pivot record: the rank-1 coefficients, the pivot row and element, and
  the next step's effective basic costs;
* the update kernel, grid (B, column tiles), applies the rank-1 update
  to W in place and prices the next step from the updated W in the same
  pass, so W is read once and written once a step.

The reduced costs are loop state (``_State.d``).  Which step runs is
decided here, by ``on_card``: on a CUDA device ``simplex._step`` and
``dual_simplex._dstep`` call ``step``, and ``start`` prices the state
(``price``) at the start of their pivot loop (``simplex._run_segmented``,
told which step it runs by the step's ``dual`` attribute); every step
leaves the next step's reduced costs.  Elsewhere the steps are the plain
versions and ``start`` leaves the state as it is.  The kernels launch on
the current stream and allocate nothing (the outputs come from
torch.empty), so a CUDA graph captures a step as it captured the torch
ops.  A refused launch raises.

``plan`` picks the update kernel's tile from the padded shape.  The
library is built by lp/_build.py at the first step on a card, never at
import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from bensolve_tpu_torch.lp import segments

# threads of an update block for LPs wider than one tile (tile * rows)
THREADS_UPDATE = 512
# an LP of at most this many columns is one tile; wider ones are cut
# into tiles one warp wide
ONE_TILE_MAX = 128
WARP = 32
# the choice kernel's pointer arguments (Step in csrc/tableau_step.cu;
# tests/test_torch_tableau_step.py holds the two to each other)
STEP_PTRS = 31

# the dtype of each field of the loop state the kernels read (beside the
# reduced costs, which ``price`` makes), None for the tableau's own
_FIELD_DTYPES = dict(W=None, xb=None, lbB=None, ubB=None, cB=None,
                     gamma=None, basis=torch.int64, in_basis=torch.bool,
                     at_upper=torch.bool, status=torch.int32,
                     stall=torch.int32, iters=torch.int32)

_LOCK = threading.Lock()
_LIB = None


def plan(Mp: int, NT: int) -> tuple[int, int]:
    """(tile, rows) of the update kernel at a padded shape: a tile of
    all NT columns where NT <= ONE_TILE_MAX, else of one warp; rows, the
    row groups a block walks W in, fill THREADS_UPDATE threads (at most
    one group per row)."""
    tile = NT if NT <= ONE_TILE_MAX else WARP
    return tile, max(1, min(Mp, THREADS_UPDATE // tile))


def _library():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from bensolve_tpu_torch.lp import _build

            lib = _build.load("tableau_step")
            p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for dt in ("f64", "f32"):
                choice = getattr(lib, f"tableau_choice_{dt}")
                choice.argtypes = [i, p, i, i, i, d, d, d, i, p]
                choice.restype = i
                update = getattr(lib, f"tableau_update_{dt}")
                update.argtypes = [p, i, i, i, i, i, p]
                update.restype = i
            _LIB = lib
    return _LIB


def _suffix(W):
    if W.device.type != "cuda" or not W.is_contiguous():
        raise ValueError("tableau_step: W must be a contiguous CUDA tensor")
    if W.dtype == torch.float64:
        return "f64"
    if W.dtype == torch.float32:
        return "f32"
    raise ValueError(f"tableau_step: unsupported dtype {W.dtype}")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors])


def _check(err: int, what: str, W) -> None:
    if err != 0:
        raise RuntimeError(f"tableau_step {what} launch failed: CUDA error "
                           f"{err} (B, M, NT = {tuple(W.shape)}, {W.dtype})")


def _update(W, coef, cbe, piv, pidx, feas, c, gamma, d) -> None:
    """The update kernel: W -= coef w_r / alpha_r in place (none where
    ``coef`` is None: price only), then d = c_eff - cbe W and, where
    ``gamma`` is given, the devex weights, both in place."""
    sfx = _suffix(W)
    B, M, NT = W.shape
    tile, rows = plan(M, NT)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    err = getattr(_library(), f"tableau_update_{sfx}")(
        _ptrs((W, coef, cbe, piv, pidx, feas, c, gamma, d)), B, M, NT, tile,
        rows, stream)
    _check(err, "update", W)


def on_card(st) -> bool:
    """Whether the tableau steps of ``st`` run as the kernels here: where
    its tableau is on a CUDA device."""
    return st.W.device.type == "cuda"


def start(c, st, dual: bool):
    """The state a pivot loop of the step of ``dual`` starts from: where
    the kernels run, ``st`` priced for them (``price``), else ``st``."""
    return price(c, st, dual) if on_card(st) else st


def price(c, st, dual: bool):
    """``st`` with its reduced costs ``d``: c_eff - cB_eff W, the costs
    the step of ``dual`` (the dual's true costs, or the primal's phase
    costs) prices with.  The fields the kernels read are checked here,
    once a loop: every step leaves them as it found them (contiguous,
    of the loop's dtype and batch)."""
    from bensolve_tpu_torch.lp import simplex as sx

    _suffix(st.W)
    B, _, NT = st.W.shape
    for f, dt in _FIELD_DTYPES.items():
        t = getattr(st, f)
        if (t.dtype != (dt or st.W.dtype) or t.device != st.W.device
                or not t.is_contiguous() or t.shape[0] != B):
            raise ValueError(f"tableau_step: field {f} is not a "
                             f"contiguous ({B}, ...) tensor of "
                             f"{dt or st.W.dtype} on {st.W.device}")
    if c.shape != (B, NT) or c.dtype != st.W.dtype:
        raise ValueError(f"tableau_step: c must be a ({B}, {NT}) tensor "
                         f"of {st.W.dtype}")
    c = c.contiguous()
    if dual:
        cbe = st.cB.contiguous()
        feas = torch.ones(c.shape[0], dtype=torch.bool, device=c.device)
    else:
        _, _, feas, cbe = sx._phase_costs(st)
    d = torch.empty_like(c)
    _update(st.W, None, cbe.contiguous(), None, None, feas.contiguous(), c,
            None, d)
    return dataclasses.replace(st, d=d)


def step(c, lb, ub, st, dual: bool):
    """One pivot (``simplex._step``, or ``dual_simplex._dstep`` where
    ``dual``) for every running LP of the batch, from a state priced by
    ``price`` (or left so by a step).  W, d and (primal) gamma are updated in place; every other
    field of the returned state is a new tensor."""
    from bensolve_tpu_torch.lp import simplex as sx

    if st.d is None:
        raise ValueError("tableau_step.step: the state has no reduced "
                         "costs (price it first)")
    sfx = _suffix(st.W)
    B, M, NT = st.W.shape
    c, lb, ub = c.contiguous(), lb.contiguous(), ub.contiguous()
    e = torch.empty_like
    out = dict(basis=e(st.basis), xb=e(st.xb), lbB=e(st.lbB), ubB=e(st.ubB),
               cB=e(st.cB), in_basis=e(st.in_basis), at_upper=e(st.at_upper),
               status=e(st.status), stall=e(st.stall), iters=e(st.iters))
    coef, cbe = e(st.xb), e(st.xb)
    piv = st.xb.new_empty((B, 3))
    pidx = st.status.new_empty((B, 3))
    feas = st.in_basis.new_empty((B,))
    ptrs = (st.W, st.d, c, lb, ub, st.gamma, st.basis, st.xb, st.lbB,
            st.ubB, st.cB, st.in_basis, st.at_upper, st.status, st.stall,
            st.iters, out["basis"], out["xb"], out["lbB"], out["ubB"],
            out["cB"], out["in_basis"], out["at_upper"], out["status"],
            out["stall"], out["iters"], coef, cbe, piv, pidx, feas)
    tol_bnd, tol_dj, tol_piv = sx._tols(st.W.dtype)
    stream = torch.cuda.current_stream(st.W.device).cuda_stream
    err = getattr(_library(), f"tableau_choice_{sfx}")(
        int(dual), _ptrs(ptrs), B, M, NT, tol_bnd, tol_dj, tol_piv,
        sx.BLAND_AFTER, stream)
    _check(err, "choice", st.W)
    _update(st.W, coef, cbe, piv, pidx, feas, c, None if dual else st.gamma,
            st.d)
    segments.tally_kernel_step()
    return sx._State(W=st.W, gamma=st.gamma, d=st.d, **out)
