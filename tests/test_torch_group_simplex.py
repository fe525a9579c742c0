"""The per-LP simplex kernel's plain PyTorch version against the JAX
package's Pallas kernel (lp_batch_pallas in interpret mode, as
tests/test_pallas_simplex.py runs it on the CPU), the kernel's gate, and
its wrapper.

Required: equal status, iters, basis and at_upper per LP, and obj / x /
row_dual within 1e-5 (both float32 through the same recovery; the final
LU is the only part summed in another order).  The CUDA kernel itself
needs the card: its tests are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from bensolve_tpu.lp import simplex as jsx
from bensolve_tpu.lp import pallas_simplex
from bensolve_tpu.lp.pallas_simplex import lp_batch_pallas
from bensolve_tpu_torch.lp import REVISED_RATIO, _kernel_eligible
from bensolve_tpu_torch.lp import group_simplex as gs
from tests.test_pallas_simplex import make


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(ref, got):
    np.testing.assert_array_equal(ref.status, got.status)
    np.testing.assert_array_equal(ref.iters, got.iters)
    np.testing.assert_array_equal(ref.basis, got.basis)
    np.testing.assert_array_equal(ref.at_upper, got.at_upper)
    ok = ref.status == jsx.OPTIMAL
    for field in ("obj", "x", "row_dual"):
        np.testing.assert_allclose(getattr(got, field)[ok],
                                   getattr(ref, field)[ok],
                                   rtol=1e-5, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_pallas_cold_and_warm(seed, group):
    args = make(16, 16, 8, seed)
    ref = lp_batch_pallas(*args, group=group, interpret=True)
    got = gs.lp_batch_group(*args, group=group, device="cpu")
    assert_same(ref, got)
    i0 = int(np.flatnonzero(ref.status == jsx.OPTIMAL)[0])
    warm = (ref.basis[i0], ref.at_upper[i0])
    ref_w = lp_batch_pallas(*args, group=group, interpret=True,
                            start_basis=warm)
    got_w = gs.lp_batch_group(*args, group=group, device="cpu",
                              start_basis=warm)
    assert_same(ref_w, got_w)
    assert got_w.iters[i0] == 0


def test_statuses_batch():
    A = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    c = np.array([[1, 1], [0, 0], [-1, 0]], np.float32)
    rlb = np.array([[0, 0], [3, 0], [0, 0]], np.float32)
    rub = np.array([[np.inf] * 2, [1, np.inf], [np.inf] * 2], np.float32)
    clb = np.array([[0, 0], [0, 0], [-np.inf, 0]], np.float32)
    cub = np.full((3, 2), np.inf, np.float32)
    ref = lp_batch_pallas(A, c, rlb, rub, clb, cub, interpret=True)
    got = gs.lp_batch_group(A, c, rlb, rub, clb, cub, device="cpu")
    assert list(got.status) == [jsx.OPTIMAL, jsx.INFEASIBLE, jsx.UNBOUNDED]
    assert_same(ref, got)


def test_gate(monkeypatch):
    f32 = {"dtype": np.float32}
    monkeypatch.delenv("BENSOLVE_FORCE_PALLAS", raising=False)
    assert not _kernel_eligible(16, 16, f32, "cpu")
    assert not _kernel_eligible(16, 16, {"dtype": np.float64}, "cuda")
    assert _kernel_eligible(16, 16, f32, "cuda")
    # a tableau whose per-LP vectors overflow a block's shared memory
    assert not _kernel_eligible(4096, 40000, f32, "cuda")
    monkeypatch.setenv("BENSOLVE_FORCE_PALLAS", "1")
    assert _kernel_eligible(16, 16, f32, "cpu")
    assert not _kernel_eligible(16, 16, {"dtype": np.float64}, "cpu")


def test_try_solve_batch_rejects_per_instance_warm():
    args = make(16, 16, 8, seed=3)
    cold = gs.lp_batch_group(*args, device="cpu")
    assert gs.try_solve_batch(*args, start_basis=(cold.basis, cold.at_upper),
                              device="cpu") is None


def test_wrapper_runs_plain_version_on_cpu_and_counts_no_launch():
    args = make(16, 16, 8, seed=4)
    calls, routed = gs.CALLS, gs.ROUTED
    ref = lp_batch_pallas(*args, group=1, interpret=True)
    got = gs.lp_batch_group(*args, device="cpu")
    assert_same(ref, got)
    assert gs.CALLS == calls and gs.ROUTED == routed + 1
    with pytest.raises(ValueError, match="group=1"):
        gs.lp_batch_group(*args, group=8, device=torch.device("cuda"))


def test_wrapper_checks_inputs():
    W0 = torch.zeros(8, 128)
    c = torch.zeros(2, 128)
    basis0 = torch.arange(8, dtype=torch.int32)
    atup = torch.zeros(2, 128, dtype=torch.bool)
    with pytest.raises(TypeError, match="lb"):
        gs.solve_batch_group(W0, c, c.double(), c, basis0, atup, 10)
    with pytest.raises(ValueError, match="basis0"):
        gs.solve_batch_group(W0, c, c, c, basis0[:4], atup, 10)


def test_chunks_over_the_workspace_budget(monkeypatch):
    args = make(16, 16, 8, seed=5)
    ref = gs.lp_batch_group(*args, device="cpu")
    monkeypatch.setattr(gs, "WORKSPACE_BYTES_BUDGET", 3 * 16 * 128 * 4)
    assert gs._pick_chunk(16, 128) == 2
    got = gs.lp_batch_group(*args, device="cpu")
    assert_same(ref, got)


def _old_shape_supported(M, N):
    """shape_supported as it stood with the global-memory kernel alone:
    the per-LP vectors fit a block and the tableau the workspace."""
    Mp, NT = gs.padded_shape(M, N)
    return ((7 * NT + 7 * Mp) * 4 + Mp * 4 + 2 * NT <= gs.SMEM_LIMIT
            and Mp * NT * 4 <= gs.WORKSPACE_BYTES_BUDGET)


def _example_lp_shape(name, which):
    """(M, N) of an example's P2 or P1 LP, as the templates build them:
    P2 (m+q+p+1, n+q+1), P1 (m+q+1, n+q)."""
    from bensolve_tpu_torch import examples
    from bensolve_tpu_torch.algs.solution import sol_init
    from bensolve_tpu_torch.vlp.options import Options

    vlp = examples.ALL[name]()
    sol, _ = sol_init(vlp, Options(device="cpu", write_files=False))
    m, n, q = vlp.m, vlp.n, vlp.q
    if which == "P2":
        return m + q + sol.p + 1, n + q + 1
    return m + q + 1, n + q


# (M, N) or an example's LP -> (variant, cluster size)
PLANS = [((16, 16), ("cluster", 1)), ((160, 160), ("cluster", 2)),
         ((200, 200), ("cluster", 4)), ((350, 347), ("cluster", 8)),
         ((500, 500), ("cluster", 16)), ((700, 700), ("spill", 16)),
         (("example01", "P2"), ("cluster", 1)),
         (("example01", "P1"), ("cluster", 1)),
         (("example05", "P2"), ("cluster", 1)),
         (("example05", "P1"), ("cluster", 1)),
         (("example08", "P2"), ("cluster", 1)),
         (("example08", "P1"), ("cluster", 1)),
         (("example10", "P2"), ("cluster", 8)),
         (("example10", "P1"), ("cluster", 8))]


@pytest.mark.parametrize("shape,expected", PLANS,
                         ids=[f"{a}-{b}" for (a, b), _ in PLANS])
def test_plan_by_shape(shape, expected):
    M, N = _example_lp_shape(*shape) if isinstance(shape[0], str) else shape
    Mp, NT = gs.padded_shape(M, N)
    assert gs.plan(Mp, NT) == expected
    kind, C = expected
    rows = gs.spill_rows(Mp, NT) if kind == "spill" else None
    assert gs.smem_bytes(Mp, NT, C, rows) <= gs.SMEM_LIMIT
    if kind == "cluster" and C > 1:
        # the smallest cluster that holds the tableau
        assert gs.smem_bytes(Mp, NT, C // 2) > gs.SMEM_LIMIT
    if kind in ("spill", "global"):
        assert all(gs.smem_bytes(Mp, NT, k) > gs.SMEM_LIMIT
                   for k in gs.CLUSTER_SIZES)
    if kind == "spill":
        assert 0 <= rows < Mp


def test_rows_or_slices_not_in_fours_take_the_global_variant():
    assert gs.plan(6, 128) == ("global", 0)
    assert gs.plan(8, 130) == ("global", 0)
    assert gs.plan(8, 128) == ("cluster", 1)


def test_ex10_cluster_holds_the_whole_tableau():
    Mp, NT = gs.padded_shape(350, 347)
    assert (Mp, NT) == (384, 768)
    # eight column slices of 96, each with all 384 rows (row stride 100),
    # beside two buffers of the entering column and the vectors
    tableau = Mp * (NT // 8 + 4) * 4
    columns = 2 * Mp * 4
    assert gs.smem_bytes(Mp, NT, 8) >= tableau + columns
    assert gs.smem_bytes(Mp, NT, 8) - tableau - columns < 32 * 1024


@pytest.mark.parametrize("M", [1, 8, 31, 33, 100, 260, 400, 600, 1100, 2100,
                               4200])
def test_planned_bytes_fit_and_old_shapes_stay_supported(M):
    """Over a grid of shapes: the bytes of the planned C never exceed a
    block's limit, and every shape the gate took before the cluster
    variant it still takes."""
    for N in (1, 7, 50, 129, 300, 700, 1500, 3000, 6000, 12000, 24000):
        Mp, NT = gs.padded_shape(M, N)
        planned = gs.plan(Mp, NT)
        if planned is not None:
            rows = (gs.spill_rows(Mp, NT) if planned[0] == "spill"
                    else None)
            assert gs.smem_bytes(Mp, NT, planned[1], rows) <= gs.SMEM_LIMIT
        if _old_shape_supported(M, N):
            assert gs.shape_supported(M, N) and planned is not None


def test_wrapper_takes_a_forced_variant_and_rejects_an_unknown_one():
    W0 = torch.zeros(8, 128)
    c = torch.zeros(2, 128)
    args = (W0, c, c, c, torch.arange(8, dtype=torch.int32),
            torch.zeros(2, 128, dtype=torch.bool), 10)
    # the CPU runs the plain version whatever the variant
    status, _, _, _ = gs.solve_batch_group(*args, variant="global")
    assert status.shape == (2,)
    with pytest.raises(ValueError, match="variant"):
        gs.solve_batch_group(*args, variant="nope")


def _gate_shapes():
    """Every padded shape an LP with N < REVISED_RATIO * M and M < 1100
    reaches (the LPs the router can send to a kernel) that the JAX
    package's Pallas gate takes, as {(Mp, NT): (M, N)}: per row bucket
    its largest M, per column bucket its smallest N."""
    top = {gs.padded_shape(M, 1)[0]: M for M in range(1, 1100)}
    shapes = {}
    for Mp, M in top.items():
        N = 1
        while N < REVISED_RATIO * M:
            shapes.setdefault(gs.padded_shape(M, N), (M, N))
            N = gs.padded_shape(M, N)[1] - Mp + 1
    return {s: mn for s, mn in sorted(shapes.items())
            if pallas_simplex.shape_supported(*mn)}


GATE_SHAPES = _gate_shapes()
# the shapes among them that no cluster holds (2.8-6.1 MiB per LP)
BAND = [s for s in GATE_SHAPES
        if all(gs.smem_bytes(*s, C) > gs.SMEM_LIMIT for C in gs.CLUSTER_SIZES)]


def test_gate_shapes_and_band():
    """136 padded shapes, 35 of them in the band from (448, 1792) to
    (1024, 1536), each a tableau of 2.8-6.1 MiB."""
    assert len(GATE_SHAPES) == 136 and len(BAND) == 35
    assert (BAND[0], BAND[-1]) == ((448, 1792), (1024, 1536))
    mib = [Mp * NT * 4 / 2 ** 20 for Mp, NT in BAND]
    assert 2.8 <= min(mib) and max(mib) <= 6.2
    # phase 4's large VLP (P2 705x259) and M=N=700 of phase 3
    assert gs.padded_shape(705, 259) in BAND
    assert gs.padded_shape(700, 700) in BAND


@pytest.mark.parametrize("shape", list(GATE_SHAPES),
                         ids=[f"{a}x{b}" for a, b in GATE_SHAPES])
def test_every_gate_shape_plans_a_cluster_or_the_spill(shape):
    """Where the JAX package keeps the tableau on chip, the port keeps it
    in a cluster's shared memory, whole or with a spill: never the
    global-memory variant, never no kernel."""
    kind, C = gs.plan(*shape)
    assert (kind == "spill") == (shape in BAND)
    assert kind in ("cluster", "spill") and C >= 1
    assert gs.shape_supported(*GATE_SHAPES[shape])


@pytest.mark.parametrize("shape", BAND, ids=[f"{a}x{b}" for a, b in BAND])
def test_spill_rows_fit_in_fours(shape):
    """On every band shape the spill variant keeps R rows, a multiple of
    4 (0 allowed), beside its ring and vectors within a block's limit;
    four rows more would not fit."""
    Mp, NT = shape
    R = gs.spill_rows(Mp, NT)
    assert R is not None and R % 4 == 0 and 0 <= R < Mp
    assert gs.smem_bytes(Mp, NT, gs.SPILL_C, R) <= gs.SMEM_LIMIT
    assert gs.smem_bytes(Mp, NT, gs.SPILL_C, R + 4) > gs.SMEM_LIMIT
    assert gs.smem_bytes(Mp, NT, gs.SPILL_C, 0) <= gs.SMEM_LIMIT
    # the ring is there only where rows are spilled
    assert (gs.smem_bytes(Mp, NT, gs.SPILL_C, R)
            - gs.smem_bytes(Mp, NT, gs.SPILL_C, Mp)
            == gs.SPILL_STAGES * gs.THREADS * 16 - (Mp - R) * (NT // 16 + 4)
            * 4)


def test_spill_and_global_where_the_shape_says():
    """Above the band the spill variant takes config #4's f32 P2 LP;
    shapes not in fours keep the global variant; a 16-CTA cluster that
    holds the tableau keeps all its rows."""
    assert gs.plan(*gs.padded_shape(1011, 2006)) == ("spill", 16)
    assert gs.spill_rows(6, 128) is None and gs.spill_rows(8, 130) is None
    assert gs.spill_rows(512, 1024) == 512
    assert gs.plan(512, 1024) == ("cluster", 16)


def test_forced_spill_runs_plain_version_on_cpu_and_counts_no_launch():
    args = make(16, 16, 8, seed=6)
    ref = gs.lp_batch_group(*args, device="cpu")
    captured = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        captured["a"] = a
        return real(*a, **kw)

    gs.solve_batch_group = capture
    try:
        gs.lp_batch_group(*args, device="cpu")
    finally:
        gs.solve_batch_group = real
    calls = (gs.CALLS, gs.CALLS_CLUSTER, gs.CALLS_SPILL, gs.CALLS_GLOBAL)
    out = gs.solve_batch_group(*captured["a"], variant="spill", smem_rows=8)
    plain = gs.solve_batch_group_reference(*captured["a"], group=1)
    for a, b in zip(out, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (gs.CALLS, gs.CALLS_CLUSTER, gs.CALLS_SPILL,
            gs.CALLS_GLOBAL) == calls
    np.testing.assert_array_equal(out[0].numpy()[:8], ref.status)
    with pytest.raises(ValueError, match="smem_rows"):
        gs.solve_batch_group(*captured["a"], variant="global", smem_rows=8)
