"""The port on the card: the CUDA kernel's three variants build, launch
on the main path (primal and dual algorithm) and agree with their plain
PyTorch version at one shape per variant and cluster size; the spill
variant with half the rows forced out of shared memory pivots exactly as
the cluster variant; the revised
simplex and the interior-point method give on the card what they give on
the CPU, with TF32 off; lp_ipm_min takes a float32 solve past the
kernel's route to the interior-point method; a per-instance-matrix LP
batch and a 64-instance solve_many give on the card what they give on
the CPU; a "dp" mesh of streams on the card (and over the cards, where
there are several) gives the one-device result; the bench's device
stage launches the kernel; the driver entry (graft_entry) gives on the
card what it gives on the CPU, and its dry run over ("dp", "tp") gives
the unsharded result; the pivot loops replayed as CUDA graphs
(lp/segments.py) pivot bit for bit as the eager loop, primal, dual,
3-D and revised (``-k revised_graphs``), and the interior-point
iterations replayed as CUDA graphs step bit for bit as the eager loop
(``-k ipm_graphs``); the pivot step's two kernels (lp/tableau_step.py)
step as the plain torch step from the same state, whole loops through
them give the CPU's statuses and objectives on batches recorded from
example10 and example11 solves, and segments.KERNEL_STEPS counts every
tableau and dual step (``-k kernel``).

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where JAX is not installed (the
repo's conftest imports it, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from bensolve_tpu_torch import Options, examples, solve
from bensolve_tpu_torch.lp import group_simplex as gs
from bensolve_tpu_torch.lp import ipm
from bensolve_tpu_torch.lp import revised as rv
from bensolve_tpu_torch.lp.simplex import OPTIMAL
from bensolve_tpu_torch.vlp.options import Alg

F32 = dict(lp_dtype="float32", eps_benson_phase1=1e-4, eps_benson_phase2=1e-4)


def make(M, N, B, seed):
    """The random-batch recipe of tests/test_pallas_simplex.py::make."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((M, N)) / np.sqrt(N)).astype(np.float32)
    x0 = rng.random((B, N)).astype(np.float32)
    b = (x0 @ A.T + 0.5 + rng.random((B, M))).astype(np.float32)
    c = rng.standard_normal((B, N)).astype(np.float32)
    rlb = np.full((B, M), -np.inf, np.float32)
    clb = np.zeros((B, N), np.float32)
    cub = np.full((B, N), 10.0, np.float32)
    return A, c, rlb, b, clb, cub


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (M, N, B, variant, C, forced): one shape per kernel variant and cluster
# size, the planned one unless forced; (350, 347) is example10's P2 shape,
# (705, 259) phase 4's large P2 LP (padded 768 x 1152), (700, 700) pads to
# 768 x 1536; the global variant, which no band shape plans any more,
# forced at the latter
VARIANT_SHAPES = [(16, 16, 8, "cluster", 1, False),
                  (160, 160, 16, "cluster", 2, False),
                  (200, 200, 16, "cluster", 4, False),
                  (350, 347, 16, "cluster", 8, False),
                  (500, 500, 8, "cluster", 16, False),
                  (700, 700, 4, "spill", 16, False),
                  (705, 259, 8, "spill", 16, False),
                  (700, 700, 4, "global", 0, True)]


def _counts():
    return (gs.CALLS_CLUSTER, gs.CALLS_SPILL, gs.CALLS_GLOBAL, gs.CALLS)


def _kernel_and_plain(args, start, dev, monkeypatch, variant=None):
    """The kernel's LPResult (the planned variant, or the forced one) and
    the plain version's, the latter run on the same device inputs and
    recovered exactly as the wrapper does; plus the launches of each
    variant (cluster, spill, global, all) during the kernel's solve."""
    captured = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        captured["a"] = a
        return real(*a, variant=variant, **kw)

    monkeypatch.setattr(gs, "solve_batch_group", capture)
    before = _counts()
    ker = gs.lp_batch_group(*args, device=dev, start_basis=start)
    torch.cuda.synchronize()
    launched = tuple(x - y for x, y in zip(_counts(), before))
    out = gs.solve_batch_group_reference(*captured["a"], group=1)
    monkeypatch.setattr(gs, "solve_batch_group", lambda *a, **kw: out)
    plain = gs.lp_batch_group(*args, device=dev, start_basis=start)
    monkeypatch.setattr(gs, "solve_batch_group", real)
    return ker, plain, launched


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize(
    "shape", VARIANT_SHAPES,
    ids=[f"{v}{c}-M{m}-N{n}" for m, n, _, v, c, _ in VARIANT_SHAPES])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, warm,
                                              monkeypatch):
    """Each variant against the plain version on its shape, cold and from
    one shared warm basis: equal status per LP; obj within 1e-4 (float32,
    the kernel and the plain version sum in other orders); at M=N=16
    (sequential sums) the same basis and iterations on every LP.  The
    launch lands on the planned (or forced) variant and only there."""
    M, N, B, kind, C, forced = shape
    if not forced:
        assert gs.plan(*gs.padded_shape(M, N)) == (kind, C)
    args = make(M, N, B, seed=0)
    start = None
    if warm:
        cold = gs.lp_batch_group(*args, device=cuda_device)
        i0 = int(np.flatnonzero(cold.status == OPTIMAL)[0])
        start = (cold.basis[i0], cold.at_upper[i0])
    ker, plain, launched = _kernel_and_plain(
        args, start, cuda_device, monkeypatch, kind if forced else None)
    assert launched == {"cluster": (1, 0, 0, 1), "spill": (0, 1, 0, 1),
                        "global": (0, 0, 1, 1)}[kind]
    np.testing.assert_array_equal(ker.status, plain.status)
    ok = plain.status == OPTIMAL
    assert ok.any()
    np.testing.assert_allclose(ker.obj[ok], plain.obj[ok], rtol=1e-4,
                               atol=1e-4)
    if M <= 32:
        np.testing.assert_array_equal(ker.basis, plain.basis)
        np.testing.assert_array_equal(ker.iters, plain.iters)


@pytest.mark.cuda
def test_work_counts_on_card(cuda_device, monkeypatch):
    """The cluster kernel's (loop steps, pricing passes, rank-1 updates)
    per LP: pivots <= iters <= steps, and a pass at least every 128
    steps."""
    captured = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        captured["a"] = a
        return real(*a, **kw)

    monkeypatch.setattr(gs, "solve_batch_group", capture)
    gs.lp_batch_group(*make(200, 200, 8, seed=2), device=cuda_device)
    monkeypatch.setattr(gs, "solve_batch_group", real)
    a = captured["a"]
    work = torch.zeros(a[1].shape[0], 3, dtype=torch.int32,
                       device=cuda_device)
    _, _, _, iters = gs.solve_batch_group(*a, work=work)
    steps, passes, pivots = work.cpu().numpy().T
    iters = iters.cpu().numpy()
    assert (pivots <= iters).all() and (iters <= steps).all()
    assert (pivots > 0).all()
    assert (passes >= -(-steps // 128)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
def test_spill_with_half_the_rows_pivots_as_the_cluster(cuda_device, warm,
                                                        monkeypatch):
    """At M = N = 500 (Mp 512, NT 1024: a 16-CTA cluster holds it) the
    spill variant with 256 rows in shared memory and 256 in its workspace,
    and with all 512 in shared memory, gives the cluster variant's status,
    basis, at_upper, iterations and work counts exactly on every LP, cold
    and from one shared warm basis: the spill changes where rows live,
    never a sum's order."""
    args = make(500, 500, 8, seed=3)
    start = None
    if warm:
        cold = gs.lp_batch_group(*args, device=cuda_device)
        i0 = int(np.flatnonzero(cold.status == OPTIMAL)[0])
        start = (cold.basis[i0], cold.at_upper[i0])
    captured = {}
    real = gs.solve_batch_group

    def capture(*a, **kw):
        captured["a"] = a
        return real(*a, **kw)

    monkeypatch.setattr(gs, "solve_batch_group", capture)
    gs.lp_batch_group(*args, device=cuda_device, start_basis=start)
    monkeypatch.setattr(gs, "solve_batch_group", real)
    a = captured["a"]
    Mp = a[0].shape[0]
    assert (Mp, a[0].shape[1]) == (512, 1024)
    assert gs.plan(*a[0].shape) == ("cluster", 16)

    def run(**kw):
        work = torch.zeros(a[1].shape[0], 3, dtype=torch.int32,
                           device=cuda_device)
        out = gs.solve_batch_group(*a, work=work, **kw)
        return [t.cpu() for t in out] + [work.cpu()]

    ref = run()
    before = _counts()
    for rows in (Mp // 2, Mp):
        got = run(variant="spill", smem_rows=rows)
        for name, x, y in zip(("status", "basis", "at_upper", "iters",
                               "work"), got, ref):
            assert torch.equal(x, y), f"{name} differs at {rows} rows"
    assert tuple(x - y for x, y in zip(_counts(), before)) == (0, 2, 0, 2)
    assert (ref[0] == OPTIMAL).any() and (ref[3] > 0).any()


@pytest.mark.cuda
def test_wrapper_refuses_groups_on_card(cuda_device):
    with pytest.raises(ValueError, match="group=1"):
        gs.lp_batch_group(*make(16, 16, 8, seed=1), group=8,
                          device=cuda_device)


@pytest.mark.cuda
def test_f32_solve_goes_through_the_kernel(cuda_device):
    calls = gs.CALLS
    res = solve(examples.example05(),
                Options(lp_dtype="float32", eps_benson_phase1=1e-4,
                        eps_benson_phase2=1e-4, write_files=False,
                        device="cuda"))
    assert res.status.name == "OPTIMAL"
    assert gs.CALLS > calls


@pytest.mark.cuda
def test_dual_f32_solve_goes_through_the_kernel(cuda_device):
    calls = gs.CALLS
    res = solve(examples.example05(),
                Options(write_files=False, device="cuda", alg_phase1=Alg.DUAL,
                        alg_phase2=Alg.DUAL, **F32))
    assert res.status.name == "OPTIMAL"
    assert gs.CALLS > calls


def tall(seed, M, N, B):
    """The random-instance recipe of tests/test_revised.py."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    c = rng.standard_normal((B, N))
    row_ub = x0 @ A.T + 0.3 + rng.random((B, M))
    return (A, c, np.full((B, M), -np.inf), row_ub, np.zeros((B, N)),
            np.full((B, N), 5.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((0, 6, 30, 8), np.float64, 1e-9),
                                  ((11, 48, 320, 4), np.float32, 1e-3)])
def test_revised_on_card_matches_cpu(cuda_device, case):
    shape, dtype, tol = case
    args = tall(*shape)
    calls = rv.CALLS
    card = rv.solve_batch_revised(*args, dtype=dtype, device=cuda_device)
    assert rv.CALLS == calls + 1
    cpu = rv.solve_batch_revised(*args, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    np.testing.assert_allclose(card.obj, cpu.obj, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_revised_f32_runs_without_tf32(cuda_device, monkeypatch):
    """Every pivot of a float32 revised solve sees allow_tf32 False, even
    when the caller left it on; the caller's setting comes back after.
    On the card the pivots are replayed CUDA graphs (lp/segments.py):
    the cache is emptied first, so every graph this solve replays is
    captured in it, its steps seen by the spy, and each is keyed with
    TF32 off."""
    from bensolve_tpu_torch.lp import segments

    segments.clear()
    seen = []
    real = rv._rstep

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(rv, "_rstep", spy)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rv.solve_batch_revised(*tall(11, 48, 320, 4), dtype=np.float32,
                               device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and not any(seen)
    keys = [k for gs in segments._SETS.values() if gs.loop == "revised"
            for k in gs.graphs]
    assert keys and not any(tf32 for _, tf32 in keys)


def ipm_batch(M, N, B, seed):
    """The random-LP recipe of tests/test_ipm.py::random_lp."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = x0 @ A.T + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    return (A, c, np.full((B, M), -np.inf), b, np.zeros((B, N)),
            np.full((B, N), 10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((24, 40, 4, 0), np.float64, 1e-9),
                                  ((32, 64, 4, 11), np.float32, 1e-3)])
def test_ipm_on_card_matches_cpu(cuda_device, case):
    shape, dtype, tol = case
    args = tuple(np.asarray(a, dtype) for a in ipm_batch(*shape))
    card = ipm.solve_batch_ipm(*args, dtype=dtype, device=cuda_device)
    cpu = ipm.solve_batch_ipm(*args, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    assert (cpu.status == OPTIMAL).all()
    np.testing.assert_allclose(card.obj, cpu.obj, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ipm_f32_runs_without_tf32(cuda_device, monkeypatch):
    """Every iteration of a float32 IPM solve sees allow_tf32 False, even
    when the caller left it on, and the result is the CPU's; the
    caller's setting comes back after.  On the card the iterations are
    replayed CUDA graphs of _Core.step (lp/segments.py): the cache is
    emptied first, so every graph this solve replays is captured in it,
    its steps seen by the spy, and each is keyed with TF32 off."""
    from bensolve_tpu_torch.lp import segments

    segments.clear()
    seen = []
    real = ipm._Core.step

    def spy(self, *a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(self, *a, **kw)

    monkeypatch.setattr(ipm._Core, "step", spy)
    args = tuple(np.asarray(a, np.float32) for a in ipm_batch(32, 64, 4, 11))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = ipm.solve_batch_ipm(*args, dtype=np.float32,
                                   device=cuda_device)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert seen and not any(seen)
    keys = [k for gs in segments._SETS.values() if gs.loop == "ipm"
            for k in gs.graphs]
    assert keys and not any(tf32 for _, tf32 in keys)
    cpu = ipm.solve_batch_ipm(*args, dtype=np.float32, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    np.testing.assert_allclose(card.obj, cpu.obj, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_ipm_min_routes_f32_solve_past_the_kernel(cuda_device):
    routed, calls = gs.ROUTED, ipm.CALLS
    res = solve(examples.example05(),
                Options(write_files=False, device="cuda", lp_ipm_min=1,
                        **F32))
    assert res.status.name == "OPTIMAL"
    assert ipm.CALLS > calls
    assert gs.ROUTED == routed


def batch_3d(seed, B=40, M=17, N=12):
    """B bounded LPs, each with its own matrix, at config #5's P2 shape."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N)) / np.sqrt(N)
    x0 = rng.random((B, N))
    b = np.einsum("bmn,bn->bm", A, x0) + 0.5 + rng.random((B, M))
    c = rng.standard_normal((B, N))
    return (A, c, np.full((B, M), -np.inf), b, np.zeros((B, N)),
            np.full((B, N), 10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9),
                                       (np.float32, 1e-3)])
def test_3d_batch_matches_cpu(dtype, tol, cuda_device):
    """Per LP: equal status on the card and the CPU, at float64 equal
    pivots and basis too, values within tol; chunking changes nothing."""
    from bensolve_tpu_torch.lp import simplex as sx

    args = batch_3d(0)
    card = sx.solve_batch(*args, dtype=dtype, device=cuda_device)
    cpu = sx.solve_batch(*args, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(card.status, cpu.status)
    assert (cpu.status == OPTIMAL).all()
    if dtype is np.float64:
        np.testing.assert_array_equal(card.iters, cpu.iters)
        np.testing.assert_array_equal(card.basis, cpu.basis)
    for field in ("obj", "x", "row_dual"):
        np.testing.assert_allclose(getattr(card, field), getattr(cpu, field),
                                   rtol=tol, atol=tol, err_msg=field)
    chunked = sx.solve_batch(*args, dtype=dtype, device=cuda_device,
                             max_chunk=16)
    np.testing.assert_array_equal(chunked.status, card.status)
    np.testing.assert_array_equal(chunked.iters, card.iters)
    np.testing.assert_array_equal(chunked.basis, card.basis)


@pytest.mark.cuda
def test_solve_many_matches_cpu(cuda_device):
    """64 instances of config #5's shape: equal status, LP and round
    counts and vertex sets within 1e-7 on the card and on the CPU."""
    from bensolve_tpu_torch.algs.many import solve_many

    vlps = [examples.random_vlp(q=3, m=10, n=8, seed=s) for s in range(64)]
    card = solve_many(vlps, Options(bounded=True, write_files=False,
                                    device="cuda"))
    cpu = solve_many(vlps, Options(bounded=True, write_files=False,
                                   device="cpu"))
    for a, b in zip(card, cpu):
        assert a.status.name == b.status.name == "OPTIMAL"
        assert (a.stats.lps, a.stats.rounds) == (b.stats.lps, b.stats.rounds)
        pa = np.array(sorted(map(tuple, a.primal_points)))
        pb = np.array(sorted(map(tuple, b.primal_points)))
        assert pa.shape == pb.shape
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-7)


@pytest.mark.cuda
def test_dp_mesh_on_card_matches_one_device(cuda_device):
    """A "dp" mesh of four entries cuda:0 (four streams on one card), and
    where there are several cards a mesh over them: per LP the same
    status, pivots and basis as the one-device solve, at float64."""
    from bensolve_tpu_torch.lp import simplex as sx
    from bensolve_tpu_torch.parallel.mesh import make_mesh

    args = tuple(a.astype(np.float64) for a in make(16, 16, 64, 0))
    one = sx.solve_batch(*args, device=cuda_device)
    assert (one.status == OPTIMAL).sum() > 32
    meshes = [make_mesh(4, device="cuda")]
    assert [str(d) for d in meshes[0].devices.flat] == (
        ["cuda:0"] * 4 if torch.cuda.device_count() == 1
        else [f"cuda:{i % torch.cuda.device_count()}" for i in range(4)])
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh(device="cuda"))
    for mesh in meshes:
        got = sx.solve_batch(*args, device=cuda_device, mesh=mesh)
        np.testing.assert_array_equal(got.status, one.status)
        np.testing.assert_array_equal(got.iters, one.iters)
        np.testing.assert_array_equal(got.basis, one.basis)
        np.testing.assert_allclose(got.obj, one.obj, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_solve_many_mesh_on_card_matches_unsharded(cuda_device):
    """64 instances of config #5's shape over a four-entry mesh: every
    status OPTIMAL, the unsharded run's LP and round counts per instance
    (the 3-D pivot is per LP), and every upper image (its support
    function at 256 weights inside the dual cone) within 1e-7 of the
    unsharded run's."""
    from bensolve_tpu_torch.algs.many import solve_many
    from bensolve_tpu_torch.parallel.mesh import make_mesh

    vlps = [examples.random_vlp(q=3, m=10, n=8, seed=s) for s in range(64)]
    opt = Options(bounded=True, write_files=False, device="cuda")
    plain = solve_many(vlps, opt)
    got = solve_many(vlps, opt, mesh=make_mesh(4, device="cuda"))
    rng = np.random.default_rng(0)
    for a, b in zip(plain, got):
        assert a.status.name == b.status.name == "OPTIMAL"
        assert (a.stats.lps, a.stats.rounds) == (b.stats.lps, b.stats.rounds)
        W = a.sol.Z @ (rng.random((a.sol.p, 256)) + 1e-3)
        W /= np.abs(W).sum(axis=0)
        ha, hb = (a.primal_points @ W).min(0), (b.primal_points @ W).min(0)
        assert (np.abs(ha - hb) / (1 + np.abs(ha))).max() <= 1e-7


@pytest.mark.cuda
def test_bench_device_stage_launches_the_kernel(cuda_device):
    """The bench's device stage at its LP shape (96 x 96, one launch of
    256 LPs) takes the cluster kernel (C = 1), every LP OPTIMAL cold and
    warm (the stage's gates), the first 8 objectives within 1e-3 of
    HiGHS."""
    from bensolve_tpu_torch import bench

    assert gs.plan(*gs.padded_shape(96, 96)) == ("cluster", 1)
    out = bench.run_device("cuda", 96, 96, 256, reps=1)
    assert out["launches"] == {"cluster": 2, "spill": 0, "global": 0}
    bench.run_serial(out["inputs"], 8, out["obj"])


@pytest.mark.cuda
def test_graft_entry_on_card_matches_cpu(cuda_device):
    """bensolve_tpu_torch.graft_entry on cuda:0: entry() gives the CPU's
    status, iterations and basis, and dryrun_multichip(4) over ("dp",
    "tp") = 2 x 2 entries of the card gives, in every step, what the
    port's unsharded solve of the same batch gives on the card."""
    from bensolve_tpu_torch import graft_entry as ge

    fn, args = ge.entry("cuda")
    assert all(a.device.type == "cuda" for a in args)
    got = [o.cpu().numpy() for o in fn(*args)]
    cfn, cargs = ge.entry("cpu")
    ref = [o.numpy() for o in cfn(*cargs)]
    for i in (0, 6, 7):
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-5)
    before = _counts()
    rec = ge.dryrun_multichip(4, "cuda")
    assert rec["shape"] == {"dp": 2, "tp": 2}
    batches = ge.step_inputs(rec["dp"])
    for step in rec["steps"]:
        one = ge.solve_unsharded(*batches[step["step"]], device="cuda")
        for k, i in (("status", 0), ("iters", 6), ("basis", 7)):
            np.testing.assert_array_equal(step[k], one[i], err_msg=k)
    assert _counts() == before


def _loop_states(run, monkeypatch):
    """run()'s result and the final states of its pivot loops
    (simplex._run_segmented)."""
    from bensolve_tpu_torch.lp import simplex as sx

    states, real = [], sx._run_segmented

    def kept(*a):
        st = real(*a)
        states.append(st)
        return st

    with monkeypatch.context() as m:
        m.setattr(sx, "_run_segmented", kept)
        out = run()
    return out, states


def _bits(t):
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["primal", "dual", "3-D"])
def test_graphs_equal_the_eager_loop_bit_for_bit(cuda_device, path,
                                                 monkeypatch):
    """The pivot loop by replayed CUDA graphs (lp/segments.py) against the
    eager loop on the same inputs at float64: every field of every
    loop's final state (the carried reduced costs too) bit for bit, and
    the results equal; the graph run replays graphs and runs no eager
    step; both runs' steps are the kernel step of lp/tableau_step.py."""
    from bensolve_tpu_torch.lp import dual_simplex as dx
    from bensolve_tpu_torch.lp import segments
    from bensolve_tpu_torch.lp import simplex as sx

    f64 = dict(dtype=np.float64, device=cuda_device)
    if path == "3-D":
        args = batch_3d(1)
        run = lambda: sx.solve_batch(*args, **f64)  # noqa: E731
    else:
        A, c, rlb, rub, clb, cub = make(60, 80, 16, 2)
        run = lambda: sx.solve_batch(A, c, rlb, rub, clb, cub,  # noqa: E731
                                     **f64)
        if path == "dual":
            cold = run()
            assert (cold.status == OPTIMAL).all()
            _, kept = dx.solve_batch_dual(
                A, c, rlb, rub * 0.99, clb, cub, keep_state=True,
                start_basis=(cold.basis, cold.at_upper), **f64)
            assert kept is not None
            idx = np.arange(16)[::-1].copy()
            run = lambda: dx.solve_batch_dual(  # noqa: E731
                A, c[idx], rlb[idx], rub[idx] * 0.97, clb[idx], cub[idx],
                start_state=(kept, idx), **f64)
    segments.reset_counts()
    with segments.eager_loop():
        ref, eager = _loop_states(run, monkeypatch)
    assert segments.REPLAYS == 0 and segments.EAGER_STEPS > 0
    assert segments.KERNEL_STEPS == segments.EAGER_STEPS
    steps = segments.EAGER_STEPS
    segments.reset_counts()
    got, graph = _loop_states(run, monkeypatch)
    assert segments.REPLAYS > 0 and segments.EAGER_STEPS == 0
    assert segments.GRAPH_STEPS == steps == segments.KERNEL_STEPS
    assert len(eager) == len(graph) > 0
    for a, b in zip(eager, graph):
        for f in segments.FIELDS + ("d",):
            x, y = getattr(a, f), getattr(b, f)
            assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), f
    for f in ("status", "iters", "basis", "at_upper", "obj", "x"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((1, 10, 50, 8), np.float64),
                                  ((11, 48, 320, 4), np.float32)])
def test_revised_graphs_equal_the_eager_loop_bit_for_bit(cuda_device, case,
                                                         monkeypatch):
    """The revised pivot loop by replayed CUDA graphs of _rstep
    (revised._run through lp/segments.py) against the eager loop on the
    same inputs, on the tall recipe: every field of every loop's final
    state bit for bit, the returned step counts and the results equal;
    the graph run replays graphs of the revised loop and runs no eager
    step."""
    from bensolve_tpu_torch.lp import segments

    shape, dtype = case
    args = tall(*shape)
    runs = {}
    for mode in ("eager", "graph"):
        loops, real = [], rv._run

        def kept(*a):
            out = real(*a)
            loops.append(out)
            return out

        segments.reset_counts()
        with monkeypatch.context() as m:
            m.setattr(rv, "_run", kept)
            if mode == "eager":
                with segments.eager_loop():
                    res = rv.solve_batch_revised(*args, dtype=dtype,
                                                 device=cuda_device)
            else:
                res = rv.solve_batch_revised(*args, dtype=dtype,
                                             device=cuda_device)
        runs[mode] = (res, loops, segments.counts()["by_loop"]["revised"])
    (ref, eager, ce), (got, graph, cg) = runs["eager"], runs["graph"]
    assert ce["replays"] == 0 and ce["eager_steps"] > 0
    assert cg["replays"] > 0 and cg["eager_steps"] == 0
    assert cg["graph_steps"] == ce["eager_steps"]
    assert len(eager) == len(graph) > 0
    for (a, sa), (b, sb) in zip(eager, graph):
        assert sa == sb
        for f in rv.RSTATE_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), f
    for f in ("status", "iters", "basis", "at_upper", "obj", "x"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)


def _ipm_runs(run, monkeypatch):
    """run() eagerly (segments.eager_loop) and by replayed graphs: per
    mode (result, the carries ipm._ipm_core returned, the "ipm" loop's
    counters)."""
    from bensolve_tpu_torch.lp import segments

    runs = {}
    for mode in ("eager", "graph"):
        carries, real = [], ipm._ipm_core

        def kept(*a):
            out = real(*a)
            carries.append(out)
            return out

        segments.reset_counts()
        with monkeypatch.context() as m:
            m.setattr(ipm, "_ipm_core", kept)
            if mode == "eager":
                with segments.eager_loop():
                    res = run()
            else:
                res = run()
        runs[mode] = (res, carries, segments.counts()["by_loop"]["ipm"])
    (ref, eager, ce), (got, graph, cg) = runs["eager"], runs["graph"]
    assert ce["replays"] == 0 and ce["eager_steps"] > 0
    assert cg["replays"] > 0 and cg["eager_steps"] == 0
    assert cg["graph_steps"] == ce["eager_steps"]
    assert len(eager) == len(graph) > 0
    for (a, ra), (b, rb) in zip(eager, graph):
        assert ra == rb and len(a) == len(b) == 16
        for k, (x, y) in enumerate(zip(a, b)):
            assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), k
    for f in ("status", "iters", "quality", "obj", "x", "s", "row_dual",
              "col_dual"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ipm_graphs_equal_the_eager_loop_on_config4(cuda_device, dtype,
                                                    monkeypatch):
    """ipm._ipm_core by replayed CUDA graphs of _Core.step (lp/segments.py,
    loop "ipm") against the eager loop on BASELINE config #4's P2 LPs
    (LP 1011x2006) at B = 8, cut at 10 iterations: every entry of the
    carry bit for bit, the results equal."""
    from bensolve_tpu_torch.bench import make_p2_instances

    monkeypatch.setenv("BENSOLVE_HOST_FALLBACK_MAX", "0")
    t2, extra_ub = make_p2_instances(8, dtype=dtype, device=cuda_device)
    args = (t2.A_lp,) + tuple(t2.build_inputs(extra_ub))
    _ipm_runs(lambda: ipm.solve_batch_ipm(*args, max_iter=10, polish=False,
                                          dtype=dtype, device=cuda_device),
              monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [((24, 40, 4, 0), np.float64),
                                  ((32, 64, 4, 11), np.float32)])
def test_ipm_graphs_full_solve_equals_eager(cuda_device, case, monkeypatch):
    """A whole solve_batch_ipm on tests/test_ipm.py's random batch, by
    graphs and eagerly on the card: equal LPResults, every segment's
    carry bit for bit, every LP OPTIMAL."""
    shape, dtype = case
    args = tuple(np.asarray(a, dtype) for a in ipm_batch(*shape))
    ref = _ipm_runs(lambda: ipm.solve_batch_ipm(*args, dtype=dtype,
                                                device=cuda_device),
                    monkeypatch)
    assert (ref.status == OPTIMAL).all()


# ------------------------------------- the pivot step's kernels by hand

def _step_batch(Mp, NT, B, dtype, seed, dev="cuda"):
    """B LPs of Mp rows and NT - Mp columns, as a tableau loop's start
    state on the card, in the kinds a step must take, cycled by slot:
    0 phase 2, 1 violated row bounds (the composite phase-1 costs), 2
    column ranges of ~1e-3 from the slack basis (bound flips), 3 a Bland
    stall, 4 every bound infinite from the slack basis (unbounded), 5
    fixed columns and violated rows from the slack basis (infeasible), 6
    finished
    (OPTIMAL), 7 free and upper-bounded columns; the last B/8 slots are
    padding, copies of slot 0 as simplex._pad_batch_inputs makes them.
    Other slots start from a warm basis with a quarter of its slots
    (at most half the columns) structural; devex weights in [1, 2).
    Returns (c, lb, ub, state) on ``dev``."""
    from bensolve_tpu_torch.lp import simplex as sx

    rng = np.random.default_rng(seed)
    N = NT - Mp
    A = rng.standard_normal((Mp, N)) / np.sqrt(N)
    inf = np.inf
    c = np.zeros((B, NT))
    c[:, Mp:] = rng.standard_normal((B, N))
    lb = np.zeros((B, NT))
    ub = np.zeros((B, NT))
    lb[:, :Mp], ub[:, :Mp] = -inf, 1 + rng.random((B, Mp))
    ub[:, Mp:] = 10.0
    basis = np.tile(np.arange(Mp), (B, 1))
    kind = np.arange(B) % 8
    for b in range(B):
        k = kind[b]
        if k == 1:
            lb[b, :Mp], ub[b, :Mp] = 0.5 + rng.random(Mp), inf
        elif k == 2:
            ub[b, Mp:] = 1e-3 * rng.random(N)
        elif k == 4:
            lb[b], ub[b] = -inf, inf
        elif k == 5:
            ub[b, Mp:] = 0.0
            lb[b, :Mp], ub[b, :Mp] = 1.0, 2.0
        elif k == 7:
            lb[b, Mp:Mp + N // 2] = -inf
            ub[b, Mp:Mp + N // 4] = inf
        if k not in (2, 4, 5):
            n_s = min(Mp // 4, N // 2)
            slots = rng.choice(Mp, n_s, replace=False)
            basis[b, slots] = Mp + rng.choice(N, n_s, replace=False)
    pad = B // 8
    for x in (c, lb, ub, basis):
        x[B - pad:] = x[0]
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa
    c_t, lb_t, ub_t = t(c), t(lb), t(ub)
    st = sx._initial_state(t(A), c_t, lb_t, ub_t,
                           torch.as_tensor(basis, device=dev))
    stall = torch.as_tensor(np.where(kind == 3, sx.BLAND_AFTER + 1, 0),
                            dtype=torch.int32, device=dev)
    status = torch.where(torch.as_tensor(kind == 6, device=dev),
                         sx.OPTIMAL, st.status).to(torch.int32)
    gamma = t(1 + rng.random((B, NT)))
    stall[B - pad:], status[B - pad:], gamma[B - pad:] = (
        stall[0], status[0], gamma[0])
    st = dataclasses.replace(st, stall=stall, status=status, gamma=gamma)
    st = dataclasses.replace(st, **{f: getattr(st, f).contiguous()
                                    for f in ("W", "xb", "lbB", "ubB",
                                              "cB", "basis")})
    return c_t, lb_t, ub_t, st


def _clone(st):
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(st) if getattr(st, f.name) is not None})


def _fresh_d(c, st, dual):
    """c_eff - cB_eff W from the state's own fields, and the scale of
    each entry's sum (|c| + |cB_eff| |W|)."""
    from bensolve_tpu_torch.lp import simplex as sx

    if dual:
        feas, cbe = torch.ones_like(st.status, dtype=torch.bool), st.cB
    else:
        _, _, feas, cbe = sx._phase_costs(st)
    ce = torch.where(feas[:, None], c, torch.zeros_like(c))
    d = ce - torch.bmm(cbe[:, None, :], st.W)[:, 0, :]
    scale = ce.abs() + torch.bmm(cbe.abs()[:, None, :], st.W.abs())[:, 0, :]
    return d, scale


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 256])
@pytest.mark.parametrize("shape", [(48, 64), (80, 96), (384, 768)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dual", [False, True], ids=["primal", "dual"])
def test_kernel_step_matches_the_plain_step(cuda_device, dual, dtype, shape,
                                            B):
    """One step of lp/tableau_step.py's kernels against the plain torch
    step (simplex._step_plain, dual_simplex._dstep_plain) from the same
    state (_step_batch's kinds, at ex11's (48, 64) and (80, 96) and ex10's
    (384, 768)): basis, in_basis, at_upper, status, stall, iters and the
    basic bounds and costs equal; W, the basic values and the devex
    weights equal bit for bit (none of them is a sum: the kernels compute
    each with the torch step's operations and roundings); the carried
    reduced costs d within 1e-13 (float64) or 1e-5 (float32) of the
    scale of their sum (|c| + |cB_eff| |W|) from a fresh c_eff -
    cB_eff W (cuBLAS and the kernel sum in different orders)."""
    from bensolve_tpu_torch.lp import dual_simplex as dx
    from bensolve_tpu_torch.lp import simplex as sx
    from bensolve_tpu_torch.lp import tableau_step

    c, lb, ub, st = _step_batch(*shape, B, dtype, seed=B + shape[0])
    plain = (dx._dstep_plain if dual else sx._step_plain)(
        None, c, lb, ub, _clone(st))
    got = tableau_step.step(c, lb, ub,
                            tableau_step.price(c, _clone(st), dual), dual)
    torch.cuda.synchronize()
    for f in ("basis", "in_basis", "at_upper", "status", "stall", "iters",
              "lbB", "ubB", "cB", "W", "xb", "gamma"):
        x, y = getattr(plain, f), getattr(got, f)
        assert torch.equal(_bits(x), _bits(y)), f
    d, scale = _fresh_d(c, got, dual)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert ((got.d - d).abs() <= tol * scale).all()
    stepped = got.iters > st.iters
    assert stepped.any()
    if not dual:
        assert (got.status == sx.UNBOUNDED).any()
        assert (got.status == sx.INFEASIBLE).any()
        # bound flips: a step taken with the basis unchanged
        assert (stepped & (got.basis == st.basis).all(dim=1)).any()


def _recorded_batches(vlp, monkeypatch):
    """The LP batches (A, c, row bounds, column bounds) a float64 solve
    of ``vlp`` on the card hands its LP layer, in order."""
    from bensolve_tpu_torch.algs import templates
    from bensolve_tpu_torch.lp import simplex as sx

    batches, real = [], templates._TemplateBase._run

    def record(self, A_lp, obj, row_lb, row_ub, col_lb, col_ub, *a, **kw):
        A = A_lp.A if isinstance(A_lp, sx._PreparedA) else A_lp
        batches.append(tuple(np.array(x, np.float64) for x in (
            A, np.atleast_2d(obj), row_lb, row_ub, col_lb, col_ub)))
        return real(self, A_lp, obj, row_lb, row_ub, col_lb, col_ub, *a,
                    **kw)

    with monkeypatch.context() as m:
        m.setattr(templates._TemplateBase, "_run", record)
        solve(vlp, Options(device="cuda", write_files=False))
    return batches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["example10", "example11"])
def test_kernel_loops_match_the_cpu_on_recorded_batches(cuda_device, name,
                                                        monkeypatch, capsys):
    """Whole pivot loops through the kernels on the card against the
    plain step on the CPU, on LP batches recorded from a solve (at most
    16 LPs of each of the first three batches of 8 or more, and of the
    largest): a cold primal solve, then dual re-solves from its bases
    with the row bounds of the batch's LPs rotated by one.  Statuses
    equal, objectives within 1e-9 relative.  Every LP whose iteration
    count differs is printed beside the plain step's count on the card
    (eager loop): the three sum the reduced costs in three orders (the
    kernel, cuBLAS, the CPU's BLAS), which can break a near-tie of the
    pricing the other way."""
    from bensolve_tpu_torch.lp import dual_simplex as dx
    from bensolve_tpu_torch.lp import segments
    from bensolve_tpu_torch.lp import simplex as sx

    batches = _recorded_batches(getattr(examples, name)(), monkeypatch)
    big = [b for b in batches if b[1].shape[0] >= 8]
    picked = big[:3] + [max(batches, key=lambda b: b[1].shape[0])]
    report = []
    for k, (A, c, rlb, rub, clb, cub) in enumerate(picked):
        c, rlb, rub, clb, cub = (x[:16] for x in (c, rlb, rub, clb, cub))
        runs = {}
        for mode, dev in (("kernel", "cuda"), ("plain", "cuda"),
                          ("cpu", "cpu")):
            segments.reset_counts()
            with monkeypatch.context() as m, contextlib.ExitStack() as es:
                if mode == "plain":
                    m.setattr(sx, "_step", sx._step_plain)
                    m.setattr(dx, "_dstep", dx._dstep_plain)
                    es.enter_context(segments.eager_loop())
                pri = sx.solve_batch(A, c, rlb, rub, clb, cub, device=dev)
                rot = np.roll(np.arange(c.shape[0]), 1)
                dua = dx.solve_batch_dual(
                    A, c, rlb[rot], rub[rot], clb, cub,
                    start_basis=(pri.basis, pri.at_upper), device=dev)
            kernel = segments.KERNEL_STEPS
            assert kernel > 0 if mode == "kernel" else kernel == 0
            runs[mode] = (pri, dua)
        for j, label in enumerate(("primal", "dual")):
            got, plain, ref = (runs[m][j] for m in ("kernel", "plain", "cpu"))
            np.testing.assert_array_equal(got.status, ref.status)
            ok = ref.status == OPTIMAL
            np.testing.assert_allclose(got.obj[ok], ref.obj[ok], rtol=1e-9,
                                       atol=1e-9)
            for i in np.flatnonzero(got.iters != ref.iters):
                report.append(f"{name} batch {k} {label} LP {i}: "
                              f"{got.iters[i]} kernel, {plain.iters[i]} "
                              f"plain on the card, {ref.iters[i]} cpu")
    with capsys.disabled():
        print(f"\n[{name}] iteration counts that differ: "
              f"{len(report)}" + "".join("\n  " + r for r in report))


@pytest.mark.cuda
@pytest.mark.parametrize("alg", [Alg.PRIMAL, Alg.DUAL])
def test_kernel_steps_count_every_tableau_step(cuda_device, alg):
    """KERNEL_STEPS of a float64 example11 solve on the card equals the
    tableau and dual loops' steps (replayed and eager), the revised and
    IPM loops count none, and the f32 kernel is not launched."""
    from bensolve_tpu_torch.lp import segments

    segments.reset_counts()
    before = _counts()
    solve(examples.example11(),
          Options(device="cuda", write_files=False, alg_phase1=alg,
                  alg_phase2=alg))
    c = segments.counts()
    by = c["by_loop"]
    loops = sum(by[k][f] for k in ("tableau", "dual")
                for f in ("graph_steps", "eager_steps"))
    assert loops > 0 and c["kernel_steps"] == loops
    for k in ("tableau", "dual"):
        assert by[k]["kernel_steps"] == (by[k]["graph_steps"]
                                         + by[k]["eager_steps"])
    assert by["revised"]["kernel_steps"] == by["ipm"]["kernel_steps"] == 0
    assert _counts() == before
