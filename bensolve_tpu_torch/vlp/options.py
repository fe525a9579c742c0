"""Solver options, mirroring the reference ``opttype`` (bslv_vlp.h:89-104)
and ``set_default_opt`` (bslv_vlp.c:876-894)."""

from __future__ import annotations

import dataclasses
import enum


class Alg(enum.Enum):
    PRIMAL = "primal"
    DUAL = "dual"


class Format(enum.Enum):
    SHORT = "short"
    LONG = "long"
    AUTO = "auto"


class LPMethod(enum.Enum):
    """LP method selection flags (-k/-L/-l).  The reference maps these onto
    GLPK's primal/dual simplex (bslv_lp.c:153-198).  Routing (see
    algs/templates.py _run): DUAL_SIMPLEX / DUAL_PRIMAL_SIMPLEX select the
    batched dual simplex (with the GLP_DUALP-style dual->primal retry,
    lp/dual_simplex.py); PRIMAL_SIMPLEX and AUTO use the aspect-ratio
    router over the tableau / revised / Pallas primal backends."""

    PRIMAL_SIMPLEX = "primal_simplex"
    DUAL_SIMPLEX = "dual_simplex"
    DUAL_PRIMAL_SIMPLEX = "dual_primal_simplex"
    AUTO = "auto"


# Tolerance catalog, bslv_main.h:33-78
DEFAULT_EPS_PHASE0 = 1e-8
DEFAULT_EPS_PHASE1 = 1e-8
DEFAULT_EPS_BENSON_PHASE1 = 1e-7
DEFAULT_EPS_BENSON_PHASE2 = 1e-7
EPS_C = 1e-7
EPS_POLY = 1e-9
EPS_OUTPUT_CHOP = 1e-10
PRIMAL_PLOT_CUT_SHIFT = 0.5
DUAL_PLOT_CUT_SHIFT = 0.2
FORMAT_SHORT_STR = "%10.4g "
FORMAT_LONG_STR = "%.14g "


@dataclasses.dataclass
class Options:
    bounded: bool = False          # -b: skip phases 0 and 1
    plot: bool = False             # -p: OFF graphics output (q==3 only)
    filename: str = ""             # output base name (-o)
    solution: bool = False         # -s: write pre-images
    format: Format = Format.AUTO   # -f
    message_level: int = 1         # -m 0..3
    lp_message_level: int = 1      # -M 0..3
    alg_phase1: Alg = Alg.PRIMAL   # -A
    alg_phase2: Alg = Alg.PRIMAL   # -a
    lp_method_phase0: LPMethod = LPMethod.PRIMAL_SIMPLEX  # -k
    lp_method_phase1: LPMethod = LPMethod.AUTO            # -L
    lp_method_phase2: LPMethod = LPMethod.AUTO            # -l
    eps_phase0: float = DEFAULT_EPS_PHASE0
    eps_phase1: float = DEFAULT_EPS_PHASE1
    eps_benson_phase1: float = DEFAULT_EPS_BENSON_PHASE1  # -E
    eps_benson_phase2: float = DEFAULT_EPS_BENSON_PHASE2  # -e
    # TPU-build specific knobs (no reference counterpart):
    lp_dtype: str = "float64"      # LP arithmetic: float64 (GLPK-grade
    #   tolerances) or float32 (native TPU arithmetic; use with loose
    #   epsilons, e.g. the reference's own -e 0.05 / 1e-2 advice for
    #   the large ex07/ex09 instances, ex/example07.m:9)
    write_files: bool = True       # emit the .sol/.log artifact family
    poly_test: bool = False        # run polytope integrity checks (POLY_TEST)
    lp_max_batch: int = 4096       # cap on LPs solved per device round
    lp_ipm_min: int = 0            # M+N threshold above which Benson LP
    #   batches route to the Mehrotra interior-point backend (lp/ipm.py)
    #   instead of the simplex family.  0 disables (simplex everywhere).
    #   The huge reference examples (ex09: m=4608, n=36939) are
    #   pivot-count-bound on every simplex variant; the recorded route
    #   uses lp_ipm_min=2000 with lp_dtype="float32" and the reference's
    #   own -e 1e-2 (ex/example09.m:10,21).  Equivalent env override:
    #   BENSOLVE_IPM_MIN.
    warm_mode: str = "auto"        # LP warm starts across Benson rounds:
    #   "per_candidate" seeds every frontier LP from the basis of the LP
    #   whose cut created it, "shared" carries one basis per template,
    #   "auto" picks per-candidate unless the batch routes to the Pallas
    #   kernel or runs distributed
    checkpoint_path: str = ""      # snapshot phase-2 state here per round
    checkpoint_every: int = 1      # rounds between snapshots
    profile_dir: str = ""          # write a torch.profiler Chrome trace here
    distributed: bool = False      # shard LP rounds over the processes of
    #   the torch.distributed group (parallel/distributed.py)
    mesh_axes: tuple = ()          # multi-device sharding of the LP solves
    #   (parallel/mesh.py): ("dp",) shards the frontier batch over the
    #   mesh's entries, one thread and one CUDA stream each; ("tp",)
    #   splits every LP's columns (tableau, basis inverse, A) into
    #   panels over the entries, for ex09-scale single LPs, with one
    #   exchange between panels per pivot step; ("dp", "tp") does both,
    #   one thread per dp row driving its tp panels.  Empty:
    #   single-device execution.
    mesh_devices: int | None = None  # mesh entries (default: the visible
    #   devices of ``device``'s type; more entries repeat them)
    device: str = "cuda"           # torch device every LP tensor lives on
    #   (the tests pass "cpu"); solve() raises when it is not available

    def build_mesh(self):
        """The mesh for mesh_axes over devices of ``device``'s type
        (cached; None when unset)."""
        if not self.mesh_axes:
            return None
        m = getattr(self, "_mesh_cache", None)
        if m is None:
            from bensolve_tpu_torch.parallel.mesh import make_mesh

            m = make_mesh(self.mesh_devices, tuple(self.mesh_axes),
                          self.device)
            object.__setattr__(self, "_mesh_cache", m)
        return m

    def fmt_file(self) -> str:
        """Format string for files: long unless explicitly short
        (bslv_algs.c:90)."""
        return FORMAT_SHORT_STR if self.format is Format.SHORT else FORMAT_LONG_STR

    def fmt_stdout(self) -> str:
        """Format string for stdout: short unless explicitly long
        (bslv_algs.c:81)."""
        return FORMAT_LONG_STR if self.format is Format.LONG else FORMAT_SHORT_STR
