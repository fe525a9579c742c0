"""Command-line driver: ``python -m bensolve_tpu_torch <file.vlp> [options]``.

Mirrors the reference CLI (bslv_main.c:36-409) as the JAX package's
``python -m bensolve_tpu`` does, plus ``--device`` (the torch device of
the LP solves, default cuda).
"""

from __future__ import annotations

import argparse
import os
import sys

from bensolve_tpu_torch.algs.solution import SolStatus
from bensolve_tpu_torch.vlp.options import Alg, Format, LPMethod, Options

WELCOME = "bensolve-tpu (torch): VLP solver\n"
USAGE = "Usage: bensolve [filename] [options]\n"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bensolve", add_help=False, usage=USAGE.strip())
    p.add_argument("filename", nargs="?")
    p.add_argument("--help", "-h", action="store_true", dest="help_")
    p.add_argument("--bounded", "-b", action="store_true")
    p.add_argument("--plot", "-p", action="store_true")
    p.add_argument("--test", "-t", action="store_true")
    p.add_argument("--solution", "-s", action="store_true")
    p.add_argument("--format", "-f", choices=["auto", "long", "short"],
                   default="auto")
    p.add_argument("--output_filename", "-o", default="")
    p.add_argument("--lp_method_phase0", "-k",
                   choices=["primal_simplex", "dual_simplex",
                            "dual_primal_simplex"],
                   default="primal_simplex")
    p.add_argument("--lp_method_phase1", "-L",
                   choices=["primal_simplex", "dual_simplex",
                            "dual_primal_simplex", "auto"], default="auto")
    p.add_argument("--lp_method_phase2", "-l",
                   choices=["primal_simplex", "dual_simplex",
                            "dual_primal_simplex", "auto"], default="auto")
    p.add_argument("--message_level", "-m", type=int, default=1,
                   choices=[0, 1, 2, 3])
    p.add_argument("--lp_message_level", "-M", type=int, default=1,
                   choices=[0, 1, 2, 3])
    p.add_argument("--alg_phase1", "-A", choices=["primal", "dual"],
                   default="primal")
    p.add_argument("--alg_phase2", "-a", choices=["primal", "dual"],
                   default="primal")
    p.add_argument("--eps_phase1", "-E", type=float, default=1e-7)
    p.add_argument("--eps_phase2", "-e", type=float, default=1e-7)
    # extension: LP arithmetic precision (float32 routes to the CUDA
    # kernel; pair with loose epsilons as the reference itself
    # recommends for ex07/ex09, ex/example07.m:9)
    p.add_argument("--lp_dtype", choices=["float64", "float32"],
                   default="float64")
    p.add_argument("--device", default="cuda",
                   help="torch device of the LP solves (cuda, cpu, ...)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = _build_parser()

    # reference behavior: first argument must be the filename
    # (bslv_main.c:60-68)
    if not argv or argv[0].startswith("-"):
        print(WELCOME + USAGE)
        parser.print_help()
        return 1
    args = parser.parse_args(argv)
    if args.help_ or not args.filename:
        print(WELCOME + USAGE)
        parser.print_help()
        return 1
    if args.eps_phase1 <= 0 or args.eps_phase2 <= 0:
        print("option --eps: invalid argument")
        return 1

    opt = Options(
        bounded=args.bounded,
        plot=args.plot,
        solution=args.solution,
        format=Format(args.format),
        filename=args.output_filename,
        lp_method_phase0=LPMethod(args.lp_method_phase0),
        lp_method_phase1=LPMethod(args.lp_method_phase1),
        lp_method_phase2=LPMethod(args.lp_method_phase2),
        message_level=args.message_level,
        lp_message_level=args.lp_message_level,
        alg_phase1=Alg(args.alg_phase1),
        alg_phase2=Alg(args.alg_phase2),
        eps_benson_phase1=args.eps_phase1,
        eps_benson_phase2=args.eps_phase2,
        poly_test=args.test,
        lp_dtype=args.lp_dtype,
        device=args.device,
    )
    if not opt.filename:
        opt.filename = os.path.splitext(args.filename)[0]

    if opt.message_level >= 1:
        print(WELCOME, end="")
        print("loading ... ")

    from bensolve_tpu_torch.vlp.reader import VLPFormatError, read_vlp

    try:
        vlp = read_vlp(args.filename)
    except (OSError, VLPFormatError) as e:
        print(f"error reading {args.filename}: {e}")
        return 1
    if opt.message_level >= 1:
        print(f"done: {vlp.m} rows, {vlp.n} columns, "
              f"{vlp.nz} non-zero matrix coefficients")

    if opt.plot and vlp.q != 3:
        print("OFF file generation for problem with 3 objectives only - "
              "try again without option -p")
        return 1

    if opt.message_level == 1:
        print("running ... ")

    from bensolve_tpu_torch.algs.driver import solve_file

    result = solve_file(args.filename, opt)
    if result.status is not SolStatus.OPTIMAL:
        if result.message:
            print(result.message)
        return 1

    if opt.message_level >= 1:
        t = result.time_ms
        print(f"CPU time            : {t/1000 if t >= 1000 else t:.4g} "
              f"{'s' if t >= 1000 else 'ms'}.")
        print(f"Number of LPs solved: {result.stats.lps}.")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
