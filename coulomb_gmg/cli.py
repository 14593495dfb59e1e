"""Command-line entry point.

Equivalent of the reference's ``main()`` (src/main.cc:6-121):

    python -m coulomb_gmg.cli <params.prm> [--cpu] [--cycles N]

Reads the deal.II-style parameter file, dispatches on dimension, runs the
full adaptive pipeline, and prints the reference-schema log.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="GMG solver for long-range Coulomb interactions of "
                    "Gaussian-smeared charges (runs on the GPU; --cpu for "
                    "the float64 parity mode)")
    ap.add_argument("prm", help="deal.II-style .prm parameter file")
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU + float64 (golden-parity mode)")
    ap.add_argument("--cycles", type=int, default=None,
                    help="override number of adaptive cycles")
    ap.add_argument("--smoother", default=None,
                    choices=["ssor", "mc_ssor", "jacobi", "chebyshev"])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a jax.profiler trace of the run to DIR "
                         "(TensorBoard/Perfetto format) — the analogue of "
                         "the reference's likwid profiling run "
                         "(jobscript:8,33)")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize jax.distributed for multi-process "
                         "meshes (coordinator/process env via JAX "
                         "conventions)")
    ap.add_argument("--no-fused-solve", action="store_true",
                    help="disable the fused single-executable GMG-CG for "
                         "device-resident solves (measurement aid)")
    ap.add_argument("--no-density-tiles", action="store_true",
                    help="pin the locality density to the host list path")
    args = ap.parse_args(argv)

    if args.distributed:
        from coulomb_gmg.utils.platform import init_distributed
        init_distributed()

    from coulomb_gmg.utils import platform
    if args.cpu:
        platform.use_cpu()
    else:
        platform.require_gpu()
    platform.enable_compile_cache()

    from coulomb_gmg.config import load_prm
    from coulomb_gmg.driver import Simulation

    overrides = {}
    if args.cycles is not None:
        overrides["n_adaptive_cycles"] = args.cycles
    if args.smoother is not None:
        overrides["smoother"] = args.smoother
    if not args.cpu:
        overrides.setdefault("dtype", "float32")
        overrides.setdefault("smoother", "mc_ssor")
    if args.no_fused_solve:
        overrides["solve_fused"] = False
    if args.no_density_tiles:
        overrides["density_tiles"] = False
    cfg = load_prm(args.prm, **overrides)

    from contextlib import nullcontext
    trace_ctx = nullcontext()
    if args.profile:
        import jax
        trace_ctx = jax.profiler.trace(args.profile,
                                       create_perfetto_trace=True)

    try:
        with trace_ctx:
            Simulation(cfg).run()
    except Exception as exc:                      # src/main.cc:96-118
        print("----------------------------------------------------",
              file=sys.stderr)
        print(f"Exception on processing: {exc}\nAborting!", file=sys.stderr)
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
