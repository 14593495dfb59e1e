#!/usr/bin/env python3
"""Atoms-vs-walltime scaling study — the reference's headline benchmark
series (``Plotting/RELEASE_atoms_Vs_walltime.dat``, ``SSOR_run.o876223``).

Reference baselines (total walltime, 5 adaptive cycles, SSOR-GMG-CG, RHS
locality optimization ON, 20 MPI ranks of a 40-core node):

    atoms   debug/1-node   RELEASE/5-node
      8       134.2 s          —
    216       263.0 s        2,937 s
   1000       464.3 s        6,787 s
   2744       874.9 s       50,048 s
   8000     1,990   s       69,839 s
  64000    20,540   s  (5 nodes; SSOR_64k_atoms.o876224)

Usage: python tools/bench_scaling.py [--sizes 1,3,5] [--cycles 5] [--gpu]
Prints one JSON line per size:
  {"atoms": N, "wall_s": T, "ref_debug_s": R, "speedup": R/T, ...}
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_DEBUG = {8: 134.2, 216: 263.0, 1000: 464.3, 2744: 874.9, 8000: 1990.0,
             64000: 20540.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,3",
                    help="comma list of n (atoms = 8 n^3)")
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--gpu", action="store_true",
                    help="allow the GPU backend (default: host)")
    ap.add_argument("--timers", action="store_true",
                    help="print the per-stage walltime table after each size")
    ap.add_argument("--verbose", action="store_true",
                    help="stream the reference-schema per-cycle log lines")
    ap.add_argument("--production", action="store_true",
                    help="use production_scaling_config — the configuration "
                    "of the reference's PUBLISHED study (plain-Kelly "
                    "marking, no FE-error postprocess, cg_rtol=1e-8); "
                    "checks per-cycle cell counts against "
                    "Plotting/ncells_per_atom.dat")
    ap.add_argument("--dtype", default=None,
                    help="override dtype (default: float32, or float64 "
                    "with --production on host)")
    args = ap.parse_args()

    if not args.gpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    if (args.dtype or ("float64" if args.production and not args.gpu
                       else "float32")) == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    jax.jit(lambda x: (x @ x).sum())(
        jnp.ones((512, 512), jnp.float32)).block_until_ready()

    from coulomb_gmg.config import (golden_gaussian_config,
                                    production_scaling_config)
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout

    # Plotting/ncells_per_atom.dat:6-12 — the published per-cycle cells
    ref_cells = {
        8:     [85184, 85744, 87648, 91344, 99464],
        216:   [140608, 141168, 145480, 153488, 172472],
        1000:  [216000, 216560, 222552, 233584, 253296],
        2744:  [314432, 314992, 323000, 337392, 362144],
        8000:  [512000, 512560, 523592, 543024, 576428],
        64000: [1728000, 1728560, 1749672, 1785904, 1849296],
    }

    for n in [int(s) for s in args.sizes.split(",")]:
        atoms = nacl_lattice(n)
        if args.production:
            # like-for-like with the PUBLISHED study: plain-Kelly marking,
            # no FE-error postprocess, reference tolerance 1e-8
            cfg = production_scaling_config(
                n, n_adaptive_cycles=args.cycles,
                dtype=args.dtype or ("float32" if args.gpu else "float64"),
                solver_backend="bucketed_cg",
            )
        else:
            cfg = golden_gaussian_config(
                n_adaptive_cycles=args.cycles,
                domain_left=0.0, domain_right=float(n),
                dtype=args.dtype or "float32",
                solver_backend="bucketed_cg", cg_rtol=1e-6,
                boundary_conditions="Exact" if atoms.n < 2000
                else "Inhomogeneous",
                flag_output_time=False,
            )
        t0 = time.time()
        sim = Simulation(cfg, atoms=atoms,
                         pcout=Pcout(enabled=args.verbose))
        results = sim.run()
        wall = time.time() - t0
        last = results[-1]
        e = last.get("energy", {})
        ref = REF_DEBUG.get(atoms.n)
        row = {
            "atoms": atoms.n,
            "wall_s": round(wall, 2),
            "cells_final": last["n_cells"],
            "dofs_final": last["n_dofs"],
            "cg_final": last["cg_iterations"],
            "energy_abs_err": e.get("abs_error"),
            "ref_debug_s": ref,
            "speedup_vs_ref": round(ref / wall, 2) if ref else None,
        }
        if args.production and atoms.n in ref_cells and args.cycles == 5:
            cells = [r["n_cells"] for r in results]
            row["cells_per_cycle"] = cells
            row["cells_match_published"] = cells == ref_cells[atoms.n]
            row["cg_per_cycle"] = [r["cg_iterations"] for r in results]
        print(json.dumps(row), flush=True)
        if args.timers:
            sim.timer.summary(print)


if __name__ == "__main__":
    main()
