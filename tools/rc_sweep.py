#!/usr/bin/env python3
"""Cutoff-sweep plot-data emitter.

Reproduces the reference's ``tests_rhs_rc_variation`` study and writes the
``Plotting/*.dat`` tables in the same layout its gnuplot scripts consume
(``Plotting/RHS_Norm_value_comparison_{L1,L2,LInfinity}.dat``,
``Plotting/Total_charge_density_AbsErr_L2.dat``): for cutoffs 2.0..6.0
step 0.25, the absolute error between the locality-optimized and
brute-force RHS norms and the integrated-total-charge error.

    python tools/rc_sweep.py [--out Plotting] [--reps 20] [--step 0.25]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

R_C = 0.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="Plotting")
    ap.add_argument("--reps", type=int, default=20,
                    help="base mesh cells per side (domain [-2, 3]^3)")
    ap.add_argument("--lo", type=float, default=2.0)
    ap.add_argument("--hi", type=float, default=6.0)
    ap.add_argument("--step", type=float, default=0.25)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.q1 import element_tables
    from coulomb_gmg.ops.density import atom_masks, compute_density
    from coulomb_gmg.fem.constraints import build_constraints
    from coulomb_gmg.fem.assembly import build_plan, assemble_np
    from coulomb_gmg.fem.integrals import stiffness_cells_np, rhs_cells_np
    from coulomb_gmg.models.atoms import two_atom_pair

    atoms = two_atom_pair()
    f = Forest.uniform(3, args.reps, np.full(3, -2.0), 5.0 / args.reps)
    cons = build_constraints(f.dofs, None)
    plan = build_plan(f.dofs.cell2dof, cons)
    tab_rhs = element_tables(3, 1, 5)
    tab_lap = element_tables(3, 1, 2)
    h = f.cell_h()
    K = stiffness_cells_np(tab_lap, h)
    w = np.asarray(tab_rhs.weights)
    cellvol = h ** 3

    def rhs_and_charge(mask):
        rho = np.asarray(compute_density(
            f, tab_rhs.points, atoms.positions, atoms.charges, R_C,
            mask=mask))
        _, rhs = assemble_np(plan, K, rhs_cells_np(tab_rhs, h, rho))
        # integrated total charge: sum_cells vol * sum_q w_q rho_q / 4pi
        total_q = float((cellvol * (rho @ w)).sum() / (4.0 * np.pi))
        return rhs, total_q

    rhs_ref, q_ref = rhs_and_charge(None)
    norms_ref = {
        "L1": float(np.abs(rhs_ref).sum()),
        "L2": float(np.linalg.norm(rhs_ref)),
        "LInfinity": float(np.abs(rhs_ref).max()),
    }

    cutoffs = np.arange(args.lo, args.hi + 1e-9, args.step)
    rows = []
    for c in cutoffs:
        mask = atom_masks(f, atoms.positions, float(c) * R_C)
        rhs, q = rhs_and_charge(mask)
        rows.append({
            "cutoff": float(c),
            "L1": abs(float(np.abs(rhs).sum()) - norms_ref["L1"]),
            "L2": abs(float(np.linalg.norm(rhs)) - norms_ref["L2"]),
            "LInfinity": abs(float(np.abs(rhs).max())
                             - norms_ref["LInfinity"]),
            "charge": abs(q - q_ref),
        })
        print(f"cutoff {c:4.2f}  L2 err {rows[-1]['L2']:.12f}  "
              f"charge err {rows[-1]['charge']:.10f}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    for norm in ("L1", "L2", "LInfinity"):
        path = os.path.join(args.out,
                            f"RHS_Norm_value_comparison_{norm}.dat")
        with open(path, "w") as fh:
            fh.write(f"#RHS_Norm_value_comparison_{norm}.dat for {norm} "
                     "norm values\n")
            fh.write("#Here system_rhs vector norm values with and without "
                     "rhs assembly optimization are compared\n")
            fh.write("#Absolute error between these 2 norm values is "
                     "taken\n\n")
            fh.write(f"#rhs {norm} norm\nCutoff\tAbsErr{{{norm}}}\n")
            for r in rows:
                fh.write(f"{r['cutoff']:.2f}\t{r[norm]:.12f}\n")
    path = os.path.join(args.out, "Total_charge_density_AbsErr_L2.dat")
    with open(path, "w") as fh:
        fh.write("\n#Total_charge_density_AbsErr_L2.dat\n")
        fh.write("#Here charge_densities integrated over the domain with "
                 "and without rhs assembly optimization are compared\n")
        fh.write("#Absolute error between these 2 values is taken\n\n")
        fh.write("#total charge density error\nCutoff\tAbsError{L2}\n")
        for r in rows:
            fh.write(f"{r['cutoff']:.2f}\t{r['charge']:.10f}\n")
    print(f"wrote 4 .dat tables to {args.out}/")


if __name__ == "__main__":
    main()
