"""Headline benchmark: 64,000-atom NaCl lattice, 5 adaptive GMG-CG cycles —
the reference's PRODUCTION run — on one NVIDIA GPU, in one process.

Reference baseline: 20,540 s total walltime for the same problem (64,000
atoms, 5 cycles, SSOR-GMG-CG, RHS locality optimization ON, tol 1e-8*||b||)
on 20 MPI ranks across 5 cluster nodes (`Cluster runs output and
postprocessing/SSOR_64k_atoms.o876224:62`, see BASELINE.md).

Configuration is `production_scaling_config(20, dtype="float32")`: the
published study's own settings, recovered from its logs (plain-Kelly
marking, q_rhs=1, cutoff 3.5 — tests/test_production_trajectory.py).  The
validity gate: the per-cycle active-cell trajectory must equal the
published table (`Plotting/ncells_per_atom.dat:12` — 1,728,000 ...
1,849,296 cells) and every cycle must take 1..20 CG iterations.

Exits non-zero without a GPU (it never falls back to the CPU).  Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "ok", "cells", "cg",
"device": {"platform", "kind", "count"}}.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N = 20                          # lattice: 8 n^3 = 64,000 atoms
BASELINE_S = 20540.0            # SSOR_64k_atoms.o876224
REF_CELLS = [1728000, 1728560, 1749672, 1785904, 1849296]


def main():
    import jax
    from coulomb_gmg.utils import platform
    dev = platform.require_gpu()
    platform.enable_compile_cache()

    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout

    cfg = production_scaling_config(N, dtype="float32")
    t0 = time.time()
    sim = Simulation(cfg, atoms=nacl_lattice(N), pcout=Pcout(enabled=False))
    results = sim.run()
    wall = time.time() - t0

    cells = [r["n_cells"] for r in results]
    cg = [r["cg_iterations"] for r in results]
    ok = cells == REF_CELLS and all(1 <= k <= 20 for k in cg)
    print(json.dumps({
        "metric": f"walltime_{8 * N ** 3}atom_5cycle_production_gmg_s",
        "value": round(wall, 2),
        "unit": "s",
        "vs_baseline": round(BASELINE_S / wall, 3),
        "ok": ok, "cells": cells, "cg": cg,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
