"""Micro-profile of the 'Setup system' stage pieces at a given lattice size.

Breaks the stage into its constituents (build_dofs internals, constraints,
plan/pattern) with wall timings so optimization targets are measured, not
guessed.  Host-only (numpy/native); run with JAX_PLATFORMS=cpu.

Usage: python tools/profile_setup.py [n]   # atoms = 8 n^3
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(n: int = 10):
    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout

    cfg = production_scaling_config(n, dtype="float64")
    atoms = nacl_lattice(n)
    sim = Simulation(cfg, atoms=atoms, pcout=Pcout(enabled=False))

    # run the adaptive loop WITHOUT profiling to reach the final (largest)
    # topology, then re-run the setup pieces on that forest cold.
    results = sim.run()
    f = sim.forest
    print(f"final mesh: {f.n_cells} cells")

    def t(label, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        print(f"{label:42s} {dt:8.2f} s")
        return out

    # ---- build_dofs internals, cold
    from coulomb_gmg.mesh.dofs import (_cell_node_keys, _find_hanging,
                                       _build_level, build_dofs)
    from coulomb_gmg.mesh.forest import KeyIndex
    from coulomb_gmg.utils import native

    p = cfg.degree
    ckeys = t("  _cell_node_keys", lambda: _cell_node_keys(f, p))
    uniq_inv = t("  sort_unique_inverse (cell2dof)",
                 lambda: native.sort_unique_inverse(ckeys.reshape(-1)))
    kidx = KeyIndex.__new__(KeyIndex)
    kidx.keys = uniq_inv[0]
    t("  nkey_to_coords+boundary+positions", lambda: (
        f.node_position(f.nkey_to_coords(kidx.keys, p), p)))
    t("  _find_hanging", lambda: _find_hanging(f, kidx, p))
    t("  _build_level (all levels)",
      lambda: [_build_level(f, l, p) for l in range(f.n_levels)])
    f.__dict__.pop("level_cells", None)   # cached_property: measure cold
    dofs = t("build_dofs TOTAL (cold, incl. level_cells)",
             lambda: build_dofs(f, p))

    # ---- constraints + plan
    from coulomb_gmg.fem.constraints import build_constraints
    from coulomb_gmg.fem.assembly import build_plan, _expand_entries

    cons = t("build_constraints", lambda: build_constraints(
        dofs, sim.boundary_fn()))
    crow = t("  row_of(cell2dof)", lambda: cons.row_of(
        dofs.cell2dof.reshape(-1)).reshape(dofs.cell2dof.shape))
    is_con = crow >= 0
    clean = ~is_con.any(axis=1)
    clean_idx = np.where(clean)[0]
    dirty_idx = np.where(~clean)[0]
    exp = t("  _expand_entries (dirty)", lambda: _expand_entries(
        dofs.cell2dof[dirty_idx], crow[dirty_idx], cons))
    m_row, m_col, d_dof = exp[4], exp[5], exp[8]
    extra_rows = np.concatenate([m_row, d_dof])
    extra_cols = np.concatenate([m_col, d_dof])
    n_basis = dofs.cell2dof.shape[1]
    pat = t("  native.pattern", lambda: native.pattern(
        dofs.cell2dof[clean_idx].reshape(len(clean_idx), n_basis),
        extra_rows, extra_cols, cons.n_dofs))
    plan = t("build_plan TOTAL", lambda: build_plan(dofs.cell2dof, cons))
    print(f"pattern nnz: {plan.pattern.nnz}, "
          f"clean {len(plan.clean_idx)}/{plan.n_cells} cells, "
          f"dirty m-entries {len(plan.md_cell)}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
