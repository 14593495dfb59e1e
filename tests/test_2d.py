"""2D pipeline smoke tests — the analogue of the reference's ``tests_2D/``
suite (Step16 2D and GaussianCharges 2D analytic; LAMMPS reading is 3D-only
so 2D always takes the analytic-RHS path, tests_2D/step-16.mpirun=1.output:2)."""

import numpy as np
import pytest

from coulomb_gmg.config import Config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.io.lammps import empty_atom_data
from coulomb_gmg.utils.logging import Pcout


def quiet():
    return Pcout(enabled=False)


def test_step16_2d_two_cycles():
    cfg = Config(problem="Step16", dim=2, n_global_refinements=4,
                 domain_left=-1.0, domain_right=1.0, n_adaptive_cycles=2,
                 boundary_conditions="Homogeneous", preconditioner="GMG",
                 flag_output_time=False)
    sim = Simulation(cfg, atoms=empty_atom_data2d(), pcout=quiet())
    results = sim.run()
    assert results[0]["n_cells"] == 256           # 16^2
    assert results[0]["n_dofs"] == 289            # 17^2
    assert results[0]["dofs_by_level"] == [4, 9, 25, 81, 289]
    assert results[0]["cg_iterations"] <= 30
    assert results[1]["n_cells"] > 256            # refinement happened
    assert results[1]["cg_iterations"] <= 30
    assert np.isfinite(results[1]["l2_sol"])


def test_gaussian_2d_analytic_two_cycles():
    cfg = Config(problem="GaussianCharges", dim=2, domain_left=0.0,
                 domain_right=1.0, mesh_size_h=0.25, vacuum_repetitions=2,
                 n_adaptive_cycles=2, boundary_conditions="Homogeneous",
                 preconditioner="GMG", flag_output_time=False)
    sim = Simulation(cfg, atoms=empty_atom_data2d(), pcout=quiet())
    results = sim.run()
    assert results[0]["n_cells"] == 12 ** 2       # 2*(2+4)=12 reps
    assert results[0]["cg_iterations"] <= 30
    assert results[1]["n_cells"] >= results[0]["n_cells"]


def test_jacobi_preconditioner_2d():
    cfg = Config(problem="Step16", dim=2, n_global_refinements=3,
                 domain_left=-1.0, domain_right=1.0, n_adaptive_cycles=1,
                 boundary_conditions="Homogeneous", preconditioner="Jacobi",
                 flag_output_time=False, cg_max_iters=500)
    sim = Simulation(cfg, atoms=empty_atom_data2d(), pcout=quiet())
    results = sim.run()
    assert results[0]["cg_iterations"] < 200
    assert np.isfinite(results[0]["l2_sol"])


def empty_atom_data2d():
    from coulomb_gmg.io.lammps import AtomData
    return AtomData(np.zeros((0, 2)), np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(2), np.zeros(2))


def test_grid_output_debug_gnuplot(tmp_path):
    """grid_output_debug analogue (src/step-50.cc:310-375): two .gp scripts
    with cell outlines + atom-list / presence labels."""
    import os
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.io.gnuplot import grid_output_debug

    f = Forest.uniform(2, 4, np.zeros(2), 0.25)
    mask = np.zeros((f.n_cells, 3), dtype=bool)
    mask[0, :2] = True
    grid_output_debug(f, mask, cycle=1, dim=2, output_dir=str(tmp_path))
    g1 = tmp_path / "grid2_p_cycle10.gp"
    g2 = tmp_path / "grid_atom_presence2_p_cycle10.gp"
    assert g1.exists() and g2.exists()
    t1 = g1.read_text()
    assert "set terminal png" in t1 and t1.count("e\n") >= 2
    assert '"0, 1, "' in t1                   # atom list label of cell 0
    t2 = g2.read_text()
    assert '"1"' in t2 and '"0"' in t2        # presence flags
