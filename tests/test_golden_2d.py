"""2D golden regressions vs the reference's own ``tests_2D/`` output files.

Both suites predate the volume-residual augmentation of the Kelly
indicator (their outputs print no "Threshold value" lines, unlike the
current-code goldens in ``tests/gaussian-charges.mpirun=*.output``), so
they run with ``estimator_volume_term=False`` — the same staleness proof
as tests/test_production_trajectory.py.  With plain-Kelly marking this
implementation reproduces BOTH trajectories exactly: every per-cycle
active-cell count and every printed solution-norm digit.

Configs are the reference's own prm files (tests_2D/step-16.prm,
tests_2D/gaussian-charges.prm): hyper_cube([0,1]^2) + 4 global refinements
for Step16; for the analytic GaussianCharges (LAMMPS reading is 3D-only,
tests_2D/step-16.mpirun=1.output:2) a uniform 16^2 grid over [-2.5,2.5]^2
(mesh_size_h=0.3125, no vacuum margin reproduces the old revision's
hyper_cube+refine_global(4)).
"""

import numpy as np
import pytest

from coulomb_gmg.config import Config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.io.lammps import AtomData
from coulomb_gmg.utils.logging import Pcout


def _empty(dim):
    return AtomData(np.zeros((0, dim)), np.zeros(0), np.zeros(0, np.int32),
                    np.zeros(dim), np.zeros(dim))


# tests_2D/step-16.mpirun=1.output:5-43
STEP16_2D = {
    "cells": [256, 418, 865, 1219, 1297],
    "dofs": [289, 495, 952, 1354, 1446],
    "cg": [7, 10, 11, 13, 13],
    "l2_sol": [4.75978, 5.65081, 9.64327, 10.0806, 10.13],
    "linf_sol": [0.572697, 0.57747, 0.577873, 0.579166, 0.57931],
}
# tests_2D/gaussian-charges.mpirun=1.output (8 cycles)
GAUSS_2D = {
    "cells": [256, 268, 328, 460, 712, 1084, 1744, 2824],
    "cg": [6, 6, 7, 7, 8, 8, 8, 8],
    "l2_sol": [2.02616, 2.48688, 4.07305, 5.97429, 8.38942, 11.0898,
               14.6293, 18.0956],
}


@pytest.fixture(scope="module")
def run_step16_2d():
    cfg = Config(problem="Step16", dim=2, n_global_refinements=4,
                 domain_left=0.0, domain_right=1.0, n_adaptive_cycles=5,
                 boundary_conditions="Homogeneous", preconditioner="GMG",
                 estimator_volume_term=False, dtype="float64",
                 flag_output_time=False)
    return Simulation(cfg, atoms=_empty(2), pcout=Pcout(enabled=False)).run()


@pytest.fixture(scope="module")
def run_gauss_2d():
    cfg = Config(problem="GaussianCharges", dim=2, domain_left=-2.5,
                 domain_right=2.5, mesh_size_h=0.3125, vacuum_repetitions=0,
                 n_adaptive_cycles=8, r_c=0.5, nonzero_radius=3.0,
                 boundary_conditions="Inhomogeneous", preconditioner="GMG",
                 estimator_volume_term=False, dtype="float64",
                 flag_output_time=False)
    return Simulation(cfg, atoms=_empty(2), pcout=Pcout(enabled=False)).run()


def test_step16_2d_trajectory_exact(run_step16_2d):
    assert [r["n_cells"] for r in run_step16_2d] == STEP16_2D["cells"]
    assert [r["n_dofs"] for r in run_step16_2d] == STEP16_2D["dofs"]


def test_step16_2d_solution_norms(run_step16_2d):
    for r, l2, li in zip(run_step16_2d, STEP16_2D["l2_sol"],
                         STEP16_2D["linf_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)
        assert r["linf_sol"] == pytest.approx(li, rel=1e-5)


def test_step16_2d_cg_counts(run_step16_2d):
    # our Chebyshev-smoothed GMG must converge at least as fast as the
    # golden's SSOR counts (+1 slack for smoother-variant drift)
    for r, g in zip(run_step16_2d, STEP16_2D["cg"]):
        assert 1 <= r["cg_iterations"] <= g + 1


def test_gauss_2d_trajectory_exact(run_gauss_2d):
    assert [r["n_cells"] for r in run_gauss_2d] == GAUSS_2D["cells"]


def test_gauss_2d_solution_norms(run_gauss_2d):
    for r, l2 in zip(run_gauss_2d, GAUSS_2D["l2_sol"]):
        assert r["l2_sol"] == pytest.approx(l2, rel=1e-5)


def test_gauss_2d_cg_counts(run_gauss_2d):
    for r, g in zip(run_gauss_2d, GAUSS_2D["cg"]):
        assert 1 <= r["cg_iterations"] <= g + 1
