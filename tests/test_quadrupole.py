"""The quadrupole flag must be observable: when enabled, the integrated
quadrupole feeds the multipole (Inhomogeneous/NonZeroDBC) boundary values
(include/step_50.h:378-385); when disabled (default), the quadrupole is
zero and BCs are dipole-only — the reference's effective behavior, since
it zeroes the integral right after computing it (src/step-50.cc:624)."""

import numpy as np

from coulomb_gmg.config import Config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.io.lammps import AtomData
from coulomb_gmg.utils.logging import Pcout


def _atoms_with_quadrupole():
    # +1/+1 along x, -2 at origin: zero net charge, zero dipole,
    # NON-zero quadrupole (Q_xx != Q_yy)
    pos = np.array([[0.6, 0.0, 0.0], [-0.6, 0.0, 0.0], [0.0, 0.0, 0.0]])
    q = np.array([1.0, 1.0, -2.0])
    return AtomData(positions=pos, charges=q,
                    types=np.ones(3, dtype=np.int32),
                    box_lo=np.full(3, -1.0), box_hi=np.full(3, 1.0))


def _setup(flag: bool):
    cfg = Config(problem="GaussianCharges", dim=3, domain_left=-1.0,
                 domain_right=1.0, mesh_size_h=0.25, vacuum_repetitions=2,
                 n_adaptive_cycles=1, r_c=0.5,
                 boundary_conditions="Inhomogeneous",
                 flag_compute_quadrupole=flag, flag_output_time=False,
                 dtype="float64")
    sim = Simulation(cfg, atoms=_atoms_with_quadrupole(),
                     pcout=Pcout(enabled=False))
    sim.forest = sim.make_initial_mesh()
    sim.setup(0)
    return sim


def test_flag_off_quadrupole_zero():
    sim = _setup(False)
    assert np.all(sim.quadrupole == 0.0)


def test_flag_on_quadrupole_nonzero_and_changes_bc():
    sim_on = _setup(True)
    sim_off = _setup(False)
    Q = sim_on.quadrupole
    assert Q.shape == (3, 3)
    assert not np.allclose(Q, 0.0)
    # traceless by construction: Q = 3S - tr(S) I
    assert abs(np.trace(Q)) < 1e-6 * np.abs(Q).max()
    # boundary values must differ between flag on/off (dipole is ~0 here,
    # so the quadrupole term is the leading multipole)
    pts = np.array([[1.5, 0.3, -0.2], [-1.1, 0.9, 0.4]])
    bc_on = sim_on.boundary_fn()(pts)
    bc_off = sim_off.boundary_fn()(pts)
    assert not np.allclose(bc_on, bc_off)
    # and the constrained Dirichlet values in the assembled system differ
    assert not np.allclose(sim_on.constraints.inhomog,
                           sim_off.constraints.inhomog)
