"""Morton-tiled locality density under SPMD: the work-item list sharded
by cell-block owner over the device mesh must be BIT-IDENTICAL to the
single-device tile path — same plan, same kernel, same f32 arithmetic per
(cell, atom) pair; only the launch partition differs (VERDICT r4 #6;
src/step-50.cc:509-575)."""

import numpy as np
import pytest
import jax

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.models.atoms import nacl_lattice
from coulomb_gmg.ops.q1 import element_tables
from coulomb_gmg.ops.tile_density import density_locality_tiles
from coulomb_gmg.parallel.spmd import SpmdContext

R_C = 0.5
CUT = 3.5 * R_C


def _setup(n=1, vac=3):
    atoms = nacl_lattice(n)
    a = 2.0 * 0.25
    reps = int(round(2 * (n / a + 2 * vac)))
    f = Forest.uniform(3, reps, np.full(3, -vac * a), 0.25)
    return f, atoms, element_tables(3, 1, 2)


@pytest.mark.parametrize("D", [2, 3, 8])
def test_spmd_tiles_bit_identical(D):
    if len(jax.devices()) < D:
        pytest.skip("needs virtual devices")
    f, atoms, tab = _setup()
    ref = density_locality_tiles(f, tab.points, atoms.positions,
                                 atoms.charges, R_C, CUT)
    spmd = SpmdContext(D)
    got = spmd.density_tiles(f, tab.points, atoms.positions, atoms.charges,
                             R_C, CUT)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_spmd_tiles_after_refinement():
    """Inherited level-0-ancestor membership across refinement, sharded."""
    f, atoms, tab = _setup()
    rng = np.random.default_rng(0)
    flags = rng.random(f.n_cells) < 0.02
    f2 = f.refine(flags)
    ref = density_locality_tiles(f2, tab.points, atoms.positions,
                                 atoms.charges, R_C, CUT)
    spmd = SpmdContext(8)
    got = spmd.density_tiles(f2, tab.points, atoms.positions,
                             atoms.charges, R_C, CUT)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("D", [3, 8])
def test_spmd_estimator_matches_host(D):
    """Sharded Kelly estimator == host estimator exactly (f64), including
    coarse-fine subfaces across refinement edges (VERDICT r4 #8)."""
    if len(jax.devices()) < D:
        pytest.skip("needs virtual devices")
    from coulomb_gmg.adapt.estimator import estimate, build_face_plan
    f, atoms, tab = _setup()
    rng = np.random.default_rng(3)
    f2 = f.refine(rng.random(f.n_cells) < 0.01)
    dofs = f2.dofs_of(1)
    u = rng.standard_normal(dofs.n_dofs)
    plan = build_face_plan(f2)
    ref = estimate(f2, dofs.cell2dof, u, None, tab.points, tab.weights,
                   degree=1, use_volume_term=False, plan=plan)
    spmd = SpmdContext(D)
    got = spmd.estimate(f2, dofs.cell2dof, u, plan=plan)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)
