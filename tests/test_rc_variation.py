"""Cutoff-sweep tests: the analogues of the reference's
``tests_rc_variation/`` and ``tests_rhs_rc_variation/`` suites.

Pins down: (a) the RHS assembled with the locality optimization converges
to the brute-force RHS as the cutoff grows, vanishing once the cutoff
covers the domain (Plotting/RHS_Norm_value_comparison_L2.dat: 2.4e-4 @2.0
-> 0 @>=4.5); (b) the integrated total charge error decays the same way
(Plotting/Total_charge_density_AbsErr_L2.dat); (c) A/B of optimized vs
brute-force assembly in one process (tests/test_with_optimal_parameters.cc
idiom).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.ops.q1 import element_tables
from coulomb_gmg.ops.density import atom_masks, compute_density
from coulomb_gmg.fem.constraints import build_constraints
from coulomb_gmg.fem.assembly import build_plan, assemble
from coulomb_gmg.fem.integrals import stiffness_cells, rhs_cells
from coulomb_gmg.models.atoms import two_atom_pair

R_C = 0.5


@pytest.fixture(scope="module")
def setup():
    atoms = two_atom_pair()
    # domain [0,1], h=0.25, M=4 vacuum reps -> 20^3 cells (fast)
    f = Forest.uniform(3, 20, np.full(3, -2.0), 0.25)
    cons = build_constraints(f.dofs, None)
    plan = build_plan(f.dofs.cell2dof, cons)
    tab_rhs = element_tables(3, 1, 5)
    tab_lap = element_tables(3, 1, 2)
    h = jnp.asarray(f.cell_h())
    K = stiffness_cells(tab_lap, h)
    rho_brute = compute_density(f, tab_rhs.points, atoms.positions,
                                atoms.charges, R_C)
    _, rhs_brute = assemble(plan, K, rhs_cells(tab_rhs, h, jnp.asarray(rho_brute)))
    return atoms, f, plan, tab_rhs, tab_lap, K, h, np.asarray(rhs_brute)


def _rhs_for_cutoff(setup, cutoff):
    atoms, f, plan, tab_rhs, tab_lap, K, h, _ = setup
    mask = atom_masks(f, atoms.positions, cutoff * R_C)
    rho = compute_density(f, tab_rhs.points, atoms.positions, atoms.charges,
                          R_C, mask=mask)
    _, rhs = assemble(plan, K, rhs_cells(tab_rhs, h, jnp.asarray(rho)))
    return np.asarray(rhs), rho, mask


def test_rhs_error_decays_with_cutoff(setup):
    rhs_brute = setup[-1]
    errs = []
    for cutoff in (2.0, 3.0, 4.0):
        rhs, _, _ = _rhs_for_cutoff(setup, cutoff)
        errs.append(np.linalg.norm(rhs - rhs_brute))
    assert errs[0] > errs[1] > errs[2]
    # super-exponential decay of the Gaussian tail (the reference's
    # published table decays ~2 orders per +1 cutoff,
    # Plotting/RHS_Norm_value_comparison_L2.dat)
    assert errs[1] < 0.05 * errs[0]
    assert errs[2] < 0.05 * errs[1]


def test_rhs_exact_when_cutoff_covers_domain(setup):
    # domain diameter < cutoff radius -> every atom in every cell's list
    atoms, f = setup[0], setup[1]
    rhs, _, mask = _rhs_for_cutoff(setup, 16.0)
    assert mask.all()
    assert np.array_equal(rhs, setup[-1])


def test_total_charge_integral(setup):
    """Integrated rho~/(4 pi) must approach the total charge (0 here) and
    per-atom magnitude 1 when integrating |each Gaussian| — check the
    neutral-system integral decays with cutoff (rc_variation.cc:276-321)."""
    atoms, f, plan, tab_rhs, tab_lap, K, h, _ = setup
    w = tab_rhs.weights
    vals = []
    for cutoff in (2.0, 4.0):
        _, rho, _ = _rhs_for_cutoff(setup, cutoff)
        total = float(np.sum((rho * w[None, :]).sum(axis=1)
                             * np.asarray(h) ** 3)) / (4 * np.pi)
        vals.append(abs(total))
    assert vals[0] < 5e-3                # already small (neutral system)
    assert vals[1] <= vals[0] + 1e-12    # decays (or stays) with cutoff


def test_optimized_matches_brute_at_reference_cutoff(setup):
    """The golden runs use cutoff 3.5: optimized and brute RHS must agree
    to ~1e-5 relative (test_with_optimal_parameters.cc:196-227 idiom)."""
    rhs_brute = setup[-1]
    rhs, _, _ = _rhs_for_cutoff(setup, 3.5)
    rel = np.linalg.norm(rhs - rhs_brute) / np.linalg.norm(rhs_brute)
    assert rel < 1e-5
