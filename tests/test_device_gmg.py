"""StencilGMG (chip-built operators, matrix-free system matvec) vs the
host-assembled FusedGMG oracle on the same adaptive GaussianCharges problem.

The device-operator path never assembles a CSR: level operators come from
the stencil table (ops/stencil.py), the outer-CG matvec runs cellwise
(solver/fused_gmg.py:cellwise_mv).  It must reproduce the host path's
solutions, iteration counts (within 1), and converged residuals.
Reference contract: SolverCG + GMG, src/step-50.cc:938-1017; system
assembly semantics src/step-50.cc:735-833.
"""

import numpy as np
import pytest

from coulomb_gmg.config import golden_gaussian_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import two_atom_pair
from coulomb_gmg.utils.logging import Pcout
from coulomb_gmg.solver.device_gmg import (StencilGMG,
                                           solve_refined_matfree)


@pytest.fixture(scope="module")
def small_sim():
    cfg = golden_gaussian_config(n_adaptive_cycles=2, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    return sim


def _stencil(sim, **kw):
    return StencilGMG(sim.forest, sim.forest.dofs_of(1), sim.constraints,
                      device=None, dtype=sim.dtype, **kw)


def test_matfree_matvec_matches_assembled(small_sim):
    """cellwise host matvec == assembled CSR matvec (f64, exact)."""
    sim = small_sim
    g = _stencil(sim)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(g.n)
    A = sim.A
    y_ref = np.zeros(g.n)
    np.add.at(y_ref, A.rowids, np.asarray(A.data, np.float64)
              * v[np.asarray(A.indices)])
    y = g.host_matvec64(v)
    np.testing.assert_allclose(y, y_ref, rtol=1e-11, atol=1e-11)


def test_stencil_solve_matches_host(small_sim):
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    from coulomb_gmg.solver.fused_gmg import FusedGMG
    g_ref = FusedGMG(sim.gmg, sim.A, sim.forest, device=None, dtype=sim.dtype)
    x_ref, k_ref, res0_ref, _ = g_ref.solve_fused(rhs, rtol=1e-8)
    g = _stencil(sim)
    x, k, res0, res = g.solve(rhs, rtol=1e-8)
    assert abs(k - k_ref) <= 1
    assert res0 == pytest.approx(res0_ref, rel=1e-8)
    bnorm = np.linalg.norm(rhs)
    assert res <= 1e-8 * bnorm * 1.01
    # both iterates satisfy the same 1e-8*||b|| stop; they agree to solver
    # tolerance (pointwise atol covers near-zero far-field dofs)
    np.testing.assert_allclose(x, x_ref, rtol=1e-6, atol=1e-9)


def test_stencil_device_matvec_matches_host64(small_sim):
    """The device cellwise_mv (through the fused tree's sys operands) ==
    the host f64 matrix-free matvec."""
    import jax.numpy as jnp
    from coulomb_gmg.solver.fused_gmg import cellwise_mv
    sim = small_sim
    g = _stencil(sim)
    rng = np.random.default_rng(1)
    v = np.zeros(g.n_pad)
    v[: g.n] = rng.standard_normal(g.n)
    y_dev = np.asarray(cellwise_mv(g._sys_dev, jnp.asarray(v)))[: g.n]
    y_ref = g.host_matvec64(v[: g.n])
    np.testing.assert_allclose(y_dev, y_ref, rtol=1e-10, atol=1e-10)


def test_refined_matfree(small_sim):
    """IR around StencilGMG reaches the reference's 1e-8*||b|| as a TRUE
    float64 residual without any assembled matrix."""
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g = _stencil(sim)
    x, k, res0, resf = solve_refined_matfree(g, rhs, rtol=1e-8,
                                             inner_rtol=1e-6)
    assert resf <= 1e-8 * np.linalg.norm(rhs) * 1.01
    r = rhs - g.host_matvec64(x)
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(rhs) * 1.01


def test_cross_cycle_cache_reuse(small_sim):
    """Coarse levels reuse cached device arrays; a second build with the
    same cache ships nothing for unchanged levels and still solves."""
    sim = small_sim
    cache = {}
    g1 = _stencil(sim, host_cache=cache)
    n_entries = len(cache)
    assert n_entries > 0
    g2 = _stencil(sim, host_cache=cache)
    assert len(cache) == n_entries
    for l in range(len(g1.levels)):
        assert g2.levels[l]["evals"] is g1.levels[l]["evals"]
    rhs = np.asarray(sim.rhs)
    x1, k1, _, _ = g1.solve(rhs, rtol=1e-8)
    x2, k2, _, _ = g2.solve(rhs, rtol=1e-8)
    assert k1 == k2
    np.testing.assert_allclose(x1, x2, rtol=1e-12, atol=1e-14)


def test_refined_device_defect(small_sim):
    """Device-resident IR (double-f32 defect on device, solution
    accumulated as a device pair) reaches the reference's 1e-8*||b|| as a
    TRUE residual, verified against the host f64 matrix-free operator."""
    from coulomb_gmg.solver.device_gmg import solve_refined_device
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g = _stencil(sim)
    rho = sim.rho_host()
    g.assemble_rhs(rho, sim.tab_rhs)      # populates the double-f32 pair
    # use the driver-assembled rhs for comparability of tolerances
    x, k, res0, resf = solve_refined_device(g, rhs, rtol=1e-8)
    # NOTE: the device pair's rhs may differ from sim.rhs at the ulp level
    # (assembled by the same math); check the residual against ITS rhs
    b = np.asarray(g._b_dd[0], np.float64) + np.asarray(g._b_dd[1],
                                                        np.float64)
    r = b[: g.n] - g.host_matvec64(x)
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b) * 1.2
    assert 1 <= k <= 30
