"""Fused single-executable GMG-CG (solver/fused_gmg.py:_fused_gmg_cg) vs the
host-orchestrated block-wise CG: identical operators, identical math — the
iteration counts and solutions must agree.  This is the production
accelerator solve path (one dispatch per solve); here it runs on the CPU
backend with the same executables.  Reference contract: SolverCG with
GMG preconditioning, src/step-50.cc:938-1017."""

import numpy as np
import pytest

from coulomb_gmg.config import golden_gaussian_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import two_atom_pair
from coulomb_gmg.utils.logging import Pcout


@pytest.fixture(scope="module")
def small_sim():
    cfg = golden_gaussian_config(n_adaptive_cycles=2, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    return sim


def _make(sim, **kw):
    from coulomb_gmg.solver.fused_gmg import FusedGMG
    kw.setdefault("use_dst", True)
    return FusedGMG(sim.gmg, sim.A, sim.forest, device=None, dtype=sim.dtype,
                  **kw)


def test_fused_matches_blockwise(small_sim):
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g = _make(sim)
    x_b, k_b, res0_b, res_b = g.solve(rhs, rtol=1e-8, fused=False)
    x_f, k_f, res0_f, res_f = g.solve_fused(rhs, rtol=1e-8)
    assert k_f == k_b
    assert res0_f == pytest.approx(res0_b, rel=1e-10)
    bnorm = np.linalg.norm(rhs)
    assert res_f <= 1e-8 * bnorm * 1.01
    np.testing.assert_allclose(x_f, x_b, rtol=1e-7, atol=1e-12)


def test_fused_matches_driver_solution(small_sim):
    """The fused solve agrees with the driver's converged solution to
    solver tolerance."""
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g = _make(sim)
    x_f, k_f, _, _ = g.solve_fused(rhs, rtol=1e-8)
    from coulomb_gmg.fem.constraints import distribute
    x_d = np.asarray(distribute(sim.constraints, x_f))
    ref = np.asarray(sim.solution)
    assert np.linalg.norm(x_d - ref) / np.linalg.norm(ref) < 1e-5
    assert 1 <= k_f <= 20


def test_fused_warm_start_and_converged_x0(small_sim):
    """x0 already converged -> 0 iterations; warm start -> fewer/equal."""
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g = _make(sim)
    x_f, k_f, _, _ = g.solve_fused(rhs, rtol=1e-8)
    _, k2, _, _ = g.solve_fused(rhs, x0=x_f, rtol=1e-8)
    assert k2 == 0


def test_fused_coarse_cg_fallback(small_sim):
    """use_dst=False exercises the while_loop Chebyshev-CG coarse solve."""
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g = _make(sim, use_dst=False, coarse_rtol=1e-10)
    x_f, k_f, _, res_f = g.solve_fused(rhs, rtol=1e-8)
    bnorm = np.linalg.norm(rhs)
    assert res_f <= 1e-8 * bnorm * 1.01
    assert 1 <= k_f <= 25


def test_level_delta_ship_across_cycles(small_sim):
    """Cross-cycle operator shipping: a second FusedGMG built from the same
    GMG hierarchy (prev=) must REUSE unchanged level device arrays (zero
    traffic) and still solve identically."""
    sim = small_sim
    rhs = np.asarray(sim.rhs)
    g1 = _make(sim)
    from coulomb_gmg.solver.fused_gmg import FusedGMG
    g2 = FusedGMG(sim.gmg, sim.A, sim.forest, device=None, dtype=sim.dtype,
                use_dst=True, host_cache=None, prev=g1)
    # identical host ELL arrays are only guaranteed through the host cache;
    # with a shared cache everything is reused
    hc = {}
    ga = FusedGMG(sim.gmg, sim.A, sim.forest, device=None, dtype=sim.dtype,
                use_dst=True, host_cache=hc)
    gb = FusedGMG(sim.gmg, sim.A, sim.forest, device=None, dtype=sim.dtype,
                use_dst=True, host_cache=hc, prev=ga)
    reused, delta, packed = gb._lvl_ship_stats
    assert reused > 0 and packed == 0, gb._lvl_ship_stats
    x_a, k_a, _, _ = ga.solve_fused(rhs, rtol=1e-8)
    x_b, k_b, _, _ = gb.solve_fused(rhs, rtol=1e-8)
    assert k_a == k_b
    np.testing.assert_allclose(x_a, x_b, rtol=1e-10, atol=1e-14)
