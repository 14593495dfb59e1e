"""Unit tests for the hot-path kernels (ELL SpMV, density, exact
gradient, energy-norm error).

The reference's analogous coverage is the A/B RHS-norm comparison in
tests/test_with_optimal_parameters.cc:196-227 (optimized vs brute force).
"""

import numpy as np
import jax.numpy as jnp
import pytest


def _random_csr(n, density, seed=0):
    rng = np.random.default_rng(seed)
    import scipy.sparse as sp
    A = (sp.random(n, n, density=density, random_state=seed, format="csr")
         + sp.eye(n))
    return A.tocsr()


def test_ell_matches_scipy():
    from coulomb_gmg.ops.ell import ELL, ell_matvec
    A = _random_csr(513, 0.02)
    e = ELL.from_csr(A.indptr, A.indices, A.data)
    x = np.random.default_rng(1).standard_normal(513)
    y = np.asarray(ell_matvec(jnp.asarray(e.cols), jnp.asarray(e.vals),
                              jnp.asarray(x)))
    np.testing.assert_allclose(y, A @ x, rtol=1e-12)
    np.testing.assert_allclose(e.diagonal(), A.diagonal(), rtol=1e-12)


def test_ell_row_padding_and_bucket():
    from coulomb_gmg.ops.ell import ELL, ell_matvec
    A = _random_csr(100, 0.05, seed=2)
    e = ELL.from_csr(A.indptr, A.indices, A.data, pad_rows_to=128,
                     pad_k_to=32)
    assert e.n_rows == 128 and e.K == 32
    x = np.random.default_rng(2).standard_normal(128)
    y = np.asarray(ell_matvec(jnp.asarray(e.cols), jnp.asarray(e.vals),
                              jnp.asarray(x)))
    np.testing.assert_allclose(y[:100], A @ x[:100], rtol=1e-12)
    np.testing.assert_allclose(y[100:], 0.0)


def test_pallas_density_matches_reference_formula():
    """The brute-force (no locality) density — the separable
    tensor-product path — against the reference formula at every
    quadrature point (include/step_50.h charge density)."""
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.density import compute_density, cell_quad_points
    from coulomb_gmg.ops.q1 import element_tables
    from coulomb_gmg.models.problems import charge_density
    rng = np.random.default_rng(4)
    f = Forest.uniform(3, 4, np.full(3, -2.0), 1.0)
    tab = element_tables(3, 1, 3)
    pos = rng.uniform(-1, 1, (33, 3))
    q = rng.choice([-1.0, 1.0], 33)
    r_c = 0.5
    pts = cell_quad_points(f, tab.points)
    ref = np.asarray(charge_density(jnp.asarray(pts), jnp.asarray(pos),
                                    jnp.asarray(q), r_c))
    got = compute_density(f, tab.points, pos, q, r_c)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


def test_spatial_hash_lists_match_dense_mask():
    """ops/neighbors.py must reproduce the dense vertex-criterion mask
    (the A/B idiom of tests/test_with_optimal_parameters.cc:196-227)."""
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.density import atom_masks
    from coulomb_gmg.ops.neighbors import atom_lists

    rng = np.random.default_rng(7)
    f = Forest.uniform(3, 6, np.zeros(3), 0.5)
    # refine a couple of cells so h varies
    flags = np.zeros(f.n_cells, dtype=bool)
    flags[[3, 40, 100]] = True
    f = f.refine(flags)
    pos = rng.uniform(-0.5, 3.5, (150, 3))
    cutoff = 0.8

    mask = atom_masks(f, pos, cutoff)
    lists, counts = atom_lists(f, pos, cutoff)
    assert (counts == mask.sum(axis=1)).all()
    for c in range(f.n_cells):
        got = set(lists[c][lists[c] >= 0].tolist())
        want = set(np.where(mask[c])[0].tolist())
        assert got == want, c


def test_density_from_lists_matches_dense():
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.density import (atom_masks, compute_density)
    from coulomb_gmg.ops.neighbors import atom_lists
    from coulomb_gmg.ops.q1 import element_tables

    rng = np.random.default_rng(8)
    f = Forest.uniform(3, 5, np.zeros(3), 0.4)
    pos = rng.uniform(0.2, 1.8, (80, 3))
    q = rng.choice([-1.0, 1.0], 80)
    r_c, cutoff = 0.3, 0.9
    tab = element_tables(3, 1, 3)
    mask = atom_masks(f, pos, cutoff)
    lists, _ = atom_lists(f, pos, cutoff)
    rho_m = compute_density(f, tab.points, pos, q, r_c, mask=mask)
    rho_l = compute_density(f, tab.points, pos, q, r_c, lists=lists)
    np.testing.assert_allclose(rho_l, rho_m, rtol=1e-10, atol=1e-12)


def test_dst_coarse_solver_exact():
    """ops/dst.py must solve the assembled level-0 Q1 Laplacian exactly
    (it replaces MGCoarseGridIterativeSolver, src/step-50.cc:962-967)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.fem.assembly import build_plan, assemble
    from coulomb_gmg.fem.integrals import stiffness_cells
    from coulomb_gmg.ops.q1 import element_tables
    from coulomb_gmg.ops.dst import DSTPoisson
    from coulomb_gmg.solver.multigrid import level_constraints

    m = 6
    f = Forest.uniform(3, m, np.zeros(3), 1.0 / m)
    dofs = f.dofs
    ld = dofs.levels[0]
    tab = element_tables(3, 1, 2)
    plan = build_plan(ld.cell2dof, level_constraints(ld))
    k = stiffness_cells(tab, jnp.asarray(f.cell_h()), dtype=jnp.float64)
    data, _ = assemble(plan, k, None, dtype=jnp.float64)

    import scipy.sparse as sp
    A = sp.csr_matrix((np.asarray(data), plan.pattern.indices,
                       plan.pattern.indptr))
    rng = np.random.default_rng(5)
    b = rng.standard_normal(ld.n_dofs)

    # reference solve
    import scipy.sparse.linalg as spla
    x_ref = spla.spsolve(A.tocsc(), b)

    # DST solve: interior exactly + boundary rows via their diagonal
    d = DSTPoisson.build(3, m, 1.0 / m, np.float64)
    coords = np.stack(np.meshgrid(*([np.arange(m + 1)] * 3),
                                  indexing="ij"), -1).reshape(-1, 3)
    interior = (coords > 0).all(1) & (coords < m).all(1)
    u = np.zeros(ld.n_dofs)
    u[interior] = np.asarray(
        d.solve(b[interior].reshape((m - 1,) * 3))).reshape(-1)
    diag = A.diagonal()
    u[~interior] = b[~interior] / diag[~interior]
    np.testing.assert_allclose(u, x_ref, rtol=1e-9, atol=1e-11)


def test_pallas_density_cells_matches_compute_density():
    """The brute-force separable density in float32 over fixed-size,
    padded cell chunks (ops/density.py) against density_dense."""
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.density import (compute_density, density_dense,
                                         cell_quad_points)
    from coulomb_gmg.ops.q1 import element_tables

    f = Forest.uniform(3, 5, np.zeros(3), 0.4)
    tab = element_tables(3, 1, 2)
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.2, 1.8, (37, 3))
    q = rng.choice([-1.0, 1.0], 37)
    r_c = 0.5

    ref = np.asarray(density_dense(jnp.asarray(cell_quad_points(
        f, tab.points)), jnp.asarray(pos), jnp.asarray(q), r_c))
    got = compute_density(f, tab.points, pos, q, r_c, chunk=48,
                          dtype=np.float32)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=5e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_pallas_gradient_matches_reference_formula():
    """analytic_solution_gradient (the FE-error exact gradient) against
    central differences of analytic_solution."""
    from coulomb_gmg.models.problems import (analytic_solution,
                                             analytic_solution_gradient)
    rng = np.random.default_rng(6)
    P, A = 300, 41
    pts = rng.uniform(-2, 2, (P, 3))
    pos = rng.uniform(-1, 1, (A, 3))
    q = rng.choice([-1.0, 1.0], A)
    r_c = 0.5
    got = np.asarray(analytic_solution_gradient(
        jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(q), r_c))
    eps = 1e-5
    fd = np.empty_like(pts)
    for d in range(3):
        e = np.zeros(3)
        e[d] = eps
        up = analytic_solution(jnp.asarray(pts + e), jnp.asarray(pos),
                               jnp.asarray(q), r_c)
        dn = analytic_solution(jnp.asarray(pts - e), jnp.asarray(pos),
                               jnp.asarray(q), r_c)
        fd[:, d] = (np.asarray(up) - np.asarray(dn)) / (2 * eps)
    np.testing.assert_allclose(got, fd, rtol=1e-6, atol=1e-8)


def test_pallas_gradient_zero_at_atom_position():
    """The reference zeroes the (removable) singularity at atom positions
    (include/step_50.h:355-369); the gradient's guard must reproduce that,
    in float64 and in the float32 the device path runs."""
    from coulomb_gmg.models.problems import analytic_solution_gradient
    pos = np.array([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]])
    q = np.array([1.0, -1.0])
    pts = np.array([[0.5, 0.5, 0.5]])        # exactly ON atom 0
    # only atom 1's (finite) contribution remains
    ref = np.asarray(analytic_solution_gradient(
        jnp.asarray(pts), jnp.asarray(pos[1:]), jnp.asarray(q[1:]), 0.4))
    for dt in (jnp.float64, jnp.float32):
        g = np.asarray(analytic_solution_gradient(
            jnp.asarray(pts, dt), jnp.asarray(pos, dt), jnp.asarray(q, dt),
            0.4))
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, ref, rtol=1e-6 if dt == jnp.float32
                                   else 1e-14)


def test_energy_norm_error_f32_matches_f64():
    """The f32 path tracks the f64 reference path to single-precision
    accuracy on a small production-shaped problem."""
    from coulomb_gmg.postprocess.energy import energy_norm_error
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.q1 import element_tables
    f = Forest.uniform(3, 6, np.zeros(3), 0.3)
    tab = element_tables(3, 1, 2)
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.4, 1.4, (29, 3))
    q = rng.choice([-1.0, 1.0], 29)
    u = rng.standard_normal(f.dofs_of(1).n_dofs) * 0.01
    e64 = energy_norm_error(f, tab, u, pos, q, 0.5)
    e32 = energy_norm_error(f, tab, u, pos, q, 0.5, dtype=np.float32)
    assert abs(e32 - e64) / e64 < 5e-4, (e32, e64)


def test_fused_gmg_sys_ell_delta_ship_matches_full_build():
    """System-ELL delta shipping: rebuilding FusedGMG from a prev instance
    with a few perturbed rows must (a) take the delta path, shipping only
    the changed rows, and (b) solve identically to a fresh full build."""
    import jax
    from coulomb_gmg.config import golden_gaussian_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import two_atom_pair
    from coulomb_gmg.ops.spmv import CSR
    from coulomb_gmg.solver.fused_gmg import FusedGMG
    from coulomb_gmg.utils.logging import Pcout

    cfg = golden_gaussian_config(n_adaptive_cycles=1, flag_output_time=False)
    cfg = type(cfg)(**{**cfg.__dict__, "mesh_size_h": 0.5,
                       "vacuum_repetitions": 4})
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    dev = jax.devices()[0]          # CPU device object: still "a device"
    rhs = np.asarray(sim.rhs, np.float64)

    prev = FusedGMG(sim.gmg, sim.A, sim.forest, device=dev, dtype=jnp.float64,
                  use_dst=True)
    # next-cycle stand-in: same pattern, a few strengthened diagonal rows
    data2 = np.asarray(sim.A.data).copy()
    diag_pos = np.flatnonzero(sim.A.rowids == sim.A.indices)
    bump = diag_pos[:: max(1, len(diag_pos) // 17)][:17]
    data2[bump] *= 1.5              # SPD preserved
    A2 = CSR.from_pattern(sim.A.indptr, sim.A.indices, data2,
                          n_cols=sim.A.n_cols)

    fresh = FusedGMG(sim.gmg, A2, sim.forest, device=dev, dtype=jnp.float64,
                   use_dst=True)
    delta = FusedGMG(sim.gmg, A2, sim.forest, device=dev, dtype=jnp.float64,
                   use_dst=True, prev=prev)
    assert delta._sys_delta_rows is not None, "delta path not taken"
    assert 1 <= delta._sys_delta_rows <= len(bump)
    np.testing.assert_array_equal(np.asarray(delta.sys_cols),
                                  np.asarray(fresh.sys_cols))
    np.testing.assert_array_equal(np.asarray(delta.sys_vals),
                                  np.asarray(fresh.sys_vals))
    xf, kf, _, _ = fresh.solve(rhs, rtol=1e-8)
    xd, kd, _, _ = delta.solve(rhs, rtol=1e-8)
    assert kf == kd
    np.testing.assert_allclose(np.asarray(xd), np.asarray(xf),
                               rtol=1e-12, atol=1e-14)
