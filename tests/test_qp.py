"""Higher-degree (Q_p) FEM support — the reference's "Polynomial degree"
parameter (src/step-50.cc:80).

Correctness strategy: a Q_p space reproduces any tensor-degree-p polynomial
exactly on any conforming mesh, so solving the Poisson problem whose exact
solution is such a polynomial must give node-exact answers — on uniform
meshes (tables + assembly + CG), on adaptively refined meshes (generic
hanging-node constraints), and through the GMG hierarchy (generic
prolongation).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from coulomb_gmg.mesh.forest import Forest, node_offsets
from coulomb_gmg.fem.constraints import build_constraints, distribute
from coulomb_gmg.fem.assembly import build_plan, assemble_np
from coulomb_gmg.fem.integrals import stiffness_cells_np, rhs_cells_np
from coulomb_gmg.ops.q1 import element_tables, lap_basis_at
from coulomb_gmg.ops.spmv import CSR
from coulomb_gmg.solver.cg import cg


def _exact(dim):
    """u = prod_d x_d (1 - x_d): tensor-quadratic, zero on the unit-box
    boundary; f = -lap u."""
    def u(p):
        out = np.ones(len(p))
        for d in range(dim):
            out *= p[:, d] * (1.0 - p[:, d])
        return out

    def f(p):
        out = np.zeros(len(p))
        for g in range(dim):
            term = 2.0 * np.ones(len(p))
            for d in range(dim):
                if d != g:
                    term *= p[:, d] * (1.0 - p[:, d])
            out += term
        return out
    return u, f


def _solve_poisson(forest, degree, boundary_fn, f_fn):
    dofs = forest.dofs_of(degree)
    cons = build_constraints(dofs, boundary_fn)
    plan = build_plan(dofs.cell2dof, cons)
    tab = element_tables(forest.dim, degree, degree + 1)
    tab_rhs = element_tables(forest.dim, degree, degree + 2)
    h = forest.cell_h()
    lower = forest.cell_lower()
    pts = lower[:, None, :] + h[:, None, None] * tab_rhs.points[None]
    rho = f_fn(pts.reshape(-1, forest.dim)).reshape(forest.n_cells, -1)
    K = stiffness_cells_np(tab, h)
    Fv = rhs_cells_np(tab_rhs, h, rho)
    data, rhs = assemble_np(plan, K, Fv)
    A = CSR.from_pattern(plan.pattern.indptr, plan.pattern.indices,
                         jnp.asarray(data))
    inv_diag = 1.0 / A.diagonal()
    res = cg(A.matvec, jnp.asarray(rhs), precond=lambda r: inv_diag * r,
             tol=1e-12 * float(np.linalg.norm(rhs)), maxiter=2000)
    x = distribute(cons, np.asarray(res.x))
    return dofs, x


@pytest.mark.parametrize("dim,degree", [(2, 2), (3, 2), (2, 3)])
def test_uniform_qp_node_exact(dim, degree):
    u_fn, f_fn = _exact(dim)
    forest = Forest.uniform(dim, 4, np.zeros(dim), 0.25)
    dofs, x = _solve_poisson(forest, degree, None, f_fn)
    exact = u_fn(dofs.positions)
    assert np.abs(x - exact).max() < 1e-10


@pytest.mark.parametrize("dim", [2, 3])
def test_adaptive_qp_hanging_nodes_exact(dim):
    """Refine an off-center block twice -> hanging nodes at two levels; a
    tensor-quadratic solution must still be reproduced node-exactly, which
    pins down the generic Q_p hanging-node constraints."""
    degree = 2
    u_fn, f_fn = _exact(dim)
    forest = Forest.uniform(dim, 4, np.zeros(dim), 0.25)
    flags = np.zeros(forest.n_cells, dtype=bool)
    flags[0] = True
    flags[len(flags) // 2] = True
    forest = forest.refine(flags)
    flags = np.zeros(forest.n_cells, dtype=bool)
    flags[3] = True
    forest = forest.refine(flags)
    assert forest.n_levels == 3
    dofs = forest.dofs_of(degree)
    assert len(dofs.hanging_pairs[0]) > 0, "no hanging nodes in test setup"
    dofs, x = _solve_poisson(forest, degree, lambda p: u_fn(p), f_fn)
    exact = u_fn(dofs.positions)
    assert np.abs(x - exact).max() < 1e-9


def test_qp_hanging_interpolation_consistency():
    """The resolved hanging constraints must be satisfied identically by the
    node-interpolant of any tensor-quadratic function (conformity)."""
    dim, degree = 3, 2
    forest = Forest.uniform(dim, 2, np.zeros(dim), 0.5)
    flags = np.zeros(forest.n_cells, dtype=bool)
    flags[0] = True
    forest = forest.refine(flags)
    dofs = forest.dofs_of(degree)
    cons = build_constraints(dofs, None, include_boundary=False)
    p = dofs.positions
    g = (1.0 + p[:, 0]) * (2.0 - p[:, 1] ** 2) * (0.5 + p[:, 2] + p[:, 2] ** 2)
    for k, row in enumerate(cons.rows):
        s, e = cons.indptr[k], cons.indptr[k + 1]
        val = np.dot(cons.weights[s:e], g[cons.cols[s:e]])
        assert abs(val - g[row]) < 1e-10


def test_q1_unchanged_by_generalization():
    """Q1 dof enumeration/keys/hanging weights must be bit-identical to the
    historical vertex-lattice scheme (the golden suite depends on it)."""
    forest = Forest.uniform(3, 3, np.zeros(3), 1.0 / 3.0)
    flags = np.zeros(forest.n_cells, dtype=bool)
    flags[0] = True
    forest = forest.refine(flags)
    d1 = forest.dofs_of(1)
    assert d1.degree == 1
    # vertex keys == node keys at degree 1
    assert np.array_equal(d1.keys, np.sort(np.unique(
        forest.cell_corner_keys().reshape(-1))))
    rows, cols, w = d1.hanging_pairs
    assert set(np.round(np.unique(w), 10)) <= {0.25, 0.5}


def test_gmg_qp_prolongation():
    """Generic Q2 prolongation: a tensor-quadratic coarse-level function
    prolongates exactly to the fine level."""
    from coulomb_gmg.solver.multigrid import build_prolongation
    dim, degree = 2, 2
    forest = Forest.hyper_cube(dim, 0.0, 1.0, 2)
    dofs = forest.dofs_of(degree)
    P = build_prolongation(forest, dofs, 1)
    lc, lf = dofs.levels[0], dofs.levels[1]
    pos_c = forest.node_position(forest.nkey_to_coords(lc.keys, degree), degree)
    pos_f = forest.node_position(forest.nkey_to_coords(lf.keys, degree), degree)
    g = lambda p: (1 + p[:, 0] + 3 * p[:, 0] ** 2) * (2 - p[:, 1] ** 2)
    coarse = jnp.asarray(g(pos_c))
    from coulomb_gmg.ops.spmv import csr_matvec
    fine = np.asarray(csr_matvec(P.rowids, P.indices, P.data, coarse,
                                 P.n_rows))
    assert np.abs(fine - g(pos_f)).max() < 1e-10


def test_step16_driver_degree2_smoke():
    """Driver end-to-end with Polynomial degree = 2 (Step16 2D, 2 cycles)."""
    from coulomb_gmg.config import Config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.utils.logging import Pcout
    cfg = Config(problem="Step16", dim=2, degree=2, n_global_refinements=2,
                 n_adaptive_cycles=2, preconditioner="GMG",
                 boundary_conditions="Homogeneous", flag_output_time=False)
    sim = Simulation(cfg, pcout=Pcout(enabled=False))
    results = sim.run()
    assert len(results) == 2
    for r in results:
        assert r["cg_iterations"] <= 25
    # dofs of a Q2 space on the (refined) mesh exceed the Q1 count
    assert results[0]["n_dofs"] > (2 ** 2 + 1) ** 2
