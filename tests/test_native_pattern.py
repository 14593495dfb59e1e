"""Native pattern engine (native/forest_engine.cpp:cgmg_pattern) vs the
pure-numpy fallback: identical CSR pattern and inverse positions, and the
assembled matrix matches a brute-force scipy assembly."""

import numpy as np
import pytest

from coulomb_gmg.utils import native


def _ref_pattern(c2d, er, ec, n):
    nb = c2d.shape[1] if c2d.size else 1
    ii = np.repeat(np.arange(nb), nb)
    jj = np.tile(np.arange(nb), nb)
    rows = np.concatenate([c2d[:, ii].reshape(-1), er])
    cols = np.concatenate([c2d[:, jj].reshape(-1), ec])
    keys = rows * np.int64(n) + cols
    uniq, inverse = np.unique(keys, return_inverse=True)
    rows_u = (uniq // n).astype(np.int64)
    indices = (uniq % n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows_u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, indices, inverse


@pytest.mark.parametrize("m,nb,k,n", [(0, 8, 7, 40), (5, 8, 0, 64),
                                      (700, 8, 311, 900),
                                      (9000, 8, 4001, 11000)])
def test_pattern_matches_numpy_reference(m, nb, k, n):
    rng = np.random.default_rng(m * 31 + k)
    c2d = rng.integers(0, n, size=(m, nb)).astype(np.int64)
    er = rng.integers(0, n, size=k).astype(np.int64)
    ec = rng.integers(0, n, size=k).astype(np.int64)
    got = native.pattern(c2d, er, ec, n)
    ref = _ref_pattern(c2d, er, ec, n)
    for g, r, name in zip(got, ref, ("indptr", "indices", "inverse")):
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.skipif(not native.available(), reason="no native engine")
def test_pattern_native_large_path():
    # force the native branch (total >= 2^15) and check CSR consistency
    rng = np.random.default_rng(0)
    n = 5000
    m = 1200                      # 1200*64 = 76800 pairs > 2^15
    c2d = rng.integers(0, n, size=(m, 8)).astype(np.int64)
    er = rng.integers(0, n, size=97).astype(np.int64)
    ec = rng.integers(0, n, size=97).astype(np.int64)
    indptr, indices, inverse = native.pattern(c2d, er, ec, n)
    ref = _ref_pattern(c2d, er, ec, n)
    np.testing.assert_array_equal(indptr, ref[0])
    np.testing.assert_array_equal(indices, ref[1])
    np.testing.assert_array_equal(inverse, ref[2])
    # every enumerated pair lands on its own (row, col) slot
    nb = 8
    ii = np.repeat(np.arange(nb), nb)
    jj = np.tile(np.arange(nb), nb)
    rows = np.concatenate([c2d[:, ii].reshape(-1), er])
    cols = np.concatenate([c2d[:, jj].reshape(-1), ec])
    rowid_of_pos = np.repeat(np.arange(n), np.diff(indptr))
    np.testing.assert_array_equal(rowid_of_pos[inverse], rows)
    np.testing.assert_array_equal(indices[inverse], cols)


def test_assembled_matrix_matches_scipy():
    import scipy.sparse as sp
    import jax
    jax.config.update("jax_enable_x64", True)
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.fem.constraints import build_constraints
    from coulomb_gmg.fem.assembly import build_plan, assemble_np
    from coulomb_gmg.fem.integrals import stiffness_cells_np
    from coulomb_gmg.ops.q1 import element_tables

    f0 = Forest.uniform(3, 6, np.zeros(3), 1.0 / 6)
    # refine a corner to create hanging nodes
    flags = np.zeros(f0.n_cells, bool)
    flags[:8] = True
    f = f0.refine(flags)
    dofs = f.dofs
    cons = build_constraints(dofs, None)
    plan = build_plan(dofs.cell2dof, cons)
    tab = element_tables(3, 1, 2)
    K = stiffness_cells_np(tab, f.cell_h())
    data, _ = assemble_np(plan, K)
    A = sp.csr_matrix((data, plan.pattern.indices, plan.pattern.indptr),
                      shape=(dofs.n_dofs, dofs.n_dofs))
    # brute force: expand constraints row by row
    crow = cons.row_of(dofs.cell2dof.reshape(-1)).reshape(dofs.cell2dof.shape)
    B = sp.lil_matrix((dofs.n_dofs, dofs.n_dofs))
    for c in range(f.n_cells):
        for i in range(8):
            gi = dofs.cell2dof[c, i]
            ri = crow[c, i]
            exp_i = ([(gi, 1.0)] if ri < 0 else
                     [(cons.cols[p], cons.weights[p])
                      for p in range(cons.indptr[ri], cons.indptr[ri + 1])])
            for j in range(8):
                gj = dofs.cell2dof[c, j]
                rj = crow[c, j]
                exp_j = ([(gj, 1.0)] if rj < 0 else
                         [(cons.cols[p], cons.weights[p])
                          for p in range(cons.indptr[rj],
                                         cons.indptr[rj + 1])])
                for di, wi in exp_i:
                    for dj, wj in exp_j:
                        B[di, dj] += wi * wj * K[c, i, j]
            if ri >= 0:
                B[gi, gi] += K[c, i, i]
    diff = abs(A - B.tocsr()).max()
    assert diff < 1e-12, diff


def test_scatter_add_matches_bincount():
    """Threaded native bincount vs numpy, above and below the size gate
    (the threaded sum reassociates float64 adds at slice boundaries —
    equality holds to 1e-12 relative, which the assembly docstring relies
    on)."""
    import numpy as np
    from coulomb_gmg.utils import native

    rng = np.random.default_rng(7)
    for n in (1 << 10, (1 << 18) + 123):
        pos = rng.integers(0, 5000, n)
        w = rng.standard_normal(n)
        ref = np.bincount(pos, weights=w, minlength=5000)
        got = native.scatter_add(pos, w, 5000)
        assert np.allclose(ref, got, rtol=1e-12, atol=1e-14)
        # accumulate-into-existing semantics
        base = rng.standard_normal(5000)
        got2 = native.scatter_add(pos, w, 5000, out=base.copy())
        assert np.allclose(base + ref, got2, rtol=1e-12, atol=1e-14)


def test_gather_blocks_matches_fancy_indexing():
    import numpy as np
    from coulomb_gmg.utils import native

    rng = np.random.default_rng(8)
    src = rng.standard_normal((40000, 8, 8))      # above the 1<<20 gate
    idx = rng.integers(0, 40000, 30000)
    assert np.array_equal(native.gather_blocks(src, idx), src[idx])
    small = rng.standard_normal((10, 3))          # below the gate
    assert np.array_equal(native.gather_blocks(small, np.array([2, 9, 0])),
                          small[[2, 9, 0]])


def test_gather_rows_any_dtype():
    import numpy as np
    from coulomb_gmg.utils import native

    rng = np.random.default_rng(9)
    for dtype, shape in ((np.int32, (300000, 8)), (bool, (200000, 16)),
                         (np.float32, (5, 3))):
        src = rng.integers(0, 2, size=shape).astype(dtype) \
            if dtype is bool else \
            rng.integers(-100, 100, size=shape).astype(dtype)
        idx = rng.integers(0, shape[0], shape[0] // 2)
        assert np.array_equal(native.gather_rows(src, idx), src[idx])


def test_csr_to_ell_matches_from_coo():
    import numpy as np
    import scipy.sparse as sp
    from coulomb_gmg.ops.ell import ELL

    rng = np.random.default_rng(11)
    for n, dt in ((2000, np.float64), (300000, np.float32)):
        counts = rng.integers(0, 24, n)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        nnz = int(indptr[-1])
        indices = rng.integers(0, n, nnz)
        data = rng.standard_normal(nnz).astype(dt)
        # padding slots must be distinguishable from real zeros
        data[data == 0.0] = 1.0
        A = sp.csr_matrix((data, indices, indptr), shape=(n, n))
        A.sum_duplicates()
        e = ELL.from_csr(A.indptr, A.indices, A.data, pad_rows_to=n + 7)
        rowids = np.repeat(np.arange(n), np.diff(A.indptr))
        ref = ELL.from_coo(rowids, A.indices, A.data, n,
                           pad_rows_to=n + 7, pad_k_to=e.K)
        assert e.K == ref.K and e.n_rows == ref.n_rows
        assert np.array_equal(e.cols, ref.cols)
        assert np.array_equal(e.vals, ref.vals)
