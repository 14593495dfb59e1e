"""Device-built (stencil) level operators vs the host-assembled oracle.

The chip-resident operator path (ops/stencil.py) must reproduce the host
assembly (solver/multigrid.py:build_gmg) EXACTLY: level matrices with
eliminated rows (src/step-50.cc:853-864), interface matrices
(src/step-50.cc:896-920), and Q1 prolongations (MGTransferPrebuilt,
src/step-50.cc:957-958).  Runs the jnp device code on CPU in float64 and
compares matvecs entry-for-entry against the assembled CSRs.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.ops.q1 import element_tables
from coulomb_gmg.ops.stencil import (
    stencil_table, level_topology, build_level_ops, build_prolongation_ops,
    offset3)
from coulomb_gmg.solver.multigrid import build_gmg


def _adaptive_forest(dim, reps=6, cycles=2, seed=0):
    f = Forest.uniform(dim, reps, np.zeros(dim), 1.0 / reps)
    rng = np.random.default_rng(seed)
    for _ in range(cycles):
        lower = f.cell_lower() + 0.5 * f.cell_h()[:, None]
        r = np.linalg.norm(lower - 0.4, axis=1)
        flags = r < 0.3 + 0.05 * rng.standard_normal(f.n_cells)
        f = f.refine(flags)
    return f


def _ell_mv(cols, vals, x):
    # device ops return TRANSPOSED (K, n) ELLs (CLAUDE.md r5 gather note)
    return np.sum(np.asarray(vals) * np.asarray(x)[np.asarray(cols)], axis=0)


@pytest.mark.parametrize("dim", [2, 3])
def test_stencil_matches_host_assembly(dim):
    f = _adaptive_forest(dim)
    dofs = f.dofs_of(1)
    tab = element_tables(dim, 1, 2)
    gmg = build_gmg(f, dofs, tab, smoother="none", dtype=jnp.float64)
    T = jnp.asarray(stencil_table(dim, tab))
    rng = np.random.default_rng(1)

    saw_iface = False
    for l, ld in enumerate(dofs.levels):
        t = level_topology(f, ld, l)
        out = build_level_ops(
            jnp.asarray(t.coords), jnp.asarray(t.mask8),
            jnp.asarray(t.elim), jnp.asarray(t.iface),
            jnp.asarray(t.boundary), t.n, T, dim=dim, side=t.side,
            h=t.h, want_iface=True, np_dtype=jnp.float64)
        cols, evals, inv_diag, if_vals, ifT_vals = out
        x = rng.standard_normal(ld.n_dofs)

        A = gmg.matrices[l]
        y_ref = np.zeros(ld.n_dofs)
        np.add.at(y_ref, A.rowids, np.asarray(A.data) * x[A.indices])
        y_dev = _ell_mv(cols, evals, x)
        np.testing.assert_allclose(y_dev, y_ref, rtol=1e-12, atol=1e-12)

        # inverse diagonal (smoother input)
        diag = np.zeros(ld.n_dofs)
        sel = A.rowids == A.indices
        np.add.at(diag, A.rowids[sel], np.asarray(A.data)[sel])
        diag[diag == 0] = 1.0
        np.testing.assert_allclose(np.asarray(inv_diag), 1.0 / diag,
                                   rtol=1e-12)

        I = gmg.interfaces[l]
        if I is not None:
            saw_iface = True
            yi_ref = np.zeros(ld.n_dofs)
            np.add.at(yi_ref, I.rowids, np.asarray(I.data) * x[I.indices])
            np.testing.assert_allclose(_ell_mv(cols, if_vals, x), yi_ref,
                                       rtol=1e-12, atol=1e-12)
            # transpose: I^T x
            yt_ref = np.zeros(ld.n_dofs)
            np.add.at(yt_ref, np.asarray(I.indices),
                      np.asarray(I.data) * x[I.rowids])
            np.testing.assert_allclose(_ell_mv(cols, ifT_vals, x), yt_ref,
                                       rtol=1e-12, atol=1e-12)
        else:
            assert not np.asarray(if_vals).any()

        if l > 0:
            lc = dofs.levels[l - 1]
            tc = level_topology(f, lc, l - 1)
            p_cols, p_vals, r_cols, r_vals = build_prolongation_ops(
                jnp.asarray(t.coords), t.n, jnp.asarray(tc.coords), tc.n,
                dim=dim, side_c=tc.side, np_dtype=jnp.float64)
            P = gmg.prolongations[l]
            xc = rng.standard_normal(lc.n_dofs)
            yp_ref = np.zeros(ld.n_dofs)
            np.add.at(yp_ref, P.rowids, np.asarray(P.data) * xc[P.indices])
            np.testing.assert_allclose(_ell_mv(p_cols, p_vals, xc), yp_ref,
                                       rtol=1e-12, atol=1e-12)
            # restriction = P^T
            yr_ref = np.zeros(lc.n_dofs)
            np.add.at(yr_ref, np.asarray(P.indices),
                      np.asarray(P.data) * x[P.rowids])
            np.testing.assert_allclose(_ell_mv(r_cols, r_vals, x), yr_ref,
                                       rtol=1e-12, atol=1e-12)
    assert saw_iface, "test mesh must exercise refinement edges"


def test_stencil_table_row_sums():
    # constant function lies in the kernel of the Laplacian stencil away
    # from elimination: full-mask rows sum to zero
    for dim in (2, 3):
        tab = element_tables(dim, 1, 2)
        T = stencil_table(dim, tab)
        full = T[(1 << (2 ** dim)) - 1]
        assert abs(full.sum()) < 1e-12
        center = (3 ** dim - 1) // 2
        assert full[center] > 0


def test_padding_rows_are_inert():
    dim = 3
    f = _adaptive_forest(dim, reps=4, cycles=1)
    dofs = f.dofs_of(1)
    tab = element_tables(dim, 1, 2)
    T = jnp.asarray(stencil_table(dim, tab))
    l = len(dofs.levels) - 1
    ld = dofs.levels[l]
    t = level_topology(f, ld, l)
    pad = 37
    n_pad = t.n + pad
    coords = np.vstack([t.coords,
                        np.full((pad, dim), t.side + 1, t.coords.dtype)])
    z8 = np.concatenate([t.mask8, np.zeros(pad, np.uint8)])
    bl = lambda a: np.concatenate([a, np.zeros(pad, bool)])
    cols, evals, inv_diag, if_vals, ifT_vals = build_level_ops(
        jnp.asarray(coords), jnp.asarray(z8), jnp.asarray(bl(t.elim)),
        jnp.asarray(bl(t.iface)), jnp.asarray(bl(t.boundary)), t.n, T,
        dim=dim, side=t.side, h=t.h, want_iface=True, np_dtype=jnp.float64)
    assert not np.asarray(evals)[:, t.n:].any()
    assert not np.asarray(if_vals)[:, t.n:].any()
    assert (np.asarray(cols) < n_pad).all() and (np.asarray(cols) >= 0).all()
    # real rows unchanged vs unpadded build
    cols0, evals0, *_ = build_level_ops(
        jnp.asarray(t.coords), jnp.asarray(t.mask8), jnp.asarray(t.elim),
        jnp.asarray(t.iface), jnp.asarray(t.boundary), t.n, T, dim=dim,
        side=t.side, h=t.h, want_iface=True, np_dtype=jnp.float64)
    x = np.random.default_rng(2).standard_normal(n_pad)
    np.testing.assert_allclose(
        _ell_mv(cols, evals, x)[: t.n],
        _ell_mv(cols0, evals0, x[: t.n]), rtol=1e-12, atol=1e-12)
