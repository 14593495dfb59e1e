"""Coarsening machinery parity (mesh/forest.py:Forest.coarsen +
adapt/transfer.py coarsen_*): the coarsening half of deal.II's
``execute_coarsening_and_refinement`` + ``SolutionTransfer`` / p4est
attach (src/step-50.cc:1104-1111) — the reference app never flags it,
so this pins the MACHINERY, not app behavior."""

import numpy as np
import pytest

from coulomb_gmg.mesh.forest import Forest, corner_offsets
from coulomb_gmg.adapt.transfer import (coarsen_map, coarsen_solution,
                                        coarsen_cell_mask)


def _cells_set(f):
    return set(zip(f.level.tolist(), map(tuple, f.ijk.tolist())))


def test_refine_coarsen_roundtrip():
    """Coarsening every child group of a refinement restores the mesh."""
    rng = np.random.default_rng(5)
    f0 = Forest.uniform(3, 4, np.zeros(3), 0.25)
    flags = rng.random(f0.n_cells) < 0.2
    f1 = f0.refine(flags, balance=False)
    cflags = f1.level > 0
    f2 = f1.coarsen(cflags)
    assert _cells_set(f2) == _cells_set(f0)


def test_incomplete_sibling_group_not_coarsened():
    f0 = Forest.uniform(2, 2, np.zeros(2), 0.5)
    f1 = f0.refine(np.array([True, False, False, False]))
    # flag only 3 of the 4 children: group incomplete -> unchanged
    flags = np.zeros(f1.n_cells, bool)
    children = np.where(f1.level == 1)[0]
    flags[children[:3]] = True
    f2 = f1.coarsen(flags)
    assert _cells_set(f2) == _cells_set(f1)


def test_coarsen_preserves_two_to_one_balance():
    """A group whose parent would touch a remaining level+2 cell is
    dropped (deal.II flag cleanup)."""
    f0 = Forest.uniform(2, 4, np.zeros(2), 0.25)
    # refine one cell twice -> levels 0..2 with 2:1 balance cascades
    f1 = f0.refine(np.arange(f0.n_cells) == 0)
    f2 = f1.refine(f1.level == 1)          # all level-1 children -> level 2
    # try to coarsen every level-1 cell (the balance cascade cells):
    # groups adjacent to level-2 cells must be dropped
    flags = f2.level == 1
    f3 = f2.coarsen(flags)
    # invariant: closure-adjacent active cells differ by <= 1 level
    lvl = f3.level.astype(np.int64)
    for i in range(f3.n_cells):
        li = int(lvl[i])
        lo_i = f3.ijk[i] * (1 << (f3.max_level - li))
        hi_i = (f3.ijk[i] + 1) * (1 << (f3.max_level - li))
        for j in range(f3.n_cells):
            lj = int(lvl[j])
            if abs(li - lj) <= 1:
                continue
            lo_j = f3.ijk[j] * (1 << (f3.max_level - lj))
            hi_j = (f3.ijk[j] + 1) * (1 << (f3.max_level - lj))
            touching = np.all(np.maximum(lo_i, lo_j)
                              <= np.minimum(hi_i, hi_j))
            assert not touching, (i, j, li, lj)


@pytest.mark.parametrize("degree", [1, 2])
def test_coarsen_solution_exact_for_polynomial(degree):
    """Q_degree nodal injection: a (multi-)linear field survives
    coarsening exactly (deal.II SolutionTransfer interpolation)."""
    rng = np.random.default_rng(9)
    f0 = Forest.uniform(3, 3, np.zeros(3), 1.0 / 3)
    f1 = f0.refine(rng.random(f0.n_cells) < 0.3)
    dofs1 = f1.dofs_of(degree)
    pos = dofs1.positions if degree == 1 else f1.node_position(
        f1.nkey_to_coords(dofs1.keys, degree), degree)
    fn = lambda p: 2.0 * p[:, 0] - 0.7 * p[:, 1] + 0.3 * p[:, 2] + 1.0
    u1 = fn(np.asarray(pos))
    f2 = f1.coarsen(f1.level > 0)
    u2 = coarsen_solution(f1, f2, u1, degree=degree)
    dofs2 = f2.dofs_of(degree)
    pos2 = f2.node_position(f2.nkey_to_coords(dofs2.keys, degree), degree)
    np.testing.assert_allclose(u2, fn(np.asarray(pos2)), rtol=1e-12)


def test_coarsen_cell_mask_union():
    f0 = Forest.uniform(2, 2, np.zeros(2), 0.5)
    f1 = f0.refine(np.array([True, False, False, False]))
    surv, mnew, mch = coarsen_map(f1, f1.coarsen(f1.level > 0))
    # dense mask: children carry disjoint atoms; parent = union
    n_atoms = 5
    mask1 = np.zeros((f1.n_cells, n_atoms), bool)
    children = np.where(f1.level == 1)[0]
    for k, c in enumerate(children):
        mask1[c, k] = True
    others = np.where(f1.level == 0)[0]
    mask1[others, 4] = True
    f2 = f1.coarsen(f1.level > 0)
    mask2 = coarsen_cell_mask(f1, f2, mask1)
    assert mask2.shape[0] == f2.n_cells
    surv, mnew, mch = coarsen_map(f1, f2)
    assert len(mnew) == 1
    assert mask2[mnew[0]].tolist() == [True, True, True, True, False]
    ok = surv >= 0
    np.testing.assert_array_equal(mask2[ok], mask1[surv[ok]])
    # padded lists: union with -1 padding
    lists1 = np.full((f1.n_cells, 2), -1, np.int32)
    for k, c in enumerate(children):
        lists1[c, 0] = k
    lists2 = coarsen_cell_mask(f1, f2, lists1)
    got = set(lists2[mnew[0]].tolist()) - {-1}
    assert got == {0, 1, 2, 3}
