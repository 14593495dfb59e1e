"""Refinement state-migration tests: the analogue of the reference's
``tests/cell_data_transfer_test.cc`` (per-cell atom lists survive
refinement with children inheriting the parent's set) plus solution
interpolation exactness."""

import numpy as np

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.adapt.transfer import (
    old_cell_of_new, transfer_solution, transfer_cell_mask)


def _refined_pair():
    f = Forest.uniform(3, 4, np.zeros(3), 0.25)
    flags = np.zeros(f.n_cells, dtype=bool)
    flags[[0, 13, 37]] = True
    return f, f.refine(flags)


def test_children_inherit_parent_mask():
    old, new = _refined_pair()
    rng = np.random.default_rng(0)
    mask_old = rng.random((old.n_cells, 5)) < 0.3
    mask_new = transfer_cell_mask(old, new, mask_old)
    omap = old_cell_of_new(old, new)
    assert mask_new.shape == (new.n_cells, 5)
    for i in range(new.n_cells):
        assert np.array_equal(mask_new[i], mask_old[omap[i]])
    # unchanged cells map to themselves: count of new cells per old parent
    refined_parents = np.unique(omap[new.level > old.level[omap]])
    assert len(refined_parents) == 3
    for p in refined_parents:
        assert (omap == p).sum() == 8      # 8 children each


def test_solution_transfer_exact_for_linear_fields():
    """Q1 interpolation reproduces any trilinear field exactly across
    refinement (SolutionTransfer contract, src/step-50.cc:1103-1118)."""
    old, new = _refined_pair()
    pos_old = old.dofs.positions
    u_old = 1.0 + 2.0 * pos_old[:, 0] - 3.0 * pos_old[:, 1] + 0.5 * pos_old[:, 2]
    u_new = transfer_solution(old, new, u_old)
    pos_new = new.dofs.positions
    expect = 1.0 + 2.0 * pos_new[:, 0] - 3.0 * pos_new[:, 1] + 0.5 * pos_new[:, 2]
    assert np.allclose(u_new, expect, atol=1e-12)


def test_solution_transfer_copies_unchanged_cells():
    old, new = _refined_pair()
    rng = np.random.default_rng(1)
    u_old = rng.standard_normal(old.dofs.n_dofs)
    u_new = transfer_solution(old, new, u_old)
    # every new dof that coincides with an old vertex keeps its nodal value
    # (interpolation of the continuous FE field at a shared vertex)
    old_by_pos = {tuple(np.round(p, 9)): v
                  for p, v in zip(old.dofs.positions, u_old)}
    hits = 0
    for p, v in zip(new.dofs.positions, u_new):
        key = tuple(np.round(p, 9))
        if key in old_by_pos:
            assert np.isclose(v, old_by_pos[key], atol=1e-12)
            hits += 1
    assert hits == old.dofs.n_dofs   # all old vertices persist (refine-only)
