"""Mesh/DoF layer pinned to the reference's golden counts.

Oracles: tests/gaussian-charges.mpirun=1.output (44^3 base mesh, 91125 DoFs)
and tests/step-16.mpirun=1.output (hyper_cube + refine_global hierarchy
8/27/125/729/4913 DoFs by level).
"""

import numpy as np

from coulomb_gmg.mesh.forest import Forest


def test_uniform_counts_golden_gaussian():
    # golden config: domain [0,1], h=0.25 -> a=0.5, N=2, M=10 vacuum reps
    # -> repetitions 2*(N+2M)=44 (src/step-50.cc:1504-1526)
    a = 2 * 0.25
    N = (1.0 - 0.0) / a
    M = 10
    reps = int(2 * (N + 2 * M))
    assert reps == 44
    f = Forest.uniform(3, reps, np.full(3, 0.0 - M * a), 0.25)
    assert f.n_cells == 85184            # 44^3, golden cycle 0
    assert f.dofs.n_dofs == 91125        # 45^3
    assert f.n_levels == 1
    assert f.dofs.levels[0].n_dofs == 91125
    assert not f.dofs.levels[0].interface.any()
    assert f.dofs.boundary.sum() == 45 ** 3 - 43 ** 3


def test_hyper_cube_hierarchy_step16():
    # step-16 3D: hyper_cube + refine_global(4): levels keep 1,8,64,512,4096
    # cells -> DoFs by level 8, 27, 125, 729, 4913 (step-16.mpirun=1.output:5)
    f = Forest.hyper_cube(3, -1.0, 1.0, 4)
    assert f.n_cells == 4096
    assert f.dofs.n_dofs == 4913
    assert [ld.n_dofs for ld in f.dofs.levels] == [8, 27, 125, 729, 4913]
    assert all(not ld.interface.any() for ld in f.dofs.levels)


def test_refine_creates_children_and_levels():
    f = Forest.uniform(3, 4, np.zeros(3), 0.25)
    flags = np.zeros(f.n_cells, dtype=bool)
    flags[0] = True
    f2 = f.refine(flags)
    assert f2.n_cells == 64 - 1 + 8
    assert f2.n_levels == 2
    # level-1 mesh has exactly the 8 children -> 27 level dofs
    assert f2.dofs.levels[1].n_dofs == 27
    # new corner vertices: refined cell adds center/edge/face points
    assert f2.dofs.n_dofs == 125 + 19

    # hanging nodes: the refined cell sits at the domain corner -> 3 interior
    # faces and 3 interior edges of the coarse cell carry hanging vertices:
    rows, cols, w = f2.dofs.hanging_pairs
    hanging = np.unique(rows)
    # face centers: 3 (one per interior face), edge midpoints: 3 + 3*2 = 9?
    # count by construction: vertices of children strictly inside coarse
    # faces/edges of neighbors.  The refined cell's own new vertices on its
    # 3 faces shared with coarse neighbors hang: 3 face centers + 9 edge
    # midpoints on the shared boundary... just sanity check nonempty and
    # weights valid.
    assert len(hanging) > 0
    assert set(np.round(w, 6)) <= {0.25, 0.5}


def test_balance_cascade():
    # refine one cell twice; the 2:1 vertex balance must refine neighbors
    f = Forest.uniform(3, 4, np.zeros(3), 0.25)
    flags = np.zeros(f.n_cells, dtype=bool)
    flags[0] = True
    f2 = f.refine(flags)
    # refine the deepest corner child again
    flags2 = (f2.level == 1)
    # pick only the child at the origin corner
    sel = np.where(flags2 & (f2.ijk == 0).all(axis=1))[0]
    flags2 = np.zeros(f2.n_cells, dtype=bool)
    flags2[sel] = True
    f3 = f2.refine(flags2)
    # no active cells sharing a vertex may differ by > 1 level
    lvl = f3.level.astype(np.int64)
    L = int(lvl.max())
    s = 1 << (L - lvl)
    lo = f3.ijk * s[:, None]
    hi = lo + s[:, None]
    for i in range(f3.n_cells):
        touch = ((lo <= hi[i]) & (hi >= lo[i])).all(axis=1)
        assert np.abs(lvl[touch] - lvl[i]).max() <= 1


def test_canonical_order_deterministic():
    f = Forest.uniform(2, 3, np.zeros(2), 1.0)
    flags = np.zeros(f.n_cells, dtype=bool)
    flags[4] = True
    f2 = f.refine(flags)
    f3 = f.refine(flags)
    assert np.array_equal(f2.level, f3.level)
    assert np.array_equal(f2.ijk, f3.ijk)
