"""DoF enumeration, hanging-node constraints, and level (multigrid) DoFs.

JAX replacement for deal.II's ``DoFHandler::distribute_dofs`` /
``distribute_mg_dofs`` / ``make_hanging_node_constraints`` /
``MGConstrainedDoFs`` stack (``src/step-50.cc:650-731``).  Global DoF ids are
the sort order of finest-lattice vertex keys — deterministic and independent
of traversal, so all reductions (norms, counts) are partition invariant.

Supports arbitrary polynomial degree (the reference's "Polynomial degree"
parameter, ``src/step-50.cc:80``): Q_p dofs are points of the node lattice
(the finest cell lattice subdivided p times per axis), hanging constraints
interpolate through the coarse side's face/edge Lagrange basis, and every
multigrid level carries its own Q_p node set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from coulomb_gmg.mesh.forest import (Forest, KeyIndex, corner_offsets,
                                     node_offsets)


@dataclass
class Constraints:
    """Resolved affine constraints ``x_c = sum_j w_j x_j + g_c``.

    CSR layout over the *constrained* dofs only.  After resolution, all
    referenced columns are unconstrained dofs (chains eliminated, like
    ``ConstraintMatrix::close()``).
    """

    rows: np.ndarray       # (n_constrained,) global dof ids, sorted
    indptr: np.ndarray     # (n_constrained + 1,)
    cols: np.ndarray       # (nnz,) global dof ids (unconstrained)
    weights: np.ndarray    # (nnz,)
    inhomog: np.ndarray    # (n_constrained,) g_c
    n_dofs: int

    @property
    def is_constrained(self) -> np.ndarray:
        mask = np.zeros(self.n_dofs, dtype=bool)
        mask[self.rows] = True
        return mask

    def row_of(self, dofs: np.ndarray) -> np.ndarray:
        """Index into `rows` for each dof (-1 if unconstrained)."""
        pos = np.searchsorted(self.rows, dofs)
        pos = np.clip(pos, 0, max(len(self.rows) - 1, 0))
        if len(self.rows) == 0:
            return np.full(np.shape(dofs), -1, dtype=np.int64)
        hit = self.rows[pos] == dofs
        return np.where(hit, pos, -1)


@dataclass
class LevelDofs:
    """DoFs of the level-l mesh (all tree cells at level l)."""

    level: int
    keys: np.ndarray            # sorted unique node-lattice keys
    cell2dof: np.ndarray        # (n_level_cells, (p+1)^dim) level-dof ids
    active_index: np.ndarray    # (n_level_cells,) active cell id or -1
    boundary: np.ndarray        # (n_dofs,) bool: on domain boundary
    interface: np.ndarray       # (n_dofs,) bool: on refinement edge
    n_dofs: int
    degree: int = 1


@dataclass
class DofInfo:
    forest: Forest
    keys: np.ndarray            # sorted unique node keys -> global dof id
    cell2dof: np.ndarray        # (n_cells, (p+1)^dim) int64
    boundary: np.ndarray        # (n_dofs,) bool
    positions: np.ndarray       # (n_dofs, dim) float64
    levels: List[LevelDofs]
    hanging_pairs: tuple        # raw (rows, cols(list), weights) pre-resolution
    degree: int = 1

    @property
    def n_dofs(self) -> int:
        return len(self.keys)


def _cell_node_keys(forest: Forest, degree: int) -> np.ndarray:
    """(n_cells, (p+1)^dim) node-lattice keys of active cells, in the
    element-table basis order."""
    s = (1 << (forest.max_level - forest.level.astype(np.int64)))
    off = node_offsets(forest.dim, degree)
    # node coord = cell base (fine lattice) * degree + offset * cell size
    nodes = (forest.ijk[:, None, :] * np.int64(degree)
             + off[None, :, :]) * s[:, None, None]
    return forest.nkey(nodes, degree)


def build_dofs(forest: Forest, degree: int = 1) -> DofInfo:
    from coulomb_gmg.utils import native
    dim = forest.dim
    ckeys = _cell_node_keys(forest, degree)
    uniq, inverse = native.sort_unique_inverse(ckeys.reshape(-1))
    kidx = KeyIndex.__new__(KeyIndex)
    kidx.keys = uniq
    cell2dof = inverse.reshape(ckeys.shape)
    coords = forest.nkey_to_coords(kidx.keys, degree)
    S = forest.fine_side * degree
    boundary = ((coords == 0) | (coords == S)).any(axis=1)
    positions = forest.node_position(coords, degree)

    hanging = _find_hanging(forest, kidx, degree)

    levels = [_build_level(forest, l, degree) for l in range(forest.n_levels)]

    return DofInfo(forest=forest, keys=kidx.keys, cell2dof=cell2dof,
                   boundary=boundary, positions=positions, levels=levels,
                   hanging_pairs=hanging, degree=degree)


# ------------------------------------------------------------ hanging nodes

def _find_hanging(forest: Forest, kidx: KeyIndex, degree: int = 1):
    """Hanging node detection for Q_degree.

    With 2:1 vertex balance, a dof hangs iff it lies on a face (3D also:
    edge) of a coarser active cell at a position that is a node of the FINE
    side's lattice (spacing s/2 in node units for a coarse cell of node
    spacing s) but not a node of the coarse cell itself.  Its constraint is
    interpolation through the coarse cell's facet Lagrange basis: 1D basis
    of the p+1 edge nodes for edge points, tensor-product 2D basis of the
    (p+1)^2 face nodes for face-interior points — deal.II
    ``make_hanging_node_constraints`` semantics.  Q1 reduces to the classic
    1/2-1/2 edge-midpoint and 1/4 face-center weights.

    Returns flat triples (rows, cols, weights) over kidx positions.
    Chains are resolved later against Dirichlet data in
    ``fem.constraints.build_constraints``.
    """
    from coulomb_gmg.ops.q1 import lagrange_nodes_1d, _lagrange_eval

    dim = forest.dim
    p = degree
    L = forest.max_level
    lvl = forest.level.astype(np.int64)
    coarse = np.where(lvl < L)[0]   # only these can have finer face neighbors
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    if len(coarse) == 0:
        return empty
    s = (1 << (L - lvl[coarse]))                   # fine-lattice cell size
    base = forest.ijk[coarse] * np.int64(p) * s[:, None]   # node-lattice base
    # cell size in node units = s*p; own node spacing = s; candidate (fine
    # side) spacing = s//2 — integer because lvl < L.
    nodes1 = lagrange_nodes_1d(p)
    tgrid = np.arange(1, 2 * p) / (2.0 * p)        # candidate fractions
    lag = _lagrange_eval(nodes1, tgrid)[0]         # (2p-1, p+1) basis values

    rows_list, cols_list, w_list = [], [], []

    def _emit(cand_keys, col_keys, w):
        """cand_keys (m,), col_keys (m, k), w (k,): keep candidates present
        in the dof set."""
        present = kidx.contains(cand_keys)
        if not present.any():
            return
        rows_list.append(cand_keys[present])
        cols_list.append(col_keys[present])
        w_list.append(np.asarray(w))

    def _edge(axis, fixed):
        """Edge along `axis` with the other axes fixed at 0 or cell-size;
        fixed: {other_axis: 0|1}."""
        e_base = base.copy()
        for d, sidev in fixed.items():
            e_base[:, d] += sidev * s * p
        # candidate points at odd multiples of s/2 along the edge
        for k in range(1, 2 * p, 2):
            cand = e_base.copy()
            cand[:, axis] += k * (s // 2)
            cols = []
            for j in range(p + 1):
                c = e_base.copy()
                c[:, axis] += j * s
                cols.append(forest.nkey(c, p))
            _emit(forest.nkey(cand, p), np.stack(cols, axis=1),
                  lag[k - 1])   # tgrid index of k/(2p) is k-1

    def _face(axis, sidev, o1, o2):
        f_base = base.copy()
        f_base[:, axis] += sidev * s * p
        for k1 in range(1, 2 * p):
            for k2 in range(1, 2 * p):
                if k1 % 2 == 0 and k2 % 2 == 0:
                    continue   # coarse node (or edge-interior coarse node)
                cand = f_base.copy()
                cand[:, o1] += k1 * (s // 2)
                cand[:, o2] += k2 * (s // 2)
                cols, w = [], []
                for j1 in range(p + 1):
                    for j2 in range(p + 1):
                        c = f_base.copy()
                        c[:, o1] += j1 * s
                        c[:, o2] += j2 * s
                        cols.append(forest.nkey(c, p))
                        w.append(lag[k1 - 1, j1] * lag[k2 - 1, j2])
                _emit(forest.nkey(cand, p), np.stack(cols, axis=1),
                      np.asarray(w))

    if dim == 2:
        for axis in range(2):
            o = 1 - axis
            for sidev in (0, 1):
                _edge(axis, {o: sidev})
    else:
        for axis in range(3):
            o1, o2 = [d for d in range(3) if d != axis]
            for s1 in (0, 1):
                for s2 in (0, 1):
                    _edge(axis, {o1: s1, o2: s2})
        for axis in range(3):
            o1, o2 = [d for d in range(3) if d != axis]
            for sidev in (0, 1):
                _face(axis, sidev, o1, o2)

    if not rows_list:
        return empty
    # flatten to per-row variable-width: keep as (rows, cols, w) triples
    rows = np.concatenate([np.repeat(kidx.lookup(r), c.shape[1])
                           for r, c in zip(rows_list, cols_list)])
    cols = np.concatenate([kidx.lookup(c).reshape(-1) for c in cols_list])
    wts = np.concatenate([np.repeat(w[None, :], len(r), axis=0).reshape(-1)
                          for r, w in zip(rows_list, w_list)])
    # drop zero weights (a facet-basis value can vanish at a candidate) and
    # columns that are themselves hanging at the SAME position class are
    # impossible by construction (cols are coarse facet nodes).
    nz = wts != 0.0
    rows, cols, wts = rows[nz], cols[nz], wts[nz]
    # dedupe identical (row, col) pairs (the same point is emitted by every
    # coarse cell sharing the edge/face) — weights agree, keep first.
    pair = rows * np.int64(len(kidx)) + cols
    _, first = np.unique(pair, return_index=True)
    return rows[first], cols[first], wts[first]


def restrict_to_vertices(forest: Forest, dofs_p: DofInfo,
                         u: np.ndarray) -> np.ndarray:
    """Vertex-subset view of a Q_p dof vector as a Q1 dof vector (VTU and
    other vertex-based output paths stay Q1)."""
    if dofs_p.degree == 1:
        return np.asarray(u)
    q1 = forest.dofs
    coords = forest.vkey_to_coords(q1.keys)
    pk = forest.nkey(coords * np.int64(dofs_p.degree), dofs_p.degree)
    pos = np.searchsorted(dofs_p.keys, pk)
    assert (dofs_p.keys[pos] == pk).all(), "vertex missing from Q_p node set"
    return np.asarray(u)[pos]


# -------------------------------------------------------------- level dofs

def _build_level(forest: Forest, l: int, degree: int = 1) -> LevelDofs:
    from coulomb_gmg.utils import native
    dim = forest.dim
    p = degree
    level_ijk, active_index = forest.level_cells[l]
    s = 1 << (forest.max_level - l)
    off = node_offsets(dim, p)
    nodes = (level_ijk[:, None, :] * np.int64(p) + off[None, :, :]) * s
    keys = forest.nkey(nodes, p)
    uniq, inverse = native.sort_unique_inverse(keys.reshape(-1))
    kidx = KeyIndex.__new__(KeyIndex)
    kidx.keys = uniq
    cell2dof = inverse.reshape(keys.shape)
    coords = forest.nkey_to_coords(kidx.keys, p)
    S = forest.fine_side * p
    boundary = ((coords == 0) | (coords == S)).any(axis=1)

    # refinement-edge (interface) dofs: dofs on faces of level-l cells whose
    # face neighbor is not part of the level-l mesh and is not the domain
    # boundary (deal.II MGConstrainedDoFs::get_refinement_edge_indices,
    # used at src/step-50.cc:860,892).
    interface = np.zeros(len(kidx), dtype=bool)
    if l > 0:
        side = forest.side(l)
        cellset = KeyIndex(forest.level_cell_key(l, level_ijk))
        for axis in range(dim):
            for sgn in (-1, 1):
                nb = level_ijk.copy()
                nb[:, axis] += sgn
                inside = (nb[:, axis] >= 0) & (nb[:, axis] < side)
                missing = inside & ~cellset.contains(
                    forest.level_cell_key(l, nb))
                if not missing.any():
                    continue
                face_nodes = off[off[:, axis] == (p if sgn > 0 else 0)]
                fc = (level_ijk[missing][:, None, :] * np.int64(p)
                      + face_nodes[None]) * s
                interface[kidx.lookup(forest.nkey(fc, p)).reshape(-1)] = True

    return LevelDofs(level=l, keys=kidx.keys, cell2dof=cell2dof,
                     active_index=active_index, boundary=boundary,
                     interface=interface, n_dofs=len(kidx), degree=p)
