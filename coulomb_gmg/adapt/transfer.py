"""State migration across mesh refinement.

Replaces two reference mechanisms (both refine-only; the reference never
coarsens):

* ``parallel::distributed::SolutionTransfer`` (src/step-50.cc:1103-1118):
  interpolate the (constraint-distributed) solution onto the new mesh —
  unchanged cells copy vertex values, children evaluate the parent's Q1
  interpolant at their vertices.
* the p4est ``register_data_attach`` / ``notify_ready_to_unpack`` byte
  protocol for per-cell atom lists (src/step-50.cc:377-491): children
  inherit the parent's atom set.  With dense (cells x atoms) masks this is
  a row gather by the old-cell index.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from coulomb_gmg.mesh.forest import Forest, KeyIndex, corner_offsets
from coulomb_gmg.ops.q1 import _basis_at


def old_cell_of_new(old: Forest, new: Forest) -> np.ndarray:
    """For each new active cell: index of the old active cell covering it
    (itself, or its parent if it was just created by refinement)."""
    per_level = {}
    lvl = old.level.astype(np.int64)
    for l in range(old.n_levels):
        sel = np.where(lvl == l)[0]
        ki, order = KeyIndex.with_order(old.level_cell_key(l, old.ijk[sel]))
        per_level[l] = (ki, sel[order])

    out = np.full(new.n_cells, -1, dtype=np.int64)
    nlvl = new.level.astype(np.int64)
    for l in range(new.n_levels):
        sel = np.where(nlvl == l)[0]
        if len(sel) == 0:
            continue
        if l in per_level:
            ki, act = per_level[l]
            pos = ki.lookup(new.level_cell_key(l, new.ijk[sel]))
            hit = pos >= 0
            out[sel[hit]] = act[pos[hit]]
            sel = sel[~hit]
        if len(sel) and (l - 1) in per_level:
            ki, act = per_level[l - 1]
            pos = ki.lookup(new.level_cell_key(l - 1, new.ijk[sel] // 2))
            hit = pos >= 0
            out[sel[hit]] = act[pos[hit]]
            sel = sel[~hit]
        assert len(sel) == 0, "new cell without old ancestor (coarsening?)"
    return out


def transfer_solution(old: Forest, new: Forest, u_old: np.ndarray,
                      degree: int = 1,
                      omap: np.ndarray = None) -> np.ndarray:
    """Q_degree interpolation of the old solution onto new-mesh dofs.

    Refine-only transfer means every new cell sits at one of exactly
    1 + 2^dim positions inside its covering old cell: itself (same level)
    or one child octant.  The per-node basis weights therefore collapse to
    2^dim precomputed (nb x nb) embedding matrices — a grouped gather +
    small matmul instead of evaluating the basis at n_new x nb arbitrary
    points (72 s -> ~2 s at 1.8M cells).  ``omap`` (old_cell_of_new) may be
    passed in to share the covering map with transfer_cell_mask — building
    it costs a per-level key sort + lookup over every new cell."""
    dim = old.dim
    if omap is None:
        omap = old_cell_of_new(old, new)
    odofs, ndofs = old.dofs_of(degree), new.dofs_of(degree)
    u_cell_old = np.asarray(u_old)[odofs.cell2dof[omap]]   # (n_new, nb)
    from coulomb_gmg.mesh.forest import node_offsets
    off = node_offsets(dim, degree).astype(np.float64) / degree  # (nb, dim)
    nb = (degree + 1) ** dim
    u_new = np.zeros(ndofs.n_dofs)

    is_child = new.level != old.level[omap]
    # unchanged cells: node values copy through (weights are exact 0/1)
    same = ~is_child
    if same.any():
        u_new[ndofs.cell2dof[same]] = u_cell_old[same]
    if is_child.any():
        # octant of each child inside its parent
        oct_id = (new.ijk[:, 0] & 1).astype(np.int64)
        for d in range(1, dim):
            oct_id |= (new.ijk[:, d] & 1).astype(np.int64) << d
        # W[o] rows: parent-basis weights at child-node positions
        # t = (octant + node_offset) / 2
        for o in range(2 ** dim):
            grp = is_child & (oct_id == o)
            if not grp.any():
                continue
            corner = np.array([(o >> d) & 1 for d in range(dim)], np.float64)
            t = (corner[None, :] + off) * 0.5            # (nb, dim)
            W = _basis_at(dim, degree, t)[0]             # (nb, nb)
            u_new[ndofs.cell2dof[grp]] = u_cell_old[grp] @ W.T
    return u_new


def transfer_cell_mask(old: Forest, new: Forest,
                       mask_old: np.ndarray,
                       omap: np.ndarray = None) -> np.ndarray:
    """Per-cell atom mask/list migration: children inherit the parent's
    set (unpack semantics of src/step-50.cc:441-456).  The row gather is
    multi-GB at 64k atoms (1.8M cells x K~300 int32 list entries) — it
    goes through the threaded native engine."""
    from coulomb_gmg.utils import native
    if omap is None:
        omap = old_cell_of_new(old, new)
    return native.gather_rows(np.ascontiguousarray(mask_old), omap)


# ---------------------------------------------------------------------------
# coarsening transfer (machinery parity with deal.II SolutionTransfer /
# p4est attach under coarsening — the reference app never flags it,
# src/step-50.cc:1104-1111)
# ---------------------------------------------------------------------------


def coarsen_map(old: Forest, new: Forest):
    """Covering map for a pure-coarsening step (new = old.coarsen(...)).

    Returns (surv, merged_new, merged_children):
      surv:            (n_new,) old index of each surviving new cell, -1
                       where the new cell is a freshly-created parent
      merged_new:      (m,) new indices of those parents
      merged_children: (m, 2^dim) old indices of the children each parent
                       replaces (deal.II child order: bit d = axis d)
    """
    per_level = {}
    lvl = old.level.astype(np.int64)
    for l in range(old.n_levels):
        sel = np.where(lvl == l)[0]
        ki, order = KeyIndex.with_order(old.level_cell_key(l, old.ijk[sel]))
        per_level[l] = (ki, sel[order])

    surv = np.full(new.n_cells, -1, dtype=np.int64)
    nlvl = new.level.astype(np.int64)
    merged_new, merged_children = [], []
    off = corner_offsets(old.dim)
    for l in range(new.n_levels):
        sel = np.where(nlvl == l)[0]
        if len(sel) == 0:
            continue
        if l in per_level:
            ki, act = per_level[l]
            pos = ki.lookup(new.level_cell_key(l, new.ijk[sel]))
            hit = pos >= 0
            surv[sel[hit]] = act[pos[hit]]
            sel = sel[~hit]
        if len(sel) == 0:
            continue
        # fresh parents: their 2^dim children must all exist in old
        assert (l + 1) in per_level, "coarsened parent without old children"
        ki, act = per_level[l + 1]
        ch = (new.ijk[sel][:, None, :] * 2 + off[None, :, :])
        pos = ki.lookup(old.level_cell_key(l + 1, ch.reshape(-1, old.dim)))
        assert (pos >= 0).all(), "coarsened parent missing a child"
        merged_new.append(sel)
        merged_children.append(act[pos].reshape(len(sel), 2 ** old.dim))
    cat = lambda xs, w: (np.concatenate(xs) if xs
                         else np.zeros((0,) + w, dtype=np.int64))
    return surv, cat(merged_new, ()), cat(merged_children, (2 ** old.dim,))


def coarsen_solution(old: Forest, new: Forest, u_old: np.ndarray,
                     degree: int = 1) -> np.ndarray:
    """Solution transfer under coarsening: every Q_degree node of the new
    mesh coincides with a node of the old mesh (children node lattices are
    2x finer), so deal.II's interpolation (evaluate the old FE function at
    the new support points) reduces to exact nodal injection by lattice
    key."""
    odofs, ndofs = old.dofs_of(degree), new.dofs_of(degree)
    # node coords in each forest's own degree-lattice; rescale new coords
    # onto the old (finer or equal) lattice
    scale = old.fine_side // new.fine_side
    ncoords = new.nkey_to_coords(ndofs.keys, degree) * scale
    okeys = old.nkey(ncoords, degree)
    pos = np.searchsorted(odofs.keys, okeys)
    pos = np.clip(pos, 0, len(odofs.keys) - 1)
    assert (odofs.keys[pos] == okeys).all(), \
        "new node not present in old dof lattice"
    return np.asarray(u_old)[pos]


def coarsen_cell_mask(old: Forest, new: Forest,
                      mask_old: np.ndarray) -> np.ndarray:
    """Per-cell data under coarsening: a parent receives the UNION of its
    children's atom sets (the conservative closure of the support
    criterion; surviving cells copy).  Works for dense boolean masks
    (cells, n_atoms) and padded int atom lists (cells, K) with -1 padding;
    list unions widen K as needed."""
    surv, mnew, mch = coarsen_map(old, new)
    mask_old = np.asarray(mask_old)
    if mask_old.dtype == bool:
        out = np.zeros((new.n_cells,) + mask_old.shape[1:], dtype=bool)
        ok = surv >= 0
        out[ok] = mask_old[surv[ok]]
        if len(mnew):
            out[mnew] = mask_old[mch].any(axis=1)
        return out
    # padded lists (pad value -1): union per merged group
    ok = surv >= 0
    rows = [None] * new.n_cells
    K = mask_old.shape[1]
    for i in np.where(ok)[0]:
        rows[i] = mask_old[surv[i]]
    K_out = K
    for j, i in enumerate(mnew):
        u = np.unique(mask_old[mch[j]])
        u = u[u >= 0]
        K_out = max(K_out, len(u))
        rows[i] = u
    out = np.full((new.n_cells, K_out), -1, dtype=mask_old.dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
