"""O(N) atom-cell locality via spatial hashing.

The reference's ``rhs_assembly_optimization`` (src/step-50.cc:260-306)
tests EVERY atom against EVERY cell vertex — 6,871 s of the 20,540 s
64k-atom run (SSOR_64k_atoms.o876224:68).  Here atoms are bucketed on a
uniform grid of pitch >= cutoff, each mesh cell probes only the buckets
its cutoff-inflated bounding box overlaps, and the exact reference
criterion (atom within ``cutoff * r_c`` of ANY cell vertex) is applied to
the candidates only: O(cells * local_atoms) with a dense-mask-identical
result, emitted as padded per-cell atom lists for
``ops.density.density_from_lists``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from coulomb_gmg.mesh.forest import Forest, corner_offsets


def build_atom_buckets(positions: np.ndarray, pitch: float,
                       origin: np.ndarray):
    """Bucket atoms on a uniform grid: returns (order, starts, shape) where
    ``order`` sorts atoms by bucket and ``starts`` is the CSR offset per
    linearized bucket id (+1 sentinel)."""
    dim = positions.shape[1]
    ijk = np.floor((positions - origin) / pitch).astype(np.int64)
    lo = ijk.min(axis=0)
    ijk -= lo
    shape = ijk.max(axis=0) + 1
    lin = ijk[:, 0]
    for d in range(1, dim):
        lin = lin * shape[d] + ijk[:, d]
    order = np.argsort(lin, kind="stable")
    nb = int(np.prod(shape))
    counts = np.bincount(lin, minlength=nb)
    starts = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts, shape, lo


def atom_lists(forest: Forest, positions: np.ndarray, cutoff: float,
               chunk: int = 262144) -> Tuple[np.ndarray, np.ndarray]:
    """Padded per-cell atom index lists (n_cells, K) int32, -1 padded, plus
    per-cell counts — identical membership to ``ops.density.atom_masks``
    (vertex-distance criterion, src/step-50.cc:273-283) but built in
    O(cells * atoms_within_cutoff)."""
    dim = forest.dim
    n_cells = forest.n_cells
    positions = np.asarray(positions, np.float64)
    if len(positions) == 0:
        return np.full((n_cells, 1), -1, np.int32), np.zeros(n_cells, np.int64)

    pitch = max(cutoff, 1e-12)
    origin = positions.min(axis=0)
    order, starts, shape, lo = build_atom_buckets(positions, pitch, origin)
    sorted_pos = positions[order]

    lower = forest.cell_lower()
    h = forest.cell_h()

    # native engine path: the whole bucket-probe + corner-criterion loop in
    # parallel C++ with no host temporaries (native/forest_engine.cpp)
    from coulomb_gmg.utils import native
    nat = native.atom_lists(lower, h, sorted_pos, order, starts,
                            np.asarray(shape), origin + lo * pitch,
                            pitch, cutoff)
    if nat is not None:
        return nat

    off = corner_offsets(dim).astype(np.float64)
    c2 = cutoff * cutoff

    rows_out, atoms_out = [], []
    for s in range(0, n_cells, chunk):
        e = min(s + chunk, n_cells)
        lo_box = lower[s:e] - cutoff
        hi_box = lower[s:e] + h[s:e, None] + cutoff
        blo = np.floor((lo_box - origin) / pitch).astype(np.int64) - lo
        bhi = np.floor((hi_box - origin) / pitch).astype(np.int64) - lo
        np.clip(blo, 0, shape - 1, out=blo)
        np.clip(bhi, 0, shape - 1, out=bhi)
        spans = bhi - blo + 1                      # (m, dim)
        # enumerate (cell, bucket) pairs for the overlapped bucket boxes
        n_buckets = np.prod(spans, axis=1)
        cell_rep = np.repeat(np.arange(s, e), n_buckets)
        base = np.repeat(np.concatenate([[0], np.cumsum(n_buckets)[:-1]]),
                         n_buckets)
        local = np.arange(len(cell_rep)) - base
        # decode local -> per-axis bucket offsets
        bidx = np.zeros((len(cell_rep), dim), dtype=np.int64)
        rem = local
        for d in range(dim - 1, -1, -1):
            sp = spans[cell_rep - s, d]
            bidx[:, d] = rem % sp
            rem //= sp
        bcoord = blo[cell_rep - s] + bidx
        blin = bcoord[:, 0]
        for d in range(1, dim):
            blin = blin * shape[d] + bcoord[:, d]
        bstart = starts[blin]
        bcount = starts[blin + 1] - bstart
        # expand to (cell, atom-candidate) pairs
        pair_cell = np.repeat(cell_rep, bcount)
        pbase = np.repeat(np.concatenate([[0], np.cumsum(bcount)[:-1]]),
                          bcount)
        pl = np.arange(len(pair_cell)) - pbase
        cand = np.repeat(bstart, bcount) + pl       # index into sorted_pos
        # exact criterion: atom within cutoff of ANY cell vertex.  The min
        # over the 2^dim corners of an axis-aligned box factorizes per axis:
        #   min_v |x - v|^2 = sum_d min((x_d - lo_d)^2, (x_d - lo_d - h)^2)
        # — one pass instead of 2^dim.
        cpos = sorted_pos[cand]
        cl = lower[pair_cell]
        ch = h[pair_cell]
        d2 = np.zeros(len(pair_cell))
        for d in range(dim):
            a = cpos[:, d] - cl[:, d]
            b = a - ch
            d2 += np.minimum(a * a, b * b)
        keep = d2 < c2
        rows_out.append(pair_cell[keep])
        atoms_out.append(order[cand[keep]])

    rows = np.concatenate(rows_out) if rows_out else np.zeros(0, np.int64)
    atoms = np.concatenate(atoms_out) if atoms_out else np.zeros(0, np.int64)
    # pack ragged -> padded lists
    counts = np.bincount(rows, minlength=n_cells)
    K = max(int(counts.max()), 1)
    lists = np.full((n_cells, K), -1, dtype=np.int32)
    ordr = np.argsort(rows, kind="stable")
    rows_s, atoms_s = rows[ordr], atoms[ordr]
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(rows_s)) - first[rows_s]
    lists[rows_s, slot] = atoms_s
    return lists, counts
