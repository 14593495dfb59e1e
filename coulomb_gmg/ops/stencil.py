"""Device-resident level-operator assembly for the GMG hierarchy.

The reference assembles every multigrid level matrix by a cell loop +
``distribute_local_to_global`` + MPI ``compress`` (src/step-50.cc:835-933).
SHIPPING assembled ELL operators (~470 MB at production scale) every
cycle costs more than the solve itself, so the operators are BUILT on the
device from compact topology.

The enabling structure: with unit coefficient and Q1 elements every level
mesh is a subset of a uniform lattice at that level's pitch, so the level
matrix is a 27-point (3^dim) stencil whose weights at node ``i`` depend
ONLY on which of the 2^dim cells adjacent to ``i`` exist in the level
mesh.  That is a lookup table

    T[cell_mask, offset] = sum over present cells adjacent to both
                           endpoints of K_ref[a, b]

of shape (2^(2^dim), 3^dim) — 256 x 27 in 3D — precomputed once from the
closed-form Q1 element matrix (fem/integrals.py:stiffness_cells).  Level
elimination (refinement-edge + boundary rows, src/step-50.cc:853-864)
zeroes off-diagonal entries touching an eliminated dof and keeps the raw
diagonal (the regularization convention of fem/assembly.py:assemble_np);
interface ("edge") matrices apply the keep-mask of src/step-50.cc:896-920
to the SAME stencil values.  Prolongation entries are pure coordinate
parity (Q1: tensor-product 1/2 weights).

What ships per level per topology: level-local node coords (int16),
the 2^dim-bit cell-existence mask (uint8), and the eliminated/interface/
boundary bitsets — ~16 MB at 1.9M DoF instead of ~470 MB of ELL arrays.
Everything else (ELL cols via lexicographic binary search over the sorted
node keys, ELL values via the stencil table, inverse diagonal, Chebyshev
eigenvalue estimates by device power iteration) is computed on device.

All device code is plain jnp (gather/searchsorted/reduce) — no Pallas —
so it compiles identically on CPU for the float64 parity tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_gmg.mesh.forest import Forest, corner_offsets
from coulomb_gmg.mesh.dofs import LevelDofs


# ---------------------------------------------------------------------------
# host: stencil table + compact per-level inputs
# ---------------------------------------------------------------------------


def offset3(dim: int) -> np.ndarray:
    """(3^dim, dim) neighbor offsets in {-1,0,1}^dim, x fastest (axis 0 is
    the least-significant digit — the same digit convention as
    mesh/forest.py:node_offsets)."""
    n = 3 ** dim
    out = np.zeros((n, dim), dtype=np.int64)
    for o in range(n):
        r = o
        for d in range(dim):
            out[o, d] = r % 3 - 1
            r //= 3
    return out


def stencil_table(dim: int, tables) -> np.ndarray:
    """T[mask, o]: stencil weight of neighbor offset ``o`` at a node whose
    adjacent-cell existence bitset is ``mask`` (bit c set = the cell with
    lower corner at node - corner_offsets[c] exists), for h = 1.  Scale by
    ``h^(dim-2)`` per level.  Unit coefficient only (GaussianCharges,
    include/step_50.h:331-336)."""
    w = np.asarray(tables.weights, np.float64)
    G = np.asarray(tables.grad_outer, np.float64)
    k_ref = np.einsum("q,qij->ij", w, G)            # (nb, nb), nb = 2^dim
    nb = 2 ** dim
    offs = offset3(dim)                              # (3^dim, dim)
    corners = corner_offsets(dim)                    # (nb, dim)
    T = np.zeros((2 ** nb, 3 ** dim))
    for c in range(nb):                              # cell c: node is its
        a = c                                        # local corner a = c
        for o in range(3 ** dim):
            b_off = offs[o] + corners[c]
            if ((b_off < 0) | (b_off > 1)).any():
                continue                             # neighbor outside cell
            b = int((b_off * (1 << np.arange(dim))).sum())
            for mask in range(2 ** nb):
                if mask >> c & 1:
                    T[mask, o] += k_ref[a, b]
    return T


@dataclass
class LevelTopology:
    """Compact shipped inputs for one level's device-side operator build."""

    level: int
    n: int                      # true dof count
    side: int                   # level lattice side (cells per axis)
    coords: np.ndarray          # (n, dim) int16/int32 level-local node coords
    mask8: np.ndarray           # (n,) uint8 adjacent-cell existence bits
    elim: np.ndarray            # (n,) bool: interface | boundary (eliminated)
    iface: np.ndarray           # (n,) bool: refinement-edge dofs
    boundary: np.ndarray        # (n,) bool: domain-boundary dofs
    h: float                    # level cell size


def level_topology(forest: Forest, ld: LevelDofs, l: int) -> LevelTopology:
    """Host-side extraction of the compact level inputs (degree 1 only)."""
    assert ld.degree == 1, "stencil operators are Q1-only"
    dim = forest.dim
    shift = forest.max_level - l
    coords = forest.nkey_to_coords(ld.keys, 1) >> shift    # level lattice
    side = forest.side(l)
    level_ijk, _ = forest.level_cells[l]
    cell_keys = np.sort(forest.level_cell_key(l, level_ijk))
    corners = corner_offsets(dim)
    mask8 = np.zeros(len(coords), np.uint8)
    for c in range(2 ** dim):
        cand = coords - corners[c]
        ok = ((cand >= 0) & (cand < side)).all(axis=1)
        key = forest.level_cell_key(l, np.where(ok[:, None], cand, 0))
        pos = np.searchsorted(cell_keys, key)
        pos = np.minimum(pos, len(cell_keys) - 1)
        present = ok & (cell_keys[pos] == key)
        mask8 |= (present.astype(np.uint8) << c)
    ctype = np.int16 if side + 2 < 2 ** 15 else np.int32
    return LevelTopology(level=l, n=ld.n_dofs, side=int(side),
                         coords=coords.astype(ctype), mask8=mask8,
                         elim=(ld.interface | ld.boundary),
                         iface=ld.interface.copy(),
                         boundary=ld.boundary.copy(), h=float(forest.h(l)))


def topology_signature(t: LevelTopology) -> tuple:
    """Content key for cross-cycle reuse of device-built level operators
    (the level-local analogue of solver/multigrid.py:_level_signature)."""
    import hashlib
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(t.coords))
    h.update(np.ascontiguousarray(t.mask8))
    h.update(np.ascontiguousarray(t.elim))
    h.update(np.ascontiguousarray(t.iface))
    return (t.level, t.n, t.side, h.hexdigest())


# ---------------------------------------------------------------------------
# device: lexicographic binary search over sorted (hi, lo) int32 key pairs
# ---------------------------------------------------------------------------
#
# Node keys linearized on the level lattice overflow int32 past ~1290^3 and
# f32-mode JAX has no int64, so keys are (hi, lo) int32 pairs compared
# lexicographically.  The node set arrives SORTED (level dof order is key
# order; the level-local coordinate shift is order-preserving — see
# solver/multigrid.py:_level_signature).


def _split_keys(coords, side):
    """coords (..., dim) int32 -> (hi, lo) int32 lexicographic key pair."""
    m = side + 1
    c = coords.astype(jnp.int32)
    if c.shape[-1] == 2:
        return c[..., 0], c[..., 1]
    return c[..., 0] * m + c[..., 1], c[..., 2]


def _lex_searchsorted(keys_hi, keys_lo, q_hi, q_lo, n_steps: int):
    """First index i with keys[i] >= q (lexicographic), keys sorted.

    The bisection runs as a ``fori_loop`` so XLA reuses one set of
    query-sized buffers per step — the unrolled form held every step's
    intermediates live and blew past device memory at production scale
    (17 GB peak for 28M queries)."""
    n = keys_hi.shape[0]
    lo = jnp.zeros(q_hi.shape, jnp.int32)
    hi = jnp.full(q_hi.shape, n, jnp.int32)

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        mc = jnp.minimum(mid, n - 1)
        khi = keys_hi[mc]
        klo = keys_lo[mc]
        less = (khi < q_hi) | ((khi == q_hi) & (klo < q_lo))
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, hi = jax.lax.fori_loop(0, n_steps, body, (lo, hi))
    return lo


def _lookup(keys_hi, keys_lo, q_hi, q_lo, n, n_steps: int):
    """Index of q in sorted keys, or -1 when absent."""
    pos = _lex_searchsorted(keys_hi, keys_lo, q_hi, q_lo, n_steps)
    pc = jnp.minimum(pos, keys_hi.shape[0] - 1)
    hit = (keys_hi[pc] == q_hi) & (keys_lo[pc] == q_lo) & (pos < n)
    return jnp.where(hit, pos, -1)


def _n_steps(n_pad: int) -> int:
    s = 1
    while (1 << s) < n_pad + 1:
        s += 1
    return s


# ---------------------------------------------------------------------------
# device: level / interface operator build
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("dim", "side", "h", "want_iface",
                                   "np_dtype"))
def build_level_ops(coords, mask8, elim, iface, bnd, n, T, *, dim, side,
                    h, want_iface, np_dtype):
    """Device-side build of one level's operators from compact topology.

    Returns (ecols, evals, inv_diag, [if_cols, if_vals, ifT_cols, ifT_vals]).
    Shapes: (n_pad, K3) with K3 = 3^dim rounded up to 32 lanes handled by
    the caller's ELL consumers (no padding needed here: _ell_mv_t only needs
    matching cols/vals shapes).

    Semantics (matches fem/assembly.py:assemble_np with
    solver/multigrid.py:level_constraints):
    - eliminated rows/cols: off-diagonals dropped, raw diagonal kept;
    - interface matrix: raw values masked to (i on edge, j off edge,
      neither on boundary) — src/step-50.cc:896-920;
    - transposed interface for the ascend phase.
    """
    n_pad = coords.shape[0]
    steps = _n_steps(n_pad)
    offs = jnp.asarray(offset3(dim), jnp.int32)          # (K3, dim)
    K3 = offs.shape[0]
    center = (K3 - 1) // 2
    scale = jnp.asarray(float(h) ** (dim - 2), np_dtype)

    # everything runs in TRANSPOSED (K3, n_pad) orientation (the gather
    # layout of solver/fused_gmg.py:_mv)
    khi, klo = _split_keys(coords, side)
    c32 = coords.astype(jnp.int32)
    nq = offs[:, None, :] + c32[None, :, :]              # (K3, n_pad, dim)
    in_box = ((nq >= 0) & (nq <= side)).all(-1)
    qhi, qlo = _split_keys(jnp.where(in_box[..., None], nq, 0), side)
    idx = _lookup(khi, klo, qhi, qlo, n, steps)          # (K3, n_pad)
    valid = in_box & (idx >= 0)

    rows = jax.lax.broadcasted_iota(jnp.int32, (K3, n_pad), 1)
    row_ok = rows[0] < n
    cols = jnp.where(valid, idx, rows)                   # self for padding
    raw = scale * T.T[:, mask8.astype(jnp.int32)]        # (K3, n_pad)
    raw = jnp.where(valid, raw, jnp.zeros((), np_dtype))

    elim_j = jnp.where(valid, elim[cols], True)
    is_center = (jax.lax.broadcasted_iota(jnp.int32, (K3, n_pad), 0)
                 == center)
    keep = is_center | (~elim[None, :] & ~elim_j)
    evals = jnp.where(keep & row_ok[None, :], raw, jnp.zeros((), np_dtype))

    diag = evals[center]
    inv_diag = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1.0),
                         jnp.ones((), np_dtype))

    if not want_iface:
        return cols, evals, inv_diag

    # interface matrix: keep (i edge, j non-edge, neither boundary)
    ifc_j = jnp.where(valid, iface[cols], False)
    bnd_j = jnp.where(valid, bnd[cols], True)
    keep_if = (iface[None, :] & ~ifc_j & ~bnd[None, :] & ~bnd_j
               & row_ok[None, :])
    if_vals = jnp.where(keep_if, raw, jnp.zeros((), np_dtype))

    # transpose: entry (o, j) = A_if[i, j] with i = j + offs[o]; the value
    # is the RAW stencil of i at the reversed offset, under the same keep
    # mask evaluated at (i, j).
    rev = K3 - 1 - jax.lax.broadcasted_iota(jnp.int32, (K3, n_pad), 0)
    i_of = cols                                          # i = node at +offs
    mask_i = mask8.astype(jnp.int32)[i_of]
    rawT = scale * T[mask_i, rev]
    rawT = jnp.where(valid, rawT, jnp.zeros((), np_dtype))
    keep_ifT = (jnp.where(valid, iface[i_of], False) & ~iface[None, :]
                & ~jnp.where(valid, bnd[i_of], True) & ~bnd[None, :]
                & row_ok[None, :])
    ifT_vals = jnp.where(keep_ifT, rawT, jnp.zeros((), np_dtype))
    return cols, evals, inv_diag, if_vals, ifT_vals


@partial(jax.jit, static_argnames=("dim", "side_c", "np_dtype"))
def build_prolongation_ops(coords_f, n_f, coords_c, n_c, *, dim, side_c,
                           np_dtype):
    """Device-side Q1 prolongation/restriction ELLs from coordinate parity.

    P rows = fine level dofs (n_pad_f, 2^dim): fine node v interpolates
    from coarse nodes floor/ceil(v/2) per axis with weight 1 (even) or
    1/2 (odd) — the closed form of solver/multigrid.py:build_prolongation
    for degree 1.  R rows = coarse dofs (n_pad_c, 3^dim): R = P^T, fine
    node 2*vc + delta with weight prod(delta_d == 0 ? 1 : 1/2).
    """
    n_pad_f = coords_f.shape[0]
    n_pad_c = coords_c.shape[0]
    steps_c = _n_steps(n_pad_c)
    steps_f = _n_steps(n_pad_f)
    khi_c, klo_c = _split_keys(coords_c, side_c)
    side_f = 2 * side_c
    khi_f, klo_f = _split_keys(coords_f, side_f)

    # transposed (K, n_pad) orientation throughout — see build_level_ops
    # ---- P: (2^dim, n_pad_f)
    cf = coords_f.astype(jnp.int32)
    nbp = 2 ** dim
    corners = jnp.asarray(corner_offsets(dim), jnp.int32)  # (nbp, dim) 0/1
    odd = (cf & 1)                                         # (n_pad_f, dim)
    base = cf >> 1
    # slot b: master coord = base + bit_d(b) * odd_d; weight
    # prod(odd ? 1/2 : (bit == 0)) — even axes only emit at bit 0.
    m_coord = base[None, :, :] + corners[:, None, :] * odd[None, :, :]
    w_axis = jnp.where(odd[None, :, :] == 1,
                       jnp.full((), 0.5, np_dtype),
                       (corners[:, None, :] == 0).astype(np_dtype))
    p_w = jnp.prod(w_axis, axis=-1)                        # (nbp, n_pad_f)
    qhi, qlo = _split_keys(m_coord, side_c)
    p_idx = _lookup(khi_c, klo_c, qhi, qlo, n_c, steps_c)  # (nbp, n_pad_f)
    rows_f = jax.lax.broadcasted_iota(jnp.int32, (nbp, n_pad_f), 1)
    ok = (p_idx >= 0) & (p_w != 0) & (rows_f[0] < n_f)[None, :]
    p_cols = jnp.where(ok, p_idx, 0)
    p_vals = jnp.where(ok, p_w, jnp.zeros((), np_dtype))

    # ---- R = P^T: (3^dim, n_pad_c)
    offs = jnp.asarray(offset3(dim), jnp.int32)
    K3 = offs.shape[0]
    cc = coords_c.astype(jnp.int32)
    fq = 2 * cc[None, :, :] + offs[:, None, :]
    in_box = ((fq >= 0) & (fq <= side_f)).all(-1)
    r_w = jnp.prod(jnp.where(offs[:, None, :] == 0,
                             jnp.ones((), np_dtype),
                             jnp.full((), 0.5, np_dtype)), axis=-1)
    qhi, qlo = _split_keys(jnp.where(in_box[..., None], fq, 0), side_f)
    r_idx = _lookup(khi_f, klo_f, qhi, qlo, n_f, steps_f)  # (K3, n_pad_c)
    rows_c = jax.lax.broadcasted_iota(jnp.int32, (K3, n_pad_c), 1)
    ok_r = in_box & (r_idx >= 0) & (rows_c[0] < n_c)[None, :]
    r_cols = jnp.where(ok_r, r_idx, 0)
    r_vals = jnp.where(ok_r, jnp.broadcast_to(r_w, (K3, n_pad_c)),
                       jnp.zeros((), np_dtype))
    return p_cols, p_vals, r_cols, r_vals


@partial(jax.jit, static_argnames=("iters",))
def power_lmax_device(ecols, evals, inv_diag, n, iters: int = 15):
    """lambda_max(D^{-1} A) by device power iteration (the on-device twin
    of solver/fused_gmg.py:_power_lmax; deterministic hash-based start).
    Operands in transposed (K, n_pad) ELL layout."""
    n_pad = ecols.shape[1]
    i = jax.lax.iota(jnp.uint32, n_pad)
    v = ((i * jnp.uint32(2654435761) >> 8).astype(evals.dtype)
         / jnp.asarray(2 ** 24, evals.dtype) - 0.5)
    v = jnp.where(jax.lax.iota(jnp.int32, n_pad) < n, v, 0.0)
    v = v / jnp.linalg.norm(v)

    def body(_, carry):
        v, lam = carry
        w = inv_diag * jnp.sum(evals * v[ecols], axis=0)
        lam = jnp.linalg.norm(w)
        return jnp.where(lam > 0, w / jnp.where(lam > 0, lam, 1.0), v), lam

    _, lam = jax.lax.fori_loop(0, iters, body,
                               (v, jnp.ones((), evals.dtype)))
    return lam
