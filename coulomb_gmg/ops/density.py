"""Gaussian charge-density evaluation and atom-cell locality.

The reference's two hottest components (64k-atom run: 6,871 s locality index
+ 7,055 s density eval, ``SSOR_64k_atoms.o876224:68-69``) become batched,
masked JAX computations:

* locality index (``rhs_assembly_optimization``, src/step-50.cc:260-306):
  per-cell atom set = atoms within ``cutoff * r_c`` of any cell vertex —
  here a vectorized (cells x atoms) distance test, chunked over cells, with
  the mask kept either dense (small atom counts) or as padded per-cell lists
  (large).
* density eval (``compute_charge_densities``, src/step-50.cc:509-575):
  rho~(x_q) = 4 pi/(r_c^3 pi^1.5) * sum_k q_k exp(-|x_q - X_k|^2 / r_c^2)
  over the cell's atom set.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_gmg.mesh.forest import Forest, corner_offsets
from coulomb_gmg.ops.q1 import ElementTables


def cell_quad_points(forest: Forest, points_ref: np.ndarray,
                     cells: Optional[np.ndarray] = None) -> np.ndarray:
    """Physical quadrature points (n_cells, n_q, dim) for reference points
    (n_q, dim)."""
    lower = forest.cell_lower(cells)
    h = forest.cell_h(cells)
    return lower[:, None, :] + h[:, None, None] * points_ref[None, :, :]


def atom_masks(forest: Forest, positions: np.ndarray, cutoff: float,
               chunk: int = 65536, device=None) -> np.ndarray:
    """(n_cells, n_atoms) bool: atom within `cutoff` of ANY cell vertex —
    the reference's per-vertex criterion (src/step-50.cc:273-283).
    Fixed-size jitted chunks (one compile, reused)."""
    dim = forest.dim
    n_cells = forest.n_cells
    lower = forest.cell_lower()
    h = forest.cell_h()
    import jax
    put = (lambda a: jax.device_put(np.asarray(a), device)) if device is not None \
        else jnp.asarray
    pos = put(positions)
    chunk = min(chunk, max(n_cells, 1))
    n_pad = ((n_cells + chunk - 1) // chunk) * chunk
    lower_p = np.full((n_pad, dim), 1e30); lower_p[:n_cells] = lower
    h_p = np.ones(n_pad); h_p[:n_cells] = h
    out = []
    for s in range(0, n_pad, chunk):
        out.append(np.asarray(_vertex_mask_jit(
            put(lower_p[s:s + chunk]), put(h_p[s:s + chunk]),
            pos, cutoff * cutoff)))
    return np.concatenate(out, axis=0)[:n_cells]


@jax.jit
def _vertex_mask_jit(lo, hh, pos, c2):
    # min over the 2^dim corners factorizes per axis (see ops/neighbors.py):
    # min_v |x - v|^2 = sum_d min((x_d - lo_d)^2, (x_d - lo_d - h)^2)
    a = pos[None, :, :] - lo[:, None, :]        # (c, atoms, dim)
    b = a - hh[:, None, None]
    d2 = jnp.sum(jnp.minimum(a * a, b * b), axis=-1)
    return d2 < c2


def masks_to_lists(mask: np.ndarray, pad_to: Optional[int] = None):
    """Dense (cells, atoms) mask -> padded per-cell atom index lists
    (n_cells, K) int32 with -1 padding (the analogue of the reference's
    ``charges_list_for_each_cell`` std::map of std::set)."""
    counts = mask.sum(axis=1)
    K = int(counts.max()) if pad_to is None else pad_to
    n_cells = mask.shape[0]
    lists = np.full((n_cells, max(K, 1)), -1, dtype=np.int32)
    rows, cols = np.nonzero(mask)
    # position within row
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(rows)) - first[rows]
    lists[rows, slot] = cols
    return lists, counts


def density_dense(points, positions, charges, r_c: float, mask=None):
    """rho~ at (n_cells, n_q, dim) points; optional (n_cells, n_atoms) mask
    implements the locality optimization with identical semantics to summing
    over the per-cell set.  Dense in atoms: right when n_atoms is small or
    the mask is mostly full."""
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)
    d = points[:, :, None, :] - positions[None, None, :, :]
    r2 = jnp.sum(d * d, axis=-1)                       # (c, q, a)
    e = jnp.exp(-r2 / (r_c * r_c)) * charges[None, None, :]
    if mask is not None:
        e = e * mask[:, None, :]
    return const * jnp.sum(e, axis=-1)


def density_from_lists(points, positions, charges, r_c: float, lists):
    """rho~ via padded per-cell atom lists (n_cells, K): O(cells * K) instead
    of O(cells * atoms).  -1 slots contribute zero."""
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)
    safe = jnp.maximum(lists, 0)
    pos = positions[safe]                              # (c, K, dim)
    q = jnp.where(lists >= 0, charges[safe], 0.0)      # (c, K)
    d = points[:, :, None, :] - pos[:, None, :, :]
    r2 = jnp.sum(d * d, axis=-1)                       # (c, q, K)
    return const * jnp.sum(jnp.exp(-r2 / (r_c * r_c)) * q[:, None, :], axis=-1)


class _ForestView:
    """Cell-subset view exposing the bits compute_density touches."""

    def __init__(self, forest, cells):
        self._f = forest
        self._cells = cells
        self.n_cells = len(cells)
        self.dim = forest.dim

    def cell_lower(self):
        return self._f.cell_lower(self._cells)

    def cell_h(self):
        return self._f.cell_h(self._cells)


def compute_density(forest: Forest, points_ref: np.ndarray, positions,
                    charges, r_c: float, mask=None, lists=None,
                    chunk: int = 32768, dtype=None, device=None,
                    _group: bool = True) -> np.ndarray:
    """Per-cell-per-quad-point density (n_cells, n_q), chunked over cells to
    bound memory.  Chooses the list path when lists are given.

    Cells are padded to a whole number of fixed-size chunks so the jitted
    chunk kernel compiles ONCE and is reused across chunks, cycles, and
    topologies (each compile costs seconds on an accelerator).
    """
    n_cells = forest.n_cells
    n_q = len(points_ref)
    dim = forest.dim
    import jax

    def put(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating) and dtype is not None:
            a = a.astype(dtype)
        return jax.device_put(a, device) if device is not None \
            else jnp.asarray(a)

    # cells whose locality set is empty contribute exactly zero (the
    # reference skips their atom loop the same way, src/step-50.cc:536-546);
    # with vacuum-padded domains that is most of the mesh.  Occupied cells
    # are further grouped by list-length class (powers of two) so cells
    # near the cloud edge don't pay the interior cells' padded width.
    if lists is not None and _group:
        counts = (lists >= 0).sum(axis=1)
        out_dtype = np.float32 if dtype == np.float32 else np.float64
        out = np.zeros((n_cells, n_q), out_dtype)
        K_full = lists.shape[1]
        kclass = 8
        lo = 1
        while lo <= K_full:
            hi = min(kclass, K_full)
            sel = np.where((counts >= lo) & (counts <= hi))[0]
            if len(sel):
                out[sel] = compute_density(
                    _ForestView(forest, sel), points_ref, positions,
                    charges, r_c, lists=lists[sel][:, :hi],
                    chunk=chunk, dtype=dtype, device=device, _group=False)
            lo = hi + 1
            kclass *= 4
        return out
    elif mask is not None:
        occupied = mask.any(axis=1)
        if not occupied.all():
            act = np.where(occupied)[0]
            sub = compute_density(
                _ForestView(forest, act), points_ref, positions, charges,
                r_c, mask=mask[act],
                chunk=chunk, dtype=dtype, device=device)
            out = np.zeros((n_cells, n_q),
                           sub.dtype if hasattr(sub, "dtype") else np.float64)
            out[act] = sub
            return out

    pos = put(positions)
    q = put(charges)

    pt_dtype = dtype if dtype is not None else np.float64
    pref = np.asarray(points_ref, pt_dtype)
    # separable tensor-product path: dim*n1*K transcendentals per cell
    # instead of n1^dim*K, recombined by a batched matmul (see _sep_rho)
    x1 = _tensor_rule_1d(np.asarray(points_ref, np.float64), dim)
    x1_dev = put(x1.astype(pt_dtype)) if x1 is not None else None

    # bound the (chunk, n_q-or-n1^2, width) intermediates to ~tens of MB
    width = (lists.shape[1] if lists is not None
             else (mask.shape[1] if mask is not None else len(positions)))
    per_cell = max(n_q * max(int(width), 1), 1)
    c_fit = 1 << max(int(np.log2(max((1 << 23) // per_cell, 1))), 9)
    chunk = min(chunk, c_fit, max(n_cells, 1))

    lower = forest.cell_lower().astype(pt_dtype)
    h = forest.cell_h().astype(pt_dtype)
    n_pad = ((n_cells + chunk - 1) // chunk) * chunk
    lower_p = np.zeros((n_pad, dim), pt_dtype); lower_p[:n_cells] = lower
    h_p = np.ones(n_pad, pt_dtype); h_p[:n_cells] = h

    pref_dev = put(pref)
    outs = []
    for s in range(0, n_pad, chunk):
        # ship only (lower, h) — the (chunk, n_q, dim) physical points are
        # built inside the jit: 3*n_q fewer bytes to transfer
        lo_c = put(lower_p[s:s + chunk])
        h_c = put(h_p[s:s + chunk])
        if lists is not None:
            li = np.full((chunk, lists.shape[1]), -1, dtype=np.int32)
            e = min(s + chunk, n_cells)
            if e > s:
                li[: e - s] = lists[s:e]
            outs.append(
                _density_lists_sep_jit(lo_c, h_c, x1_dev, pos, q, r_c,
                                       put(li)) if x1_dev is not None else
                _density_lists_jit(lo_c, h_c, pref_dev, pos, q, r_c,
                                   put(li)))
        elif mask is not None:
            mk = np.zeros((chunk, mask.shape[1]), dtype=bool)
            e = min(s + chunk, n_cells)
            if e > s:
                mk[: e - s] = mask[s:e]
            outs.append(
                _density_dense_sep_jit(lo_c, h_c, x1_dev, pos, q, r_c,
                                       put(mk)) if x1_dev is not None else
                _density_dense_jit(lo_c, h_c, pref_dev, pos, q, r_c,
                                   put(mk)))
        else:
            outs.append(
                _density_all_sep_jit(lo_c, h_c, x1_dev, pos, q, r_c)
                if x1_dev is not None else
                _density_all_jit(lo_c, h_c, pref_dev, pos, q, r_c))
        # start the device->host copy while later chunks still compute
        outs[-1].copy_to_host_async()
    return np.concatenate([np.asarray(o) for o in outs], axis=0)[:n_cells]


from functools import partial as _partial


def _cell_points(lower, h, pref):
    return lower[:, None, :] + h[:, None, None] * pref[None, :, :]


@_partial(jax.jit, static_argnames=("r_c",))
def _density_dense_jit(lower, h, pref, positions, charges, r_c, mask):
    return density_dense(_cell_points(lower, h, pref), positions, charges,
                         r_c, mask)


@_partial(jax.jit, static_argnames=("r_c",))
def _density_all_jit(lower, h, pref, positions, charges, r_c):
    return density_dense(_cell_points(lower, h, pref), positions, charges,
                         r_c)


@_partial(jax.jit, static_argnames=("r_c",))
def _density_lists_jit(lower, h, pref, positions, charges, r_c, lists):
    return density_from_lists(_cell_points(lower, h, pref), positions,
                              charges, r_c, lists)


# ---------------------------------------------------------------------------
# Separable (tensor-product) density: because the quadrature grid is a
# tensor product and the Gaussian factorizes per axis,
#   exp(-|x_q - X|^2 / rc^2) = prod_d exp(-(x_{q_d} - X_d)^2 / rc^2),
# only dim * n1 * K transcendentals are needed per cell (vs n1^dim * K) and
# the recombination is a batched matmul.  Quadrature flat index
# convention (ops/q1.element_tables): axis 0 slowest, axis dim-1 fastest.
# ---------------------------------------------------------------------------

def _sep_rho(E, qa, r_c):
    """E: (C, n1, K-or-A, dim) per-axis Gaussian factors; qa: (C, K) or
    broadcastable effective charges.  Returns (C, n1^dim)."""
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)
    C, n1 = E.shape[0], E.shape[1]
    hi = jax.lax.Precision.HIGHEST
    if E.shape[-1] == 3:
        T = (E[:, :, None, :, 1] * E[:, None, :, :, 2]).reshape(
            C, n1 * n1, -1)                       # (C, n1^2, K)
        T = T * qa[:, None, :]
        rho = jnp.einsum("cik,cjk->cij", E[..., 0], T, precision=hi)
        return const * rho.reshape(C, n1 ** 3)
    if E.shape[-1] == 2:
        T = E[..., 1] * qa[:, None, :]
        rho = jnp.einsum("cik,cjk->cij", E[..., 0], T, precision=hi)
        return const * rho.reshape(C, n1 ** 2)
    # 1-D
    return const * jnp.einsum("cik,ck->ci", E[..., 0], qa, precision=hi)


@_partial(jax.jit, static_argnames=("r_c",))
def _density_lists_sep_jit(lower, h, x1, positions, charges, r_c, lists):
    safe = jnp.maximum(lists, 0)
    pos = positions[safe]                         # (C, K, dim)
    qa = jnp.where(lists >= 0, charges[safe], 0.0)
    xq = lower[:, None, :] + h[:, None, None] * x1[None, :, None]  # (C,n1,dim)
    d = xq[:, :, None, :] - pos[:, None, :, :]    # (C, n1, K, dim)
    E = jnp.exp(-(d * d) / (r_c * r_c))
    return _sep_rho(E, qa, r_c)


@_partial(jax.jit, static_argnames=("r_c",))
def _density_dense_sep_jit(lower, h, x1, positions, charges, r_c, mask):
    qa = charges[None, :] * mask                  # (C, A)
    xq = lower[:, None, :] + h[:, None, None] * x1[None, :, None]
    d = xq[:, :, None, :] - positions[None, None, :, :]
    E = jnp.exp(-(d * d) / (r_c * r_c))
    return _sep_rho(E, qa, r_c)


@_partial(jax.jit, static_argnames=("r_c",))
def _density_all_sep_jit(lower, h, x1, positions, charges, r_c):
    C = lower.shape[0]
    qa = jnp.broadcast_to(charges[None, :], (C, charges.shape[0]))
    xq = lower[:, None, :] + h[:, None, None] * x1[None, :, None]
    d = xq[:, :, None, :] - positions[None, None, :, :]
    E = jnp.exp(-(d * d) / (r_c * r_c))
    return _sep_rho(E, qa, r_c)


def _tensor_rule_1d(points_ref: np.ndarray, dim: int):
    """1-D Gauss abscissae if points_ref is their tensor-product grid
    (axis 0 slowest, axis dim-1 fastest), else None."""
    n_q = len(points_ref)
    n1 = int(round(n_q ** (1.0 / dim)))
    if n1 ** dim != n_q:
        return None
    grids = np.stack(np.meshgrid(*([np.arange(n1)] * dim), indexing="ij"),
                     axis=-1).reshape(-1, dim)
    x1 = points_ref[: n1, dim - 1] if dim > 1 else points_ref[: n1, 0]
    rebuilt = x1[grids]
    if np.allclose(rebuilt, points_ref, atol=1e-14):
        return x1
    return None
