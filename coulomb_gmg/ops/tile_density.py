"""Locality-list charge density as dense (atom tile x point block) work.

The reference's dominant production cost is the per-quadrature-point
density over each cell's atom list (7,055 s of the 20,540 s 64k run,
``SSOR_64k_atoms.o876224:69``; src/step-50.cc:509-575).  The host path
(ops/density.py:density_from_lists) gathers one padded atom list per cell.
This module replaces the per-cell gathers with dense tiles:

* atoms are SORTED BY SPATIAL BUCKET (pitch = cutoff, the same hash as
  ops/neighbors.py) once per run — z (the least-significant bucket axis)
  is contiguous, so the atoms near any z-pencil of cells form a few
  CONTIGUOUS SLICES of the sorted array;
* cells are grouped into fixed blocks in forest (SFC) order; for each
  block the candidate-atom slices are found by two vectorized
  searchsorteds and rounded to atom-tile boundaries;
* the work list is CSR: per-block offsets into a block-major list of
  atom-tile ids (no wasted tiles over vacuum blocks);
* every (block, atom tile) item evaluates DENSE (atom x point) pairs:
  explicit per-coordinate differences (exact in f32 for lattice data — no
  |x|^2+|X|^2-2xX cancellation), the EXACT locality criterion applied per
  pair, and the charge reduction as a multiply and a sum (no matrix
  product, so no reduced-precision tensor-core path).

Exactness of the locality semantics: the production pipeline builds atom
lists once on the CYCLE-0 (uniform level-0) mesh and children INHERIT the
parent's list across refinement (src/step-50.cc:441-456).  Every cell's
cycle-0 ancestor is its LEVEL-0 ancestor, so membership is "atom within
``cutoff*r_c`` of any vertex of the cell's level-0 ancestor" — evaluated
here per (cell, atom) pair with the same per-axis-min factorization and
strict ``<`` as ops/neighbors.py:atom_lists.  For NaCl-lattice data every
quantity in the test is an exact small multiple of 1/16 well inside f32
range, so the f32 test reproduces the host f64 membership bit-for-bit
(borderline distances equal to the cutoff occur in these lattices and are
excluded by both).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.ops.neighbors import build_atom_buckets


@dataclass
class TilePlan:
    """Host-side work plan for one (forest topology, atom set)."""

    cpb: int                 # cells per block
    n_q: int
    p_tile: int              # points per block (cpb * n_q, padded)
    a_tile: int              # atoms per atom tile
    nb: int                  # blocks (padded to a pow2 bucket)
    offsets: np.ndarray      # (nb+1,) int32 CSR: block b's items are
    atile: np.ndarray        # atile[offsets[b]:offsets[b+1]] (int32 ids)
    cells16: np.ndarray      # (nb*cpb, dim+1) int — ijk + level (padded)
    at: np.ndarray           # (8, A_pad) f32 sorted coords
    wt: np.ndarray           # (1, A_pad) f32 sorted charges

    @property
    def blk(self) -> np.ndarray:
        """(n_items,) block id of every work item."""
        return np.repeat(np.arange(self.nb, dtype=np.int32),
                         np.diff(self.offsets))

    @property
    def pad_tile(self) -> int:
        """The guaranteed all-pad atom tile (coords 1e6, charge 0)."""
        return self.at.shape[1] // self.a_tile - 1


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def build_tile_plan(forest: Forest, n_q: int, positions: np.ndarray,
                    charges: np.ndarray, cutoff: float,
                    p_tile: int = 512, a_tile: int = 512,
                    nb_multiple: int = 1) -> TilePlan:
    dim = forest.dim
    C = forest.n_cells
    positions = np.asarray(positions, np.float64)
    A = len(positions)
    cpb = max(p_tile // n_q, 1)
    nb = _next_pow2(max((C + cpb - 1) // cpb, 1))
    if nb % nb_multiple:
        # SPMD sharding needs the block count divisible by the device
        # count (odd D included) — round up; extra blocks are pure padding
        nb = (nb // nb_multiple + 1) * nb_multiple

    # ---- sorted atoms (the bucket hash of ops/neighbors.py)
    pitch = max(cutoff, 1e-12)
    origin = positions.min(axis=0)
    order, starts, shape, lo = build_atom_buckets(positions, pitch, origin)
    borigin = origin + lo * pitch
    sorted_pos = positions[order]
    sorted_q = np.asarray(charges, np.float64)[order]
    # always one FULLY-pad atom tile beyond the last real one (coords 1e6,
    # charge 0): work-list bucket padding targets it, so pad items
    # contribute exactly zero (see padded_items)
    A_pad = ((A + a_tile - 1) // a_tile + 1) * a_tile
    at = np.full((8, A_pad), 1.0e6, np.float32)
    at[:dim, :A] = sorted_pos.T
    wt = np.zeros((1, A_pad), np.float32)
    wt[0, :A] = sorted_q

    # ---- per-block bounding boxes of the cells' LEVEL-0 ancestor boxes
    lvl = forest.level.astype(np.int64)
    LB = forest.lower + forest.h0 * (forest.ijk >> lvl[:, None])
    edges = np.arange(0, C, cpb)
    lo_blk = np.minimum.reduceat(LB, edges, axis=0) - cutoff
    hi_blk = np.maximum.reduceat(LB, edges, axis=0) + forest.h0 + cutoff
    nb_real = len(edges)

    # ---- candidate bucket ranges: the last bucket axis is contiguous in
    # the sorted order, so each (leading-axes combo) gives one slice
    blo = np.floor((lo_blk - borigin) / pitch).astype(np.int64)
    bhi = np.floor((hi_blk - borigin) / pitch).astype(np.int64)
    np.clip(blo, 0, shape - 1, out=blo)
    np.clip(bhi, 0, shape - 1, out=bhi)
    spans_lead = np.prod(bhi[:, :-1] - blo[:, :-1] + 1, axis=1)  # leading
    blk_rep = np.repeat(np.arange(nb_real), spans_lead)
    base = np.repeat(np.concatenate([[0], np.cumsum(spans_lead)[:-1]]),
                     spans_lead)
    local = np.arange(len(blk_rep)) - base
    lead = np.zeros((len(blk_rep), max(dim - 1, 1)), dtype=np.int64)
    rem = local
    for d in range(dim - 2, -1, -1):
        sp = bhi[blk_rep, d] - blo[blk_rep, d] + 1
        lead[:, d] = rem % sp
        rem //= sp
    # linearized bucket ids of the slice ends (z contiguous)
    lin_lo = np.zeros(len(blk_rep), dtype=np.int64)
    for d in range(dim - 1):
        lin_lo = lin_lo * shape[d] + (blo[blk_rep, d] + lead[:, d])
    lin_hi = lin_lo * shape[dim - 1] + bhi[blk_rep, dim - 1]
    lin_lo = lin_lo * shape[dim - 1] + blo[blk_rep, dim - 1]
    s0 = starts[lin_lo]
    s1 = starts[lin_hi + 1]
    keep = s1 > s0
    blk_rep, s0, s1 = blk_rep[keep], s0[keep], s1[keep]

    # ---- slices -> deduped (block, atom-tile) work items, block-major
    t0 = s0 // a_tile
    t1 = (s1 - 1) // a_tile
    n_t = (t1 - t0 + 1).astype(np.int64)
    item_blk = np.repeat(blk_rep, n_t)
    tbase = np.repeat(np.concatenate([[0], np.cumsum(n_t)[:-1]]), n_t)
    item_tile = np.repeat(t0, n_t) + (np.arange(len(item_blk)) - tbase)
    # np.unique sorts the (block, tile) keys: block-major, tiles ascending
    pair = np.unique(item_blk * np.int64(A_pad // a_tile + 1) + item_tile)
    item_blk = pair // (A_pad // a_tile + 1)
    item_tile = pair % (A_pad // a_tile + 1)
    offsets = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(item_blk, minlength=nb), out=offsets[1:])

    # ---- padded integer cell table (pad cells pushed far away)
    idt = np.int16 if forest.fine_side < 2 ** 14 else np.int32
    cells16 = np.full((nb * cpb, dim + 1), 0, dtype=idt)
    cells16[:C, :dim] = forest.ijk.astype(idt)
    cells16[:C, dim] = forest.level.astype(idt)
    cells16[C:, :dim] = np.iinfo(idt).max // 2   # far away -> masked out
    return TilePlan(cpb=cpb, n_q=n_q, p_tile=p_tile, a_tile=a_tile, nb=nb,
                    offsets=offsets.astype(np.int32),
                    atile=item_tile.astype(np.int32),
                    cells16=cells16, at=at, wt=wt)


def padded_items(atile: np.ndarray, pad_tile: int,
                 length: Optional[int] = None) -> np.ndarray:
    """The atom-tile list padded to a power-of-2 length (at least 256) —
    or to ``length`` — so the compiled density is REUSED across adaptive
    cycles and run sizes instead of recompiling per cycle.  Pad items lie
    past the last block's CSR range and point at the all-pad atom tile,
    so they contribute exactly zero."""
    n = len(atile)
    E = _next_pow2(max(n, 256)) if length is None else int(length)
    if E < n:
        raise ValueError(f"work list of {n} items exceeds length {E}")
    out = np.full(E, pad_tile, np.int32)
    out[:n] = atile
    return out


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("dim", "n_q", "cpb", "p_tile", "h0",
                                   "lower0"))
def _build_geom(cells16, pref, dim, n_q, cpb, p_tile, h0, lower0):
    """(8, nb*p_tile) geometry table on device: rows 0..dim-1 = quadrature
    point coords RELATIVE to the level-0 ancestor's lower corner, rows
    3..3+dim-1 = that lower corner.  Built from the shipped integer cell
    table (int16/int32 — 4x less H2D than floats).  The corner is exact in
    f32 (small ints times pow2-scaled h0), and the relative point carries
    one rounding of a value below h0: the pair difference (X - corner) -
    point is accurate to ~1e-8, where an absolute point coordinate near 20
    would carry ~1e-6."""
    n_pad = cells16.shape[0]
    ijk = cells16[:, :dim].astype(jnp.float32)
    lev = cells16[:, dim].astype(jnp.int32)
    scale = (h0 * jnp.exp2(-lev.astype(jnp.float32)))[:, None]
    anc = (cells16[:, :dim].astype(jnp.int32) >> lev[:, None]).astype(
        jnp.float32)
    rel = ijk * scale - anc * h0                   # exact, in [0, h0)
    LB = jnp.asarray(lower0, jnp.float32) + anc * h0
    pts = (rel[:, None, :]
           + scale[:, None] * pref[None, :, :])    # (n_pad, n_q, dim)
    LBq = jnp.broadcast_to(LB[:, None, :], (n_pad, n_q, dim))
    g = jnp.concatenate([pts, LBq], axis=2)        # (n_pad, n_q, 2*dim)
    nb = n_pad // cpb
    g = g.reshape(nb, cpb * n_q, 2 * dim)
    g = jnp.pad(g, ((0, 0), (0, p_tile - cpb * n_q), (0, 0)),
                constant_values=1.0e6)
    g = g.reshape(nb * p_tile, 2 * dim).T          # (2*dim, nb*p_tile)
    out = jnp.zeros((8, g.shape[1]), jnp.float32)
    out = out.at[:dim].set(g[:dim])
    out = out.at[3:3 + dim].set(g[dim:])
    return out


def _pair_weights(xa, g, lo, *, inv_rc2, cut2, h0):
    """exp(-|x - X|^2 / r_c^2) masked by the level-0-ancestor membership
    test, for per-axis atom coords ``xa``, ancestor lower corners ``lo``
    and points relative to them ``g`` (see _build_geom), broadcasting to
    one (atom, point) shape."""
    r2 = m2 = None
    for xd, gd, ld in zip(xa, g, lo):
        dlo = xd - ld                              # exact for lattice data
        dd = dlo - gd                              # per-axis difference
        r2 = dd * dd if r2 is None else r2 + dd * dd
        dhi = dlo - h0
        m = jnp.minimum(dlo * dlo, dhi * dhi)
        m2 = m if m2 is None else m2 + m
    return jnp.where(m2 < cut2, jnp.exp(-r2 * inv_rc2), 0.0)


def _plain_chunk(n_pairs: int, a_tile: int, p_tile: int, E: int) -> int:
    """Items per loop step: about ``n_pairs`` (atom, point) pairs each."""
    return min(E, _next_pow2(max(n_pairs // (a_tile * p_tile), 1)))


@partial(jax.jit, static_argnames=("dim", "a_tile", "r_c", "cut", "h0",
                                   "chunk"))
def tiles_plain(offsets, atile, G, at, wt, *, dim, a_tile, r_c, cut, h0,
                chunk):
    """Raw per-point sums (nb*p_tile,) of the CSR work list, left to XLA:
    a loop over chunks of ``chunk`` items gathers each item's point block
    and atom tile, reduces the masked Gaussians over atoms, and adds each
    item's row into its block (a segment sum; items past ``offsets[-1]``
    are dropped).  No (items, atoms, points) array is kept.

    The sums run in two parts: every term q*e (|q*e| <= 1) is split into
    its value on the 2^-12 grid and the remainder.  Grid values add up
    EXACTLY in float32 (a point sees far fewer than 2^12 atoms), so only
    the tiny remainders round: the f32 accumulation error, which the
    alternating charges otherwise amplify to ~2e-6 of max|rho| at 64k
    atoms, drops below the terms' own rounding, and the result no longer
    depends on the order of the (atomic) segment sum."""
    nb = offsets.shape[0] - 1
    P = G.shape[1] // nb
    n_tiles = at.shape[1] // a_tile
    Gb = G.reshape(8, nb, P).transpose(1, 0, 2)         # (nb, 8, P)
    Xb = at.reshape(8, n_tiles, a_tile).transpose(1, 0, 2)
    Wb = wt.reshape(n_tiles, a_tile)
    E = atile.shape[0]
    blk = jnp.searchsorted(offsets, jnp.arange(E, dtype=offsets.dtype),
                           side="right").astype(jnp.int32) - 1
    steps = -(-E // chunk)
    if steps * chunk > E:             # a ragged last step: dropped items
        fill = steps * chunk - E
        blk = jnp.concatenate([blk, jnp.full(fill, nb, jnp.int32)])
        atile = jnp.concatenate([atile, jnp.zeros(fill, atile.dtype)])
    kw = dict(inv_rc2=1.0 / (r_c * r_c), cut2=cut * cut, h0=h0)

    def body(k, acc):
        b = jax.lax.dynamic_slice_in_dim(blk, k * chunk, chunk)
        t = jax.lax.dynamic_slice_in_dim(atile, k * chunk, chunk)
        g = Gb[jnp.minimum(b, nb - 1)]                  # (c, 8, P)
        X = Xb[t]                                       # (c, 8, A)
        e = _pair_weights([X[:, d, :, None] for d in range(dim)],
                          [g[:, d, None, :] for d in range(dim)],
                          [g[:, 3 + d, None, :] for d in range(dim)], **kw)
        term = Wb[t][:, :, None] * e                    # (c, A, P)
        grid = jnp.round(term * 4096.0) * (1.0 / 4096.0)
        return (acc[0].at[b].add(jnp.sum(grid, axis=1), mode="drop"),
                acc[1].at[b].add(jnp.sum(term - grid, axis=1), mode="drop"))

    zero = jnp.zeros((nb, P), jnp.float32)
    hi, lo = jax.lax.fori_loop(0, steps, body, (zero, zero))
    return (hi + lo).reshape(-1)


@partial(jax.jit, static_argnames=("cpb", "n_q", "p_tile", "c_pad"))
def _rho_device_postprocess(out, const, cpb, n_q, p_tile, c_pad):
    """Device-side finishing of the raw sums: strip block padding, apply
    the 4*pi normalization, and bucket-pad the cell axis — so rho can feed
    straight into the device RHS assembly without a pull."""
    nb = out.shape[0] // p_tile
    r = out.reshape(nb, p_tile)
    r = (r[:, : cpb * n_q] * const).reshape(nb * cpb, n_q)
    if nb * cpb < c_pad:
        r = jnp.pad(r, ((0, c_pad - nb * cpb), (0, 0)))
    return r[:c_pad]


def density_locality_tiles(forest: Forest, points_ref: np.ndarray,
                           positions: np.ndarray, charges: np.ndarray,
                           r_c: float, cutoff: float, device=None,
                           p_tile: int = 512, a_tile: int = 512,
                           plan: Optional[TilePlan] = None,
                           return_device: bool = False,
                           c_pad: Optional[int] = None,
                           chunk_pairs: int = 1 << 25):
    """rho~ per (cell, reference quadrature point), (n_cells, n_q) f32,
    with the 4*pi normalization (src/step-50.cc:553-560) and the EXACT
    production locality semantics (see module docstring).  ``plan`` may be
    passed in when reusing a topology (e.g. measurement loops);
    ``chunk_pairs`` sets the (atom, point) pairs per loop step of
    ``tiles_plain``.

    ``return_device=True``: keep rho ON DEVICE, returned as a
    (c_pad, n_q) bucket-padded array (pad cells exactly zero) for direct
    consumption by the device RHS assembly — no D2H pull."""
    dim = forest.dim
    pref = np.asarray(points_ref, np.float32)
    n_q = len(pref)
    if plan is None:
        plan = build_tile_plan(forest, n_q, positions, charges, cutoff,
                               p_tile=p_tile, a_tile=a_tile)
    C = forest.n_cells
    if c_pad is None:
        # strictly more than C — matches StencilGMG's cell padding (its
        # gather-transpose table needs a guaranteed pad cell)
        c_pad = _next_pow2(C + 1)
    put = (lambda a: jax.device_put(jnp.asarray(a), device)) \
        if device is not None else jnp.asarray
    G = _build_geom(put(plan.cells16), put(pref), dim=dim, n_q=n_q,
                    cpb=plan.cpb, p_tile=plan.p_tile, h0=float(forest.h0),
                    lower0=tuple(float(x) for x in forest.lower))
    items = padded_items(plan.atile, plan.pad_tile)
    common = dict(dim=dim, a_tile=plan.a_tile, r_c=float(r_c),
                  cut=float(cutoff), h0=float(forest.h0))
    out = tiles_plain(put(plan.offsets), put(items), G, put(plan.at),
                      put(plan.wt), chunk=_plain_chunk(
                          chunk_pairs, plan.a_tile, plan.p_tile, len(items)),
                      **common)
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)   # as ops/density.py
    if return_device:
        return _rho_device_postprocess(
            out, np.float32(const), cpb=plan.cpb, n_q=n_q,
            p_tile=plan.p_tile, c_pad=int(c_pad))
    rho = np.asarray(out).reshape(plan.nb, plan.p_tile)[:, : plan.cpb * n_q]
    rho = rho.reshape(plan.nb * plan.cpb, n_q)[:C]
    return (const * rho).astype(np.float32)
