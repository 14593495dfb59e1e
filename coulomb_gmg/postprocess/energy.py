"""Electrostatic energy postprocessing.

Replicates ``postprocess_electrostatic_energy`` (src/step-50.cc:1310-1420):

  (A)  analytic pairwise   sum_{i<j} q_i q_j / r_ij
  (B1) short-range         sum_{i<j} q_i q_j erfc(r_ij / r_c) / r_ij
  (B2) FE long-range       1/2 sum_i q_i phi_h(X_i)   (point evaluation)
  (B3) self energy         sum_i q_i^2 / (sqrt(pi) r_c)
  total(split) = B1 + B2 - B3

and ``postprocess_error_in_energy_norm`` (src/step-50.cc:1423-1461):
  sqrt( sum_cells int ||grad u_h - grad u_exact||^2 ).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import jax.numpy as jnp
from scipy.special import erfc

from coulomb_gmg.mesh.forest import Forest, KeyIndex
from coulomb_gmg.ops.q1 import basis_at, ElementTables
from coulomb_gmg.models.problems import analytic_solution_gradient


def locate_cells(forest: Forest, points: np.ndarray) -> np.ndarray:
    """Active cell index containing each point (the analogue of
    ``GridTools::find_active_cell_around_point``, src/step-50.cc:1353)."""
    per_level = {}
    lvl = forest.level.astype(np.int64)
    for l in range(forest.n_levels):
        sel = np.where(lvl == l)[0]
        keys = forest.level_cell_key(l, forest.ijk[sel])
        order = np.argsort(keys)
        per_level[l] = (KeyIndex(keys), sel[order])
    out = np.full(len(points), -1, dtype=np.int64)
    for l in range(forest.n_levels - 1, -1, -1):
        need = out < 0
        if not need.any():
            break
        h = forest.h(l)
        ijk = np.floor((points[need] - forest.lower) / h).astype(np.int64)
        ijk = np.clip(ijk, 0, forest.side(l) - 1)
        ki, act = per_level[l]
        pos = ki.lookup(forest.level_cell_key(l, ijk))
        hit = pos >= 0
        idx = np.where(need)[0]
        out[idx[hit]] = act[pos[hit]]
    assert (out >= 0).all(), "point outside mesh"
    return out


def point_values(forest: Forest, u: np.ndarray, points: np.ndarray,
                 degree: int = 1) -> np.ndarray:
    """FE field values at arbitrary points (vectorized over points)."""
    cells = locate_cells(forest, points)
    lower = forest.cell_lower(cells)
    h = forest.cell_h(cells)
    t = (points - lower) / h[:, None]
    ucell = np.asarray(u)[forest.dofs_of(degree).cell2dof[cells]]
    phi = np.asarray(basis_at(forest.dim, degree, t)[0])   # (n_pts, nb)
    return np.sum(phi * ucell, axis=1)


def electrostatic_energy(forest: Forest, u: np.ndarray, positions: np.ndarray,
                         charges: np.ndarray, r_c: float,
                         degree: int = 1,
                         phi_at_atoms: np.ndarray = None) -> Dict[str, float]:
    d = positions[:, None, :] - positions[None, :, :]
    r = np.sqrt((d * d).sum(-1))
    iu = np.triu_indices(len(charges), 1)
    qq = np.outer(charges, charges)
    analytic = float((qq[iu] / r[iu]).sum())
    short = float((qq[iu] * erfc(r[iu] / r_c) / r[iu]).sum())
    if phi_at_atoms is None:
        phi_at_atoms = point_values(forest, u, positions, degree=degree)
    fe_long = float(0.5 * np.sum(charges * phi_at_atoms))
    self_e = float(np.sum(charges ** 2) / (np.sqrt(np.pi) * r_c))
    total_split = short + fe_long - self_e
    return {
        "analytic": analytic,
        "short_range": short,
        "fe_long_range": fe_long,
        "self_energy": self_e,
        "total_split": total_split,
        "abs_error": abs(abs(analytic) - abs(total_split)),
        "rel_error": abs((abs(analytic) - abs(total_split)) / analytic),
    }


from functools import partial as _partial

import jax as _jax


@_partial(_jax.jit, static_argnames=("dim", "r_c"))
def _enorm_chunk(ucell, dphi, h, lower, pref, pos, q, r_c, w, valid,
                 dim: int):
    """Energy-norm error contribution of one fixed-size cell chunk.
    The (chunk, n_q, atoms, dim) exact-gradient intermediate is what makes
    the naive whole-mesh evaluation blow past memory (the single largest
    cost of the 216-atom run: 220 s of 310 s); chunking bounds it and the
    jit compiles once."""
    hi = _jax.lax.Precision.HIGHEST
    grad_h = jnp.einsum("cb,qbd->cqd", ucell, dphi,
                        precision=hi) / h[:, None, None]
    pts = lower[:, None, :] + h[:, None, None] * pref[None, :, :]
    grad_ex = analytic_solution_gradient(pts, pos, q, r_c)
    diff2 = jnp.sum((grad_h - grad_ex) ** 2, axis=-1)   # (c, q)
    return jnp.sum(jnp.sum(diff2 * w[None, :], axis=1) * h ** dim * valid)


@_partial(_jax.jit, static_argnames=("dim", "r_c", "chunk", "n_chunks"))
def _enorm_device_loop(ucell, h, lower, valid, dphi, pref, w, pos, q,
                       r_c, chunk: int, n_chunks: int, dim: int):
    """Whole-mesh energy-norm accumulation, device-resident: the mesh
    arrays ship ONCE and a ``fori_loop`` slices chunks device-side — one
    dispatch, one scalar, per cycle (a host loop over chunks would pay a
    transfer and a dispatch per chunk).  ``n_chunks`` is static (the
    caller buckets the padded cell count) so one compile covers every
    adaptive cycle of a run."""
    def body(i, acc):
        s = i * chunk
        sl = lambda a: _jax.lax.dynamic_slice_in_dim(a, s, chunk, 0)
        return acc + _enorm_chunk(sl(ucell), dphi, sl(h), sl(lower), pref,
                                  pos, q, r_c, w, sl(valid), dim=dim)
    return _jax.lax.fori_loop(0, n_chunks, body,
                              jnp.zeros((), ucell.dtype))


# per-(device, chunk) sticky padded chunk count — see the shape
# stabilization note inside energy_norm_error
_ENORM_STICKY: dict = {}


def energy_norm_error(forest: Forest, tables: ElementTables, u,
                      positions, charges, r_c: float,
                      chunk: int = 2048, device=None, dtype=None) -> float:
    """sqrt( sum_c int ||grad u_h - grad u_exact||^2 dx ), laplace rule
    (src/step-50.cc:1423-1461), chunked over cells.  With ``device``, the
    whole accumulation runs on that device as one dispatch (ONE final
    pull)."""
    import jax as _j
    dim = forest.dim
    n = forest.n_cells
    dt = dtype or np.float64

    def put(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(dt)
        return _j.device_put(a, device) if device is not None \
            else jnp.asarray(a)

    h = forest.cell_h()
    lower = forest.cell_lower()
    ucell = np.asarray(u)[forest.dofs_of(tables.degree).cell2dof]  # (c, nb)
    dphi = put(tables.dphi)
    pref = put(tables.points)
    w = put(tables.weights)
    pos = put(positions)
    q = put(charges)
    if device is not None:
        # bound the (chunk, n_q, atoms) gradient intermediate to ~2^26
        # pair terms per loop step
        fit = (1 << 26) // max(len(tables.points) * len(positions), 1)
        chunk = 1 << max(int(np.log2(max(fit, 1))), 0)
    chunk = min(chunk, max(n, 1))
    n_chunks = (n + chunk - 1) // chunk
    if device is not None and n_chunks > 16:
        # shape-stabilize the chunk count so every adaptive cycle of a run
        # hits the SAME compiled executable (a recompile costs far more
        # than running a few padded chunks).  First sizing for this
        # (device, chunk) pre-pads 25% headroom (production meshes grow
        # ~13% over 5 cycles); later cycles reuse it while they fit and
        # re-pad with fresh headroom if exceeded.
        key = (getattr(device, "id", None), chunk)
        sticky = _ENORM_STICKY.get(key, 0)
        if n_chunks <= sticky:
            n_chunks = sticky
        else:
            n_chunks = ((int(n_chunks * 1.25) + 15) // 16) * 16
            _ENORM_STICKY[key] = n_chunks
    n_pad = n_chunks * chunk
    h_p = np.ones(n_pad); h_p[:n] = h
    lo_p = np.zeros((n_pad, dim)); lo_p[:n] = lower
    uc_p = np.zeros((n_pad,) + ucell.shape[1:]); uc_p[:n] = ucell
    val_p = np.zeros(n_pad); val_p[:n] = 1.0

    if device is not None:
        err = _enorm_device_loop(
            put(uc_p), put(h_p), put(lo_p), put(val_p),
            dphi, pref, w, pos, q, float(r_c), chunk, n_chunks, dim)
        return float(np.sqrt(np.asarray(err)))

    err = None
    for s in range(0, n_pad, chunk):
        e = _enorm_chunk(
            put(uc_p[s:s + chunk]), dphi,
            put(h_p[s:s + chunk]), put(lo_p[s:s + chunk]),
            pref, pos, q, float(r_c), w, put(val_p[s:s + chunk]), dim=dim)
        err = e if err is None else err + e
    return float(np.sqrt(np.asarray(err)))
