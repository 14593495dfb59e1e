"""Batched element integrals on axis-aligned cubic cells.

Because every cell is a cube of size h, the deal.II FEValues pipeline
(``src/step-50.cc:744-790``) reduces to closed-form contractions of
precomputed reference tables:

  K[c,i,j] = h_c^{dim-2} * sum_q c(x_q) w_q (grad phi_i . grad phi_j)(q)
  f[c,i]   = h_c^{dim}   * sum_q rho(x_q) w_q phi_i(q)

shaped as (n_cells, n_q) @ (n_q, nb*nb) matmuls, not loops.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_gmg.ops.q1 import ElementTables


def stiffness_cells(tables: ElementTables, h, coeff_q=None, dtype=None):
    """(n_cells, nb, nb) stiffness matrices.

    coeff_q: (n_cells, n_q) coefficient at quadrature points, or None for
    unit coefficient (GaussianCharges, include/step_50.h:331-336)."""
    h = jnp.asarray(h)
    dtype = dtype or h.dtype
    scale = h ** (tables.dim - 2)
    w = jnp.asarray(tables.weights, dtype)
    G = jnp.asarray(tables.grad_outer, dtype)      # (n_q, nb, nb)
    hi = jax.lax.Precision.HIGHEST
    if coeff_q is None:
        k_ref = jnp.einsum("q,qij->ij", w, G, precision=hi)
        return scale[:, None, None] * k_ref[None, :, :]
    cw = jnp.asarray(coeff_q, dtype) * w[None, :]
    k = jnp.einsum("cq,qij->cij", cw, G, precision=hi)
    return scale[:, None, None] * k


def rhs_cells(tables: ElementTables, h, rho_q, dtype=None):
    """(n_cells, nb) load vectors from density values at quadrature points."""
    h = jnp.asarray(h)
    dtype = dtype or h.dtype
    w = jnp.asarray(tables.weights, dtype)
    phi = jnp.asarray(tables.phi, dtype)           # (n_q, nb)
    f = jnp.matmul(jnp.asarray(rho_q, dtype) * w[None, :], phi,
                   precision=jax.lax.Precision.HIGHEST)
    return (h ** tables.dim)[:, None] * f


def stiffness_cells_np(tables: ElementTables, h, coeff_q=None,
                       dtype=np.float64):
    """Numpy twin of :func:`stiffness_cells` for host orchestration (the
    per-cycle shapes are fresh each adaptive cycle; see assemble_np)."""
    h = np.asarray(h, dtype)
    scale = h ** (tables.dim - 2)
    w = np.asarray(tables.weights, dtype)
    G = np.asarray(tables.grad_outer, dtype)
    if coeff_q is None:
        k_ref = np.einsum("q,qij->ij", w, G)
        return scale[:, None, None] * k_ref[None, :, :]
    cw = np.asarray(coeff_q, dtype) * w[None, :]
    k = np.tensordot(cw, G, axes=([1], [0]))
    return scale[:, None, None] * k


def rhs_cells_np(tables: ElementTables, h, rho_q, dtype=np.float64):
    """Numpy twin of :func:`rhs_cells`."""
    h = np.asarray(h, dtype)
    w = np.asarray(tables.weights, dtype)
    phi = np.asarray(tables.phi, dtype)
    f = (np.asarray(rho_q, dtype) * w[None, :]) @ phi
    return (h ** tables.dim)[:, None] * f
