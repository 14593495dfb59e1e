"""Analytic problem definitions (RHS, coefficients, exact solutions, BCs).

Vectorized (jnp, jit-compatible) equivalents of the reference's deal.II
``Function`` objects in ``include/step_50.h:216-386``.  All functions take
points of shape ``(N, dim)`` and return ``(N,)`` (or ``(N, dim)`` for
gradients).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import erf


SQRT_PI = float(np.sqrt(np.pi))


# ---------------------------------------------------------------- Step16

def step16_rhs(points):
    """f = 10 (include/step_50.h:240-244)."""
    return jnp.full(points.shape[:-1], 10.0, dtype=points.dtype)


def step16_coefficient(points):
    """c = 5 inside r < 0.5, else 1 (include/step_50.h:246-254)."""
    r2 = jnp.sum(points * points, axis=-1)
    return jnp.where(r2 < 0.25, 5.0, 1.0).astype(points.dtype)


# ---------------------------------------------------------------- GaussianCharges

def gaussian_rhs(points, r_c: float):
    """Analytic two-Gaussian RHS used when no LAMMPS file is given:
    (8 e^{-4 r^2/r_c^2} - e^{-r^2/r_c^2}) / (r_c^3 pi^{3/2})
    (include/step_50.h:322-329)."""
    r2 = jnp.sum(points * points, axis=-1)
    c = r2 / (r_c * r_c)
    return (8.0 * jnp.exp(-4.0 * c) - jnp.exp(-c)) / (r_c ** 3 * np.pi ** 1.5)


def gaussian_coefficient(points):
    """c = 1 (include/step_50.h:331-336)."""
    return jnp.ones(points.shape[:-1], dtype=points.dtype)


def charge_density(points, atom_positions, charges, r_c: float):
    """Smeared charge density (with the 4*pi of the weak form folded in):
    rho~(x) = sum_k q_k * 4 pi / (r_c^3 pi^{3/2}) * exp(-|x - X_k|^2 / r_c^2)
    (src/step-50.cc:522, 544-553)."""
    const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)
    diff = points[..., None, :] - atom_positions  # (N, n_atoms, dim)
    r2 = jnp.sum(diff * diff, axis=-1)
    return const * jnp.sum(jnp.exp(-r2 / (r_c * r_c)) * charges, axis=-1)


def analytic_solution(points, atom_positions, charges, r_c: float):
    """phi(x) = sum_i q_i erf(|x - X_i| / r_c) / |x - X_i|, with the
    r -> 0 limit 2 q / (sqrt(pi) r_c) (include/step_50.h:338-353)."""
    inv_const = 1.0 / (SQRT_PI * r_c)
    diff = points[..., None, :] - atom_positions
    r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    safe_r = jnp.where(r < 1e-10, 1.0, r)
    vals = jnp.where(r < 1e-10, 2.0 * inv_const, erf(safe_r / r_c) / safe_r)
    return jnp.sum(vals * charges, axis=-1)


def analytic_solution_gradient(points, atom_positions, charges, r_c: float):
    """grad phi (include/step_50.h:355-369).  Matches the reference formula,
    including its (removable) singularity handling: the gradient is zero at
    an atom position in the limit."""
    inv_const = 1.0 / (SQRT_PI * r_c)
    diff = points[..., None, :] - atom_positions       # (N, A, dim)
    r = jnp.sqrt(jnp.sum(diff * diff, axis=-1))        # (N, A)
    safe_r = jnp.where(r < 1e-14, 1.0, r)
    rq = safe_r / r_c
    radial = (2.0 * safe_r * jnp.exp(-rq * rq) * inv_const
              - erf(rq)) / (safe_r * safe_r)
    radial = jnp.where(r < 1e-14, 0.0, radial)
    unit = diff / safe_r[..., None]
    return jnp.sum((charges * radial)[..., None] * unit, axis=-2)


def analytic_solution_without_lammps(points, r_c: float):
    """(erf(2 r / r_c) - erf(r / r_c)) / (4 pi r)
    (include/step_50.h:371-376)."""
    r = jnp.sqrt(jnp.sum(points * points, axis=-1))
    safe_r = jnp.where(r < 1e-14, 1.0, r)
    limit = (2.0 / SQRT_PI) * (2.0 - 1.0) / (4.0 * np.pi * r_c)
    val = (erf(2.0 * safe_r / r_c) - erf(safe_r / r_c)) / (4.0 * np.pi * safe_r)
    return jnp.where(r < 1e-14, limit, val)


def nonzero_dbc(points, x0, dipole, quadrupole):
    """Multipole far-field boundary values:
    p0.(x-x0)/|x-x0|^3 + 0.5 (x-x0)^T Q0 (x-x0) / |x-x0|^5
    (include/step_50.h:378-385).  The reference zeroes the quadrupole after
    computing it (src/step-50.cc:624), so in practice this is dipole-only."""
    d = points - x0
    norm = jnp.sqrt(jnp.sum(d * d, axis=-1))
    hi = jax.lax.Precision.HIGHEST
    xqx = jnp.einsum("...i,ij,...j->...", d, jnp.asarray(quadrupole), d,
                     precision=hi)
    p0 = jnp.matmul(d, jnp.asarray(dipole), precision=hi)
    return p0 / norm ** 3 + 0.5 * xqx / norm ** 5


def compute_dipole_moment(atom_positions, charges):
    """p0 = sum_k q_k X_k (src/step-50.cc:588-590)."""
    return np.asarray(atom_positions).T @ np.asarray(charges)


def compute_quadrupole_moment(quad_points, jxw, rho):
    """Q0 = integral rho(x) (3 x (x) x - |x|^2 I) dV by quadrature
    (src/step-50.cc:595-623): ``quad_points`` (cells, q, dim), ``jxw``
    (cells, q), ``rho`` (cells, q).  NOTE the reference explicitly zeroes
    the result right after the MPI sum (src/step-50.cc:624), so callers
    should do the same for golden parity — this function returns the
    actual integral for completeness/testing."""
    dim = np.asarray(quad_points).shape[-1]
    x = np.asarray(quad_points).reshape(-1, dim)
    w = (np.asarray(jxw) * np.asarray(rho)).reshape(-1)
    # second moment S_ij = sum w x_i x_j as one (dim, N)@(N, dim) matmul;
    # Q = 3 S - tr(S) I  (since sum w |x|^2 = tr S)
    S = (x * w[:, None]).T @ x
    return 3.0 * S - np.trace(S) * np.eye(dim)


def quadrupole_from_forest(forest, points_ref, weights, rho,
                           chunk: int = 65536):
    """Quadrupole integral over the mesh without materializing all physical
    quadrature points: chunked second-moment accumulation
    (src/step-50.cc:595-623; the reference then zeroes the result, :624)."""
    dim = forest.dim
    lower = forest.cell_lower().astype(np.float32)
    h = forest.cell_h().astype(np.float32)
    pr = np.asarray(points_ref, np.float32)
    wq = np.asarray(weights, np.float32)
    rho = np.asarray(rho, np.float32)
    n = forest.n_cells
    S = np.zeros((dim, dim), np.float64)
    wsum = 0.0
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = (lower[s:e, None, :] + h[s:e, None, None] * pr[None, :, :])
        x = x.reshape(-1, dim)
        w = ((h[s:e] ** dim)[:, None] * wq[None, :] * rho[s:e]).reshape(-1)
        S += ((x * w[:, None]).T @ x).astype(np.float64)
    return 3.0 * S - np.trace(S) * np.eye(dim)
