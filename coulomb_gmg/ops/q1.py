"""Tensor-product Lagrange (Q_p) reference-element tables on axis-aligned
boxes.

The reference leans on deal.II ``FEValues`` + ``QGauss`` for all element
integrals (``src/step-50.cc:744-749``).  Because every cell in this framework
is an axis-aligned cube, the Jacobian is diagonal and constant, so shape
values/gradients on the reference cell are precomputed *once* as dense
tables, and per-cell integrals become batched contractions —
``(n_cells, n_q) @ (n_q, n_basis^2)`` matmuls instead of per-cell loops.

Vertex/DoF ordering: deal.II lexicographic-by-bit (x fastest): local dof v
has reference coords ``((v>>0)&1, (v>>1)&1, (v>>2)&1)`` scaled by node
spacing (degree 1: corners).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np


def gauss_rule(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1] (matches deal.II QGauss)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def lagrange_nodes_1d(degree: int) -> np.ndarray:
    """Equidistant support points, ALL degrees — a deliberate deviation
    from deal.II's FE_Q (Gauss-Lobatto points for degree >= 3).

    The span (the FE space) is identical either way, so cells/DoF counts,
    energies and energy-norm errors match the reference for every degree;
    only the meaning of individual coefficients — and hence the logged
    solution/rhs VECTOR norms — differs for p >= 3 (they agree exactly for
    p <= 2, where Gauss-Lobatto == equidistant; all golden suites are p=1).

    Why not Gauss-Lobatto: DoF identity here is a uniform integer node
    lattice (mesh/dofs.py) — a hanging fine-side node whose lattice key is
    an even multiple of the half-spacing coincides GEOMETRICALLY with a
    coarse node only for equidistant nodes, which is what lets the lattice
    merge them into one DoF (the exact analogue of deal.II's weight-1.0
    hanging constraint).  Gauss-Lobatto would alias two distinct continuum
    points under one key, so it needs entity-based DoF identification, not
    a lattice.  Equidistant conditioning is acceptable through the p <= 4
    range the reference exercises."""
    return np.linspace(0.0, 1.0, degree + 1)


def _lagrange_eval(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the 1-D Lagrange basis at points x.
    Returns (val[m, p+1], der[m, p+1])."""
    m, p1 = len(x), len(nodes)
    val = np.ones((m, p1))
    der = np.zeros((m, p1))
    for i in range(p1):
        for j in range(p1):
            if j == i:
                continue
            val[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        # derivative by sum-over-excluded-factor
        for k in range(p1):
            if k == i:
                continue
            term = np.ones(m) / (nodes[i] - nodes[k])
            for j in range(p1):
                if j in (i, k):
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            der[:, i] += term
    return val, der


@dataclass(frozen=True)
class ElementTables:
    """Reference-cell tables for Q_degree on [0,1]^dim with an n_q1^dim
    Gauss rule.  All arrays are numpy float64; jitted code converts once."""

    dim: int
    degree: int
    n_q1: int
    points: np.ndarray        # (n_q, dim) quadrature points on [0,1]^dim
    weights: np.ndarray       # (n_q,)
    phi: np.ndarray           # (n_q, n_basis) shape values
    dphi: np.ndarray          # (n_q, n_basis, dim) reference gradients
    grad_outer: np.ndarray    # (n_q, n_basis, n_basis) sum_d dphi_i,d dphi_j,d
    mass_ref: np.ndarray      # (n_basis, n_basis) reference mass (unit cell)

    @property
    def n_q(self) -> int:
        return len(self.weights)

    @property
    def n_basis(self) -> int:
        return self.phi.shape[1]


@lru_cache(maxsize=None)
def element_tables(dim: int, degree: int, n_q1: int) -> ElementTables:
    x1, w1 = gauss_rule(n_q1)
    nodes = lagrange_nodes_1d(degree)
    v1, d1 = _lagrange_eval(nodes, x1)            # (n_q1, p+1)
    p1 = degree + 1

    # tensor products; axis d varies with bit/“digit” d, x fastest in dof id
    qs = [x1] * dim
    pts = np.stack(np.meshgrid(*qs, indexing="ij"), axis=-1)
    # quadrature index ordering: q = sum_d q_d * n_q1^d (x fastest) — any
    # consistent order works; use x slowest via ij-meshgrid then flatten.
    points = pts.reshape(-1, dim)
    wgrid = np.ones([n_q1] * dim)
    for d in range(dim):
        shape = [1] * dim
        shape[d] = n_q1
        wgrid = wgrid * w1.reshape(shape)
    weights = wgrid.reshape(-1)

    n_basis = p1 ** dim
    n_q = len(weights)
    phi = np.ones((n_q, n_basis))
    dphi = np.zeros((n_q, n_basis, dim))
    # map flat q index -> per-axis index (consistent with meshgrid 'ij'
    # + reshape: axis dim-1 fastest)
    qidx = np.indices([n_q1] * dim).reshape(dim, -1).T  # (n_q, dim), axis0=x
    for b in range(n_basis):
        digits = []
        bb = b
        for d in range(dim):
            digits.append(bb // (p1 ** (dim - 1 - d)) if False else 0)
        # dof digit along axis d (x fastest): digit_d = (b // (p1**d)) % p1
        digits = [(b // (p1 ** d)) % p1 for d in range(dim)]
        for d in range(dim):
            phi[:, b] *= v1[qidx[:, d], digits[d]]
        for g in range(dim):
            grad = np.ones(n_q)
            for d in range(dim):
                tab = d1 if d == g else v1
                grad *= tab[qidx[:, d], digits[d]]
            dphi[:, b, g] = grad

    grad_outer = np.einsum("qid,qjd->qij", dphi, dphi)
    mass_ref = np.einsum("q,qi,qj->ij", weights, phi, phi)
    return ElementTables(dim=dim, degree=degree, n_q1=n_q1,
                         points=points, weights=weights, phi=phi, dphi=dphi,
                         grad_outer=grad_outer, mass_ref=mass_ref)


@lru_cache(maxsize=None)
def face_tables(dim: int, degree: int, n_q1: int):
    """Face quadrature for Kelly jump integrals: for each of the 2*dim faces,
    (points (n_fq, dim) on the reference cell, weights (n_fq,), plus shape
    values/gradients of the cell basis at those points).

    Face id f: axis = f // 2, side = f % 2 (0 = low, 1 = high) — matching
    deal.II face ordering.
    """
    x1, w1 = gauss_rule(n_q1)
    out = []
    for f in range(2 * dim):
        axis, side = f // 2, f % 2
        if dim == 2:
            tang = x1.reshape(-1, 1)
            weights = w1
        else:
            a, b = np.meshgrid(x1, x1, indexing="ij")
            tang = np.stack([a.reshape(-1), b.reshape(-1)], axis=-1)
            weights = np.outer(w1, w1).reshape(-1)
        pts = np.zeros((len(weights), dim))
        free_axes = [d for d in range(dim) if d != axis]
        for k, d in enumerate(free_axes):
            pts[:, d] = tang[:, k]
        pts[:, axis] = float(side)
        tabs = _basis_at(dim, degree, pts)
        out.append((pts, weights, tabs[0], tabs[1]))
    return out


def _basis_at(dim: int, degree: int, pts: np.ndarray):
    """Shape values (m, n_basis) and reference gradients (m, n_basis, dim)
    of Q_degree at arbitrary reference points."""
    nodes = lagrange_nodes_1d(degree)
    p1 = degree + 1
    n_basis = p1 ** dim
    m = len(pts)
    vals = np.ones((m, n_basis))
    grads = np.zeros((m, n_basis, dim))
    per_axis = [_lagrange_eval(nodes, pts[:, d]) for d in range(dim)]
    for b in range(n_basis):
        digits = [(b // (p1 ** d)) % p1 for d in range(dim)]
        for d in range(dim):
            vals[:, b] *= per_axis[d][0][:, digits[d]]
        for g in range(dim):
            grad = np.ones(m)
            for d in range(dim):
                tab = per_axis[d][1] if d == g else per_axis[d][0]
                grad *= tab[:, digits[d]]
            grads[:, b, g] = grad
    return vals, grads


def basis_at(dim: int, degree: int, pts: np.ndarray):
    """Public wrapper (used for point evaluation of the FE field, the
    analogue of ``GridTools::find_active_cell_around_point`` + ``FEValues``
    at an arbitrary point, src/step-50.cc:1353-1363)."""
    return _basis_at(dim, degree, pts)


def _lagrange_eval2(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Second derivatives of the 1-D Lagrange basis at points x: (m, p+1)."""
    m, p1 = len(x), len(nodes)
    d2 = np.zeros((m, p1))
    for i in range(p1):
        for k in range(p1):
            if k == i:
                continue
            for kk in range(p1):
                if kk in (i, k):
                    continue
                term = np.ones(m) / ((nodes[i] - nodes[k])
                                     * (nodes[i] - nodes[kk]))
                for j in range(p1):
                    if j in (i, k, kk):
                        continue
                    term *= (x - nodes[j]) / (nodes[i] - nodes[j])
                d2[:, i] += term
    return d2


def lap_basis_at(dim: int, degree: int, pts: np.ndarray) -> np.ndarray:
    """Reference-cell Laplacian of the Q_degree basis at arbitrary points:
    (m, n_basis) with lap_b = sum_d d2phi_b/dx_d^2 (physical Laplacian =
    this / h^2 on a cube of size h).  Identically zero for degree 1 — the
    volume-residual term of the Kelly estimator needs it for higher degree
    (the reference evaluates solution Hessians, src/step-50.cc:1052-1082)."""
    nodes = lagrange_nodes_1d(degree)
    p1 = degree + 1
    n_basis = p1 ** dim
    m = len(pts)
    out = np.zeros((m, n_basis))
    per_val = [_lagrange_eval(nodes, pts[:, d])[0] for d in range(dim)]
    per_d2 = [_lagrange_eval2(nodes, pts[:, d]) for d in range(dim)]
    for b in range(n_basis):
        digits = [(b // (p1 ** d)) % p1 for d in range(dim)]
        for g in range(dim):
            term = np.ones(m)
            for d in range(dim):
                tab = per_d2[d] if d == g else per_val[d]
                term *= tab[:, digits[d]]
            out[:, b] += term
    return out
