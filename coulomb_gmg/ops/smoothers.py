"""Multigrid smoothers.

The reference smooths with Trilinos ``PreconditionSSOR`` (damping 0.5, two
steps, src/step-50.cc:969-973) — an inherently sequential sweep.  This
framework provides:

* ``ssor``: exact sequential SSOR via sparse triangular solves (host/scipy,
  float64) — bit-compatible with the single-rank reference for golden-parity
  tests;
* ``mc_ssor``: multicolor (2^dim-color) symmetric Gauss-Seidel — the same
  operation reordered by lattice parity so each color update is a masked SpMV;
  fully jit-able, used for performance runs;
* ``jacobi``: damped point Jacobi (reference's alternative path,
  src/step-50.cc:996-1005);
* ``chebyshev``: degree-k Chebyshev acceleration of Jacobi, the classic
  communication-free GPU smoother.

All are exposed as ``precond(r) -> z`` callables (approximate A^{-1});
``MGSmoother`` wraps them with the deal.II ``MGSmootherPrecondition``
stepping scheme: u <- u + M^{-1}(rhs - A u), `steps` times, with the first
step optimized to u = M^{-1} rhs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import jax.numpy as jnp


def make_jacobi(A, damping: float = 0.6):
    """Damped Jacobi preconditioner: z = damping * r / diag(A)."""
    inv_diag = damping / A.diagonal()

    def precond(r):
        return inv_diag * r
    return precond


def make_ssor_host(A, omega: float = 0.5):
    """Exact sequential SSOR (one symmetric sweep, zero initial guess):

      forward  i asc : y_i += omega * (r_i - sum_j a_ij y_j) / a_ii
      backward i desc: y_i += omega * (r_i - sum_j a_ij y_j) / a_ii

    Expressed with triangular solves:
      y1 = (D/omega + L)^{-1} r
      y  = y1 + (D/omega + U)^{-1} (r - A y1)
    Host-side scipy; used for reference-parity tests.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    S = A.to_scipy().tocsr()
    D = S.diagonal()
    L = sp.tril(S, k=-1, format="csr")
    U = sp.triu(S, k=1, format="csr")
    Dw = sp.diags(D / omega)
    lowerM = (Dw + L).tocsr()
    upperM = (Dw + U).tocsr()

    def precond(r):
        r = np.asarray(r)
        y1 = spla.spsolve_triangular(lowerM, r, lower=True)
        y = y1 + spla.spsolve_triangular(upperM, r - S @ y1, lower=False)
        return jnp.asarray(y)
    return precond


def make_mc_ssor(A, color: np.ndarray, omega: float = 0.5):
    """Multicolor symmetric Gauss-Seidel: within a color all updates are
    independent, so each half-sweep visits the colors in order with a
    per-color defect-correction update — pure jnp, jit friendly.

    O(nnz) per half-sweep: each color's update reads ONLY its own rows,
    pre-sliced into a padded per-color ELL block (gather + row-sum), so a
    full symmetric application costs 2*nnz — not the 2*n_colors full
    matvecs (16 in 3D) of a masked-matvec formulation.  Same math: the
    update for row i of color c is y_i += omega/a_ii * (r_i - A_i.y) with
    y as left by the previous colors (src/step-50.cc:969-973 semantics,
    reordered by color).

    color: (n,) int — lattice-parity coloring (2^dim colors for Q1 stencils
    guarantees no same-color coupling on uniform regions; stray same-color
    couplings at refinement edges only perturb the smoother slightly).
    """
    n_colors = int(color.max()) + 1 if len(color) else 1
    diag = np.asarray(A.diagonal())
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    data = np.asarray(A.data)
    counts = np.diff(indptr)
    slices = []
    for c in range(n_colors):
        rows = np.where(np.asarray(color) == c)[0]
        if len(rows) == 0:
            continue
        starts, lens = indptr[rows], counts[rows]
        total = int(lens.sum())
        off = np.repeat(lens.cumsum() - lens, lens)
        k_in_row = np.arange(total) - off
        src = np.repeat(starts, lens) + k_in_row
        K = max(int(lens.max()) if len(lens) else 1, 1)
        cols = np.zeros((len(rows), K), np.int64)
        vals = np.zeros((len(rows), K), data.dtype)
        rpos = np.repeat(np.arange(len(rows)), lens)
        cols[rpos, k_in_row] = indices[src]
        vals[rpos, k_in_row] = data[src]
        slices.append((jnp.asarray(rows), jnp.asarray(cols),
                       jnp.asarray(vals),
                       jnp.asarray(omega / diag[rows])))

    def precond(r):
        y = jnp.zeros_like(r)

        def upd(y, sl):
            rows, cols, vals, w = sl
            resid = r[rows] - jnp.sum(vals * y[cols], axis=1)
            return y.at[rows].add(w * resid)

        for sl in slices:
            y = upd(y, sl)
        for sl in reversed(slices):
            y = upd(y, sl)
        return y
    return precond


def make_chebyshev(A, degree: int = 4, eig_ratio: float = 30.0,
                   lambda_max: Optional[float] = None):
    """Chebyshev(degree) smoother on the Jacobi-preconditioned operator.
    lambda_max estimated by power iteration on D^{-1}A if not given."""
    inv_diag = 1.0 / A.diagonal()
    if lambda_max is None:
        # host-side power iteration (scipy SpMV): cheap, and avoids a dozen
        # eager XLA dispatches on fresh per-cycle shapes
        S = A.to_scipy()
        d = np.asarray(inv_diag, np.float64)
        x = np.ones(A.n_rows)
        for _ in range(12):
            x = d * (S @ x)
            nrm = np.linalg.norm(x)
            if nrm == 0:
                break
            x = x / nrm
        lambda_max = float(x @ (d * (S @ x))) if np.linalg.norm(x) else 1.0
        lambda_max *= 1.1
    lmax = lambda_max
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def precond(r):
        # standard Chebyshev iteration for z ~ (D^{-1}A)^{-1} D^{-1} r
        rd = inv_diag * r
        z = rd / theta
        p = z
        sigma = theta / delta
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            resid = rd - inv_diag * A.matvec(z)
            rho = 1.0 / (2.0 * sigma - rho_old)
            p = rho * rho_old * p + (2.0 * rho / delta) * resid
            z = z + p
            rho_old = rho
        return z
    return precond


@dataclass
class MGSmoother:
    """deal.II ``MGSmootherPrecondition`` stepping (set_steps(k)):
    ``apply``: u = M^{-1} rhs, then (k-1) defect-correction steps;
    ``smooth``: k defect-correction steps from the current u."""

    A: object                       # CSR-like with .matvec
    precond: Callable
    steps: int = 2

    def apply(self, rhs):
        u = self.precond(rhs)
        for _ in range(self.steps - 1):
            u = u + self.precond(rhs - self.A.matvec(u))
        return u

    def smooth(self, u, rhs):
        for _ in range(self.steps):
            u = u + self.precond(rhs - self.A.matvec(u))
        return u


def lattice_color(forest, level_dofs) -> np.ndarray:
    """2^dim-coloring of level dofs by parity of their lattice coords at the
    level's resolution.  For Q_p the node lattice is p-times finer; parity is
    taken at the per-cell-node resolution (s = node spacing), which still
    decouples same-colored nodes for Q1; for p > 1 it is a heuristic
    coloring (use jacobi/chebyshev there)."""
    p = getattr(level_dofs, "degree", 1)
    coords = forest.nkey_to_coords(level_dofs.keys, p)
    s = 1 << (forest.max_level - level_dofs.level)
    par = (coords // s) & 1
    color = np.zeros(len(coords), dtype=np.int64)
    for d in range(forest.dim):
        color |= par[:, d].astype(np.int64) << d
    return color
