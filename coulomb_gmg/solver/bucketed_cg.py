"""Shape-bucketed Jacobi-path solve kernel.

Every new (op, shape) pair costs a compile, so this solve path is ONE
jitted kernel whose shapes are padded to power-of-two buckets: across
adaptive cycles the same executable is reused even though DoF/nnz counts
change.  The kernel is a Chebyshev(4)-preconditioned CG on COO operators —
the data-parallel replacement for sequential-SSOR when SpMV is so cheap
that iteration count stops mattering (the GMG path remains the CPU/parity
solver).

tol is a traced scalar (no recompile when it changes); maxiter, degree and
the padded sizes are static.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _cheby_cg_body(matvec, rhs, x0, inv_diag, tol, maxiter: int,
                   degree: int = 4):

    # lambda_max of D^{-1}A by fixed power iteration (smoother bound)
    v = jnp.ones_like(rhs)
    def power(i, v):
        w = inv_diag * matvec(v)
        return w / jnp.linalg.norm(w)
    v = lax.fori_loop(0, 12, power, v)
    lmax = jnp.vdot(v, inv_diag * matvec(v)) * 1.1
    lmin = lmax / 30.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def precond(r):
        rd = inv_diag * r
        z = rd / theta
        p = z
        sigma = theta / delta
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            resid = rd - inv_diag * matvec(z)
            rho = 1.0 / (2.0 * sigma - rho_old)
            p = rho * rho_old * p + (2.0 * rho / delta) * resid
            z = z + p
            rho_old = rho
        return z

    x = x0
    r = rhs - matvec(x)
    res0 = jnp.linalg.norm(r)
    z = precond(r)
    rho = jnp.vdot(r, z)

    def cond(s):
        return (s[5] >= tol) & (s[6] < maxiter)

    def body(s):
        x, r, z, p, rho, res, k = s
        q = matvec(p)
        alpha = rho / jnp.vdot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        res = jnp.linalg.norm(r)
        z = precond(r)
        rho_new = jnp.vdot(r, z)
        p = z + (rho_new / rho) * p
        return (x, r, z, p, rho_new, res, k + 1)

    s = (x, r, z, z, rho, res0, jnp.asarray(0, jnp.int32))
    x, r, z, p, rho, res, k = lax.while_loop(cond, body, s)
    return x, k, res0, res


@partial(jax.jit, static_argnames=("n_rows", "maxiter", "degree"))
def _cheby_cg_coo(rowids, cols, data, rhs, x0, inv_diag, tol, n_rows: int,
                  maxiter: int, degree: int = 4):
    def matvec(x):
        vals = data * x[cols]
        return jnp.zeros(n_rows, vals.dtype).at[rowids].add(vals)
    return _cheby_cg_body(matvec, rhs, x0, inv_diag, tol, maxiter, degree)


@partial(jax.jit, static_argnames=("maxiter", "degree"))
def _cheby_cg_ell(ecols, evals, rhs, x0, inv_diag, tol,
                  maxiter: int, degree: int = 4):
    from coulomb_gmg.ops.ell import ell_matvec

    def matvec(x):
        return ell_matvec(ecols, evals, x)
    return _cheby_cg_body(matvec, rhs, x0, inv_diag, tol, maxiter, degree)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def bucketed_cg_solve(rowids, cols, data, rhs, x0=None, *, diag=None,
                 rtol: float = 1e-6, maxiter: int = 2000,
                 device=None, dtype=jnp.float32, layout: str = "ell"):
    """Bucket-padded Chebyshev-CG solve.  Host-facing wrapper: numpy in,
    numpy out; pads sizes to power-of-two buckets so repeated calls across
    adaptive cycles reuse the compiled kernel.

    layout="ell" (default): gather-only ELL SpMV — the device hot path
    (no scatter).  layout="coo": segment scatter-add (kept for comparison and
    for pathological row-length distributions)."""
    n = len(rhs)
    n_pad = _next_pow2(n + 1)
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64

    b = np.zeros(n_pad, np_dtype)
    b[:n] = np.asarray(rhs, np_dtype)
    x = np.zeros(n_pad, np_dtype)
    if x0 is not None:
        x[:n] = np.asarray(x0, np_dtype)
    if diag is None:
        diag_full = np.zeros(n_pad, np_dtype)
        sel = np.asarray(rowids) == np.asarray(cols)
        np.add.at(diag_full, np.asarray(rowids)[sel],
                  np.asarray(data, np_dtype)[sel])
    else:
        diag_full = np.zeros(n_pad, np_dtype)
        diag_full[:n] = np.asarray(diag, np_dtype)
    diag_full[diag_full == 0] = 1.0
    inv_diag = (1.0 / diag_full).astype(np_dtype)

    put = (lambda a: jax.device_put(a, device)) if device is not None \
        else jnp.asarray
    tol = rtol * float(np.linalg.norm(b))

    if layout == "ell":
        from coulomb_gmg.ops.ell import ELL
        e = ELL.from_coo(np.asarray(rowids), np.asarray(cols),
                         np.asarray(data, np_dtype), n, n,
                         pad_rows_to=n_pad, pad_k_to=None)
        # bucket K to a multiple of 8 so K jitter across cycles rarely
        # forces a recompile
        K_pad = _round_up(e.K, 8)
        if K_pad != e.K:
            ecols = np.zeros((e.n_rows, K_pad), np.int32)
            evals = np.zeros((e.n_rows, K_pad), np_dtype)
            ecols[:, : e.K] = e.cols
            evals[:, : e.K] = e.vals
        else:
            ecols, evals = e.cols, e.vals
        xj, k, res0, res = _cheby_cg_ell(
            put(ecols), put(evals), put(b), put(x), put(inv_diag),
            put(np.asarray(tol, np_dtype)), maxiter=maxiter)
    else:
        nnz = len(data)
        nnz_pad = _next_pow2(nnz)
        ri = np.full(nnz_pad, n_pad - 1, dtype=np.int32)
        ci = np.zeros(nnz_pad, dtype=np.int32)
        dv = np.zeros(nnz_pad, dtype=np_dtype)
        ri[:nnz] = rowids
        ci[:nnz] = cols
        dv[:nnz] = np.asarray(data, np_dtype)
        xj, k, res0, res = _cheby_cg_coo(
            put(ri), put(ci), put(dv), put(b), put(x), put(inv_diag),
            put(np.asarray(tol, np_dtype)), n_rows=n_pad, maxiter=maxiter)
    return (np.asarray(xj)[:n], int(k), float(res0), float(res))
