"""Sparse matrix-vector products for XLA.

The parity/CPU path uses a COO gather/scatter formulation (jit-friendly,
deterministic in f64 via sorted segment ids); the device hot path uses a
padded ELL layout (``ops/ell.py``) where every row has a fixed number of
slots — static shapes, no scatter, easy to shard.

Replaces Trilinos Epetra SpMV (the workhorse inside the reference's CG and
V-cycle, src/step-50.cc:938-1017).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class CSR:
    """Host-side CSR with device-resident compute arrays."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray     # (n_rows+1,)
    indices: np.ndarray    # (nnz,)
    rowids: np.ndarray     # (nnz,) expanded row ids (COO row index)
    data: jnp.ndarray      # (nnz,) device array

    @staticmethod
    def from_pattern(indptr, indices, data, n_cols: Optional[int] = None):
        n_rows = len(indptr) - 1
        rowids = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        return CSR(n_rows=n_rows, n_cols=n_cols or n_rows,
                   indptr=np.asarray(indptr), indices=np.asarray(indices),
                   rowids=rowids, data=jnp.asarray(data))

    def matvec(self, x):
        return csr_matvec(self.rowids, self.indices, self.data, x, self.n_rows)

    def diagonal(self):
        mask = self.rowids == self.indices
        return jnp.zeros(self.n_rows, self.data.dtype).at[
            jnp.asarray(self.rowids)].add(jnp.where(mask, self.data, 0.0))

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((np.asarray(self.data), self.indices,
                              self.indptr), shape=(self.n_rows, self.n_cols))


def csr_matvec(rowids, indices, data, x, n_rows: int):
    """y = A x via gather + segment scatter-add (jit-compatible)."""
    vals = data * x[indices]
    return jnp.zeros(n_rows, dtype=vals.dtype).at[rowids].add(vals)


def csr_matvec_T(rowids, indices, data, x, n_cols: int):
    """y = A^T x."""
    vals = data * x[rowids]
    return jnp.zeros(n_cols, dtype=vals.dtype).at[indices].add(vals)
