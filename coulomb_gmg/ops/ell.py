"""ELL (padded-row) sparse format and its gather-only SpMV.

The reference's hot SpMV lives inside Trilinos Epetra CRS (driven from
``SolverCG``/``Multigrid``, src/step-50.cc:938-1017).  ELL turns SpMV into
a *gather-only* computation — every row gets exactly K slots, padding
slots carry value 0 and column 0 — so

    y[i] = sum_k vals[i, k] * x[cols[i, k]]

is a dense (n, K) gather + multiply + row-reduce with fully static shapes
and no scatter.  For a Q1 hex discretization K = 27 interior (more at
hanging nodes), so the padding waste is small and bounded.

Bucket padding (rows AND K to fixed buckets) keeps one compiled executable
across adaptive cycles (mesh sizes change every cycle; see solver/bucketed_cg.py).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import jax.numpy as jnp


@dataclass
class ELL:
    """Host-built ELL matrix. ``cols``/``vals`` are (n_rows, K); padding
    slots have ``vals == 0`` and ``cols == 0`` (gather-safe)."""

    n_rows: int
    n_cols: int
    K: int
    cols: np.ndarray   # (n_rows, K) int32
    vals: np.ndarray   # (n_rows, K) float

    @staticmethod
    def from_coo(rowids, cols, data, n_rows: int, n_cols: int = None,
                 pad_rows_to: int = None, pad_k_to: int = None) -> "ELL":
        rowids = np.asarray(rowids)
        cols = np.asarray(cols)
        data = np.asarray(data)
        if len(rowids) and (np.diff(rowids) < 0).any():
            order = np.argsort(rowids, kind="stable")
            rowids, cols, data = rowids[order], cols[order], data[order]
        counts = np.bincount(rowids, minlength=n_rows)
        K = int(counts.max()) if len(counts) and counts.max() > 0 else 1
        if pad_k_to is not None:
            K = max(K, pad_k_to)
        n_pad = n_rows if pad_rows_to is None else max(n_rows, pad_rows_to)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rowids)) - first[rowids]
        ecols = np.zeros((n_pad, K), dtype=np.int32)
        evals = np.zeros((n_pad, K), dtype=data.dtype)
        ecols[rowids, slot] = cols
        evals[rowids, slot] = data
        return ELL(n_rows=n_pad, n_cols=n_cols or n_rows, K=K,
                   cols=ecols, vals=evals)

    @staticmethod
    def from_csr(indptr, indices, data, n_cols: int = None,
                 pad_rows_to: int = None, pad_k_to: int = None) -> "ELL":
        n_rows = len(indptr) - 1
        counts = np.diff(indptr)
        K = int(counts.max()) if n_rows and counts.max() > 0 else 1
        if pad_k_to is not None:
            K = max(K, pad_k_to)
        n_pad = n_rows if pad_rows_to is None else max(n_rows, pad_rows_to)
        from coulomb_gmg.utils import native
        if n_rows * K >= (1 << 20):
            out = native.csr_to_ell(indptr, indices, np.asarray(data),
                                    n_pad, K)
            if out is not None:
                ecols, evals = out
                return ELL(n_rows=n_pad, n_cols=n_cols or n_rows, K=K,
                           cols=ecols, vals=evals)
        rowids = np.repeat(np.arange(n_rows), counts)
        return ELL.from_coo(rowids, indices, data, n_rows, n_cols,
                            pad_rows_to=pad_rows_to, pad_k_to=K)

    def diagonal(self) -> np.ndarray:
        rows = np.arange(self.n_rows)[:, None]
        mask = (self.cols == rows) & (self.vals != 0)
        return (self.vals * mask).sum(axis=1)


def ell_matvec(cols, vals, x):
    """y = A x, gather-only (XLA).  cols/vals (n, K), x (n,) -> y (n,)."""
    return jnp.sum(vals * x[cols], axis=1)
