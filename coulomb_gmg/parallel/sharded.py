"""SPMD sharded linear algebra over a JAX device mesh.

The JAX equivalent of the reference's one parallelism strategy —
MPI domain decomposition with row-partitioned Trilinos matrices, ghost
imports, and scalar all-reduces inside CG (SURVEY 2.3; compress/ghost
machinery at src/step-50.cc:653-657, 831-832) — expressed as
``shard_map`` over a 1-D device mesh:

* DoFs are row-partitioned into contiguous equal blocks (padded).
* Matrices are COO entry lists partitioned by owner row, one padded block
  per device (the partition-invariant analogue of owner-rows CSR).
* SpMV: ``all_gather`` the solution (ghost import between devices), local
  gather+segment-scatter for the owned rows.
* Dot products: local partial + ``psum`` (the CG all-reduce).
* The GMG hierarchy shards every level the same way; the coarse level is
  solved redundantly on every device (MGCoarseGridIterativeSolver
  semantics, src/step-50.cc:962-967).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def put_blocks(a, mesh: Mesh):
    """(D, ...) host array -> global device array sharded along the mesh
    axis (one block per device).

    Multi-process safe: under ``jax.distributed`` (multi-host DCN meshes,
    utils/platform.py:init_distributed) each process materializes only its
    addressable shards — the analogue of each MPI rank holding its own
    Trilinos row block (src/step-50.cc:699-701).  Single-process it is an
    explicit sharded device_put (no implicit reshard inside jit).
    """
    from jax.sharding import NamedSharding
    a = np.asarray(a)
    sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])


@dataclass
class ShardedCSR:
    """Row-partitioned sparse matrix as per-device padded COO blocks.

    Device-stacked arrays (leading axis = device):
      rows_local: (D, E) int32 — row index within the device's block
      cols:       (D, E) int32 — GLOBAL column index
      data:       (D, E)       — entry values (0 in padding slots)
    """

    n_rows: int            # global (padded) row count
    block: int             # rows per device
    rows_local: np.ndarray
    cols: np.ndarray
    data: jnp.ndarray

    @staticmethod
    def from_coo(rowids, cols, data, n_rows: int, n_dev: int) -> "ShardedCSR":
        n_pad = round_up(n_rows, n_dev)
        block = n_pad // n_dev
        owner = rowids // block
        E = int(np.bincount(owner, minlength=n_dev).max())
        r = np.zeros((n_dev, E), dtype=np.int32)
        c = np.zeros((n_dev, E), dtype=np.int32)
        d = np.zeros((n_dev, E), dtype=np.asarray(data).dtype)
        for dev in range(n_dev):
            sel = owner == dev
            k = int(sel.sum())
            r[dev, :k] = (rowids[sel] - dev * block).astype(np.int32)
            c[dev, :k] = cols[sel].astype(np.int32)
            d[dev, :k] = np.asarray(data)[sel]
        return ShardedCSR(n_rows=n_pad, block=block, rows_local=r, cols=c,
                          data=jnp.asarray(d))


def shard_vector(x: np.ndarray, n_dev: int) -> np.ndarray:
    n_pad = round_up(len(x), n_dev)
    out = np.zeros(n_pad, dtype=np.asarray(x).dtype)
    out[: len(x)] = np.asarray(x)
    return out.reshape(n_dev, -1)


def _local_matvec(rows_local, cols, data, x_full, block):
    vals = data * x_full[cols]
    return jnp.zeros(block, dtype=vals.dtype).at[rows_local].add(vals)


# ---------------------------------------------------------------------------
# Halo exchange: owned/ghost index sets + all_to_all ghost import.
#
# The JAX equivalent of deal.II's locally_owned / locally_relevant
# IndexSets and Trilinos ghost imports (src/step-50.cc:653-657, 722-731):
# instead of all_gather-ing the whole vector (O(n) traffic and O(n)
# replicated memory per device), each device receives ONLY the ghost
# entries its operator block actually reads — O(ghost) traffic, O(block +
# ghost) memory, which is what lets weak scaling hold as levels grow.
# ---------------------------------------------------------------------------


@dataclass
class HaloPlan:
    """Static exchange plan for one row-partitioned operator.

    send_idx: (D, D, Eh) int32 — for sender s (leading axis when sharded),
        send_idx[s, d] = LOCAL indices into s's block of the values that
        device d needs; padded with 0 (receivers never read pad slots).
    cols_local: (D, E) int32 — operator column ids rewritten to the
        extended local numbering [own block | ghost buffer], where the
        ghost buffer is laid out as D pads of Eh entries (one per sender).
    Eh: ghost pad width (max over ordered device pairs).
    """

    send_idx: np.ndarray
    cols_local: np.ndarray
    Eh: int

    @staticmethod
    def build(cols: np.ndarray, block: int, n_dev: int) -> "HaloPlan":
        """cols: (D, E) GLOBAL column ids of each device's COO block."""
        D = n_dev
        need = []            # need[d][s] = sorted global ids d needs from s
        for d in range(D):
            g = np.unique(cols[d])
            outside = g[(g < d * block) | (g >= (d + 1) * block)]
            owners = np.minimum(outside // block, D - 1)
            need.append([outside[owners == s] for s in range(D)])
        Eh = max([1] + [len(lst) for per in need for lst in per])
        send_idx = np.zeros((D, D, Eh), dtype=np.int32)
        for d in range(D):
            for s in range(D):
                lst = need[d][s]
                send_idx[s, d, : len(lst)] = (lst - s * block).astype(
                    np.int32)
        cols_local = np.empty_like(cols, dtype=np.int32)
        for d in range(D):
            own_lo = d * block
            c = cols[d]
            inside = (c >= own_lo) & (c < own_lo + block)
            cl = np.where(inside, c - own_lo, 0).astype(np.int32)
            owner = np.minimum(c // block, D - 1)
            for s in range(D):
                sel = (~inside) & (owner == s)
                if sel.any():
                    p = np.searchsorted(need[d][s], c[sel])
                    cl[sel] = (block + s * Eh + p).astype(np.int32)
            cols_local[d] = cl
        return HaloPlan(send_idx=send_idx, cols_local=cols_local, Eh=Eh)


def halo_import(xb, send_idx, axis: str):
    """Local (block,) + (D, Eh) send table -> (block + D*Eh,) extended
    vector [own | ghosts] via one all_to_all over the mesh axis."""
    buf = xb[send_idx]                                   # (D, Eh)
    # recv[s] = the Eh values device s prepared for THIS device
    recv = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0)
    return jnp.concatenate([xb, recv.reshape(-1)])


def make_sharded_solver(mesh: Mesh, A: ShardedCSR, diag_block: jnp.ndarray,
                        tol_rtol: float = 1e-8, maxiter: int = 500,
                        damping: float = 0.6, halo: bool = True):
    """Jitted SPMD Jacobi-preconditioned CG (the reference's Jacobi solve
    path, src/step-50.cc:996-1005) over the device mesh.

    ``halo=True`` (production): the SpMV ghost import moves only the ghost
    entries each device's rows read (HaloPlan all_to_all — the IndexSet/
    ghost-import semantics of src/step-50.cc:653-657); ``halo=False``
    replicates the whole vector per device (all_gather) — kept as the
    brute-force oracle for invariance tests.

    Returns fn(rhs_blocks, x0_blocks) -> (x_blocks, iters, res0, res).
    rhs/x blocks have shape (D, block).
    """
    axis = mesh.axis_names[0]
    spec = P(axis)
    D = mesh.devices.size
    plan = HaloPlan.build(A.cols, A.block, D) if halo else None

    def solve(rhs_b, x0_b, rows_local, cols, data, inv_diag, send_idx):
        # shard_map local views keep the leading (device) axis of size 1
        rhs_b, x0_b = rhs_b[0], x0_b[0]
        rows_local, cols, data, inv_diag = (rows_local[0], cols[0], data[0],
                                            inv_diag[0])

        def matvec(xb):
            if plan is not None:
                x_ext = halo_import(xb, send_idx[0], axis)
            else:
                x_ext = jax.lax.all_gather(xb, axis, tiled=True)
            return _local_matvec(rows_local, cols, data, x_ext, A.block)

        def dot(a, b):
            return jax.lax.psum(jnp.vdot(a, b), axis)

        def norm(a):
            return jnp.sqrt(dot(a, a))

        M = lambda r: inv_diag * r
        x = x0_b
        r = rhs_b - matvec(x)
        res0 = norm(r)
        tol = tol_rtol * norm(rhs_b)
        z = M(r)
        rho = dot(r, z)

        def cond(s):
            x, r, z, p, rho, res, k = s
            return (res >= tol) & (k < maxiter)

        def body(s):
            x, r, z, p, rho, res, k = s
            q = matvec(p)
            alpha = rho / dot(p, q)
            x = x + alpha * p
            r = r - alpha * q
            res = norm(r)
            z = M(r)
            rho_new = dot(r, z)
            p = z + (rho_new / rho) * p
            return (x, r, z, p, rho_new, res, k + 1)

        s = (x, r, z, z, rho, res0, jnp.asarray(0))
        x, r, z, p, rho, res, k = jax.lax.while_loop(cond, body, s)
        return x[None], k, res0, res

    inv_diag = damping / diag_block

    fn = shard_map(
        partial(solve),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, spec, spec, spec),
        out_specs=(spec, P(), P(), P()),
        check_vma=False,
    )

    rows_local = put_blocks(A.rows_local, mesh)
    cols = put_blocks(plan.cols_local if plan is not None else A.cols, mesh)
    data = put_blocks(np.asarray(A.data), mesh)
    inv_diag_b = put_blocks(np.asarray(inv_diag), mesh)
    send_idx = put_blocks(
        plan.send_idx if plan is not None
        else np.zeros((D, 1, 1), np.int32), mesh)

    # the matrix blocks are jit ARGUMENTS, not closure constants: closed-over
    # concrete arrays are baked into the jaxpr, which requires fetching their
    # value — impossible for multi-process global arrays (each process only
    # holds its own shards).
    run_impl = jax.jit(fn)

    def run(rhs_b, x0_b):
        return run_impl(rhs_b, x0_b, rows_local, cols, data, inv_diag_b,
                        send_idx)

    return run


def sharded_diag(A: ShardedCSR, n_dev: int) -> np.ndarray:
    """(D, block) diagonal of the sharded matrix; rows without a diagonal
    entry (padding rows) get 1 so Jacobi stays well-defined."""
    data = np.asarray(A.data)
    out = np.zeros((n_dev, A.block), dtype=data.dtype)
    for dev in range(n_dev):
        grow = A.rows_local[dev].astype(np.int64) + dev * A.block
        mask = A.cols[dev] == grow
        np.add.at(out[dev], A.rows_local[dev][mask], data[dev][mask])
    out[out == 0.0] = 1.0
    return out
