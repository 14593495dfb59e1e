"""Owned/ghost halo exchange (parallel/sharded.py:HaloPlan).

The JAX equivalent of deal.II's locally_owned/locally_relevant
IndexSets + Trilinos ghost import (src/step-50.cc:653-657, 722-731): each
device receives ONLY the ghost entries its operator rows read, via one
all_to_all, instead of replicating the whole vector (all_gather).  Pinned
here: plan correctness (extended-numbering SpMV == scipy), solver-level
equivalence halo vs all_gather, and ghost-volume sanity (ghosts << n)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from coulomb_gmg.parallel.sharded import (
    ShardedCSR, HaloPlan, halo_import, sharded_diag, make_sharded_solver,
    shard_vector, put_blocks, shard_map, round_up)


def _poisson(m):
    n = m ** 3
    idx = np.arange(n).reshape(m, m, m)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [6.0 * np.ones(n)]
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, b]
        cols += [b, a]
        vals += [-np.ones(len(a)), -np.ones(len(a))]
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), n


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("shard",))


def test_halo_spmv_matches_scipy(mesh8):
    import scipy.sparse as sp
    rows, cols, vals, n = _poisson(10)
    D = 8
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    plan = HaloPlan.build(A.cols, A.block, D)
    x = np.random.default_rng(0).standard_normal(round_up(n, D))

    def mv(xb, rl, cl, dd, si):
        xb, rl, cl, dd, si = xb[0], rl[0], cl[0], dd[0], si[0]
        x_ext = halo_import(xb, si, "shard")
        vals = dd * x_ext[cl]
        return (jnp.zeros(A.block, vals.dtype).at[rl].add(vals))[None]

    fn = jax.jit(shard_map(mv, mesh=mesh8,
                           in_specs=(P("shard"),) * 5,
                           out_specs=P("shard"), check_vma=False))
    y = np.asarray(fn(
        put_blocks(x.reshape(D, -1), mesh8),
        put_blocks(A.rows_local, mesh8),
        put_blocks(plan.cols_local, mesh8),
        put_blocks(np.asarray(A.data), mesh8),
        put_blocks(plan.send_idx, mesh8))).reshape(-1)

    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_allclose(y[:n], S @ x[:n], rtol=1e-12, atol=1e-12)


def test_halo_ghosts_shrink_relative_to_n(mesh8):
    """Ghost volume is surface work: the extended vector (block + ghosts)
    must shrink RELATIVE to the replicated all_gather vector as the mesh
    grows (surface/volume).  m=16: slab surface 2*16^2 vs block 16^3/8;
    m=32 halves the ratio again."""
    D = 8
    ratios = {}
    for m in (16, 32):
        rows, cols, vals, n = _poisson(m)
        A = ShardedCSR.from_coo(rows, cols, vals, n, D)
        plan = HaloPlan.build(A.cols, A.block, D)
        ratios[m] = (A.block + D * plan.Eh) / round_up(n, D)
    assert ratios[32] < ratios[16] < 0.7, ratios
    assert ratios[32] < 0.4, ratios


def test_solver_halo_matches_allgather(mesh8):
    rows, cols, vals, n = _poisson(9)
    D = 8
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    diag = sharded_diag(A, D)
    b = np.random.default_rng(1).standard_normal(n)
    rhs_b = put_blocks(shard_vector(b, D), mesh8)

    outs = {}
    for halo in (True, False):
        solver = make_sharded_solver(mesh8, A, diag, tol_rtol=1e-10,
                                     maxiter=2000, halo=halo)
        xb, k, res0, res = solver(rhs_b, rhs_b * 0.0)
        outs[halo] = (np.asarray(xb).reshape(-1), int(k), float(res))
    x_h, k_h, r_h = outs[True]
    x_a, k_a, r_a = outs[False]
    assert k_h == k_a                     # identical math -> identical iters
    np.testing.assert_allclose(x_h, x_a, rtol=1e-9, atol=1e-12)
