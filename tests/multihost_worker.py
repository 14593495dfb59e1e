"""Multi-host worker: one process of a 2-process DCN-style mesh.

Run as ``python multihost_worker.py <process_id> <num_processes> <port>``.
Each process contributes 2 virtual CPU devices; the global mesh spans all
``2 * num_processes`` devices across processes, so every collective inside
the sharded solve (all_gather ghost import, psum CG dots) crosses the
process boundary — the analogue of the reference running ``mpirun -np N``
across nodes (run.sh:13, 5-node production mode).

Prints ONE JSON line with the CG iteration count, final relative residual,
and a solution checksum for the driving test to compare across processes
and against the single-process answer.
"""

import json
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
          if not f.startswith("--xla_force_host_platform_device_count")]
os.environ["XLA_FLAGS"] = " ".join(
    _flags + ["--xla_force_host_platform_device_count=2"]).strip()
os.environ["JAX_ENABLE_X64"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np          # noqa: E402
import jax                  # noqa: E402

jax.config.update("jax_enable_x64", True)
# cross-process CPU collectives ride gloo (the CPU stand-in for NCCL)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from coulomb_gmg.utils.platform import init_distributed  # noqa: E402

init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=nproc,
                 process_id=pid)


def poisson_7pt(m: int):
    """7-point Laplacian on an m^3 grid as COO (deterministic, replicated
    on every process — the problem definition, not the distributed state)."""
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
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


def main():
    from jax.sharding import Mesh
    from coulomb_gmg.parallel.sharded import (
        ShardedCSR, sharded_diag, make_sharded_solver, shard_vector,
        put_blocks)

    devs = jax.devices()
    assert len(devs) == 2 * nproc, (len(devs), nproc)
    D = len(devs)
    mesh = Mesh(np.array(devs), ("shard",))

    rows, cols, vals, n = poisson_7pt(12)
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    diag = sharded_diag(A, D)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)

    solver = make_sharded_solver(mesh, A, diag, tol_rtol=1e-10,
                                 maxiter=2000, damping=0.6)
    rhs_b = put_blocks(shard_vector(b, D), mesh)
    xb, k, res0, res = solver(rhs_b, rhs_b * 0.0)

    # every process holds only its addressable shards; the checksum is a
    # psum-style global quantity so both processes print the same number
    x_local = np.concatenate(
        [np.asarray(s.data).ravel() for s in xb.addressable_shards])
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    ssum = jax.jit(shard_map(
        lambda a: jax.lax.psum(jnp.sum(a * a), "shard"),
        mesh=mesh, in_specs=P("shard"), out_specs=P(), check_vma=False))
    checksum = float(ssum(xb))

    # ---- stage 2: the FULL ShardedGMG (every MG level row-partitioned,
    # halo all_to_all ghost imports, interface matrices, redundant coarse
    # solve) across the process boundary — the reference's production mode
    # runs the whole GMG hierarchy distributed across 5 nodes
    # (src/step-50.cc:722-731, run.sh:13).  The problem is built
    # deterministically and replicated per process (host topology work);
    # only the SOLVE state is distributed.
    from coulomb_gmg.config import golden_gaussian_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import two_atom_pair
    from coulomb_gmg.utils.logging import Pcout
    from coulomb_gmg.parallel.sharded_gmg import ShardedGMG

    cfg = golden_gaussian_config(n_adaptive_cycles=2, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    rhs = np.asarray(sim.rhs)
    sg = ShardedGMG(sim.gmg, sim.A, mesh, dtype=sim.dtype, maxiter=50)
    xg, kg, res0g, resg = sg.solve_global(rhs, rtol=1e-8)
    gmg_checksum = float(ssum(xg))
    gmg_local = np.concatenate(
        [np.asarray(s.data).ravel() for s in xg.addressable_shards])

    print(json.dumps({
        "pid": pid,
        "devices": D,
        "iters": int(k),
        "rel_res": float(res) / float(res0),
        "checksum": checksum,
        "local_norm": float(np.linalg.norm(x_local)),
        "gmg_iters": int(kg),
        "gmg_rel_res": float(resg) / max(float(res0g), 1e-300),
        "gmg_checksum": gmg_checksum,
        "gmg_local_norm": float(np.linalg.norm(gmg_local)),
    }), flush=True)


main()
