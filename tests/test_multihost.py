"""Multi-host (multi-process) distributed solve.

The reference's production mode is MPI across 5 nodes (``run.sh:13``,
``jobscript``); its correctness story is rank-count golden invariance
(SURVEY §4).  Here: two OS processes, each owning 2 virtual CPU devices,
joined by ``jax.distributed`` (utils/platform.py:init_distributed) into one
4-device mesh.  Every all_gather/psum inside the sharded CG crosses the
process boundary (gloo — the CPU stand-in for DCN), so this exercises the
actual multi-host code path, not just a single-process simulation of it.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def worker_results():
    port = _free_port()
    env = dict(os.environ)
    # CPU-only workers: 2 virtual devices each (set in the child's
    # environment, before its interpreter starts)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=env, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"multihost worker timed out; stderr tail: "
                        f"{err[-2000:]}")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    return outs


def test_two_process_mesh_spans_four_devices(worker_results):
    for r in worker_results:
        assert r["devices"] == 4


def test_two_process_solve_converges_identically(worker_results):
    a, b = worker_results
    assert a["iters"] == b["iters"] > 0
    assert a["rel_res"] <= 1e-10 and b["rel_res"] <= 1e-10
    # global checksum is a psum: bitwise-identical on both processes
    assert a["checksum"] == b["checksum"]
    # each process holds a DIFFERENT half of the solution
    assert a["local_norm"] != b["local_norm"]


def test_two_process_sharded_gmg(worker_results):
    """The FULL GMG hierarchy distributed across the process boundary
    (halo all_to_all ghost imports, level/interface operators, redundant
    coarse solve, psum dots) — the reference's 5-node production mode
    (src/step-50.cc:722-731, run.sh:13).  Both processes must agree on the
    iteration count and the global checksum while holding different local
    shards."""
    a, b = worker_results
    assert 1 <= a["gmg_iters"] <= 20 and a["gmg_iters"] == b["gmg_iters"]
    assert a["gmg_rel_res"] <= 1e-8 * 1.01
    assert a["gmg_checksum"] == b["gmg_checksum"]
    assert a["gmg_local_norm"] != b["gmg_local_norm"]


def test_two_process_gmg_matches_single_process(worker_results):
    """Process-count invariance for the GMG solve: the 2-process/4-device
    answer equals the 1-process/4-device answer."""
    import jax
    from jax.sharding import Mesh
    from coulomb_gmg.config import golden_gaussian_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import two_atom_pair
    from coulomb_gmg.utils.logging import Pcout
    from coulomb_gmg.parallel.sharded_gmg import ShardedGMG

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg = golden_gaussian_config(n_adaptive_cycles=2, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    rhs = np.asarray(sim.rhs)
    mesh = Mesh(np.array(devs[:4]), ("shard",))
    sg = ShardedGMG(sim.gmg, sim.A, mesh, dtype=sim.dtype, maxiter=50)
    xg, k, _, _ = sg.solve_global(rhs, rtol=1e-8)
    checksum = float(np.sum(np.asarray(xg) ** 2))
    a = worker_results[0]
    assert int(k) == a["gmg_iters"]
    assert checksum == pytest.approx(a["gmg_checksum"], rel=1e-10)


def test_two_process_matches_single_process(worker_results):
    """Process-count invariance: 2-process/4-device answer == 1-process/
    4-device answer (the analogue of diffing mpirun=1 vs mpirun=3 goldens)."""
    import jax
    from jax.sharding import Mesh
    from coulomb_gmg.parallel.sharded import (
        ShardedCSR, sharded_diag, make_sharded_solver, shard_vector,
        put_blocks)

    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")

    def poisson_7pt(m):
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

    rows, cols, vals, n = poisson_7pt(12)
    D = 4
    mesh = Mesh(np.array(devs[:D]), ("shard",))
    A = ShardedCSR.from_coo(rows, cols, vals, n, D)
    diag = sharded_diag(A, D)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(n)
    solver = make_sharded_solver(mesh, A, diag, tol_rtol=1e-10,
                                 maxiter=2000, damping=0.6)
    rhs_b = put_blocks(shard_vector(b, D), mesh)
    xb, k, res0, res = solver(rhs_b, rhs_b * 0.0)
    checksum = float(np.sum(np.asarray(xb) ** 2))

    a = worker_results[0]
    assert int(k) == a["iters"]
    assert checksum == pytest.approx(a["checksum"], rel=1e-12)
