"""SPMD sharded GMG-CG vs the single-device solve (8-device CPU mesh).

The analogue of the reference's rank-count invariance strategy (golden
files at mpirun=1/3/7, SURVEY §4): the same problem solved on 1 device and
on an 8-way row partition must agree to solver tolerance, with the same
iteration behavior (GMG mesh-independence)."""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from coulomb_gmg.config import golden_gaussian_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import two_atom_pair
from coulomb_gmg.utils.logging import Pcout


@pytest.fixture(scope="module")
def small_sim():
    """Two adaptive cycles of the small gaussian problem: returns the sim
    with its final assembled system + GMG hierarchy."""
    cfg = golden_gaussian_config(n_adaptive_cycles=2, flag_output_time=False)
    cfg = type(cfg)(**{**cfg.__dict__, "mesh_size_h": 0.5,
                       "vacuum_repetitions": 4})
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    return sim


def test_sharded_solution_matches_single_device(small_sim):
    from coulomb_gmg.parallel.sharded_gmg import ShardedGMG

    sim = small_sim
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(devs[:8]), ("shard",))

    rhs = np.asarray(sim.rhs)
    sg = ShardedGMG(sim.gmg, sim.A, mesh, dtype=sim.dtype, maxiter=50)
    x_sh, k_sh, res0_sh, res_sh = sg.solve(rhs, rtol=1e-8)

    # single-device answer (the driver already solved this cycle)
    x_ref = np.asarray(sim.solution)

    bnorm = np.linalg.norm(rhs)
    assert res0_sh == pytest.approx(bnorm, rel=1e-6)
    assert res_sh <= 1e-8 * bnorm * 1.01
    assert 1 <= k_sh <= 20
    # both solves converged to 1e-8||b||: solutions agree to ~that level
    from coulomb_gmg.fem.constraints import distribute
    x_sh_d = distribute(sim.constraints, x_sh)
    num = np.linalg.norm(np.asarray(x_sh_d) - x_ref)
    den = np.linalg.norm(x_ref)
    assert num / den < 1e-5


def test_sharded_iteration_count_device_invariant(small_sim):
    """1-way vs odd/even partitions: identical math -> identical CG counts
    and matching solutions.  D=3 and D=7 are the analogue of the
    reference's deliberately non-power-of-2 mpirun=3/7 golden files
    (tests/CMakeLists.txt:1-7) — they stress the uneven block padding in
    _block_coo/_block_pairs."""
    from coulomb_gmg.parallel.sharded_gmg import ShardedGMG

    sim = small_sim
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    rhs = np.asarray(sim.rhs)
    counts, sols = {}, {}
    for d in (1, 3, 4, 7, 8):
        mesh = Mesh(np.array(devs[:d]), ("shard",))
        sg = ShardedGMG(sim.gmg, sim.A, mesh, dtype=sim.dtype, maxiter=50)
        x, k, _, _ = sg.solve(rhs, rtol=1e-8)
        counts[d] = k
        sols[d] = x
    assert len(set(counts.values())) == 1, counts
    for d in (3, 4, 7, 8):
        num = np.linalg.norm(sols[d] - sols[1])
        den = np.linalg.norm(sols[1])
        assert num / den < 1e-6, (d, num / den)


def test_halo_ghost_import_matches_allgather(small_sim):
    """Owned/ghost halo exchange (HaloPlan all_to_all, the IndexSet ghost
    import of src/step-50.cc:722-731) vs whole-vector all_gather: identical
    math -> identical iteration counts and solutions."""
    from coulomb_gmg.parallel.sharded_gmg import ShardedGMG

    sim = small_sim
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(devs[:8]), ("shard",))
    rhs = np.asarray(sim.rhs)

    outs = {}
    for halo in (True, False):
        sg = ShardedGMG(sim.gmg, sim.A, mesh, dtype=sim.dtype, maxiter=50,
                        halo=halo)
        x, k, res0, res = sg.solve(rhs, rtol=1e-8)
        outs[halo] = (x, k, res)
    x_h, k_h, _ = outs[True]
    x_a, k_a, _ = outs[False]
    assert k_h == k_a
    np.testing.assert_allclose(x_h, x_a, rtol=1e-6, atol=1e-10)
