"""SPMD production-config trajectory parity — the published scaling
study's configuration (plain-Kelly marking, cg_rtol=1e-8,
tests/test_production_trajectory.py) run through the full distributed
pipeline on an 8-device mesh: sharded locality-LIST density, distributed
assembly with psum compress, ShardedGMG solve.  The per-cycle cell counts
must equal `Plotting/ncells_per_atom.dat:6` and the single-device run —
the reference's own distributed-correctness idiom (its golden files are
identical at mpirun=1/3/7).
"""

import os

import pytest

from coulomb_gmg.config import production_scaling_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import nacl_lattice
from coulomb_gmg.utils.logging import Pcout

N_CYCLES = int(os.environ.get("SPMD_PROD_CYCLES", "3"))

REF_CELLS_8 = [85184, 85744, 87648, 91344, 99464]


@pytest.fixture(scope="module")
def run8dev():
    cfg = production_scaling_config(1, dtype="float64", n_devices=8,
                                    n_adaptive_cycles=N_CYCLES)
    sim = Simulation(cfg, atoms=nacl_lattice(1), pcout=Pcout(enabled=False))
    return sim.run()


def test_cells_match_published(run8dev):
    assert [r["n_cells"] for r in run8dev] == REF_CELLS_8[:len(run8dev)]


def test_cg_counts_at_reference_tolerance(run8dev):
    # SSOR_run.o876223:18-54 (1, 6, 8, 7, 8) +-1
    for r, ref in zip(run8dev, [1, 6, 8, 7, 8]):
        assert abs(r["cg_iterations"] - ref) <= 1, \
            f"cycle {r['cycle']}: {r['cg_iterations']} vs {ref}"


def test_matches_single_device(run8dev):
    cfg = production_scaling_config(1, dtype="float64",
                                    n_adaptive_cycles=N_CYCLES)
    sim = Simulation(cfg, atoms=nacl_lattice(1), pcout=Pcout(enabled=False))
    solo = sim.run()
    for r8, r1 in zip(run8dev, solo):
        assert r8["n_cells"] == r1["n_cells"]
        assert r8["n_dofs"] == r1["n_dofs"]
        assert r8["l2_rhs"] == pytest.approx(r1["l2_rhs"], rel=1e-10)
        assert r8["l2_sol"] == pytest.approx(r1["l2_sol"], rel=1e-8)


@pytest.mark.parametrize("n_dev", [3, 7])
def test_odd_device_count_trajectory(n_dev, run8dev):
    """D=3 and D=7 — the analogue of the reference's deliberately
    non-power-of-2 mpirun=3/7 golden files (tests/CMakeLists.txt:1-7):
    uneven SFC partitions through the FULL production pipeline must
    reproduce the same trajectory as D=8 and the published cell counts."""
    cycles = min(N_CYCLES, 2)
    cfg = production_scaling_config(1, dtype="float64", n_devices=n_dev,
                                    n_adaptive_cycles=cycles)
    sim = Simulation(cfg, atoms=nacl_lattice(1), pcout=Pcout(enabled=False))
    res = sim.run()
    assert [r["n_cells"] for r in res] == REF_CELLS_8[:cycles]
    for r, r8 in zip(res, run8dev):
        assert r["n_dofs"] == r8["n_dofs"]
        assert r["l2_rhs"] == pytest.approx(r8["l2_rhs"], rel=1e-10)
        assert r["l2_sol"] == pytest.approx(r8["l2_sol"], rel=1e-8)
        assert abs(r["cg_iterations"] - r8["cg_iterations"]) <= 1


REF_CELLS_1000 = [216000, 216560, 222552, 233584, 253296]


def test_1000_atoms_published_trajectory_8dev():
    """Production-scale multi-device evidence (VERDICT r4 #7): the
    1000-atom published trajectory (`Plotting/ncells_per_atom.dat:8`)
    reproduced cycle-for-cycle by the FULL SPMD pipeline on an 8-device
    mesh — not just self-consistency against the single-device run."""
    n_cyc = int(os.environ.get("SPMD_PROD_1000_CYCLES", "5"))
    cfg = production_scaling_config(5, dtype="float64", n_devices=8,
                                    n_adaptive_cycles=n_cyc)
    sim = Simulation(cfg, atoms=nacl_lattice(5), pcout=Pcout(enabled=False))
    res = sim.run()
    assert [r["n_cells"] for r in res] == REF_CELLS_1000[:n_cyc]
    # SSOR_run.o876223 1000-atom CG counts: 1, 5, 7, 7, 7 (+-1)
    for r, ref in zip(res, [1, 5, 7, 7, 7]):
        assert abs(r["cg_iterations"] - ref) <= 1
