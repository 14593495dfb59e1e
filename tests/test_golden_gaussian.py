"""End-to-end golden regression vs the reference's own output files.

The reference pins its entire distributed-correctness story on golden
stdout comparison (tests/CMakeLists.txt, numdiff vs mpirun=N.output); we
compare the structured per-cycle results against the parsed golden file
with documented tolerances: topology counts exact, norms/energies to 1e-6
relative, CG iteration counts within +-1 (Trilinos' processor-local SSOR
is not bit-identical to our exact SSOR; the reference itself ships separate
golden files per rank count for the same reason).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from golden import parse_golden, GOLDEN_GAUSSIAN

from coulomb_gmg.config import golden_gaussian_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import two_atom_pair

# the full 6-cycle golden trajectory is the central fidelity claim — it is
# what CI checks by default; set GOLDEN_CYCLES to shorten during iteration.
N_CYCLES = int(os.environ.get("GOLDEN_CYCLES", "6"))


@pytest.fixture(scope="module")
def run_and_golden():
    golden = parse_golden(GOLDEN_GAUSSIAN)
    cfg = golden_gaussian_config(n_adaptive_cycles=N_CYCLES)
    sim = Simulation(cfg, atoms=two_atom_pair())
    results = sim.run()
    return results, golden


def test_topology_counts_exact(run_and_golden):
    results, golden = run_and_golden
    for r, g in zip(results, golden):
        assert r["n_cells"] == g["n_cells"], f"cycle {r['cycle']}"
        assert r["n_dofs"] == g["n_dofs"], f"cycle {r['cycle']}"
        assert r["dofs_by_level"] == g["dofs_by_level"], f"cycle {r['cycle']}"


def test_cg_iteration_counts(run_and_golden):
    results, golden = run_and_golden
    for r, g in zip(results, golden):
        assert abs(r["cg_iterations"] - g["cg_iterations"]) <= 1, \
            f"cycle {r['cycle']}: {r['cg_iterations']} vs {g['cg_iterations']}"


def test_cg_start_and_threshold(run_and_golden):
    results, golden = run_and_golden
    for r, g in zip(results, golden):
        assert r["cg_start"] == pytest.approx(g["cg_start"], rel=1e-6)
        assert r["threshold"] == pytest.approx(g["threshold"], rel=1e-5)


def test_norms(run_and_golden):
    results, golden = run_and_golden
    for r, g in zip(results, golden):
        for key in ("l1_rhs", "l2_rhs", "linf_rhs", "l1_mat", "linf_mat",
                    "fro_mat", "l1_sol", "l2_sol", "linf_sol"):
            assert r[key] == pytest.approx(g[key], rel=1e-6), \
                f"cycle {r['cycle']} {key}"


def test_energies(run_and_golden):
    results, golden = run_and_golden
    for r, g in zip(results, golden):
        e = r["energy"]
        assert e["analytic"] == pytest.approx(g["e_analytic"], rel=1e-9)
        assert e["short_range"] == pytest.approx(g["e_short"], rel=1e-9)
        assert e["fe_long_range"] == pytest.approx(g["e_fe_long"], rel=1e-6)
        assert e["self_energy"] == pytest.approx(g["e_self"], rel=1e-9)
        assert e["abs_error"] == pytest.approx(g["e_abs_error"], rel=1e-4)
        assert r["energy_norm_error"] == pytest.approx(
            g["energy_norm_error"], rel=1e-6)
