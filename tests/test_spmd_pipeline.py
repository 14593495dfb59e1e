"""Full-pipeline SPMD golden regression — the analogue of the reference's
``mpirun=3``/``mpirun=7`` golden suites (tests/CMakeLists.txt): the SAME
problem run through the production driver on a multi-device mesh must
reproduce the reference golden trajectory AND be invariant to the device
count.

Covers: sharded density (production separable kernels), distributed
assembly with psum compress, SPMD GMG-CG solve (ShardedGMG), sharded
energy-norm error, ownership-dedup energies, and per-shard VTU pieces
with real subdomain ids (src/step-50.cc:1252-1297).
"""

import glob
import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from golden import parse_golden, GOLDEN_GAUSSIAN

from coulomb_gmg.config import golden_gaussian_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import two_atom_pair
from coulomb_gmg.utils.logging import Pcout

N_CYCLES = int(os.environ.get("SPMD_CYCLES", "3"))


def _run(n_devices: int, n_cycles: int, **overrides):
    cfg = golden_gaussian_config(n_adaptive_cycles=n_cycles,
                                 n_devices=n_devices, **overrides)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    return sim.run()


@pytest.fixture(scope="module")
def run8():
    return _run(8, N_CYCLES)


@pytest.fixture(scope="module")
def golden():
    return parse_golden(GOLDEN_GAUSSIAN)


def test_topology_matches_golden(run8, golden):
    for r, g in zip(run8, golden):
        assert r["n_cells"] == g["n_cells"], f"cycle {r['cycle']}"
        assert r["n_dofs"] == g["n_dofs"], f"cycle {r['cycle']}"
        assert r["dofs_by_level"] == g["dofs_by_level"], f"cycle {r['cycle']}"


def test_cg_counts_match_golden(run8, golden):
    # reference golden counts are identical at ranks 1/3/7; our SPMD
    # Chebyshev smoother is allowed the same +-1 drift as the host suite
    for r, g in zip(run8, golden):
        assert abs(r["cg_iterations"] - g["cg_iterations"]) <= 1, \
            f"cycle {r['cycle']}: {r['cg_iterations']} vs {g['cg_iterations']}"


def test_norms_match_golden(run8, golden):
    for r, g in zip(run8, golden):
        for key in ("l1_rhs", "l2_rhs", "linf_rhs", "l1_mat", "linf_mat",
                    "fro_mat", "l1_sol", "l2_sol", "linf_sol"):
            assert r[key] == pytest.approx(g[key], rel=1e-6), \
                f"cycle {r['cycle']} {key}"
        assert r["threshold"] == pytest.approx(g["threshold"], rel=1e-5)


def test_energies_match_golden(run8, golden):
    for r, g in zip(run8, golden):
        e = r["energy"]
        assert e["analytic"] == pytest.approx(g["e_analytic"], rel=1e-9)
        assert e["short_range"] == pytest.approx(g["e_short"], rel=1e-9)
        assert e["fe_long_range"] == pytest.approx(g["e_fe_long"], rel=1e-6)
        assert e["abs_error"] == pytest.approx(g["e_abs_error"], rel=1e-4)
        assert r["energy_norm_error"] == pytest.approx(
            g["energy_norm_error"], rel=1e-6)


def test_device_count_invariance(run8):
    """1/4/8-device invariance — the reference's mpirun=1/3/7 idiom
    (SURVEY §4): the whole per-cycle structured log must agree across
    device counts (4 and 8 SPMD bit-near; the host path within solver
    tolerance)."""
    run4 = _run(4, min(N_CYCLES, 2))
    for r8, r4 in zip(run8, run4):
        assert r8["n_cells"] == r4["n_cells"]
        assert r8["n_dofs"] == r4["n_dofs"]
        assert r8["dofs_by_level"] == r4["dofs_by_level"]
        assert r8["cg_iterations"] == r4["cg_iterations"]
        for key in ("l1_rhs", "l2_rhs", "linf_rhs", "l1_sol", "l2_sol",
                    "linf_sol", "threshold"):
            assert r8[key] == pytest.approx(r4[key], rel=1e-9), key
        assert r8["energy_norm_error"] == pytest.approx(
            r4["energy_norm_error"], rel=1e-9)


def test_sharded_vtu_pieces_and_subdomains():
    with tempfile.TemporaryDirectory() as td:
        res = _run(8, 1, write_vtu=True, output_dir=td)
        pieces = sorted(glob.glob(os.path.join(td, "solution-00000.*.vtu")))
        assert len(pieces) == 8
        pvtu = os.path.join(td, "solution-00000.pvtu")
        assert os.path.exists(pvtu)
        txt = open(pvtu).read()
        for p in pieces:
            assert os.path.basename(p) in txt
        assert 'Name="subdomain"' in txt
        # piece cell counts partition the mesh
        n_total = 0
        for p in pieces:
            body = open(p).read()
            import re
            m = re.search(r'NumberOfCells="(\d+)"', body)
            n_total += int(m.group(1))
        assert n_total == res[0]["n_cells"]
