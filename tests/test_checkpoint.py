"""Checkpoint/resume: a killed run resumed from a cycle snapshot must
produce the same trajectory as an uninterrupted run (capability absent in
the reference, SURVEY §5.4 — its only 'recovery' was the PBS timeout)."""

import os

import numpy as np
import pytest

from coulomb_gmg.config import golden_gaussian_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import two_atom_pair
from coulomb_gmg.utils.logging import Pcout


def _small(**kw):
    cfg = golden_gaussian_config(n_adaptive_cycles=3, flag_output_time=False)
    return type(cfg)(**{**cfg.__dict__, "mesh_size_h": 0.5,
                        "vacuum_repetitions": 4, **kw})


def test_resume_matches_uninterrupted(tmp_path):
    ck = str(tmp_path / "ck")
    # full 3-cycle run with checkpoints
    sim_full = Simulation(_small(checkpoint_dir=ck),
                          atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    full = sim_full.run()
    assert os.path.exists(os.path.join(ck, "ckpt_cycle001.npz"))

    # resume a fresh process-equivalent after cycle 1
    sim_res = Simulation(
        _small(resume_from=os.path.join(ck, "ckpt_cycle001.npz")),
        atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    resumed = sim_res.run()

    assert len(resumed) == 1
    r, g = resumed[0], full[2]
    assert r["n_cells"] == g["n_cells"]
    assert r["n_dofs"] == g["n_dofs"]
    assert r["cg_iterations"] == g["cg_iterations"]
    assert r["l2_sol"] == pytest.approx(g["l2_sol"], rel=1e-12)
    assert r["threshold"] == pytest.approx(g["threshold"], rel=1e-12)
