"""Incremental FacePlan (adapt/estimator.py:update_face_plan) vs the full
rebuild: across several refinement rounds (random flags + 2:1 balance) the
incrementally-updated plan must contain EXACTLY the same face set."""

import numpy as np
import pytest

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.adapt.estimator import (build_face_plan,
                                         update_face_plan)
from coulomb_gmg.adapt.transfer import old_cell_of_new


def _canon(plan):
    sl = set(zip(plan.sl_a.tolist(), plan.sl_b.tolist(),
                 plan.sl_axis.tolist()))
    cf = set(zip(plan.cf_fine.tolist(), plan.cf_coarse.tolist(),
                 plan.cf_axis.tolist(), plan.cf_side.tolist(),
                 plan.cf_sub.tolist()))
    return sl, cf


@pytest.mark.parametrize("dim,reps", [(2, 6), (3, 4)])
def test_incremental_matches_full_rebuild(dim, reps):
    rng = np.random.default_rng(11)
    f = Forest.uniform(dim, reps, np.zeros(dim), 1.0 / reps)
    plan = build_face_plan(f)
    for round_ in range(3):
        flags = rng.random(f.n_cells) < 0.18
        flags[int(rng.integers(f.n_cells))] = True   # never-empty marking
        new = f.refine(flags)
        omap = old_cell_of_new(f, new)
        plan = update_face_plan(f, new, plan, omap)
        full = build_face_plan(new)
        sl_i, cf_i = _canon(plan)
        sl_f, cf_f = _canon(full)
        assert sl_i == sl_f, (round_, len(sl_i - sl_f), len(sl_f - sl_i))
        assert cf_i == cf_f, (round_, len(cf_i - cf_f), len(cf_f - cf_i))
        f = new


def test_incremental_through_driver_matches_rebuild():
    """After a 3-cycle adaptive run the driver's cached plan equals a
    fresh rebuild on the final mesh."""
    from coulomb_gmg.config import golden_gaussian_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import two_atom_pair
    from coulomb_gmg.utils.logging import Pcout

    cfg = golden_gaussian_config(n_adaptive_cycles=3, flag_output_time=False,
                                 mesh_size_h=0.5, vacuum_repetitions=4)
    sim = Simulation(cfg, atoms=two_atom_pair(), pcout=Pcout(enabled=False))
    sim.run()
    assert sim._face_plan is not None
    full = build_face_plan(sim.forest)
    assert _canon(sim._face_plan) == _canon(full)
