"""Locality-tile density (ops/tile_density.py) vs the host locality-list
path: identical membership semantics (level-0-ancestor vertex criterion,
strict <, the production inherited-list behavior) and matching density
values.  The compiled check on the card is tests/test_gpu.py."""

import numpy as np
import pytest

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.models.atoms import nacl_lattice
from coulomb_gmg.ops.q1 import element_tables
from coulomb_gmg.ops.density import compute_density
from coulomb_gmg.ops.neighbors import atom_lists
from coulomb_gmg.ops.tile_density import (build_tile_plan,
                                          density_locality_tiles)

R_C = 0.5
CUT = 3.5 * R_C


def _setup(n=1, vac=3):
    atoms = nacl_lattice(n)
    a = 2.0 * 0.25
    reps = int(round(2 * (n / a + 2 * vac)))
    lower = np.full(3, -vac * a)
    f = Forest.uniform(3, reps, lower, 0.25)
    tab = element_tables(3, 1, 2)
    return f, atoms, tab


def _host_rho(f, atoms, tab):
    lists, _ = atom_lists(f, atoms.positions, CUT)
    return np.asarray(compute_density(
        f, tab.points, atoms.positions, atoms.charges, R_C,
        lists=lists, dtype=np.float32)), lists


def test_tiles_match_host_lists_uniform():
    f, atoms, tab = _setup()
    rho_h, _ = _host_rho(f, atoms, tab)
    rho_t = density_locality_tiles(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, CUT)
    assert rho_t.shape == rho_h.shape
    scale = np.abs(rho_h).max()
    np.testing.assert_allclose(rho_t, rho_h, atol=2e-6 * scale, rtol=2e-5)


def test_tiles_match_host_lists_refined_inheritance():
    """After refinement the host path INHERITS the parent's (cycle-0)
    lists; the tile path recomputes membership from the level-0 ancestor —
    both must give the same density."""
    from coulomb_gmg.adapt.transfer import transfer_cell_mask
    f, atoms, tab = _setup()
    lists0, _ = atom_lists(f, atoms.positions, CUT)
    rng = np.random.default_rng(2)
    flags = rng.random(f.n_cells) < 0.1
    f2 = f.refine(flags)
    lists2 = transfer_cell_mask(f, f2, lists0)
    rho_h = np.asarray(compute_density(
        f2, tab.points, atoms.positions, atoms.charges, R_C,
        lists=lists2, dtype=np.float32))
    rho_t = density_locality_tiles(f2, tab.points, atoms.positions,
                                   atoms.charges, R_C, CUT)
    scale = np.abs(rho_h).max()
    np.testing.assert_allclose(rho_t, rho_h, atol=2e-6 * scale, rtol=2e-5)


def test_plan_membership_covers_host_lists():
    """Every (cell, atom) pair the host lists contain must be covered by
    some work item of the plan (tile candidates are a superset; the
    in-kernel mask trims them)."""
    f, atoms, tab = _setup()
    lists, counts = atom_lists(f, atoms.positions, CUT)
    plan = build_tile_plan(f, len(tab.points), atoms.positions,
                           atoms.charges, CUT)
    # invert the atom sort: position of each original atom in sorted order
    pos_sorted = plan.at[:3, : len(atoms.positions)].T
    # map original atom index -> sorted index by matching positions
    order = {}
    orig = np.asarray(atoms.positions, np.float32)
    for s in range(len(orig)):
        order[tuple(np.round(pos_sorted[s], 6))] = s
    covered = {(b, t) for b, t in zip(plan.blk.tolist(),
                                      plan.atile.tolist())}
    for c in range(f.n_cells):
        b = c // plan.cpb
        for a in lists[c][: counts[c]]:
            s = order[tuple(np.round(orig[a], 6))]
            assert (b, s // plan.a_tile) in covered, (c, a)


def test_tiles_larger_lattice_and_bigger_tiles():
    f, atoms, tab = _setup(n=2, vac=2)
    rho_h, _ = _host_rho(f, atoms, tab)
    rho_t = density_locality_tiles(f, tab.points, atoms.positions,
                                   atoms.charges, R_C, CUT,
                                   a_tile=256)
    scale = np.abs(rho_h).max()
    np.testing.assert_allclose(rho_t, rho_h, atol=2e-6 * scale, rtol=2e-5)


def test_tiles_chunked_matches_single_launch():
    """A bucket-padded CSR work list (pad items on the all-pad atom tile,
    past the last block's range) gives the same rho as an unpadded one."""
    import jax.numpy as jnp
    from coulomb_gmg.ops.tile_density import (_build_geom, padded_items,
                                              tiles_plain)
    f, atoms, tab = _setup()
    plan = build_tile_plan(f, len(tab.points), atoms.positions,
                           atoms.charges, CUT)
    n = len(plan.atile)
    assert n > 40
    G = _build_geom(jnp.asarray(plan.cells16),
                    jnp.asarray(tab.points, jnp.float32), dim=3, n_q=8,
                    cpb=plan.cpb, p_tile=plan.p_tile, h0=float(f.h0),
                    lower0=tuple(float(x) for x in f.lower))

    def run(items, chunk):
        return np.asarray(tiles_plain(
            jnp.asarray(plan.offsets), jnp.asarray(items), G,
            jnp.asarray(plan.at), jnp.asarray(plan.wt), dim=3,
            a_tile=plan.a_tile, r_c=R_C, cut=CUT, h0=float(f.h0),
            chunk=chunk))

    exact = run(plan.atile, n)
    # 3n + 5 items: more pad than work, and a ragged last loop step
    np.testing.assert_array_equal(
        run(padded_items(plan.atile, plan.pad_tile, 3 * n + 5), 4), exact)
    assert exact.any()


def test_driver_tile_path_trajectory(tmp_path):
    """The driver's tile-density branch (forced via a CPU device standing
    in for the GPU, in a non-x64 subprocess) reproduces the host run's
    trajectory and norms."""
    import json
    import os
    import subprocess
    import sys

    script = tmp_path / "drv.py"
    script.write_text("""
import json, sys
import numpy as np
import jax
from coulomb_gmg.config import production_scaling_config
from coulomb_gmg.driver import Simulation
from coulomb_gmg.models.atoms import nacl_lattice
from coulomb_gmg.utils.logging import Pcout

out = {}
for tiles in (True, False):
    cfg = production_scaling_config(1, dtype="float32",
                                    n_adaptive_cycles=2,
                                    density_tiles=tiles,
                                    density_tiles_min_work=0.0)
    sim = Simulation(cfg, atoms=nacl_lattice(1), pcout=Pcout(enabled=False))
    if tiles:
        sim.device = jax.devices()[0]   # CPU device in the GPU's place
    res = sim.run()
    out[str(tiles)] = [{k: r[k] for k in
                        ("n_cells", "n_dofs", "l2_rhs", "cg_iterations")}
                       for r in res]
print("RES " + json.dumps(out))
""")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "0"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, str(script)], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RES ")][-1]
    out = json.loads(line[4:])
    for rt, rh in zip(out["True"], out["False"]):
        assert rt["n_cells"] == rh["n_cells"]
        assert rt["n_dofs"] == rh["n_dofs"]
        assert abs(rt["l2_rhs"] - rh["l2_rhs"]) < 1e-5 * abs(rh["l2_rhs"])
        assert abs(rt["cg_iterations"] - rh["cg_iterations"]) <= 1


def test_tiles_return_device_matches_pull():
    """return_device=True keeps rho resident and bucket-padded; the padded
    view must equal the pulled host result (pad rows exactly zero)."""
    f, atoms, tab = _setup()
    rho_np = density_locality_tiles(f, tab.points, atoms.positions,
                                    atoms.charges, R_C, CUT)
    rho_dev = density_locality_tiles(f, tab.points, atoms.positions,
                                     atoms.charges, R_C, CUT,
                                     return_device=True)
    C = f.n_cells
    assert rho_dev.shape[0] >= C and (rho_dev.shape[0] & (rho_dev.shape[0] - 1)) == 0
    r = np.asarray(rho_dev)
    np.testing.assert_allclose(r[:C], rho_np, rtol=1e-6, atol=1e-8)
    assert not r[C:].any()


def test_csr_worklist_has_empty_blocks_and_sorted_ranges():
    """Vacuum and pad blocks own empty CSR ranges; offsets are monotone and
    every block's atom tiles are distinct and ascending."""
    f, atoms, tab = _setup(n=2, vac=4)
    plan = build_tile_plan(f, len(tab.points), atoms.positions,
                           atoms.charges, CUT, p_tile=128, a_tile=16)
    counts = np.diff(plan.offsets)
    assert plan.offsets[0] == 0 and plan.offsets[-1] == len(plan.atile)
    assert (counts >= 0).all() and (counts == 0).any() and counts.any()
    assert len(plan.offsets) == plan.nb + 1
    for b in np.flatnonzero(counts):
        t = plan.atile[plan.offsets[b]:plan.offsets[b + 1]]
        assert (np.diff(t) > 0).all()
    assert plan.atile.max() < plan.pad_tile
    np.testing.assert_array_equal(plan.blk, np.repeat(np.arange(plan.nb),
                                                      counts))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 3000])
def test_padded_items_length_is_power_of_two(n):
    from coulomb_gmg.ops.tile_density import padded_items
    atile = np.arange(n, dtype=np.int32)
    out = padded_items(atile, pad_tile=7777)
    E = len(out)
    assert E >= max(n, 256) and E & (E - 1) == 0 and E < 2 * max(n, 256)
    np.testing.assert_array_equal(out[:n], atile)
    assert (out[n:] == 7777).all()


def test_pad_items_contribute_exactly_zero():
    """A work list of pad items only (every block empty) sums to exactly
    zero everywhere."""
    import jax.numpy as jnp
    from coulomb_gmg.ops.tile_density import (_build_geom, padded_items,
                                              tiles_plain)
    f, atoms, tab = _setup()
    plan = build_tile_plan(f, len(tab.points), atoms.positions,
                           atoms.charges, CUT)
    G = _build_geom(jnp.asarray(plan.cells16),
                    jnp.asarray(tab.points, jnp.float32), dim=3, n_q=8,
                    cpb=plan.cpb, p_tile=plan.p_tile, h0=float(f.h0),
                    lower0=tuple(float(x) for x in f.lower))
    # the all-pad tile, even when attributed to a real block, adds zeros
    offsets = np.zeros(plan.nb + 1, np.int32)
    offsets[1:] = 256                       # block 0 owns every pad item
    items = padded_items(np.zeros(0, np.int32), plan.pad_tile)
    out = tiles_plain(jnp.asarray(offsets), jnp.asarray(items), G,
                      jnp.asarray(plan.at), jnp.asarray(plan.wt), dim=3,
                      a_tile=plan.a_tile, r_c=R_C, cut=CUT,
                      h0=float(f.h0), chunk=64)
    assert not np.asarray(out).any()


@pytest.mark.parametrize("p_tile,a_tile,chunk_pairs", [
    (512, 512, 1 << 25), (256, 64, 1 << 14), (128, 32, 1 << 12),
    (64, 128, 1 << 13)])
def test_plain_tiles_match_host_lists(p_tile, a_tile, chunk_pairs):
    """The plain chunked density against the host list path over tile
    sizes and loop-step sizes (one item per step up to all at once), on a
    refined mesh."""
    from coulomb_gmg.adapt.transfer import transfer_cell_mask
    f, atoms, tab = _setup(n=2, vac=2)
    lists0, _ = atom_lists(f, atoms.positions, CUT)
    f2 = f.refine(np.random.default_rng(4).random(f.n_cells) < 0.05)
    lists2 = transfer_cell_mask(f, f2, lists0)
    rho_h = np.asarray(compute_density(
        f2, tab.points, atoms.positions, atoms.charges, R_C,
        lists=lists2, dtype=np.float32))
    rho_t = density_locality_tiles(f2, tab.points, atoms.positions,
                                   atoms.charges, R_C, CUT, p_tile=p_tile,
                                   a_tile=a_tile, chunk_pairs=chunk_pairs)
    scale = np.abs(rho_h).max()
    np.testing.assert_allclose(rho_t, rho_h, atol=2e-6 * scale, rtol=2e-5)
