"""Compiled checks on the card.  Each test runs a child process with
JAX's default backend (the parent test process is pinned to the CPU) and
skips when that backend is not a GPU."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_GPU = 77


def run_on_card(body: str):
    """Run ``body`` in a child on the default backend; skip without a
    GPU, fail on any error."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import jax
        if jax.devices()[0].platform != "gpu":
            sys.exit(%d)
        dev = jax.devices()[0]
    """ % NO_GPU) + textwrap.dedent(body)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    env["PYTHONPATH"] = ROOT
    p = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    if p.returncode == NO_GPU:
        pytest.skip("no GPU: JAX's default backend is not a GPU")
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


@pytest.mark.gpu
def test_tile_density_compiled_matches_host_lists():
    run_on_card("""
        from coulomb_gmg.mesh.forest import Forest
        from coulomb_gmg.models.atoms import nacl_lattice
        from coulomb_gmg.ops.q1 import element_tables
        from coulomb_gmg.ops.density import compute_density
        from coulomb_gmg.ops.neighbors import atom_lists
        from coulomb_gmg.ops.tile_density import density_locality_tiles
        atoms = nacl_lattice(2)
        f = Forest.uniform(3, 16, np.full(3, -1.0), 0.25)
        tab = element_tables(3, 1, 2)
        lists, _ = atom_lists(f, atoms.positions, 1.75)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            ref = np.asarray(compute_density(
                f, tab.points, atoms.positions, atoms.charges, 0.5,
                lists=lists, dtype=np.float32, device=cpu))
        got = density_locality_tiles(f, tab.points, atoms.positions,
                                     atoms.charges, 0.5, 1.75, device=dev)
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=2e-6 * np.abs(ref).max())
    """)


@pytest.mark.gpu
def test_energy_norm_device_loop_compiled_matches_host():
    run_on_card("""
        from coulomb_gmg.mesh.forest import Forest
        from coulomb_gmg.models.atoms import nacl_lattice
        from coulomb_gmg.ops.q1 import element_tables
        from coulomb_gmg.postprocess.energy import energy_norm_error
        atoms = nacl_lattice(2)
        f = Forest.uniform(3, 12, np.full(3, -1.0), 0.5)
        tab = element_tables(3, 1, 2)
        u = np.random.default_rng(0).standard_normal(
            f.dofs_of(1).n_dofs) * 0.01
        e_dev = energy_norm_error(f, tab, u, atoms.positions, atoms.charges,
                                  0.5, device=dev, dtype=np.float32)
        with jax.default_device(jax.devices("cpu")[0]):
            e_host = energy_norm_error(f, tab, u, atoms.positions,
                                       atoms.charges, 0.5, dtype=np.float32)
        assert abs(e_dev - e_host) <= 1e-4 * abs(e_host), (e_dev, e_host)
    """)
