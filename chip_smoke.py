"""Smoke test of the solver on one NVIDIA GPU (or four with --four-cards).

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: the sharded 8k run only

Phases (one card):

1. the card: ``nvidia-smi`` name and power limit, the compile-cache
   directory;
2. the density stage at the 64,000-atom cycle-0 plan, compiled for the
   card, against the host list path on the CPU backend for a random
   sample of cells (times after warm-up);
3. the main path: ``Simulation.run`` of the published 64,000-atom
   production configuration in float32, all 5 cycles — exact published
   per-cycle cell counts, 1..20 CG iterations and a true residual
   <= 1e-8 ||b|| per cycle; the double-f32 device RHS against the host
   float64 assembly of the same density on a small lattice first;
4. the FE-error exact gradient in float32 on the card against a float64
   numpy evaluation of the same formula, and the one-dispatch FE-error
   loop on the card against the host loop.

``--four-cards`` runs the reference's MPI decomposition of the 8,000-atom
run in float64 over four cards and compares it with the same
configuration on one card and with the published cell counts.

Every phase raises on failure.  The last line of standard output is one
JSON object naming the device; it is printed only when every phase
passed.  With no GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Plotting/ncells_per_atom.dat:6-12 of the reference, by lattice n
# (8 n^3 atoms)
REF_CELLS = {
    1: [85184, 85744, 87648, 91344, 99464],
    3: [140608, 141168, 145480, 153488, 172472],
    5: [216000, 216560, 222552, 233584, 253296],
    7: [314432, 314992, 323000, 337392, 362144],
    10: [512000, 512560, 523592, 543024, 576428],
    20: [1728000, 1728560, 1749672, 1785904, 1849296],
}


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn, reps=3):
    """(first-call seconds, best of ``reps`` warm seconds, last result);
    every call ends in block_until_ready."""
    t0 = time.perf_counter()
    out = fn()
    out.block_until_ready()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        out.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def peak_bytes(dev):
    return dev.memory_stats()["peak_bytes_in_use"]


def phase_density(dev, n=20):
    """The density stage at the 64k cycle-0 plan vs the host list path."""
    import jax
    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.ops import tile_density as td
    from coulomb_gmg.ops.density import compute_density, _ForestView
    from coulomb_gmg.ops.neighbors import atom_lists
    from coulomb_gmg.utils.logging import Pcout

    cfg = production_scaling_config(n, dtype="float32")
    atoms = nacl_lattice(n)
    sim = Simulation(cfg, atoms=atoms, pcout=Pcout(enabled=False))
    f = sim.make_initial_mesh()
    pts = sim.tab_rhs.points
    cut = cfg.nonzero_radius * cfg.r_c
    t0 = time.perf_counter()
    plan = td.build_tile_plan(f, len(pts), atoms.positions, atoms.charges,
                              cut)
    t_plan = time.perf_counter() - t0
    n_items = len(plan.atile)
    print(f"[density] {atoms.n} atoms, cycle 0: {f.n_cells} cells, {plan.nb} blocks, "
          f"{n_items} work items of {plan.a_tile} atoms x {plan.p_tile} "
          f"points ({n_items * plan.a_tile * plan.p_tile:.3e} pairs); "
          f"host plan {t_plan:.3f} s", flush=True)

    first, best, rho = timed(lambda: td.density_locality_tiles(
        f, pts, atoms.positions, atoms.charges, cfg.r_c, cut, device=dev,
        plan=plan, return_device=True))
    rho = np.asarray(rho)[: f.n_cells]
    print(f"[density] device stage: first call {first:.3f} s, warm best of "
          f"3 {best:.6f} s", flush=True)

    # the reference: the host list path on the CPU backend, in float64
    # (the float32 host path rounds absolute point coordinates near 20 to
    # ~1e-6, which moves rho by up to ~2e-5: it is printed, not asserted)
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(f.n_cells, min(8192, f.n_cells),
                                replace=False))
    sub = _ForestView(f, sample)
    lists, _ = atom_lists(sub, atoms.positions, cut)

    def host(dtype):
        with jax.default_device(cpu):
            return np.asarray(compute_density(
                sub, pts, atoms.positions, atoms.charges, cfg.r_c,
                lists=lists, dtype=dtype, device=cpu, _group=False),
                np.float64)

    with jax.enable_x64(True):
        ref = host(None)
    scale = float(np.abs(ref).max())
    print(f"[density] host list path float32 vs float64 on {len(sample)} "
          f"cells: max abs err {np.abs(host(np.float32) - ref).max():.3e} "
          f"(max |rho| {scale:.4f})", flush=True)
    err = np.abs(rho[sample] - ref)
    margin = (err / (2e-6 * scale + 2e-5 * np.abs(ref))).max()
    print(f"[density] device vs host list path float64: max abs err "
          f"{err.max():.3e}, {margin:.3f} of the tolerance", flush=True)
    np.testing.assert_allclose(rho[sample], ref, atol=2e-6 * scale,
                               rtol=2e-5)


def phase_rhs_identities(dev):
    """Double-f32 primitives on the card, and the device RHS of a small
    production lattice against the host float64 assembly."""
    import jax
    import jax.numpy as jnp
    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.fem.assembly import build_plan, assemble_np
    from coulomb_gmg.fem.integrals import stiffness_cells_np, rhs_cells_np
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.solver.device_gmg import _two_prod, _neumaier_step
    from coulomb_gmg.utils.logging import Pcout

    rng = np.random.default_rng(1)
    a = rng.standard_normal(1 << 20).astype(np.float32)
    b = rng.standard_normal(1 << 20).astype(np.float32)
    p, e = jax.jit(_two_prod)(jax.device_put(a, dev), jax.device_put(b, dev))
    exact = a.astype(np.float64) * b.astype(np.float64)
    perr = (np.abs(np.asarray(p, np.float64) + np.asarray(e, np.float64)
                   - exact) / np.abs(exact)).max()
    check(perr <= 2.0 ** -32, f"split product error {perr}")
    terms = rng.standard_normal((64, 1 << 16)).astype(np.float32)

    @jax.jit
    def nsum(t):
        def body(i, c):
            return _neumaier_step(c[0], c[1], t[i])
        z = jnp.zeros(t.shape[1], t.dtype)
        return jax.lax.fori_loop(0, t.shape[0], body, (z, z))

    hi, lo = nsum(jax.device_put(terms, dev))
    s64 = terms.astype(np.float64).sum(axis=0)
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    err = np.abs(got - s64).max() / np.abs(terms).sum(axis=0).max()
    print(f"[rhs] split products rel err {perr:.3e}; Neumaier sum rel err "
          f"{err:.3e}", flush=True)
    check(err < 2.0 ** -40, "Neumaier sum lost its compensation")

    cfg = production_scaling_config(3, dtype="float32", n_adaptive_cycles=1)
    sim = Simulation(cfg, atoms=nacl_lattice(3), pcout=Pcout(enabled=False))
    check(sim.device is not None, "no device selected")
    sim.forest = sim.make_initial_mesh()
    sim.setup(0)
    check(sim.device_ops_active(), "device operators not active")
    sim.assemble_system()
    f = sim.forest
    h = f.cell_h()
    plan = build_plan(f.dofs_of(1).cell2dof, sim.constraints)
    _, rhs64 = assemble_np(
        plan, stiffness_cells_np(sim.tab_lap, h),
        rhs_cells_np(sim.tab_rhs, h, sim.rho_host().astype(np.float64)))
    d = np.abs(np.asarray(sim.rhs, np.float64) - rhs64)
    nz = rhs64 != 0.0                        # constrained rows are zero
    ulps = d[nz] / np.spacing(np.abs(rhs64[nz]).astype(np.float32))
    rel = d.max() / np.abs(rhs64).max()
    print(f"[rhs] 216-atom device RHS vs host float64: max |diff| / "
          f"max |b| {rel:.3e}; {np.mean(ulps <= 1.0):.4f} of nonzero "
          f"entries within 1 f32 ulp",
          flush=True)
    check(rel <= 1e-6, "device RHS drifts from the host float64 RHS")


def phase_main(dev, n=20):
    """The published 64k production run, all 5 cycles, float32."""
    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout

    lines = []
    cfg = production_scaling_config(n, dtype="float32")
    t0 = time.perf_counter()
    sim = Simulation(cfg, atoms=nacl_lattice(n),
                     pcout=Pcout(enabled=False, tee=lines))
    res = sim.run()
    wall = time.perf_counter() - t0
    cells = [r["n_cells"] for r in res]
    cg = [r["cg_iterations"] for r in res]
    conv = [float(ln.split()[-1]) for ln in lines
            if ln.strip().startswith("Convergence value")]
    rel = [c / r["l2_rhs"] for c, r in zip(conv, res)]
    print(f"[main] {8 * n ** 3} atoms float32, 5 cycles: wall "
          f"{wall:.3f} s", flush=True)
    print(f"[main] cells per cycle {cells}", flush=True)
    print(f"[main] CG iterations per cycle {cg}", flush=True)
    print("[main] true residual / ||b|| per cycle "
          + " ".join(f"{x:.3e}" for x in rel), flush=True)
    for name in sorted(sim.timer.totals, key=sim.timer.totals.get,
                       reverse=True):
        print(f"[main] stage {name:<66s} {sim.timer.totals[name]:10.3f} s"
              f" ({sim.timer.calls[name]} calls)", flush=True)
    print(f"[main] peak_bytes_in_use {peak_bytes(dev)}", flush=True)
    check(cells == REF_CELLS[n], f"cell counts {cells}")
    check(all(1 <= k <= 20 for k in cg), f"CG iterations {cg}")
    check(len(rel) == 5 and all(x <= 1e-8 for x in rel),
          f"true residuals {rel}")


def grad_f64(points, pos, q, r_c):
    """analytic_solution_gradient (include/step_50.h:355-369) in float64
    numpy, over point chunks on a thread pool.  Returns the gradient and
    the sum of the terms' magnitudes (per point and component)."""
    from concurrent.futures import ThreadPoolExecutor
    from scipy.special import erf

    inv_const = 1.0 / (np.sqrt(np.pi) * r_c)

    def one(s):
        d = points[s:s + 256, None, :] - pos[None, :, :]
        r = np.sqrt((d * d).sum(-1))
        safe = np.where(r < 1e-14, 1.0, r)
        rq = safe / r_c
        radial = (2.0 * safe * np.exp(-rq * rq) * inv_const
                  - erf(rq)) / (safe * safe)
        radial = np.where(r < 1e-14, 0.0, radial)
        t = (q * radial / safe)[..., None] * d
        return t.sum(-2), np.abs(t).sum(-2)

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        parts = list(ex.map(one, range(0, len(points), 256)))
    return (np.concatenate([g for g, _ in parts]),
            np.concatenate([a for _, a in parts]))


def phase_gradient(dev, n_points=100_000):
    """FE-error exact gradient in float32 on the card."""
    import jax
    import jax.numpy as jnp
    from coulomb_gmg.mesh.forest import Forest
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.models.problems import analytic_solution_gradient
    from coulomb_gmg.ops.q1 import element_tables
    from coulomb_gmg.postprocess.energy import energy_norm_error

    atoms = nacl_lattice(10)
    r_c = 0.5
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.0, 11.0, (n_points, 3))
    pos32 = jax.device_put(atoms.positions.astype(np.float32), dev)
    q32 = jax.device_put(atoms.charges.astype(np.float32), dev)
    grad = jax.jit(lambda p, x, w: jax.lax.map(
        lambda c: analytic_solution_gradient(c, x, w, r_c),
        p.reshape(-1, 1000, 3)).reshape(-1, 3))
    p32 = jax.device_put(pts.astype(np.float32), dev)
    first, best, g32 = timed(lambda: grad(p32, pos32, q32), reps=1)
    g64, mag = grad_f64(pts, atoms.positions, atoms.charges, r_c)
    err = np.abs(np.asarray(g32, np.float64) - g64)
    rel = np.linalg.norm(err) / np.linalg.norm(g64)
    # each float32 term carries ~1 ulp, and the lattice's alternating
    # charges cancel: the field is ~1e-4 of the summed term magnitudes, so
    # the bound is per point, in units of eps32 * sum |term|
    cond = (err / (np.finfo(np.float32).eps * mag)).max()
    print(f"[gradient] {n_points} points x 8000 atoms float32: {best:.4f} s "
          f"warm; relative L2 vs float64 numpy {rel:.3e}; max error "
          f"{cond:.3f} eps32 * sum|term|", flush=True)
    check(cond <= 4.0, f"gradient error {cond} eps32 * sum|term|")

    f = Forest.uniform(3, 12, np.full(3, -1.0), 0.5)
    tab = element_tables(3, 1, 2)
    small = nacl_lattice(2)
    u = rng.standard_normal(f.dofs_of(1).n_dofs) * 0.01
    e_dev = energy_norm_error(f, tab, u, small.positions, small.charges,
                              r_c, device=dev, dtype=np.float32)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        e_host = energy_norm_error(f, tab, u, small.positions,
                                   small.charges, r_c, dtype=np.float32)
    print(f"[gradient] FE-error device loop {e_dev:.8e} vs host loop "
          f"{e_host:.8e}", flush=True)
    check(abs(e_dev - e_host) <= 1e-4 * abs(e_host), "FE-error loop")


def phase_four_cards(devs, n=10):
    """The 8,000-atom decomposition on four cards vs one card."""
    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout

    runs = {}
    for n_dev in (4, 1):
        cfg = production_scaling_config(n, dtype="float64",
                                        n_devices=n_dev)
        t0 = time.perf_counter()
        sim = Simulation(cfg, atoms=nacl_lattice(n),
                         pcout=Pcout(enabled=False))
        runs[n_dev] = sim.run()
        wall = time.perf_counter() - t0
        r = runs[n_dev]
        print(f"[four] n_devices={n_dev}: wall {wall:.3f} s, cells "
              f"{[x['n_cells'] for x in r]}, CG "
              f"{[x['cg_iterations'] for x in r]}", flush=True)
        print(f"[four] n_devices={n_dev}: peak_bytes_in_use per card "
              f"{[peak_bytes(d) for d in devs]}", flush=True)
    for n_dev in (4, 1):
        cells = [x["n_cells"] for x in runs[n_dev]]
        check(cells == REF_CELLS[n], f"{n_dev} cards: cells {cells}")
    worst = 0.0
    for r4, r1 in zip(runs[4], runs[1]):
        check(abs(r4["cg_iterations"] - r1["cg_iterations"]) <= 2,
              f"CG {r4['cg_iterations']} vs {r1['cg_iterations']}")
        for key in ("l2_rhs", "l2_sol", "threshold"):
            d = abs(r4[key] - r1[key]) / max(abs(r1[key]), 1e-300)
            worst = max(worst, d)
            check(d <= 1e-6, f"{key}: {r4[key]} vs {r1[key]}")
    print(f"[four] worst relative difference 4 vs 1 card (L2 rhs, L2 "
          f"solution, threshold): {worst:.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 8,000-atom float64 run on "
                         "four cards and its one-card comparison")
    args = ap.parse_args()

    import jax
    from coulomb_gmg.utils import platform
    if args.four_cards:
        jax.config.update("jax_enable_x64", True)
    dev = platform.require_gpu()
    cache = platform.enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"[card] {dev.device_kind}, {len(jax.devices())} device(s); "
          f"compile cache {cache}", flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        devs = jax.devices()
        check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")
        phase_four_cards(devs[:4])
    else:
        phase_density(dev)
        phase_rhs_identities(dev)
        phase_main(dev)
        phase_gradient(dev)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
