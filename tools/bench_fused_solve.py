#!/usr/bin/env python3
"""Solve-stage head-to-head at production scale: host block-wise GMG-CG vs
the FUSED single-executable device solve (solver/fused_gmg.py).

Builds the production system at the requested lattice size through the
real pipeline (cycle-0 mesh, locality density, assembly, GMG hierarchy),
then times

  * host block-wise   FusedGMG(device=None).solve(fused=False)
  * fused on device   FusedGMG(device=gpu).solve_fused — cold (ship +
                      compile) and hot (operators resident),

plus the cross-cycle delta-ship saving (a second FusedGMG built with
prev=).  The numbers feed PERF.md and the solve_device_min_dofs placement
threshold (Config).  Run on the GPU:

    python tools/bench_fused_solve.py --n 10   # 8,000 atoms
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10, help="atoms = 8 n^3")
    ap.add_argument("--rtol", type=float, default=1e-6)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    from coulomb_gmg.utils import platform
    dev = platform.select_device()
    on_chip = dev is not None
    platform.enable_compile_cache()

    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout
    from coulomb_gmg.solver.fused_gmg import FusedGMG

    cfg = production_scaling_config(args.n, dtype="float32",
                                    solver_backend="bucketed_cg",
                                    n_adaptive_cycles=1,
                                    device_operators="off")
    t0 = time.time()
    sim = Simulation(cfg, atoms=nacl_lattice(args.n),
                     pcout=Pcout(enabled=False))
    sim.run()
    print(json.dumps({"setup_s": round(time.time() - t0, 1),
                      "n_dofs": sim.A.n_rows,
                      "n_cells": sim.forest.n_cells}), flush=True)
    rhs = np.asarray(sim.rhs)

    # host block-wise
    gh = FusedGMG(sim.gmg, sim.A, sim.forest, device=None, dtype=jnp.float32)
    x_h, k_h, _, _ = gh.solve(rhs, rtol=args.rtol, fused=False)   # warm
    t0 = time.time()
    x_h, k_h, _, _ = gh.solve(rhs, rtol=args.rtol, fused=False)
    t_host = time.time() - t0
    print(json.dumps({"solve": "host_blockwise", "s": round(t_host, 2),
                      "iters": int(k_h)}), flush=True)

    # host fused (same machine, one executable)
    t0 = time.time()
    x_hf, k_hf, _, _ = gh.solve_fused(rhs, rtol=args.rtol)
    t_hostf_cold = time.time() - t0
    t0 = time.time()
    x_hf, k_hf, _, _ = gh.solve_fused(rhs, rtol=args.rtol)
    t_hostf = time.time() - t0
    print(json.dumps({"solve": "host_fused", "s": round(t_hostf, 2),
                      "cold_s": round(t_hostf_cold, 2),
                      "iters": int(k_hf)}), flush=True)

    if not on_chip:
        print(json.dumps({"note": "no GPU visible; device rows "
                                  "skipped"}), flush=True)
        return 0

    # fused on device: cold = operator ship + (cached) compile
    t0 = time.time()
    gd = FusedGMG(sim.gmg, sim.A, sim.forest, device=dev, dtype=jnp.float32,
                host_cache=getattr(sim, "_fused_host_cache", None))
    t_ship = time.time() - t0
    t0 = time.time()
    x_d, k_d, _, _ = gd.solve_fused(rhs, rtol=args.rtol)
    t_cold = time.time() - t0
    t0 = time.time()
    x_d, k_d, _, _ = gd.solve_fused(rhs, rtol=args.rtol)
    t_hot = time.time() - t0
    rel = float(np.linalg.norm(x_d - x_h) / (np.linalg.norm(x_h) + 1e-30))
    print(json.dumps({"solve": "device_fused", "ship_s": round(t_ship, 2),
                      "cold_s": round(t_cold, 2), "hot_s": round(t_hot, 2),
                      "iters": int(k_d), "rel_vs_host": rel}), flush=True)

    # cross-cycle rebuild with delta-ship (same operators -> full reuse)
    t0 = time.time()
    gd2 = FusedGMG(sim.gmg, sim.A, sim.forest, device=dev, dtype=jnp.float32,
                 host_cache=getattr(sim, "_fused_host_cache", None), prev=gd)
    t_reship = time.time() - t0
    t0 = time.time()
    x2, k2, _, _ = gd2.solve_fused(rhs, rtol=args.rtol)
    t_hot2 = time.time() - t0
    print(json.dumps({"solve": "device_fused_rebuilt_prev",
                      "reship_s": round(t_reship, 2),
                      "solve_s": round(t_hot2, 2),
                      "ship_stats_reused_delta_packed":
                          gd2._lvl_ship_stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
