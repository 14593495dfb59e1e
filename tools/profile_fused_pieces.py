"""Micro-profile the StencilGMG fused-solve pieces on the real chip.

Round-5 diagnosis aid: the 531k-DoF cycle-0 device solve measured ~15 s
hot (3 CG iterations) — this times each constituent (cellwise matvec,
DST coarse apply, copy maps, full vcycle-equivalent, one fused solve) as
separate chained executables so the hog is identifiable.

Usage: python tools/profile_fused_pieces.py [--n 10]
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def timeit(fn, iters=5):
    fn()                                   # warm
    t0 = time.time()
    for _ in range(iters):
        out = fn()
    # chain a scalar pull to defeat async dispatch
    import numpy as np
    float(np.asarray(out).ravel()[0])
    return (time.time() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    print(f"platform: {dev.platform}", flush=True)

    from coulomb_gmg.config import production_scaling_config
    from coulomb_gmg.driver import Simulation
    from coulomb_gmg.models.atoms import nacl_lattice
    from coulomb_gmg.utils.logging import Pcout
    from coulomb_gmg.solver.device_gmg import StencilGMG
    from coulomb_gmg.solver.fused_gmg import cellwise_mv, _coarse_apply

    cfg = production_scaling_config(args.n, dtype="float32",
                                    solver_backend="bucketed_cg",
                                    n_adaptive_cycles=1,
                                    device_operators="on")
    t0 = time.time()
    sim = Simulation(cfg, atoms=nacl_lattice(args.n),
                     pcout=Pcout(enabled=False))
    sim.run()
    print(f"cycle-0 run: {time.time() - t0:.1f}s", flush=True)
    g = sim._stencil_gmg
    rhs = np.asarray(sim.rhs)

    b = np.zeros(g.n_pad, g.np_dtype)
    b[: g.n] = rhs
    v = jax.device_put(jnp.asarray(b), g.device) if g.device is not None \
        else jnp.asarray(b)

    mv = jax.jit(cellwise_mv)
    t = timeit(lambda: mv(g._sys_dev, v))
    print(f"cellwise_mv: {t * 1e3:.1f} ms", flush=True)

    if g.dst is not None:
        lv0 = g.levels[0]
        n0_pad = lv0["inv_diag"].shape[0]
        d0 = jax.device_put(jnp.asarray(
            np.random.default_rng(0).standard_normal(n0_pad)
            .astype(g.np_dtype)), g.device)
        ca = jax.jit(lambda d: _coarse_apply(
            g.dst_S, g.dst_lam, d, lv0["inv_diag"], g.dst_interior,
            g.dst_boundary, g.dst_shape), static_argnums=())
        t = timeit(lambda: ca(d0))
        print(f"dst_coarse_apply: {t * 1e3:.1f} ms", flush=True)

    # copy maps (gather form)
    cp = jax.jit(lambda x, l2g, cm: jnp.where(cm, x[l2g], 0.0))
    t = timeit(lambda: cp(v, g._l2g[0], g._cmask[0]))
    print(f"copy_to level0: {t * 1e3:.1f} ms", flush=True)

    t0 = time.time()
    x, k, res0, res = g.solve(rhs, rtol=1e-6)
    print(f"fused solve (cold-ish): {time.time() - t0:.2f}s "
          f"k={k}", flush=True)
    t0 = time.time()
    x, k, res0, res = g.solve(rhs, rtol=1e-6)
    print(f"fused solve hot: {time.time() - t0:.2f}s k={k}", flush=True)


if __name__ == "__main__":
    main()
