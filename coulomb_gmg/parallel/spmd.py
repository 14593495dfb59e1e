"""Production SPMD context: the driver's multi-device execution path.

The JAX equivalent of the reference's end-to-end MPI domain
decomposition — p4est partitions cells by contiguous space-filling-curve
ranges (``src/step-50.cc:120-122``), each rank assembles its own cells and
``compress()`` add-reduces off-owner matrix/vector entries
(``src/step-50.cc:831-832``), density/estimation loop only over
locally-owned cells, and the solve runs on row-partitioned level matrices
(``src/step-50.cc:722-731``).  Here:

* cells are partitioned into contiguous canonical-order (tree-DFS SFC)
  index blocks — ``Forest`` stores cells in that order, so a contiguous
  index range IS an SFC range (mesh/forest.py:_canonical_order);
* density and energy-norm-error evaluation run as ``shard_map`` programs
  over per-device cell blocks, calling the SAME separable/chunked kernel
  math as the single-device production path (ops/density.py,
  postprocess/energy.py);
* assembly computes element tensors per device block and scatter-adds into
  the global CSR slots; the cross-device ``psum`` of those partial arrays
  is the ``compress()`` add-reduction (at production scale the same maps
  feed a ``reduce_scatter`` onto row blocks — the solver re-blocks by rows
  anyway, parallel/sharded_gmg.py);
* the solve itself is ``ShardedGMG`` (GMG path) or the sharded Jacobi-CG
  (``parallel/sharded.py``, the reference's src/step-50.cc:996-1005 path).

Everything compiles once per mesh topology and device count; XLA inserts
the collectives (psum across the devices).

Deliberately NOT sharded: the Kelly estimator + marking
(adapt/estimator.py) runs replicated on host over the full mesh with the
ghost-complete solution — numerically identical to every rank estimating
its own cells with ghosted vectors and MPI-maxing the threshold
(src/step-50.cc:1040-1089), because the threshold is a global max and the
per-cell indicators are independent.  It is host numpy by design (fresh
topology every cycle would force per-cycle XLA recompiles), so sharding
it over devices would change nothing but add collectives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map


class SpmdContext:
    """Device mesh + cell partition + sharded pipeline stages."""

    def __init__(self, n_devices: int):
        devs = jax.devices()
        if len(devs) < n_devices:
            raise RuntimeError(
                f"Config.n_devices={n_devices} but only {len(devs)} JAX "
                f"devices are visible (for CPU testing set XLA_FLAGS="
                f"--xla_force_host_platform_device_count={n_devices})")
        self.D = int(n_devices)
        self.mesh = Mesh(np.array(devs[: self.D]), ("shard",))
        self.axis = "shard"
        # jitted shard_map programs memoized by (stage, static shapes,
        # dtype, ...) so repeated block shapes across cycles hit the jit
        # cache instead of recompiling.
        # Device-varying data is always passed as ARGUMENTS (replicated
        # P() specs for atoms/tables) — never closed over, which would
        # constant-fold concrete arrays into the executable.
        self._progs = {}

    # ------------------------------------------------------ cell partition

    def block(self, n_cells: int) -> int:
        """Cells per device (last device may own fewer real cells)."""
        return (n_cells + self.D - 1) // self.D

    def owners(self, n_cells: int) -> np.ndarray:
        """(n_cells,) owning device by contiguous canonical-order blocks —
        the subdomain id (p4est SFC partition, src/step-50.cc:120-122)."""
        B = self.block(n_cells)
        return (np.arange(n_cells) // B).astype(np.int32)

    def _blocks(self, a: np.ndarray, pad_value=0, dtype=None):
        """(n, ...) cell array -> (D, B, ...) padded device blocks."""
        a = np.asarray(a)
        if dtype is not None:
            a = a.astype(dtype)
        n = a.shape[0]
        B = self.block(n)
        out = np.full((self.D * B,) + a.shape[1:], pad_value, dtype=a.dtype)
        out[:n] = a
        return out.reshape((self.D, B) + a.shape[1:])

    # ---------------------------------------------------- sharded density

    def density(self, forest, points_ref, positions, charges, r_c: float,
                mask=None, lists=None, dtype=None) -> np.ndarray:
        """Charge density over device-sharded cell blocks.

        Same math as the single-device production path: the separable
        tensor-product Gaussian evaluation with the dense-mask or
        padded-list locality variants (ops/density.py:_density_*_sep_jit);
        each device computes only its own cells
        (src/step-50.cc:509-575 loops locally-owned cells the same way).
        """
        from coulomb_gmg.ops.density import (
            _tensor_rule_1d, _density_lists_sep_jit, _density_dense_sep_jit,
            _density_all_sep_jit, _density_lists_jit, _density_dense_jit,
            _density_all_jit)

        n = forest.n_cells
        dim = forest.dim
        dt = dtype or np.float64
        lower = self._blocks(forest.cell_lower(), dtype=dt)
        h = self._blocks(forest.cell_h(), pad_value=1.0, dtype=dt)
        pos = jnp.asarray(np.asarray(positions, dt))
        q = jnp.asarray(np.asarray(charges, dt))
        pref = np.asarray(points_ref, dt)
        x1 = _tensor_rule_1d(np.asarray(points_ref, np.float64), dim)
        sep = x1 is not None
        rc = float(r_c)

        grid = jnp.asarray(x1.astype(dt)) if sep else jnp.asarray(pref)
        if lists is not None:
            variant = "lists"
            kern = _density_lists_sep_jit if sep else _density_lists_jit
            extra = (jnp.asarray(self._blocks(lists, pad_value=-1)),)
        elif mask is not None:
            variant = "mask"
            kern = _density_dense_sep_jit if sep else _density_dense_jit
            extra = (jnp.asarray(self._blocks(mask, pad_value=False)),)
        else:
            variant = "all"
            kern = _density_all_sep_jit if sep else _density_all_jit
            extra = ()

        args = (jnp.asarray(lower), jnp.asarray(h)) + extra + \
            (jnp.asarray(grid), pos, q)
        key = ("density", variant, sep, rc,
               tuple(a.shape for a in args), str(args[0].dtype))
        fn = self._progs.get(key)
        if fn is None:
            if variant == "all":
                def local(lo, hh, gr, po, qq):
                    return kern(lo[0], hh[0], gr, po, qq, rc)[None]
            else:
                def local(lo, hh, ex, gr, po, qq):
                    return kern(lo[0], hh[0], gr, po, qq, rc, ex[0])[None]
            sp = P(self.axis)
            n_sharded = 2 + len(extra)
            fn = jax.jit(shard_map(
                local, mesh=self.mesh,
                in_specs=(sp,) * n_sharded + (P(), P(), P()),
                out_specs=sp, check_vma=False))
            self._progs[key] = fn
        out = np.asarray(fn(*args))
        return out.reshape(-1, out.shape[-1])[:n]

    # ------------------------------------- sharded Morton-tiled density

    def density_tiles(self, forest, points_ref, positions, charges,
                      r_c: float, cutoff: float) -> np.ndarray:
        """The production locality-tile density (ops/tile_density.py)
        under SPMD: the CSR work list is split by cell-block OWNER
        (contiguous SFC block ranges — the same partition as every other
        stage) and every device runs the SAME density on its own blocks;
        the output is the device's own cell blocks, so no reduction is
        needed (src/step-50.cc:509-575 loops locally-owned cells the same
        way).

        Bit-identical to the single-device tile path on the CPU backend:
        identical plan, identical f32 arithmetic per (cell, atom) pair,
        items added to their block in the same order — only the partition
        differs.
        """
        from coulomb_gmg.ops import tile_density as td

        D = self.D
        pref = np.asarray(points_ref, np.float32)
        n_q = len(pref)
        plan = td.build_tile_plan(forest, n_q, positions, charges, cutoff,
                                  nb_multiple=D)
        C = forest.n_cells
        nbb = plan.nb // D

        # per-device CSR (LOCAL block offsets), padded to a common
        # power-of-2 length with the all-pad atom tile (exact zeros)
        starts = plan.offsets[::nbb]                     # (D+1,)
        E = td._next_pow2(max(256, int(np.diff(starts).max())))
        offs = np.stack([plan.offsets[d * nbb:(d + 1) * nbb + 1] - starts[d]
                         for d in range(D)])
        items = np.stack([td.padded_items(
            plan.atile[starts[d]:starts[d + 1]], plan.pad_tile, E)
            for d in range(D)])

        G = td._build_geom(jnp.asarray(plan.cells16), jnp.asarray(pref),
                           dim=forest.dim, n_q=n_q, cpb=plan.cpb,
                           p_tile=plan.p_tile, h0=float(forest.h0),
                           lower0=tuple(float(x) for x in forest.lower))
        Gb = jnp.asarray(np.asarray(G).reshape(
            8, D, nbb * plan.p_tile).transpose(1, 0, 2))   # (D, 8, cols_d)
        at = jnp.asarray(plan.at)
        wt = jnp.asarray(plan.wt)
        kw = dict(dim=forest.dim, a_tile=plan.a_tile, r_c=float(r_c),
                  cut=float(cutoff), h0=float(forest.h0),
                  chunk=td._plain_chunk(1 << 25, plan.a_tile, plan.p_tile,
                                        E))

        key = ("tiles", tuple(sorted(kw.items())), offs.shape, items.shape,
               Gb.shape, at.shape)
        fn = self._progs.get(key)
        if fn is None:
            def local(of, it, Gl, a, w):
                return td.tiles_plain(of[0], it[0], Gl[0], a, w, **kw)[None]

            sp = P(self.axis)
            fn = jax.jit(shard_map(
                local, mesh=self.mesh, in_specs=(sp, sp, sp, P(), P()),
                out_specs=sp, check_vma=False))
            self._progs[key] = fn
        out = np.asarray(fn(jnp.asarray(offs), jnp.asarray(items), Gb, at,
                            wt))
        rho = out.reshape(plan.nb, plan.p_tile)[:, : plan.cpb * n_q]
        rho = rho.reshape(plan.nb * plan.cpb, n_q)[:C]
        const = 4.0 * np.pi / (r_c ** 3 * np.pi ** 1.5)
        return (const * rho).astype(np.float32)

    # ------------------------------------------- sharded energy-norm error

    def energy_norm_error(self, forest, tables, u, positions, charges,
                          r_c: float, dtype=None) -> float:
        """sqrt(sum_c int ||grad u_h - grad u_exact||^2): per-device cell
        blocks with the production chunk kernel (postprocess/energy.py:
        _enorm_chunk) + psum — the reference's MPI sum
        (src/step-50.cc:1459)."""
        from coulomb_gmg.postprocess.energy import _enorm_chunk

        n = forest.n_cells
        dim = forest.dim
        dt = dtype or np.float64
        ucell = np.asarray(u)[forest.dofs_of(tables.degree).cell2dof]
        uc = self._blocks(ucell, dtype=dt)
        h = self._blocks(forest.cell_h(), pad_value=1.0, dtype=dt)
        lo = self._blocks(forest.cell_lower(), dtype=dt)
        val = self._blocks(np.ones(n), pad_value=0.0, dtype=dt)
        dphi = jnp.asarray(np.asarray(tables.dphi, dt))
        pref = jnp.asarray(np.asarray(tables.points, dt))
        w = jnp.asarray(np.asarray(tables.weights, dt))
        pos = jnp.asarray(np.asarray(positions, dt))
        q = jnp.asarray(np.asarray(charges, dt))
        rc = float(r_c)
        axis = self.axis

        args = (jnp.asarray(uc), jnp.asarray(h), jnp.asarray(lo),
                jnp.asarray(val), dphi, pref, w, pos, q)
        key = ("enorm", dim, rc, tuple(a.shape for a in args),
               str(args[0].dtype))
        fn = self._progs.get(key)
        if fn is None:
            def local(ucb, hb, lob, vb, dp, pr, wt, po, qq):
                e = _enorm_chunk(ucb[0], dp, hb[0], lob[0], pr, po, qq,
                                 rc, wt, vb[0], dim=dim)
                return jax.lax.psum(e, axis)

            sp = P(self.axis)
            fn = jax.jit(shard_map(
                local, mesh=self.mesh,
                in_specs=(sp, sp, sp, sp) + (P(),) * 5, out_specs=P(),
                check_vma=False))
            self._progs[key] = fn
        err = fn(*args)
        return float(np.sqrt(np.asarray(err)))

    # --------------------------------------------------- sharded estimator

    def estimate(self, forest, cell2dof, u, plan=None) -> np.ndarray:
        """Kelly face-jump indicators sharded over the device mesh
        (round-5 lift of the replicated-host default, VERDICT r4 #8;
        src/step-50.cc:1020-1090 estimates locally-owned cells per rank).

        Every face category (same-level per axis; coarse-fine per
        axis/side/subface) is flattened into ONE face list with per-face
        gradient-table ids; faces are partitioned by the owner of their
        first (fine) cell, each device integrates its faces' jumps and
        scatter-adds into a full-length partial, and a psum replicates
        the result — the compress step of distributed estimation.
        Identical math to adapt/estimator.py:estimate (f64)."""
        from coulomb_gmg.adapt.estimator import (build_face_plan,
                                                 _face_grad_tables)
        dim = forest.dim
        degree = 1 if cell2dof.shape[1] == 2 ** forest.dim else None
        assert degree == 1, "sharded estimator is Q1-only"
        if plan is None:
            plan = build_face_plan(forest)
        grads, fweights, sub_grads = _face_grad_tables(dim, degree,
                                                       degree + 1)
        # ---- unified gradient-table stack
        tabs, wts, tab_id = [], [], {}

        def tid(G, w):
            key = id(G)
            if key not in tab_id:
                tab_id[key] = len(tabs)
                tabs.append(np.asarray(G, np.float64))
                wts.append(np.asarray(w, np.float64))
            return tab_id[key]

        F_a, F_b, F_ta, F_tb = [], [], [], []
        for axis in range(dim):
            sel = plan.sl_axis == axis
            if sel.any():
                f_hi, f_lo = 2 * axis + 1, 2 * axis
                ta = tid(grads[f_hi][:, :, axis], fweights[f_hi])
                tb = tid(grads[f_lo][:, :, axis], fweights[f_lo])
                F_a.append(plan.sl_a[sel])
                F_b.append(plan.sl_b[sel])
                F_ta.append(np.full(sel.sum(), ta))
                F_tb.append(np.full(sel.sum(), tb))
        for axis in range(dim):
            for sidev in (0, 1):
                for sub in range(2 ** (dim - 1)):
                    sel = ((plan.cf_axis == axis) & (plan.cf_side == sidev)
                           & (plan.cf_sub == sub))
                    if not sel.any():
                        continue
                    f = 2 * axis + sidev
                    ta = tid(grads[f][:, :, axis], fweights[f])
                    tb = tid(sub_grads[(f, sub)][:, :, axis], fweights[f])
                    F_a.append(plan.cf_fine[sel])
                    F_b.append(plan.cf_coarse[sel])
                    F_ta.append(np.full(sel.sum(), ta))
                    F_tb.append(np.full(sel.sum(), tb))
        n_cells = forest.n_cells
        if not F_a:
            return np.zeros(n_cells)
        F_a = np.concatenate(F_a)
        F_b = np.concatenate(F_b)
        F_ta = np.concatenate(F_ta)
        F_tb = np.concatenate(F_tb)
        GT = jnp.asarray(np.stack(tabs))               # (n_tab, n_fq, nb)
        WT = jnp.asarray(np.stack(wts))                # (n_tab, n_fq)

        # ---- partition faces by owner of the (fine) first cell
        D = self.D
        owner = self.owners(n_cells)[F_a]
        counts = np.bincount(owner, minlength=D)
        E = max(int(counts.max()), 1)
        faces = np.zeros((D, E, 4), np.int32)
        valid = np.zeros((D, E), bool)
        offs = np.concatenate([[0], np.cumsum(counts)])
        order = np.argsort(owner, kind="stable")
        packed = np.stack([F_a, F_b, F_ta, F_tb], axis=1)[order]
        for d in range(D):
            faces[d, : counts[d]] = packed[offs[d]: offs[d + 1]]
            valid[d, : counts[d]] = True

        u = np.asarray(u, np.float64)
        ucell = jnp.asarray(u[cell2dof])               # replicated (C, nb)
        h = jnp.asarray(forest.cell_h())
        diam = h * np.sqrt(dim)
        axis = self.axis

        key = ("estimate", dim, faces.shape, ucell.shape, GT.shape)
        fn = self._progs.get(key)
        if fn is None:
            def local(fc, vd, uc, hh, dm, Gt, Wt):
                fc, vd = fc[0], vd[0]
                a, b, ta, tb = fc[:, 0], fc[:, 1], fc[:, 2], fc[:, 3]
                hi = jax.lax.Precision.HIGHEST
                ga = jnp.einsum("eb,eqb->eq", uc[a], Gt[ta],
                                precision=hi) / hh[a][:, None]
                gb = jnp.einsum("eb,eqb->eq", uc[b], Gt[tb],
                                precision=hi) / hh[b][:, None]
                Jf = jnp.sum(((ga - gb) ** 2) * Wt[ta], axis=1) \
                    * hh[a] ** (dim - 1)
                Jf = jnp.where(vd, Jf, 0.0)
                eta2 = jnp.zeros(uc.shape[0], uc.dtype)
                eta2 = eta2.at[a].add(dm[a] * Jf)
                eta2 = eta2.at[b].add(dm[b] * Jf)
                return jax.lax.psum(eta2, axis)

            sp = P(self.axis)
            fn = jax.jit(shard_map(
                local, mesh=self.mesh, in_specs=(sp, sp) + (P(),) * 5,
                out_specs=P(), check_vma=False))
            self._progs[key] = fn
        eta2 = np.asarray(fn(jnp.asarray(faces), jnp.asarray(valid),
                             ucell, h, diam, GT, WT))
        return np.sqrt(eta2)

    # --------------------------------------------------- sharded assembly

    def build_assembler(self, plan, tab_lap, tab_rhs, has_coeff: bool,
                        np_dtype=np.float64):
        """Distributed assembly with compress.

        Each device computes the element stiffness/load tensors for its
        own cell block (fem/integrals.py math) and scatter-adds them into
        the global CSR slots through its partition of the assembly plan's
        constraint-expanded maps; the cross-device ``psum`` is the
        ``compress(add)`` reduction of src/step-50.cc:831-832.

        Returns fn(h, coeff_q, rho_q) -> (data (nnz,), rhs (n,)) numpy.
        """
        D = self.D
        nnz = plan.pattern.nnz
        n = plan.pattern.n_rows
        nb = plan.n_basis
        n_cells = plan.n_cells
        B = self.block(n_cells)
        owner_of_cell = self.owners(n_cells)

        def pack(owner, arrays, pads):
            """Partition owner-sorted entry arrays into (D, E, ...) blocks."""
            counts = np.bincount(owner, minlength=D)
            E = max(int(counts.max()), 1)
            offs = np.concatenate([[0], np.cumsum(counts)])
            outs = []
            for a, padv in zip(arrays, pads):
                a = np.asarray(a)
                out = np.full((D, E) + a.shape[1:], padv, dtype=a.dtype)
                for d in range(D):
                    out[d, : counts[d]] = a[offs[d]: offs[d + 1]]
                outs.append(out)
            return outs

        # clean cells: nb^2 matrix entries + nb rhs entries per cell
        n_clean = len(plan.clean_idx)
        cl_owner = owner_of_cell[plan.clean_idx]
        cl_pos = plan.m_pos[: n_clean * nb * nb].reshape(n_clean, nb * nb)
        cl_rdof = plan.r_dof_clean.reshape(n_clean, nb)
        cl_local = plan.clean_idx - cl_owner.astype(np.int64) * B
        cl_idx_b, cl_pos_b, cl_rdof_b = pack(
            cl_owner, [cl_local, cl_pos, cl_rdof], [0, nnz, n])

        # dirty matrix entries (constraint-expanded)
        md_owner = owner_of_cell[plan.md_cell]
        md_pos = plan.m_pos[n_clean * nb * nb:]
        md_cell_b, md_i_b, md_j_b, md_w_b, md_pos_b = pack(
            md_owner,
            [plan.md_cell - md_owner.astype(np.int64) * B,
             plan.md_i, plan.md_j, plan.md_w.astype(np_dtype), md_pos],
            [0, 0, 0, 0.0, nnz])

        # constrained-diagonal entries
        d_owner = owner_of_cell[plan.d_cell]
        d_cell_b, d_i_b, d_pos_b = pack(
            d_owner, [plan.d_cell - d_owner.astype(np.int64) * B,
                      plan.d_i, plan.d_pos], [0, 0, nnz])

        # dirty rhs entries: need the device's dirty-cell list for the lift
        dd_owner = owner_of_cell[plan.dirty_idx]
        dd_counts = np.bincount(dd_owner, minlength=D)
        dd_offs = np.concatenate([[0], np.cumsum(dd_counts)])
        dd_idx_b, gd_b = pack(
            dd_owner, [plan.dirty_idx - dd_owner.astype(np.int64) * B,
                       plan.gd_local.astype(np_dtype)], [0, 0.0])
        # rd_cell indexes the GLOBAL dirty list; remap to device-local
        rd_owner = owner_of_cell[plan.dirty_idx[plan.rd_cell]]
        rd_cell_local = plan.rd_cell - dd_offs[rd_owner]
        rd_cell_b, rd_i_b, rd_w_b, rd_dof_b = pack(
            rd_owner, [rd_cell_local, plan.rd_i,
                       plan.rd_w.astype(np_dtype), plan.rd_dof], [0, 0, 0.0, n])

        axis = self.axis
        w_lap = jnp.asarray(np.asarray(tab_lap.weights, np_dtype))
        G = jnp.asarray(np.asarray(tab_lap.grad_outer, np_dtype))
        w_rhs = jnp.asarray(np.asarray(tab_rhs.weights, np_dtype))
        phi = jnp.asarray(np.asarray(tab_rhs.phi, np_dtype))
        dim = tab_lap.dim

        key = ("assemble", has_coeff, dim, nnz, n, nb, B,
               cl_pos_b.shape, md_pos_b.shape, d_pos_b.shape,
               dd_idx_b.shape, rd_dof_b.shape,
               w_lap.shape, w_rhs.shape, str(np.dtype(np_dtype)))
        fn = self._progs.get(key)
        if fn is None:
            def local(h, coeff_q, rho_q, cl_idx, cl_pos, cl_rdof, md_cell,
                      md_i, md_j, md_w, md_pos, d_cell, d_i, d_pos, dd_idx,
                      gd, rd_cell, rd_i, rd_w, rd_dof, wl, Gq, wr, ph):
                (h, coeff_q, rho_q, cl_idx, cl_pos, cl_rdof, md_cell, md_i,
                 md_j, md_w, md_pos, d_cell, d_i, d_pos, dd_idx, gd, rd_cell,
                 rd_i, rd_w, rd_dof) = (x[0] for x in (
                     h, coeff_q, rho_q, cl_idx, cl_pos, cl_rdof, md_cell,
                     md_i, md_j, md_w, md_pos, d_cell, d_i, d_pos, dd_idx,
                     gd, rd_cell, rd_i, rd_w, rd_dof))
                # element tensors for this device's cells (fem/integrals.py)
                scale = h ** (dim - 2)
                hi = jax.lax.Precision.HIGHEST
                if has_coeff:
                    cw = coeff_q * wl[None, :]
                    K = scale[:, None, None] * jnp.einsum(
                        "cq,qij->cij", cw, Gq, precision=hi)
                else:
                    k_ref = jnp.einsum("q,qij->ij", wl, Gq, precision=hi)
                    K = scale[:, None, None] * k_ref[None, :, :]
                F = (h ** dim)[:, None] * jnp.matmul(
                    rho_q * wr[None, :], ph, precision=hi)

                data = jnp.zeros(nnz + 1, K.dtype)
                data = data.at[cl_pos].add(
                    K[cl_idx].reshape(cl_idx.shape[0], nb * nb))
                data = data.at[md_pos].add(K[md_cell, md_i, md_j] * md_w)
                data = data.at[d_pos].add(K[d_cell, d_i, d_i])
                rhs = jnp.zeros(n + 1, K.dtype)
                rhs = rhs.at[cl_rdof].add(F[cl_idx])
                lift = jnp.einsum("cij,cj->ci", K[dd_idx], gd, precision=hi)
                f_eff = F[dd_idx] - lift
                rhs = rhs.at[rd_dof].add(f_eff[rd_cell, rd_i] * rd_w)
                # compress: add-reduce partial contributions across devices
                return (jax.lax.psum(data[:nnz], axis),
                        jax.lax.psum(rhs[:n], axis))

            sp = P(self.axis)
            fn = jax.jit(shard_map(
                local, mesh=self.mesh, in_specs=(sp,) * 20 + (P(),) * 4,
                out_specs=(P(), P()), check_vma=False))
            self._progs[key] = fn

        def run(h, coeff_q, rho_q):
            h_b = self._blocks(np.asarray(h, np_dtype), pad_value=1.0)
            n_q_l = len(np.asarray(tab_lap.weights))
            if coeff_q is None:
                coeff_b = np.ones((D, B, n_q_l), np_dtype)
            else:
                coeff_b = self._blocks(np.asarray(coeff_q, np_dtype),
                                       pad_value=1.0)
            rho_b = self._blocks(np.asarray(rho_q, np_dtype), pad_value=0.0)
            data, rhs = fn(
                jnp.asarray(h_b), jnp.asarray(coeff_b), jnp.asarray(rho_b),
                *map(jnp.asarray, (
                    cl_idx_b, cl_pos_b, cl_rdof_b, md_cell_b, md_i_b, md_j_b,
                    md_w_b, md_pos_b, d_cell_b, d_i_b, d_pos_b, dd_idx_b,
                    gd_b, rd_cell_b, rd_i_b, rd_w_b, rd_dof_b)),
                w_lap, G, w_rhs, phi)
            return np.asarray(data), np.asarray(rhs)

        return run


def electrostatic_energy_spmd(spmd: SpmdContext, forest, u, positions,
                              charges, r_c: float, degree: int = 1):
    """Energy postprocess with shard-ownership dedup: each atom's potential
    is evaluated by the shard OWNING the cell that contains it, partial
    long-range sums are combined, and the atom count is cross-checked —
    the all_gather + lowest-rank dedup of src/step-50.cc:1334-1398."""
    from coulomb_gmg.postprocess.energy import (
        locate_cells, point_values, electrostatic_energy)
    cells = locate_cells(forest, np.asarray(positions))
    atom_owner = spmd.owners(forest.n_cells)[cells]
    phi = np.zeros(len(charges))
    n_eval = 0
    for d in range(spmd.D):
        sel = atom_owner == d
        if not sel.any():
            continue
        phi[sel] = point_values(forest, u, np.asarray(positions)[sel],
                                degree=degree)
        n_eval += int(sel.sum())
    # the reference's sanity cross-check after the gather
    # (src/step-50.cc:1397-1398)
    assert n_eval == len(charges), (n_eval, len(charges))
    # phi was evaluated exactly once per atom, by its owning shard —
    # hand it to the energy split rather than re-evaluating globally
    return electrostatic_energy(forest, u, positions, charges, r_c,
                                degree=degree, phi_at_atoms=phi)
