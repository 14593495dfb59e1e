"""Device-resident GMG-CG: level operators BUILT on device, system matvec
matrix-free — no assembled operator crosses from host to device.

Shipping the assembled ELL hierarchy every cycle (hundreds of MB at
production scale) costs more than the solve it feeds.  This module
removes the data plane:

* every LEVEL operator (matrix, interface, transpose, prolongation,
  restriction, inverse diagonal, Chebyshev bounds) is built ON DEVICE from
  ~8 bytes/DoF of shipped topology (ops/stencil.py) — the level meshes are
  lattice subsets, so the operators are stencil-table lookups;
* the SYSTEM matrix is never assembled: the outer-CG matvec runs
  matrix-free from (cell2dof, h, K_ref, constraint expansion) — the
  assembled-matrix semantics of fem/assembly.py reproduced cellwise
  (solver/fused_gmg.py:cellwise_mv);
* unchanged levels reuse the previous cycle's device arrays outright
  (content-hash keys, ops/stencil.py:topology_signature) — zero traffic;
* the whole solve still runs as ONE fused executable
  (solver/fused_gmg.py:_fused_gmg_cg) — one dispatch, one pull.

Applies to the production configuration: GaussianCharges, Q1, unit
coefficient (src/step-50.cc:835-933 assembles exactly this operator).
The float64 host-assembly path (golden parity) is untouched.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.mesh.dofs import DofInfo, Constraints
from coulomb_gmg.ops.q1 import element_tables
from coulomb_gmg.ops.dst import DSTPoisson
from coulomb_gmg.ops.stencil import (
    stencil_table, level_topology, topology_signature, build_level_ops,
    build_prolongation_ops, power_lmax_device)
from coulomb_gmg.solver.fused_gmg import (
    _Packer, _pad_n, _pad_idx, _next_pow2, _round_up, _fused_gmg_cg)


def copy_maps(forest: Forest, dofs: DofInfo):
    """Per-level (global dof ids, level dof ids) copy maps: dofs on ACTIVE
    level-l cells minus the refinement edge (copy_to_mg / copy_from_mg,
    the Janssen-Kanschat transfer of solver/multigrid.py)."""
    out = []
    for ld in dofs.levels:
        _, active_index = forest.level_cells[ld.level]
        act = active_index >= 0
        ldofs = np.unique(ld.cell2dof[act])
        ldofs = ldofs[~ld.interface[ldofs]]
        gpos = np.searchsorted(dofs.keys, ld.keys[ldofs])
        out.append((gpos, ldofs))
    return out


def constraint_ell(con: Constraints, k_mult: int = 4):
    """(rows, cols (ncon, Kc), weights, inhomog) dense-ELL form of the
    resolved constraints (Q1: hanging rows have <= 4 masters, Dirichlet
    rows none)."""
    ncon = len(con.rows)
    counts = np.diff(con.indptr)
    Kc = _round_up(max(int(counts.max()) if ncon else 1, 1), k_mult)
    cols = np.zeros((ncon, Kc), np.int64)
    w = np.zeros((ncon, Kc), np.float64)
    if ncon:
        pos = np.arange(len(con.cols)) - np.repeat(con.indptr[:-1], counts)
        rowrep = np.repeat(np.arange(ncon), counts)
        cols[rowrep, pos] = con.cols
        w[rowrep, pos] = con.weights
    return con.rows, cols, w, con.inhomog


class StencilGMG:
    """Device-resident GMG-CG with chip-built operators.

    Drop-in for FusedGMG.solve on the production configuration; operators
    come from topology, not from host assembly — ``build_gmg`` is never
    called.
    """

    def __init__(self, forest: Forest, dofs: DofInfo, constraints: Constraints,
                 device=None, dtype=jnp.float32, smoother_degree: int = 4,
                 smoothing_range: float = 8.0, use_dst: bool = True,
                 coarse_maxiter: int = 500, coarse_rtol: float = 1e-6,
                 host_cache: Optional[dict] = None):
        import os
        import time
        t_init = time.time()
        self._debug = bool(os.environ.get("COULOMB_GMG_DEBUG"))
        assert dofs.degree == 1, "StencilGMG is Q1-only"
        self.device = device
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == jnp.float32 else np.float64
        self.degree = smoother_degree
        self.coarse_maxiter = coarse_maxiter
        self.coarse_rtol = coarse_rtol
        self.forest = forest
        self.dofs = dofs
        self.constraints = constraints
        dim = forest.dim
        put = (lambda a: jax.device_put(jnp.asarray(a), device)) \
            if device is not None else (lambda a: jnp.asarray(a))
        self._put = put

        n = dofs.n_dofs
        self.n = n
        self.n_pad = _pad_n(n)
        tab = element_tables(dim, 1, 2)
        self._T_host = stencil_table(dim, tab)
        w = np.asarray(tab.weights, np.float64)
        G = np.asarray(tab.grad_outer, np.float64)
        self._kref_host = np.einsum("q,qij->ij", w, G)

        cache = host_cache if host_cache is not None else {}
        touched = set()

        # ---- host topology extraction + per-level ship/build decisions
        topos = [level_topology(forest, ld, l)
                 for l, ld in enumerate(dofs.levels)]
        sigs = [topology_signature(t) for t in topos]
        cmaps = copy_maps(forest, dofs)

        pk = _Packer(self.np_dtype)
        ship_specs = []           # (l, handles) for levels that must build
        for l, t in enumerate(topos):
            key = ("slvl", sigs[l], str(self.np_dtype))
            touched.add(key)
            if key in cache:
                ship_specs.append((l, None))
                continue
            nl_pad = _pad_n(t.n)
            ctype = t.coords.dtype
            coords_pad = np.full((nl_pad, dim), t.side + 1, ctype)
            coords_pad[: t.n] = t.coords
            flags = (t.iface.astype(np.uint8)
                     | (t.boundary.astype(np.uint8) << 1))
            flags_pad = np.zeros(nl_pad, np.uint8)
            flags_pad[: t.n] = flags
            mask_pad = np.zeros(nl_pad, np.uint8)
            mask_pad[: t.n] = t.mask8
            h_c = (pk.h(coords_pad) if ctype == np.int16
                   else pk.i(coords_pad))
            ship_specs.append((l, (h_c, pk.b(mask_pad), pk.b(flags_pad))))
        # gather-form copy maps (solver/fused_gmg.py:copy_map_tables)
        from coulomb_gmg.solver.fused_gmg import copy_map_tables
        cm_levels, src_lvl, src_idx = copy_map_tables(
            [g for g, _ in cmaps], [ld for _, ld in cmaps], self.n_pad,
            [_pad_n(t.n) for t in topos])
        cg_h = [pk.i(l2g) for l2g, _ in cm_levels]
        cl_h = [pk.b(cmask) for _, cmask in cm_levels]
        h_src_lvl = pk.i(src_lvl)
        h_src_idx = pk.i(src_idx)

        # ---- system operands (matrix-free outer matvec)
        c2d = dofs.cell2dof
        C, nb = c2d.shape
        # strictly MORE than C: the gather-transpose table needs at least
        # one guaranteed pad cell whose entries are inert (hsc = 0)
        C_pad = _next_pow2(C + 1)
        self._C = C
        self._C_pad = C_pad
        c2d_pad = np.full((C_pad, nb), self.n_pad - 1, np.int64)
        c2d_pad[:C] = c2d
        # TRANSPOSED (nb, C_pad) on device (the gather layout of
        # solver/fused_gmg.py:_mv)
        c2dT = np.ascontiguousarray(c2d_pad.T)
        hsc = np.zeros(C_pad, np.float64)
        hsc[:C] = forest.cell_h() ** (dim - 2)
        hdim = np.zeros(C_pad, np.float64)
        hdim[:C] = forest.cell_h() ** dim
        con_rows, con_cols, con_w, con_g = constraint_ell(constraints)
        ncon = len(con_rows)
        Kc = con_cols.shape[1]
        dead = self.n_pad - 1
        # at least one all-pad row (its cols point at the dead dof with
        # zero weights) — the full-width gather tables redirect
        # unconstrained dofs to it
        ncon_pad = _next_pow2(ncon + 1)
        cr_pad = np.full(ncon_pad, dead, np.int64)
        cc_pad = np.full((ncon_pad, Kc), dead, np.int64)
        cw_pad = np.zeros((ncon_pad, Kc), np.float64)
        cg_pad = np.zeros(ncon_pad, np.float64)
        if ncon:
            counts = np.diff(constraints.indptr)
            filled = np.arange(Kc)[None, :] < counts[:, None]
            cr_pad[:ncon] = con_rows
            cc_pad[:ncon] = np.where(filled, con_cols, dead)
            cw_pad[:ncon] = con_w
            cg_pad[:ncon] = con_g
        # transpose width: how many constrained rows reference one master
        Kt = 1
        if ncon and len(constraints.cols):
            Kt = int(np.bincount(constraints.cols).max())
        self._Kt = _round_up(max(Kt, 1), 4)
        h_sys = dict(c2d=pk.i(c2dT), hsc=pk.f(hsc), hdim=pk.f(hdim),
                     con_rows=pk.i(cr_pad), con_cols=pk.i(cc_pad),
                     con_w=pk.f(cw_pad), con_g=pk.f(cg_pad))
        self._host_sys = dict(c2d=c2d, hsc=hsc[:C], con_rows=con_rows,
                              con_indptr=constraints.indptr,
                              con_cols_flat=constraints.cols,
                              con_w_flat=constraints.weights,
                              con_g=con_g)

        # ---- DST coarse precompute (host, small)
        self.dst = None
        dst_handles = None
        if use_dst and forest.base_reps >= 3:
            m0 = forest.base_reps
            d = DSTPoisson.build(dim, m0, float(forest.h(0)), self.np_dtype)
            nodes = m0 + 1
            coords0 = np.stack(
                np.meshgrid(*([np.arange(nodes)] * dim), indexing="ij"),
                -1).reshape(-1, dim)
            interior = (coords0 > 0).all(1) & (coords0 < m0).all(1)
            n0_pad = _pad_n(topos[0].n)
            from coulomb_gmg.solver.fused_gmg import _dst_handles
            dst_handles = _dst_handles(pk, interior, n0_pad, d)
            self.dst_shape = (m0 - 1,) * dim
            self.dst = d

        # ---- one transfer, then device-side builds
        views = pk.ship(device)
        T_dev = put(self._T_host.astype(self.np_dtype))
        self.levels = []
        self._coords_dev = []
        for (l, handles), t in zip(ship_specs, topos):
            key = ("slvl", sigs[l], str(self.np_dtype))
            if handles is None:
                ent = cache[key]
            else:
                h_c, h_m, h_fl = handles
                coords_dev = views[h_c]
                mask_dev = views[h_m]
                fl = views[h_fl]
                iface_dev = (fl & 1) != 0
                bnd_dev = (fl & 2) != 0
                elim_dev = iface_dev | bnd_dev
                want_if = l > 0 and bool(t.iface.any())
                out = build_level_ops(
                    coords_dev, mask_dev, elim_dev, iface_dev, bnd_dev,
                    t.n, T_dev, dim=dim, side=t.side, h=t.h,
                    want_iface=want_if, np_dtype=self.dtype)
                if want_if:
                    cols, evals, inv_diag, if_vals, ifT_vals = out
                else:
                    cols, evals, inv_diag = out
                    if_vals = ifT_vals = None
                lmax = power_lmax_device(cols, evals, inv_diag, t.n) * 1.05
                lmin = lmax / smoothing_range
                ent = dict(cols=cols, evals=evals, inv_diag=inv_diag,
                           if_vals=if_vals, ifT_vals=ifT_vals,
                           theta=0.5 * (lmax + lmin),
                           delta=0.5 * (lmax - lmin),
                           coords=coords_dev, n=t.n, side=t.side)
                cache[key] = ent
            self._coords_dev.append(ent["coords"])
            self.levels.append(ent)

        # prolongations: keyed on the level PAIR
        self._pr = [None]
        for l in range(1, len(topos)):
            key = ("spro", sigs[l], sigs[l - 1], str(self.np_dtype))
            touched.add(key)
            if key not in cache:
                cache[key] = build_prolongation_ops(
                    self._coords_dev[l], topos[l].n,
                    self._coords_dev[l - 1], topos[l - 1].n,
                    dim=dim, side_c=topos[l - 1].side, np_dtype=self.dtype)
            self._pr.append(cache[key])

        # evict superseded entries (the fine levels churn every cycle)
        if host_cache is not None:
            for k in [k for k in cache
                      if k[0] in ("slvl", "spro") and k not in touched]:
                del cache[k]

        self._l2g = [views[h] for h in cg_h]
        self._cmask = [views[h] != 0 for h in cl_h]
        self._src_lvl = views[h_src_lvl]
        self._src_idx = views[h_src_idx]
        self._sys_dev = {k: views[h] for k, h in h_sys.items()}
        kref_dev = put(self._kref_host.astype(self.np_dtype))
        kref_hi = self._kref_host.astype(self.np_dtype)
        self._kref_hi = put(kref_hi)
        self._kref_lo = put((self._kref_host - kref_hi).astype(self.np_dtype))
        s = self._sys_dev
        s["kref"] = kref_dev
        s["d2c"] = _build_d2c(s["c2d"], n_pad=self.n_pad)
        s["d_reg"] = _raw_diag(s["c2d"], s["d2c"], s["hsc"], kref_dev)
        (s["con_mask"], s["con_cols_full"], s["con_w_full"], s["g_full"],
         s["conT_row"], s["conT_w"]) = _build_con_tables(
            s["con_rows"], s["con_cols"], s["con_w"], s["con_g"],
            n_pad=self.n_pad, Kt=self._Kt)
        if dst_handles is not None:
            from coulomb_gmg.solver.fused_gmg import _resolve_dst
            (self.dst_interior, self.dst_inv_map, self.dst_int_mask,
             self.dst_bnd_mask, self.dst_S, self.dst_lam) = \
                _resolve_dst(views, dst_handles)
        if self._debug:
            import time as _t
            built = sum(1 for _, h in ship_specs if h is not None)
            print(f"[device_gmg] init {time.time() - t_init:.2f}s "
                  f"(n={n}, built {built}/{len(topos)} levels)", flush=True)

    # ------------------------------------------------------------- fused

    def _fused_tree(self):
        lv_list = []
        for l, ent in enumerate(self.levels):
            pr = self._pr[l]
            lv_list.append({
                "A": (ent["cols"], ent["evals"]),
                "inv_diag": ent["inv_diag"],
                "theta": ent["theta"], "delta": ent["delta"],
                "if": ((ent["cols"], ent["if_vals"])
                       if ent["if_vals"] is not None else None),
                "ifT": ((ent["cols"], ent["ifT_vals"])
                        if ent["ifT_vals"] is not None else None),
                "P": (pr[0], pr[1]) if pr is not None else None,
                "R": (pr[2], pr[3]) if pr is not None else None,
                "l2g": self._l2g[l], "cmask": self._cmask[l],
            })
        s = self._sys_dev
        sys_tree = {k: s[k] for k in ("c2d", "d2c", "hsc", "kref",
                                      "con_mask", "con_cols_full",
                                      "con_w_full", "conT_row", "conT_w",
                                      "d_reg")}
        return {"sys": sys_tree, "levels": lv_list,
                "src_lvl": self._src_lvl, "src_idx": self._src_idx,
                "dst": ((self.dst_S, self.dst_lam, self.dst_interior,
                         self.dst_inv_map, self.dst_int_mask,
                         self.dst_bnd_mask) if self.dst is not None
                        else None)}

    def solve(self, rhs, x0=None, rtol: float = 1e-6, maxiter: int = 100,
              abstol: float = 0.0, fused: Optional[bool] = None,
              rhs_dev=None, rhs_norm: Optional[float] = None,
              return_dev: bool = False):
        """Fused one-dispatch GMG-CG (FusedGMG.solve contract).  ``rhs_dev``:
        an already-device-resident padded rhs (the device RHS-assembly /
        device-IR paths) — skips the host ship; ``rhs_norm`` supplies the
        tolerance norm without a pull; ``return_dev`` keeps the padded
        solution on device (the device-IR accumulation) instead of
        pulling it."""
        import time
        t_s = time.time()
        if rhs_dev is not None:
            bj = rhs_dev
            if rhs_norm is not None:
                nb2 = float(rhs_norm)
            else:
                nb2 = (float(np.linalg.norm(np.asarray(rhs, np.float64)))
                       if rhs is not None else float(jnp.linalg.norm(bj)))
        else:
            b = np.zeros(self.n_pad, self.np_dtype)
            b[: self.n] = np.asarray(rhs, self.np_dtype)
            bj = self._put(b)
            nb2 = float(np.linalg.norm(b))
        x = np.zeros(self.n_pad, self.np_dtype)
        if x0 is not None:
            x[: self.n] = np.asarray(x0, self.np_dtype)
        xj = self._put(x)
        tol = np.asarray(max(rtol * nb2, abstol), self.np_dtype)
        flat, treedef = jax.tree_util.tree_flatten(self._fused_tree())
        xs, stats = _fused_gmg_cg(
            bj, xj, tol, np.asarray(self.coarse_rtol, self.np_dtype), flat,
            treedef=treedef, degree=self.degree,
            dst_shape=self.dst_shape if self.dst is not None else None,
            coarse_maxiter=self.coarse_maxiter, maxiter=maxiter)
        st = np.asarray(stats)                    # one small pull
        k, res0, res = int(st[0]), float(st[1]), float(st[2])
        out = xs if return_dev else np.asarray(xs)[: self.n]
        if self._debug:
            print(f"[device_gmg] fused solve {k} iters "
                  f"{time.time() - t_s:.2f}s", flush=True)
        return out, k, res0, res

    # ---------------------------------------------------- device RHS

    def assemble_rhs(self, rho, tab_rhs):
        """Device-side RHS assembly from density at quadrature points
        (src/step-50.cc:799-828 semantics via fem/assembly.py's C^T form):
        ``rhs = C^T_hom(f_raw - A_raw g_ext)`` with constrained rows zeroed.

        rho: (n_cells, n_q) numpy, or an already-device (C_pad, n_q)
        array (the tile-density path keeps it resident — VERDICT r4 #2).
        Returns (rhs_np (n,), rhs_dev (n_pad,))."""
        # the w*phi table ships as an (hi, lo) f32 split of its float64
        # value so the device's double-f32 chain sees exact coefficients
        # (see _rhs_device)
        wphi64 = (np.asarray(tab_rhs.weights, np.float64)[:, None]
                  * np.asarray(tab_rhs.phi, np.float64))
        wphi_hi = wphi64.astype(self.np_dtype)
        wphi_lo = (wphi64 - wphi_hi).astype(self.np_dtype)
        wq = np.stack([wphi_hi, wphi_lo]).astype(self.np_dtype)
        if isinstance(rho, np.ndarray):
            r = np.zeros((self._C_pad, rho.shape[1]), self.np_dtype)
            r[: rho.shape[0]] = rho
            rho_dev = self._put(r)
        else:
            rho_dev = rho
            assert rho_dev.shape[0] == self._C_pad, (
                rho_dev.shape, self._C_pad)
        s = self._sys_dev
        import time
        t0 = time.time()
        rhs_dev, bh, bl = _rhs_device(
            rho_dev, self._put(wq), s["hdim"], s["c2d"],
            s["d2c"], s["hsc"], s["kref"], s["g_full"], s["con_mask"],
            s["conT_row"], s["conT_w"])
        self._b_dd = (bh, bl)       # double-f32 rhs for the device defect
        t1 = time.time()
        rhs_np = np.asarray(rhs_dev)[: self.n]
        if self._debug:
            print(f"[device_gmg] rhs dispatch {t1 - t0:.2f}s "
                  f"pull {time.time() - t1:.2f}s", flush=True)
        return rhs_np, rhs_dev

    # ----------------------------------------------- host f64 matvec (IR)

    def host_matvec64(self, v: np.ndarray) -> np.ndarray:
        """Float64 matrix-free matvec of the assembled system on host —
        the defect operator for mixed-precision iterative refinement
        (no CSR is ever assembled in device-operator mode)."""
        from coulomb_gmg.utils import native
        s = self._host_sys
        n = self.n
        v = np.asarray(v, np.float64)
        w = v.copy()
        rows = s["con_rows"]
        counts = np.diff(s["con_indptr"]) if len(rows) else np.zeros(0,
                                                                     np.int64)
        if len(rows):
            prod = s["con_w_flat"] * v[s["con_cols_flat"]]
            rowrep = np.repeat(np.arange(len(rows)), counts)
            w[rows] = np.bincount(rowrep, weights=prod,
                                  minlength=len(rows))
        xl = w[s["c2d"]]
        yl = (xl @ self._kref_host) * s["hsc"][:, None]
        z = np.zeros(n)
        native.scatter_add(s["c2d"].reshape(-1), yl.reshape(-1), n, out=z)
        y = z.copy()
        if len(rows):
            rowrep = np.repeat(np.arange(len(rows)), counts)
            np.add.at(y, s["con_cols_flat"],
                      s["con_w_flat"] * z[rows[rowrep]])
            y[rows] = self._raw_diag_host()[rows] * v[rows]
        return y

    def _raw_diag_host(self):
        if not hasattr(self, "_d_reg_host"):
            from coulomb_gmg.utils import native
            s = self._host_sys
            kd = np.diag(self._kref_host)
            vals = (kd[None, :] * s["hsc"][:, None]).reshape(-1)
            d = np.zeros(self.n)
            native.scatter_add(s["c2d"].reshape(-1), vals, self.n, out=d)
            self._d_reg_host = d
        return self._d_reg_host


from functools import partial


@partial(jax.jit, static_argnames=("n_pad",))
def _build_d2c(c2dT, n_pad: int):
    """Transpose of cell2dof as a gather table: d2c[slot, i] = flat entry
    position in the (nb * C_pad) TRANSPOSED cell-local value array
    contributing to dof i (a vertex touches <= 2^dim cells), dead slots
    -> a guaranteed pad-cell entry (hsc = 0, so its value is always
    exactly zero).  Built on device once per topology; turns every
    cell->dof accumulation into a gather-sum (no runtime scatter).
    Input and output in transposed (nb, N) layout."""
    nb, C_pad = c2dT.shape
    flat = c2dT.reshape(-1).astype(jnp.int32)       # layout a*C_pad + c
    order = jnp.argsort(flat, stable=True).astype(jnp.int32)
    sortedv = flat[order]
    rows = jnp.arange(n_pad, dtype=jnp.int32)
    start = jnp.searchsorted(sortedv, rows).astype(jnp.int32)
    pos = start[None, :] + jnp.arange(nb, dtype=jnp.int32)[:, None]
    pos_c = jnp.minimum(pos, flat.shape[0] - 1)
    valid = (sortedv[pos_c] == rows[None, :]) & (pos < flat.shape[0])
    # the last pad cell's entry lives at column C_pad-1 of every row; use
    # the final flat position of the LAST row (a pad-cell entry)
    return jnp.where(valid, order[pos_c], flat.shape[0] - 1)


@partial(jax.jit, static_argnames=("n_pad", "Kt"))
def _build_con_tables(con_rows, con_cols, con_w, con_g, n_pad: int,
                      Kt: int):
    """Full-width gather tables for the constraint expansion, built once
    per topology on device (scatters here are OUT of the solve loop):

    - con_mask (n_pad,): dof is constrained;
    - con_cols_full / con_w_full (n_pad, Kc): per-dof master expansion
      (unconstrained dofs redirect to the all-pad row: dead cols, zero
      weights);
    - g_full (n_pad,): constraint inhomogeneity per dof;
    - conT_row / conT_w (n_pad, Kt): TRANSPOSED expansion — for each
      master dof, the constrained rows referencing it (dead slots carry
      zero weight).  Kt is the host-computed max reference count.
    """
    ncon_pad, Kc = con_cols.shape
    dead = n_pad - 1
    mask = (jnp.zeros(n_pad, bool).at[con_rows].set(True)
            .at[dead].set(False))
    idx = jnp.full(n_pad, ncon_pad - 1, jnp.int32).at[con_rows].set(
        jnp.arange(ncon_pad, dtype=jnp.int32))
    idx = jnp.where(mask, idx, ncon_pad - 1)
    # all full-width tables TRANSPOSED (K, n_pad) (the gather layout of
    # solver/fused_gmg.py:_mv)
    ccf = con_cols[idx].T
    cwf = jnp.where(mask[None, :], con_w[idx].T, 0.0).astype(con_w.dtype)
    gf = (jnp.zeros(n_pad, con_w.dtype).at[con_rows].set(con_g)
          .at[dead].set(0.0))
    flat_cols = con_cols.reshape(-1).astype(jnp.int32)
    flat_w = con_w.reshape(-1)
    flat_row = jnp.repeat(con_rows.astype(jnp.int32), Kc)
    order = jnp.argsort(flat_cols, stable=True).astype(jnp.int32)
    sc = flat_cols[order]
    rows = jnp.arange(n_pad, dtype=jnp.int32)
    start = jnp.searchsorted(sc, rows).astype(jnp.int32)
    pos = start[None, :] + jnp.arange(Kt, dtype=jnp.int32)[:, None]
    pos_c = jnp.minimum(pos, sc.shape[0] - 1)
    valid = (sc[pos_c] == rows[None, :]) & (pos < sc.shape[0])
    src = jnp.where(valid, order[pos_c], sc.shape[0] - 1)
    tr = flat_row[src]
    tw = jnp.where(valid, flat_w[src], 0.0).astype(con_w.dtype)
    # the dead dof's own slots reference only pad entries (zero weight)
    tw = jnp.where(rows[None, :] == dead, 0.0, tw).astype(con_w.dtype)
    return mask, ccf, cwf, gf, tr, tw


def _neumaier_step(hi, lo, t):
    """One Neumaier (exact-TwoSum, propagated-low) accumulation step.
    The optimization barrier stops XLA's algebraic simplifier from
    folding the error term to zero (measured: unprotected Kahan compiles
    to a plain sum).  Reproduces f64-accumulate-then-cast-to-f32
    BIT-FOR-BIT for exact f32 terms (verified)."""
    s = jax.lax.optimization_barrier(hi + t)
    bb = jax.lax.optimization_barrier(s - hi)
    err = (hi - (s - bb)) + (t - bb)
    lo = lo + err
    return jax.lax.optimization_barrier((s, lo))


def _split(a):
    """(hi, lo) with hi = a's leading half of the significand (the low
    bits cleared through the integer view) and lo = a - hi, both exact,
    so every product of halves is exact."""
    it = jnp.int32 if a.dtype == jnp.float32 else jnp.int64
    keep = -(1 << 12) if a.dtype == jnp.float32 else -(1 << 27)
    hi = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(a, it) & keep, a.dtype)
    return hi, a - hi


def _two_prod(a, b):
    """The product as a (value, error) pair that sums to ``a * b`` within
    ~2^-33 relative (float32): value = ah * bh exactly, error = the cross
    and low products (each exact, one rounding in their sum).

    Dekker's form (value = fl(a * b), error = a residual cancelled against
    it) is NOT used: XLA's CPU and GPU backends contract multiplies and
    adds into fused multiply-adds, and contracting ``ah * bh - fl(a * b)``
    into fma(-a, b, ah * bh) cancels against the exact product instead,
    which silently zeroes the error term (measured: the double-f32 defect
    fell to float32 accuracy).  Here every product is exact, so a fused
    multiply-add can only remove a rounding."""
    ah, al = jax.lax.optimization_barrier(_split(a))
    bh, bl = jax.lax.optimization_barrier(_split(b))
    err = (ah * bl + al * bh) + al * bl
    return jax.lax.optimization_barrier((ah * bh, err))


@jax.jit
def _rhs_device(rho, wq, hdim, c2d, d2c, hsc, kref, g_full, con_mask,
                conT_row, conT_w):
    """Device RHS with COMPENSATED f32 accumulation.

    The NaCl charges alternate sign, so plain f32 evaluation of the load
    vector carries ~3e-6 entrywise cancellation error (measured round 5)
    — enough to flip near-threshold Kelly marking and break the exact
    published-trajectory reproduction at 8k atoms.  The whole chain runs
    in DOUBLE-F32 (split products against a split w*phi table,
    Neumaier sums within the cell and across cells; h^dim multiplications
    are exact powers of two), reproducing the reference's float64 RHS to
    ~1 f32 ulp without any f64 on the device."""
    nb = c2d.shape[0]                     # c2d is TRANSPOSED (nb, C_pad)
    n_q = rho.shape[1]
    rhoT = rho.T                          # (n_q, C_pad)
    # w*phi split into an (hi, lo) f32 pair on host: wq row layout is
    # (2, n_q, nb) — see assemble_rhs
    wphi_hi, wphi_lo = wq[0], wq[1]
    S = jnp.zeros((nb, rhoT.shape[1]), rho.dtype)    # (nb, C_pad)
    E = jnp.zeros_like(S)
    for q in range(n_q):
        rq = rhoT[q][None, :]
        t, te = _two_prod(rq, wphi_hi[q][:, None])
        S, E = _neumaier_step(S, E, t)
        E = E + te + rq * wphi_lo[q][:, None]
    hd = hdim[None, :]                    # exact power of two per cell
    f_hi = S * hd
    f_lo = E * hd
    lift = (jax.lax.dot(kref, g_full[c2d],
                        precision=jax.lax.Precision.HIGHEST)
            * hsc[None, :])                              # inhomog. BC lift
    fl_hi = (f_hi - lift).reshape(-1)
    fl_lo = f_lo.reshape(-1)
    # cross-cell sum over the <= 2^dim contributing cells (== the host's
    # f64 accumulation at f32 output precision); d2c is (nb, n_pad)
    hi = jnp.zeros(d2c.shape[1], rho.dtype)
    lo = jnp.zeros_like(hi)
    for b in range(nb):
        hi, lo = _neumaier_step(hi, lo, fl_hi[d2c[b]])
        lo = lo + fl_lo[d2c[b]]
    # constraint C^T carrying the double-f32 pair (the master corrections
    # are first-order); non-master dofs reduce to hi + lo exactly as the
    # collapsed form did
    ch = jnp.sum(conT_w * hi[conT_row], axis=0)
    cl = jnp.sum(conT_w * lo[conT_row], axis=0)
    H, L = _neumaier_step(hi, lo, ch)
    L = L + cl
    zero = jnp.zeros((), rho.dtype)
    H = jnp.where(con_mask, zero, H)                     # zero rhs rows
    L = jnp.where(con_mask, zero, L)
    return (H + L).astype(rho.dtype), H, L


@jax.jit
def _raw_diag(c2dT, d2cT, hsc, kref):
    del c2dT
    kd = jnp.diagonal(kref)
    vals = (kd[:, None] * hsc[None, :]).reshape(-1)   # (nb, C_pad) flat
    return jnp.sum(vals[d2cT], axis=0)


@jax.jit
def _defect_dd(bh, bl, xh, xl, c2dT, d2cT, hsc, kref_hi, kref_lo,
               con_mask, con_cols_full, con_w_full, conT_row, conT_w):
    """Double-f32 device defect ``r = b - A x`` with the EXACT assembled
    semantics (C^T A_raw C + regularized constrained rows): the f64 host
    defect of iterative refinement moved onto the device — products
    against the split K_ref carry ~2^-33 relative error (_two_prod), every
    accumulation is Neumaier-compensated, h factors are exact powers of
    two.  Entry accuracy ~1e-10 relative — the refinement target
    (1e-8 * ||b||) is a TRUE residual.

    Returns (r32, r_hi, r_lo, ||r||^2)."""
    Kc = con_cols_full.shape[0]
    nb = c2dT.shape[0]
    # w = C x (hanging weights are exact powers of two)
    EH = jnp.zeros_like(xh)
    EL = jnp.zeros_like(xh)
    for k in range(Kc):
        EH, EL = _neumaier_step(EH, EL,
                                con_w_full[k] * xh[con_cols_full[k]])
        EL = EL + con_w_full[k] * xl[con_cols_full[k]]
    wh = jnp.where(con_mask, EH, xh)
    wl = jnp.where(con_mask, EL, xl)
    # cell pass: yl[a, c] = sum_b kref[a, b] w[c2d[b, c]], double-f32
    gh = wh[c2dT]                                        # (nb, C_pad)
    gl = wl[c2dT]
    YH = jnp.zeros_like(gh)
    YL = jnp.zeros_like(gh)
    for b in range(nb):
        t, te = _two_prod(kref_hi[:, b][:, None], gh[b][None, :])
        YH, YL = _neumaier_step(YH, YL, t)
        YL = (YL + te + kref_lo[:, b][:, None] * gh[b][None, :]
              + kref_hi[:, b][:, None] * gl[b][None, :])
    YH = YH * hsc[None, :]                               # exact pow2
    YL = YL * hsc[None, :]
    fh = YH.reshape(-1)
    fl = YL.reshape(-1)
    ZH = jnp.zeros(d2cT.shape[1], xh.dtype)
    ZL = jnp.zeros_like(ZH)
    for b in range(d2cT.shape[0]):
        ZH, ZL = _neumaier_step(ZH, ZL, fh[d2cT[b]])
        ZL = ZL + fl[d2cT[b]]
    # C^T
    ch = jnp.sum(conT_w * ZH[conT_row], axis=0)
    cl = jnp.sum(conT_w * ZL[conT_row], axis=0)
    AH, AL = _neumaier_step(ZH, ZL, ch)
    AL = AL + cl
    # r = b - A x; constrained rows are exactly zero (b rows are zero and
    # the iterate keeps x = 0 there)
    RH, RL = _neumaier_step(bh, bl, -AH)
    RL = RL - AL
    zero = jnp.zeros((), xh.dtype)
    RH = jnp.where(con_mask, zero, RH)
    RL = jnp.where(con_mask, zero, RL)
    r32 = (RH + RL).astype(xh.dtype)
    return r32, RH, RL, jnp.vdot(r32, r32)


@jax.jit
def _dd_axpy(xh, xl, d):
    """(xh, xl) += d, exactly (Neumaier)."""
    return _neumaier_step(xh, xl, d)


def solve_refined_device(gmg: StencilGMG, rhs_np, x0=None,
                         rtol: float = 1e-8, maxiter: int = 100,
                         inner_rtol: float = 1e-6, max_passes: int = 4):
    """Iterative refinement with the defect ON DEVICE: no per-pass x/defect
    ships, no host matvecs — one scalar pull per pass plus the final
    solution pair.  Requires assemble_rhs to have produced the double-f32
    rhs pair (gmg._b_dd); the solution accumulates on device as a
    double-f32 pair."""
    import time
    s = gmg._sys_dev
    bh, bl = gmg._b_dd
    nb_ = float(np.linalg.norm(np.asarray(rhs_np, np.float64)))
    tol = rtol * nb_
    if x0 is not None:
        x64 = np.zeros(gmg.n_pad, np.float64)
        x64[: gmg.n] = np.asarray(x0, np.float64)
        xh_np = x64.astype(gmg.np_dtype)
        xh = gmg._put(xh_np)
        xl = gmg._put((x64 - xh_np).astype(gmg.np_dtype))
    else:
        xh = gmg._put(np.zeros(gmg.n_pad, gmg.np_dtype))
        xl = gmg._put(np.zeros(gmg.n_pad, gmg.np_dtype))
    total_k = 0
    res0 = None
    resf = nb_
    for p in range(max_passes + 1):
        t0 = time.time()
        r32, RH, RL, rn2 = _defect_dd(
            bh, bl, xh, xl, s["c2d"], s["d2c"], s["hsc"], gmg._kref_hi,
            gmg._kref_lo, s["con_mask"], s["con_cols_full"],
            s["con_w_full"], s["conT_row"], s["conT_w"])
        rnorm = float(np.sqrt(max(float(rn2), 0.0)))     # one scalar pull
        if gmg._debug:
            print(f"[device_gmg] device defect {time.time() - t0:.2f}s "
                  f"rnorm {rnorm:.3e}", flush=True)
        if res0 is None:
            res0 = rnorm
        resf = rnorm
        if rnorm <= tol or total_k >= maxiter or p == max_passes:
            break
        need = tol / max(rnorm, 1e-300)
        inner = min(max(inner_rtol, 0.3 * need), 0.1)
        d_pad, k, _, _ = gmg.solve(None, None, rtol=inner, maxiter=maxiter,
                                   rhs_dev=r32, rhs_norm=rnorm,
                                   return_dev=True)
        xh, xl = _dd_axpy(xh, xl, d_pad)
        total_k += int(k)
    x64 = (np.asarray(xh, np.float64)
           + np.asarray(xl, np.float64))[: gmg.n]
    return x64, total_k, res0, resf


def solve_refined_matfree(gmg: StencilGMG, rhs, x0=None, rtol: float = 1e-8,
                          maxiter: int = 100, inner_rtol: float = 1e-6,
                          max_passes: int = 4):
    """Mixed-precision iterative refinement around StencilGMG.solve with a
    MATRIX-FREE float64 defect (solver/fused_gmg.py:solve_refined semantics
    without the assembled CSR)."""
    b64 = np.asarray(rhs, np.float64)
    nb = float(np.linalg.norm(b64))
    tol = rtol * nb
    x64 = (np.asarray(x0, np.float64) if x0 is not None
           else np.zeros_like(b64))
    import time
    total_k = 0
    res0 = None
    resf = nb
    for p in range(max_passes + 1):
        t0 = time.time()
        r64 = b64 - gmg.host_matvec64(x64)
        if gmg._debug:
            print(f"[device_gmg] host defect {time.time() - t0:.2f}s",
                  flush=True)
        rnorm = float(np.linalg.norm(r64))
        if res0 is None:
            res0 = rnorm
        resf = rnorm
        if rnorm <= tol or total_k >= maxiter or p == max_passes:
            break
        # NOTE: maxiter is a STATIC arg of the fused executable — pass the
        # same value every pass (passing the shrinking budget recompiled
        # the whole solve per IR pass: ~5 s/pass even with a warm disk
        # cache, measured round 5).  The iteration budget is enforced by
        # the host-side total_k check above.
        # Adaptive inner tolerance: a later pass only needs the REMAINING
        # gain (tol / current defect), not the full f32 floor — the final
        # pass typically converges in 2-3 V-cycles instead of 6.
        need = tol / rnorm
        inner = min(max(inner_rtol, 0.3 * need), 0.1)
        d, k, _, _ = gmg.solve(r64, None, rtol=inner,
                               maxiter=maxiter)
        x64 = x64 + np.asarray(d, np.float64)
        total_k += int(k)
    return x64, total_k, res0, resf
