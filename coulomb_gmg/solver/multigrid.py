"""Geometric multigrid preconditioner with local smoothing.

The JAX re-design of the reference's deal.II multigrid stack
(``src/step-50.cc:954-992``): per-level matrices with refinement-edge and
boundary dofs eliminated (``assemble_multigrid``, src/step-50.cc:835-933),
interface ("edge") matrices carrying the eliminated edge-interior couplings,
prebuilt prolongation embeddings (``MGTransferPrebuilt``), a redundant
coarse CG solve (``MGCoarseGridIterativeSolver``), and the V-cycle of
``Multigrid`` + ``PreconditionMG``.

The cycle implements the Janssen-Kanschat local-smoothing algorithm:

  copy_to:   d_l = residual at dofs of *active* level-l cells,
             zeroed at refinement-edge dofs of level l
  descend l: u_l = Smooth^m(A_l, 0, d_l)
             r_l = d_l - A_l u_l - A_l^if u_l     (edge rows get coupling)
             d_{l-1} += P_l^T r_l
  coarse:    u_0 = CG(A_0, d_0)  to 1e-10
  ascend l:  u_l += P_l u_{l-1}
             d_l -= (A_l^if)^T u_l               (interior feels edge values)
             u_l = Smooth^m(A_l, u_l, d_l)
  copy_from: global[dof] = u_l[dof] from the level where the dof lies on an
             active level-l cell and is not at that level's refinement edge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import jax.numpy as jnp

from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.mesh.dofs import Constraints, DofInfo, LevelDofs
from coulomb_gmg.fem.assembly import (build_plan, assemble, assemble_np,
                                      AssemblyPlan)
from coulomb_gmg.ops.spmv import CSR, csr_matvec, csr_matvec_T
from coulomb_gmg.ops.smoothers import (
    MGSmoother, make_jacobi, make_mc_ssor, make_ssor_host, make_chebyshev,
    lattice_color)
from coulomb_gmg.solver.cg import cg


def level_constraints(ld: LevelDofs) -> Constraints:
    """Homogeneous elimination set: refinement-edge + boundary level dofs
    (deal.II ``boundary_constraints[level]``, src/step-50.cc:853-864)."""
    rows = np.where(ld.interface | ld.boundary)[0].astype(np.int64)
    return Constraints(rows=rows,
                       indptr=np.zeros(len(rows) + 1, dtype=np.int64),
                       cols=np.zeros(0, dtype=np.int64),
                       weights=np.zeros(0), inhomog=np.zeros(len(rows)),
                       n_dofs=ld.n_dofs)


def build_interface_csr(plan: AssemblyPlan, ld: LevelDofs, k_cells,
                        dtype=jnp.float64) -> CSR:
    """Interface ("edge") matrix: raw level assembly masked to entries
    (i at edge, j not at edge, neither at domain boundary) — the keep
    condition of src/step-50.cc:896-920.

    The plan may cover only the subset of level cells that touch the
    refinement edge (all other cells contribute nothing after the mask);
    its pattern still spans the full level dof numbering."""
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64
    data, _ = assemble_np(plan, k_cells, None, dtype=np_dtype)
    rows = plan.pattern.indptr
    rowids = np.repeat(np.arange(plan.pattern.n_rows), np.diff(rows))
    cols = plan.pattern.indices
    keep = (ld.interface[rowids] & ~ld.interface[cols]
            & ~ld.boundary[rowids] & ~ld.boundary[cols])
    data = np.where(keep, data, 0.0)
    return CSR.from_pattern(plan.pattern.indptr, plan.pattern.indices,
                            jnp.asarray(data))


def build_prolongation(forest: Forest, dofs: DofInfo, l: int) -> CSR:
    """P_l: level l-1 -> level l embedding.  Each level-l dof interpolates
    through the parent level-(l-1) cell's Q_p basis (Q1: the trilinear
    2^dim-point stencil; the analogue of
    ``MGTransferPrebuilt::build_matrices``, src/step-50.cc:957-958)."""
    dim = forest.dim
    p = dofs.degree
    ld, lc = dofs.levels[l], dofs.levels[l - 1]
    level_ijk, _ = forest.level_cells[l]
    # parent level cell + child offset per level-l cell
    parent = level_ijk // 2
    child = (level_ijk & 1).astype(np.int64)            # (m, dim)
    # parent level-dof ids of the parent's nodes
    side = forest.side(l - 1)
    par_key = forest.level_cell_key(l - 1, parent)
    pc_ijk, _ = forest.level_cells[l - 1]
    pc_key = forest.level_cell_key(l - 1, pc_ijk)
    order = np.argsort(pc_key)
    ppos = order[np.searchsorted(pc_key[order], par_key)]
    parent_dofs = lc.cell2dof[ppos]                      # (m, (p+1)^dim)

    from coulomb_gmg.mesh.forest import node_offsets
    from coulomb_gmg.ops.q1 import lagrange_nodes_1d, _lagrange_eval
    off = node_offsets(dim, p)
    nb = (p + 1) ** dim
    # 1D parent-basis values at the child-node fractions (c + a/p)/2 for
    # parity c in {0,1} and node digit a in 0..p: val1d[c, a, j]
    nodes1 = lagrange_nodes_1d(p)
    tvals = np.array([[(c + a / p) / 2.0 for a in range(p + 1)]
                      for c in (0, 1)])
    val1d = np.stack([_lagrange_eval(nodes1, tvals[c])[0] for c in (0, 1)])
    rows, cols, vals = [], [], []
    for v in range(nb):
        digits_v = [(v // ((p + 1) ** d)) % (p + 1) for d in range(dim)]
        child_dof = ld.cell2dof[:, v]
        for pv in range(nb):
            digits_p = [(pv // ((p + 1) ** d)) % (p + 1) for d in range(dim)]
            w = np.ones(len(level_ijk))
            for d in range(dim):
                w = w * val1d[child[:, d], digits_v[d], digits_p[d]]
            nz = w != 0.0
            rows.append(child_dof[nz])
            cols.append(parent_dofs[nz, pv])
            vals.append(w[nz])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    # dedupe (each dof interpolated identically from any parent containing it)
    pair = rows * np.int64(lc.n_dofs) + cols
    uniq, first = np.unique(pair, return_index=True)
    rows, cols, vals = rows[first], cols[first], vals[first]
    order = np.lexsort([cols, rows])
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(ld.n_dofs + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(n_rows=ld.n_dofs, n_cols=lc.n_dofs, indptr=indptr,
               indices=cols, rowids=rows, data=jnp.asarray(vals))


@dataclass
class GMGPreconditioner:
    """One V-cycle of local-smoothing GMG, used as a CG preconditioner."""

    matrices: List[CSR]                 # A_l per level
    interfaces: List[Optional[CSR]]     # A_l^if (None at level 0)
    prolongations: List[Optional[CSR]]  # P_l (None at level 0)
    smoothers: List[Optional[MGSmoother]]
    copy_global: List[np.ndarray]       # per level: global dof ids
    copy_level: List[np.ndarray]        # per level: level dof ids
    n_dofs: int
    coarse_tol: float = 1e-10
    coarse_maxiter: int = 1000
    coarse_rtol: float = 0.0      # >0: relative floor (float32 runs)

    def _coarse_solve(self, d0):
        A0 = self.matrices[0]
        tol = self.coarse_tol
        if self.coarse_rtol > 0.0:
            tol = jnp.maximum(tol, self.coarse_rtol * jnp.linalg.norm(d0))
        return cg(A0.matvec, d0, tol=tol, maxiter=self.coarse_maxiter).x

    def __call__(self, g):
        L = len(self.matrices) - 1
        dtype = g.dtype
        # copy_to_mg
        defect = [jnp.zeros(A.n_rows, dtype) for A in self.matrices]
        for l in range(L + 1):
            defect[l] = defect[l].at[self.copy_level[l]].set(
                g[self.copy_global[l]])
        sol = [None] * (L + 1)
        # descend
        for l in range(L, 0, -1):
            A, I = self.matrices[l], self.interfaces[l]
            u = self.smoothers[l].apply(defect[l])
            r = defect[l] - A.matvec(u)
            if I is not None:
                r = r - I.matvec(u)
            P = self.prolongations[l]
            defect[l - 1] = defect[l - 1] + csr_matvec_T(
                P.rowids, P.indices, P.data, r, P.n_cols)
            sol[l] = u
        # coarse
        sol[0] = self._coarse_solve(defect[0])
        # ascend
        for l in range(1, L + 1):
            P = self.prolongations[l]
            u = sol[l] + csr_matvec(P.rowids, P.indices, P.data, sol[l - 1],
                                    P.n_rows)
            I = self.interfaces[l]
            d = defect[l]
            if I is not None:
                d = d - csr_matvec_T(I.rowids, I.indices, I.data, u, I.n_cols)
            u = self.smoothers[l].smooth(u, d)
            sol[l] = u
        # copy_from_mg
        out = jnp.zeros(self.n_dofs, dtype)
        for l in range(L + 1):
            out = out.at[self.copy_global[l]].set(sol[l][self.copy_level[l]])
        return out


def _level_signature(forest: Forest, ld: LevelDofs) -> tuple:
    """Cheap content key for level-operator caching: the level matrix,
    interface matrix, and smoother depend only on the level MESH and its
    constrained sets — not on which level cells are active.  Levels stop
    changing once refinement moves past them, so operators are reused
    across adaptive cycles.

    The hash uses LEVEL-LOCAL node coordinates (finest-lattice coords
    shifted down by max_level - level): raw ``ld.keys`` are linearized on
    the FINEST lattice, whose pitch doubles whenever refinement deepens
    the tree, which used to invalidate every signature — including the
    huge, genuinely-unchanged level-0 operator — on every cycle that
    added a level.  The cached values stay valid across that shift:
    level-dof numbering is key-sorted and the shift is order-preserving."""
    import hashlib
    coords = forest.nkey_to_coords(ld.keys, ld.degree)
    coords = coords >> (forest.max_level - ld.level)
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(coords))
    h.update(np.ascontiguousarray(ld.interface))
    return (ld.level, ld.n_dofs, len(ld.cell2dof), h.hexdigest())


def build_gmg(forest: Forest, dofs: DofInfo, tables, coeff_fn=None,
              smoother: str = "ssor", smoother_damping: float = 0.5,
              smoother_steps: int = 2, coarse_tol: float = 1e-10,
              coarse_maxiter: int = 1000, dtype=jnp.float64,
              jacobi_damping: float = 0.6,
              coarse_rtol: float = 0.0, cache: dict = None) -> GMGPreconditioner:
    """Assemble all levels and wire the V-cycle.

    coeff_fn: points (m, dim) -> coefficient, or None for unit coefficient.
    cache: optional dict carried across adaptive cycles; unchanged levels
    reuse their assembled matrices/smoothers/prolongations.
    """
    from coulomb_gmg.fem.integrals import stiffness_cells
    from coulomb_gmg.ops.density import cell_quad_points

    matrices, interfaces, prolongs, smoothers = [], [], [], []
    copy_global, copy_level = [], []
    kidx_keys = dofs.keys
    sigs = [_level_signature(forest, ld) if cache is not None else None
            for ld in dofs.levels]

    for l, ld in enumerate(dofs.levels):
        level_ijk, active_index = forest.level_cells[l]
        # prolongation couples levels l-1 and l: cache on both signatures
        ck = ("lvl", sigs[l], sigs[l - 1] if l > 0 else None) \
            if cache is not None else None
        if ck is not None and ck in cache:
            A, iface, P, smth = cache[ck]
            matrices.append(A)
            interfaces.append(iface)
            prolongs.append(P)
            smoothers.append(smth)
        else:
            np_dtype = np.float32 if dtype == jnp.float32 else np.float64
            h = forest.h(l) * np.ones(len(level_ijk))
            coeff_q = None
            if coeff_fn is not None:
                lower = forest.lower + forest.h(l) * level_ijk
                pts = (lower[:, None, :]
                       + forest.h(l) * tables.points[None, :, :])
                coeff_q = np.asarray(coeff_fn(jnp.asarray(pts)))
            from coulomb_gmg.fem.integrals import stiffness_cells_np
            k_cells = stiffness_cells_np(tables, h, coeff_q, dtype=np_dtype)

            plan_lvl = build_plan(ld.cell2dof, level_constraints(ld))
            data, _ = assemble_np(plan_lvl, k_cells, None, dtype=np_dtype)
            A = CSR.from_pattern(plan_lvl.pattern.indptr,
                                 plan_lvl.pattern.indices, jnp.asarray(data))
            matrices.append(A)
            if l > 0 and ld.interface.any():
                # only cells touching a refinement-edge dof can contribute
                # surviving (edge-row) entries — restrict the raw assembly
                # to them (the mask of src/step-50.cc:896-920 zeroes
                # everything else anyway).
                sel = ld.interface[ld.cell2dof].any(axis=1)
                plan_raw = build_plan(ld.cell2dof[sel],
                                      _empty_constraints(ld.n_dofs))
                interfaces.append(build_interface_csr(
                    plan_raw, ld, k_cells[sel], dtype=dtype))
            else:
                interfaces.append(None)
            prolongs.append(build_prolongation(forest, dofs, l)
                            if l > 0 else None)

            if l == 0 or smoother == "none":
                # level 0 uses the coarse solver; "none" skips smoother
                # construction entirely (the FusedGMG path builds its own
                # Chebyshev smoothers from the level operators)
                smoothers.append(None)
            else:
                if smoother == "ssor":
                    pre = make_ssor_host(A, smoother_damping)
                elif smoother == "mc_ssor":
                    pre = make_mc_ssor(A, lattice_color(forest, ld),
                                       smoother_damping)
                elif smoother == "chebyshev":
                    pre = make_chebyshev(A)
                else:
                    pre = make_jacobi(A, jacobi_damping)
                smoothers.append(MGSmoother(A=A, precond=pre,
                                            steps=smoother_steps))
            if ck is not None:
                cache[ck] = (matrices[-1], interfaces[-1], prolongs[-1],
                             smoothers[-1])

        # copy indices: dofs on ACTIVE level-l cells, minus refinement edge
        # (depend on the active set — rebuilt every cycle, cheap)
        act = active_index >= 0
        ldofs = np.unique(ld.cell2dof[act])
        ldofs = ldofs[~ld.interface[ldofs]]
        gpos = np.searchsorted(kidx_keys, ld.keys[ldofs])
        copy_global.append(gpos)
        copy_level.append(ldofs)

    return GMGPreconditioner(matrices=matrices, interfaces=interfaces,
                             prolongations=prolongs, smoothers=smoothers,
                             copy_global=copy_global, copy_level=copy_level,
                             n_dofs=dofs.n_dofs, coarse_tol=coarse_tol,
                             coarse_maxiter=coarse_maxiter,
                             coarse_rtol=coarse_rtol)


def _empty_constraints(n: int) -> Constraints:
    return Constraints(rows=np.zeros(0, dtype=np.int64),
                       indptr=np.zeros(1, dtype=np.int64),
                       cols=np.zeros(0, dtype=np.int64),
                       weights=np.zeros(0), inhomog=np.zeros(0), n_dofs=n)
