"""Simulation driver: the pipeline orchestrator.

The equivalent of the reference's ``LaplaceProblem<dim>`` class and
its ``run()`` loop (``src/step-50.cc:104-178, 1464-1573``): per adaptive
cycle — mesh (generate or refine+transfer) -> setup (constraints, locality
index, densities, moments) -> assemble -> assemble multigrid -> GMG/Jacobi
CG solve -> error estimation + marking -> postprocess energies and
energy-norm error — with the reference's exact log-line schema.

Topology work (mesh, DoFs, constraint resolution, scatter plans) runs on
host; all numerics (density, element integrals, scatter, CG + V-cycle)
run through JAX and are device-agnostic (CPU float64 for parity, GPU
float32 for speed).
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from coulomb_gmg.config import Config
from coulomb_gmg.io.lammps import AtomData, read_lammps_file, empty_atom_data
from coulomb_gmg.mesh.forest import Forest
from coulomb_gmg.fem.constraints import build_constraints, distribute, set_zero
from coulomb_gmg.fem.assembly import build_plan, assemble, assemble_np
from coulomb_gmg.fem.integrals import stiffness_cells, rhs_cells
from coulomb_gmg.ops.q1 import element_tables
from coulomb_gmg.ops.density import (
    atom_masks, compute_density, cell_quad_points)
from coulomb_gmg.ops.spmv import CSR
from coulomb_gmg.ops.smoothers import make_jacobi
from coulomb_gmg.solver.cg import cg
from coulomb_gmg.solver.multigrid import build_gmg
from coulomb_gmg.adapt.estimator import estimate, mark_cells
from coulomb_gmg.adapt.transfer import transfer_solution, transfer_cell_mask
from coulomb_gmg.postprocess.energy import (
    electrostatic_energy, energy_norm_error)
from coulomb_gmg.models import problems as P
from coulomb_gmg.models.problems import compute_dipole_moment
from coulomb_gmg.utils.logging import Pcout, sci10, fix10
from coulomb_gmg.utils.timer import TimerOutput


class Simulation:
    """One full adaptive simulation (the reference's LaplaceProblem)."""

    def __init__(self, cfg: Config, atoms: AtomData = None, pcout=None):
        self.cfg = cfg
        self.pcout = pcout or Pcout()
        self.timer = TimerOutput()
        self.results = []          # per-cycle metric dicts

        self.pcout(f"Problem type is:   {cfg.problem}")
        self.pcout(f"Preconditioner :    {cfg.preconditioner}")
        self.pcout("Rhs assembly optimization ENABLED" if cfg.flag_rhs_assembly
                   else "Without rhs assembly optimization")

        if atoms is not None:
            self.atoms = atoms
        else:
            with self.timer.scope("Read LAMMPS input file"):
                self.atoms = read_lammps_file(cfg.lammps_file, cfg.dim)
            if cfg.dim != 3:
                self.pcout("\nReading of Lammps input file implemented for "
                           "3D only\n")
            elif not self.atoms.has_atoms:
                self.pcout("Unable to open the file.")
        self.lammpsinput = self.atoms.has_atoms
        if self.lammpsinput:
            self.pcout(f"Number of atoms: {self.atoms.n}")

        self.forest: Forest = None
        self.solution: np.ndarray = None
        self.mask = None           # (cells, atoms) locality mask (small N)
        self.lists = None          # (cells, K) padded atom lists (large N)
        self.error_per_cell = None
        self.tab_lap = element_tables(cfg.dim, cfg.degree, cfg.degree + 1)
        self.tab_rhs = element_tables(cfg.dim, cfg.degree,
                                      cfg.degree + cfg.quadrature_degree_rhs)
        self.dipole = np.zeros(cfg.dim)
        self.dtype = (jnp.float64 if cfg.dtype == "float64"
                      and jax.config.jax_enable_x64 else jnp.float32)

        # device placement: the GPU when JAX's default backend is one
        # (utils/platform.py:select_device), else everything on the CPU.
        from coulomb_gmg.utils.platform import select_device
        self.device = select_device()
        if self.device is not None:
            # Pin the DEFAULT device to the host CPU: per-cycle
            # topology-shaped jnp work (assembly, estimator, FE error) has
            # fresh shapes every cycle and would compile every cycle on
            # the GPU.  Shape-stable (bucketed) jitted kernels opt in
            # explicitly via device=self.device.  Whether the GPU should
            # take that work anyway is an open measurement (ROADMAP).
            jax.config.update("jax_default_device", jax.devices("cpu")[0])
        self.use_bucketed = (cfg.solver_backend == "bucketed_cg" or
                             (cfg.solver_backend == "auto" and
                              self.device is not None and
                              self.dtype == jnp.float32))

        # multi-device SPMD: the production domain-decomposition path
        # (parallel/spmd.py) — sharded density/assembly/FE-error over SFC
        # cell blocks, ShardedGMG (or sharded Jacobi-CG) solve.
        self.spmd = None
        if cfg.n_devices > 1:
            from coulomb_gmg.parallel.spmd import SpmdContext
            self.spmd = SpmdContext(cfg.n_devices)
            self.use_bucketed = False
            self.device = None

    # ------------------------------------------------------------ meshing

    def make_initial_mesh(self) -> Forest:
        cfg = self.cfg
        if cfg.problem == "Step16":
            # hyper_cube + refine_global (src/step-50.cc:1496-1497)
            return Forest.hyper_cube(cfg.dim, cfg.domain_left,
                                     cfg.domain_right,
                                     cfg.n_global_refinements)
        # GaussianCharges: subdivided rectangle with vacuum margin
        # (src/step-50.cc:1504-1526)
        a = 2.0 * cfg.mesh_size_h
        N = (cfg.domain_right - cfg.domain_left) / a
        M = cfg.vacuum_repetitions
        reps = int(round(2 * (N + 2 * M)))
        lower = np.full(cfg.dim, cfg.domain_left - M * a)
        return Forest.uniform(cfg.dim, reps, lower, cfg.mesh_size_h)

    # -------------------------------------------------------------- setup

    def coeff_fn(self):
        if self.cfg.problem == "Step16":
            return P.step16_coefficient
        return None    # GaussianCharges: unit coefficient

    def boundary_fn(self):
        cfg = self.cfg
        if cfg.boundary_conditions == "Homogeneous":
            return None
        if cfg.boundary_conditions == "Inhomogeneous":
            dip = self.dipole
            Q = getattr(self, "quadrupole", None)
            if Q is None:
                Q = np.zeros((cfg.dim, cfg.dim))
            return lambda pts: np.asarray(P.nonzero_dbc(
                jnp.asarray(pts), np.zeros(cfg.dim), dip, Q))
        # Exact
        if cfg.problem != "GaussianCharges":
            raise ValueError("Exact BC requires GaussianCharges")
        pos, q = self.atoms.positions, self.atoms.charges
        return lambda pts: np.asarray(P.analytic_solution(
            jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(q), cfg.r_c))

    def rho_host(self) -> np.ndarray:
        """(n_cells, n_q) numpy density — pulls and trims the bucket
        padding if the density is device-resident (tile path under
        device-operator mode)."""
        rho = self.rho
        if isinstance(rho, np.ndarray):
            return rho
        return np.asarray(rho)[: self.forest.n_cells]

    def device_ops_active(self) -> bool:
        """Device-resident operator mode (solver/device_gmg.py): level
        operators built on device from topology, matrix-free system
        matvec, device RHS assembly — no host CSR assembly at all.
        Eligibility mirrors what the stencil form can express (the
        production configuration: src/step-50.cc:835-933 assembles exactly
        this operator)."""
        cfg = self.cfg
        eligible = (cfg.problem == "GaussianCharges" and cfg.degree == 1
                    and cfg.preconditioner == "GMG" and self.spmd is None
                    and self.use_bucketed and self.coeff_fn() is None)
        if cfg.device_operators == "off":
            return False
        if cfg.device_operators == "on":
            return eligible
        return (eligible and self.device is not None
                and self.dtype == jnp.float32)

    def setup(self, cycle: int):
        cfg = self.cfg
        f = self.forest
        with self.timer.scope("Setup system"):
            dofs = f.dofs_of(cfg.degree)
        # workload-based placement: a device stage pays a compile per
        # fresh shape and a transfer, so only large cell x atom
        # interactions go there; small ones run on the host CPU backend.
        # HOT_WORK (pair evaluations) is not measured on the H100 (ROADMAP
        # Queue 3, item 5); the 64k production run exceeds it.
        HOT_WORK = 2e9
        n_atoms = self.atoms.n if self.lammpsinput else 0

        def hot_device(work, floor=HOT_WORK):
            # placement is independent of the SOLVER backend: any run with
            # the GPU visible offloads big pair stages in f32.  x64 runs
            # stay host-resident: float64 on the device is its own
            # change (ROADMAP Queue 2, item 2).
            if (self.device is not None and work >= floor
                    and not jax.config.jax_enable_x64):
                return self.device
            return None

        # large atom counts use O(N) spatial-hash neighbor LISTS (the
        # reference's dominant cost recast, ops/neighbors.py); small counts
        # keep the dense (cells, atoms) mask (simpler, supports the
        # per-atom VTU support fields).
        use_lists = n_atoms > 64
        if self.lammpsinput:
            if cfg.flag_rhs_assembly and use_lists and self.lists is None:
                with self.timer.scope("RHS assembly optimization"):
                    from coulomb_gmg.ops.neighbors import atom_lists
                    self.lists, _ = atom_lists(
                        f, self.atoms.positions,
                        cfg.nonzero_radius * cfg.r_c)
            if cfg.flag_rhs_assembly and not use_lists and self.mask is None:
                with self.timer.scope("RHS assembly optimization"):
                    work = f.n_cells * (2 ** cfg.dim) * n_atoms
                    self.mask = atom_masks(f, self.atoms.positions,
                                           cfg.nonzero_radius * cfg.r_c,
                                           device=hot_device(work))
            with self.timer.scope("Compute charge densities"):
                eff_atoms = (self.lists.shape[1] if self.lists is not None
                             and cfg.flag_rhs_assembly else n_atoms)
                work = f.n_cells * len(self.tab_rhs.points) * eff_atoms
                # the padded-list density is gather-bound (per pair ~16 B
                # of list/position data for ~6 flops); on the device it
                # runs as dense tiles instead (below), so the list path
                # stays on the host.
                if self.lists is not None and cfg.flag_rhs_assembly:
                    work = 0.0
                # brute-force (no locality) density: all pairs; the 1e8
                # floor is not measured on the H100 (ROADMAP Queue 3,
                # item 5)
                brute = not cfg.flag_rhs_assembly or (
                    self.lists is None and self.mask is None)
                dens_dev = hot_device(work, floor=1e8 if brute
                                      else HOT_WORK)
                # locality density as dense tiles over bucket-sorted atom
                # slices (ops/tile_density.py) on the device, when the GPU
                # is visible and the stage is big enough
                tile_work = (f.n_cells * len(self.tab_rhs.points)
                             * (self.lists.shape[1] if self.lists is not None
                                else n_atoms))
                use_tiles = (cfg.density_tiles and self.spmd is None
                             and not brute and self.lists is not None
                             and hot_device(tile_work,
                                            floor=cfg.density_tiles_min_work)
                             is not None)
                if use_tiles:
                    from coulomb_gmg.ops.tile_density import (
                        density_locality_tiles)
                    # device-operator mode consumes rho ON DEVICE in the
                    # RHS assembly — skip the (cells x q) pull entirely
                    keep_dev = self.device_ops_active()
                    self.rho = density_locality_tiles(
                        f, self.tab_rhs.points, self.atoms.positions,
                        self.atoms.charges, cfg.r_c,
                        cfg.nonzero_radius * cfg.r_c,
                        device=self.device,
                        return_device=keep_dev)
                elif self.spmd is not None:
                    # SPMD path: the tile density sharded by cell-block
                    # owner (bit-identical to single-device tiles) when
                    # the run is f32 with locality lists; otherwise the
                    # separable/masked kernels per block.
                    if (cfg.density_tiles and not brute
                            and self.lists is not None
                            and cfg.flag_rhs_assembly
                            and self.dtype == jnp.float32):
                        self.rho = self.spmd.density_tiles(
                            f, self.tab_rhs.points, self.atoms.positions,
                            self.atoms.charges, cfg.r_c,
                            cfg.nonzero_radius * cfg.r_c)
                    else:
                        self.rho = self.spmd.density(
                            f, self.tab_rhs.points, self.atoms.positions,
                            self.atoms.charges, cfg.r_c,
                            mask=self.mask if cfg.flag_rhs_assembly else None,
                            lists=self.lists if cfg.flag_rhs_assembly
                            else None,
                            dtype=np.float32 if self.dtype == jnp.float32
                            else np.float64)
                else:
                    self.rho = compute_density(
                        f, self.tab_rhs.points, self.atoms.positions,
                        self.atoms.charges, cfg.r_c,
                        mask=self.mask if cfg.flag_rhs_assembly else None,
                        lists=self.lists if cfg.flag_rhs_assembly else None,
                        dtype=np.float32 if (self.use_bucketed or
                                             dens_dev is not None)
                        else None,
                        device=dens_dev)
            with self.timer.scope("Compute dipole moments"):
                self.dipole = compute_dipole_moment(self.atoms.positions,
                                                    self.atoms.charges)
                # quadrupole: the reference integrates it by quadrature and
                # then explicitly zeroes it (src/step-50.cc:595-624), so its
                # Inhomogeneous BCs are dipole-only in practice.  Default off
                # reproduces that (zero quadrupole); enabling the flag keeps
                # the integral and feeds it to the multipole BC expansion.
                if cfg.flag_compute_quadrupole:
                    self.quadrupole = P.quadrupole_from_forest(
                        f, self.tab_rhs.points, self.tab_rhs.weights,
                        self.rho_host())
                else:
                    self.quadrupole = np.zeros((cfg.dim, cfg.dim))
        else:
            # analytic RHS path (lammpsinput == 0)
            pts = cell_quad_points(f, self.tab_rhs.points)
            if cfg.problem == "Step16":
                self.rho = np.asarray(P.step16_rhs(jnp.asarray(pts)))
            else:
                self.rho = np.asarray(P.gaussian_rhs(jnp.asarray(pts),
                                                     cfg.r_c))
        with self.timer.scope("Setup system"):
            self.constraints = build_constraints(dofs, self.boundary_fn())
            if self.device_ops_active():
                # no CSR is ever assembled: the sparsity pattern + scatter
                # plan (the bulk of this stage at production scale) are
                # not needed — operators are stencil-built on device
                self.plan = None
            else:
                self.plan = build_plan(dofs.cell2dof, self.constraints)

    # ----------------------------------------------------------- assembly

    def assemble_system(self):
        cfg = self.cfg
        f = self.forest
        if self.device_ops_active():
            # device-resident operators: StencilGMG owns the (device) system
            # operands; build it here (charged to the MG-assembly stage,
            # its host-assembly analogue) and assemble the RHS on device
            # from the resident density.  The matrix is never assembled.
            from coulomb_gmg.solver.device_gmg import StencilGMG
            with self.timer.scope("Assemble Multigrid"):
                if not hasattr(self, "_stencil_cache"):
                    self._stencil_cache = {}
                self._stencil_gmg = StencilGMG(
                    f, f.dofs_of(cfg.degree), self.constraints,
                    device=self.device, dtype=self.dtype,
                    use_dst=True, coarse_maxiter=cfg.coarse_max_iters,
                    coarse_rtol=cfg.coarse_rtol,
                    host_cache=self._stencil_cache)
            with self.timer.scope("Assemble system"):
                self.rhs, self.rhs_dev = self._stencil_gmg.assemble_rhs(
                    self.rho, self.tab_rhs)
                self.A = None
            return
        with self.timer.scope("Assemble system"):
            np_dtype = np.float32 if self.dtype == jnp.float32 else np.float64
            h = f.cell_h()
            coeff_fn = self.coeff_fn()
            coeff_q = None
            if coeff_fn is not None:
                pts = cell_quad_points(f, self.tab_lap.points)
                coeff_q = np.asarray(coeff_fn(jnp.asarray(pts)))
            if self.spmd is not None:
                # distributed assembly: per-device element tensors +
                # psum compress (parallel/spmd.py:build_assembler)
                asm = self.spmd.build_assembler(
                    self.plan, self.tab_lap, self.tab_rhs,
                    has_coeff=coeff_fn is not None, np_dtype=np_dtype)
                data, rhs = asm(h, coeff_q, self.rho_host())
            else:
                # host numpy path: per-cycle topology shapes are fresh every
                # cycle, so eager XLA would pay a compile per primitive per
                # cycle; see fem/assembly.py:assemble_np.
                from coulomb_gmg.fem.integrals import (stiffness_cells_np,
                                                       rhs_cells_np)
                K = stiffness_cells_np(self.tab_lap, h, coeff_q,
                                       dtype=np_dtype)
                Fv = rhs_cells_np(self.tab_rhs, h, self.rho_host(),
                                  dtype=np_dtype)
                data, rhs = assemble_np(self.plan, K, Fv, dtype=np_dtype)
            self.A = CSR.from_pattern(self.plan.pattern.indptr,
                                      self.plan.pattern.indices,
                                      jnp.asarray(data))
            self.rhs = rhs

    def assemble_multigrid(self):
        cfg = self.cfg
        if self.device_ops_active():
            return          # StencilGMG was built with the system
        if not hasattr(self, "_gmg_cache"):
            self._gmg_cache = {}
        with self.timer.scope("Assemble Multigrid"):
            # the FusedGMG/ShardedGMG solve paths build their own (Chebyshev)
            # smoothers from the level operators — skip host smoothers
            smoother = ("none" if self.use_bucketed or self.spmd is not None
                        else cfg.smoother)
            self.gmg = build_gmg(
                self.forest, self.forest.dofs_of(cfg.degree), self.tab_lap,
                coeff_fn=self.coeff_fn(), smoother=smoother,
                smoother_damping=cfg.smoother_damping,
                smoother_steps=cfg.smoother_steps,
                coarse_tol=cfg.coarse_tol,
                coarse_maxiter=cfg.coarse_max_iters, dtype=self.dtype,
                coarse_rtol=cfg.coarse_rtol, cache=self._gmg_cache)

    # -------------------------------------------------------------- solve

    def solve(self):
        cfg = self.cfg
        pc = self.pcout
        with self.timer.scope("Solve"):
            rhs = self.rhs
            rhs_np = np.asarray(rhs)
            pc("   L1 rhs norm " + sci10(np.abs(rhs_np).sum()))
            pc("   L2 rhs norm " + sci10(np.linalg.norm(rhs_np)))
            pc("   LInfinity rhs norm " + sci10(np.abs(rhs_np).max()))
            if self.device_ops_active():
                # matrix-free: no assembled CSR, so the matrix-norm lines
                # of the reference log (printed by the f64 parity path)
                # are unavailable here
                from coulomb_gmg.solver.device_gmg import (
                    solve_refined_matfree)
                g = self._stencil_gmg
                x0_np = None
                if self.solution is not None and \
                        len(self.solution) == g.n:
                    x0_np = self.solution
                if self.dtype == jnp.float32 and cfg.cg_rtol < 5e-7:
                    # f32 recurrence floor ~6e-7: mixed-precision IR.
                    # With the double-f32 rhs pair resident (device RHS
                    # assembly ran), the defect runs ON DEVICE — no
                    # per-pass ships or host matvecs.
                    if getattr(g, "_b_dd", None) is not None:
                        from coulomb_gmg.solver.device_gmg import (
                            solve_refined_device)
                        x, k, res0, resf = solve_refined_device(
                            g, rhs_np, x0_np, rtol=cfg.cg_rtol,
                            maxiter=cfg.cg_max_iters)
                    else:
                        x, k, res0, resf = solve_refined_matfree(
                            g, rhs_np, x0_np, rtol=cfg.cg_rtol,
                            maxiter=cfg.cg_max_iters)
                else:
                    x, k, res0, resf = g.solve(
                        rhs_np, x0_np, rtol=cfg.cg_rtol,
                        maxiter=cfg.cg_max_iters,
                        rhs_dev=getattr(self, "rhs_dev", None))
                pc("   Starting value " + fix10(res0))
                pc(f"   CG converged in {k} iterations.")
                pc("   Convergence value " + sci10(resf))
                pc("   L1 solution norm " + sci10(np.abs(x).sum()))
                pc("   L2 solution norm " + sci10(np.linalg.norm(x)))
                pc("   LInfinity solution norm " + sci10(np.abs(x).max()))
                self.solution = distribute(self.constraints, x)
                self.cg_iterations = int(k)
                self.cg_start = float(res0)
                self.norms = {
                    "l1_rhs": float(np.abs(rhs_np).sum()),
                    "l2_rhs": float(np.linalg.norm(rhs_np)),
                    "linf_rhs": float(np.abs(rhs_np).max()),
                    "l1_mat": None, "linf_mat": None, "fro_mat": None,
                    "l1_sol": float(np.abs(x).sum()),
                    "l2_sol": float(np.linalg.norm(x)),
                    "linf_sol": float(np.abs(x).max()),
                }
                return
            data = np.asarray(self.A.data)
            indptr, indices = self.plan.pattern.indptr, self.plan.pattern.indices
            rowsum = np.add.reduceat(np.abs(data), indptr[:-1])
            colsum = np.zeros(self.A.n_rows)
            np.add.at(colsum, indices, np.abs(data))
            pc("   L1 Matrix norm " + sci10(colsum.max()))
            pc("   LInfinity Matrix norm " + sci10(rowsum.max()))
            pc("   Frobenius Matrix norm " + sci10(np.sqrt((data ** 2).sum())))

            tol = cfg.cg_rtol * float(np.linalg.norm(rhs_np))
            x0 = None
            if self.solution is not None and len(self.solution) == self.A.n_rows:
                x0 = jnp.asarray(self.solution, dtype=self.dtype)
            if self.spmd is not None:
                x0_np = None
                if self.solution is not None and \
                        len(self.solution) == self.A.n_rows:
                    x0_np = self.solution
                if cfg.preconditioner == "GMG":
                    # SPMD GMG-CG: every level row-partitioned over the
                    # device mesh, redundant coarse solve, psum dots
                    # (parallel/sharded_gmg.py; src/step-50.cc:722-731,
                    # 938-992)
                    from coulomb_gmg.parallel.sharded_gmg import ShardedGMG
                    sg = ShardedGMG(self.gmg, self.A, self.spmd.mesh,
                                    dtype=self.dtype,
                                    maxiter=cfg.cg_max_iters)
                    x, k, res0, resf = sg.solve(rhs_np, x0_np,
                                                rtol=cfg.cg_rtol)
                else:
                    # SPMD Jacobi-CG (src/step-50.cc:996-1005)
                    from coulomb_gmg.parallel.sharded import (
                        ShardedCSR, sharded_diag, make_sharded_solver,
                        shard_vector, put_blocks)
                    np_dtype = (np.float32 if self.dtype == jnp.float32
                                else np.float64)
                    As = ShardedCSR.from_coo(
                        self.A.rowids, np.asarray(self.A.indices),
                        np.asarray(self.A.data, np_dtype),
                        self.A.n_rows, self.spmd.D)
                    diag = sharded_diag(As, self.spmd.D)
                    solver = make_sharded_solver(
                        self.spmd.mesh, As, jnp.asarray(diag),
                        tol_rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters * 10,
                        damping=cfg.jacobi_damping)
                    rhs_b = put_blocks(shard_vector(
                        np.asarray(rhs_np, np_dtype), self.spmd.D),
                        self.spmd.mesh)
                    x0_b = (put_blocks(shard_vector(
                        np.asarray(x0_np, np_dtype), self.spmd.D),
                        self.spmd.mesh)
                        if x0_np is not None else jnp.zeros_like(rhs_b))
                    xb, k, res0, resf = solver(rhs_b, x0_b)
                    x = np.asarray(xb).reshape(-1)[: self.A.n_rows]
                    k, res0, resf = int(k), float(res0), float(resf)
                pc("   Starting value " + fix10(res0))
                pc(f"   CG converged in {k} iterations.")
                pc("   Convergence value " + sci10(resf))
                pc("   L1 solution norm " + sci10(np.abs(x).sum()))
                pc("   L2 solution norm " + sci10(np.linalg.norm(x)))
                pc("   LInfinity solution norm " + sci10(np.abs(x).max()))
                self.solution = distribute(self.constraints, x)
                self.cg_iterations = int(k)
                self.cg_start = float(res0)
                self.norms = {
                    "l1_rhs": float(np.abs(rhs_np).sum()),
                    "l2_rhs": float(np.linalg.norm(rhs_np)),
                    "linf_rhs": float(np.abs(rhs_np).max()),
                    "l1_mat": float(colsum.max()),
                    "linf_mat": float(rowsum.max()),
                    "fro_mat": float(np.sqrt((data ** 2).sum())),
                    "l1_sol": float(np.abs(x).sum()),
                    "l2_sol": float(np.linalg.norm(x)),
                    "linf_sol": float(np.abs(x).max()),
                }
                return
            if self.use_bucketed:
                x0_np = None
                if self.solution is not None and \
                        len(self.solution) == self.A.n_rows:
                    x0_np = self.solution
                if cfg.preconditioner == "GMG":
                    from coulomb_gmg.solver.fused_gmg import FusedGMG
                    if not hasattr(self, "_fused_host_cache"):
                        self._fused_host_cache = {}
                    # below solve_device_min_dofs the level-operator
                    # transfer outweighs the device solve (not measured on
                    # the H100: ROADMAP Queue 3, item 5)
                    solve_dev = (self.device
                                 if self.A.n_rows >= cfg.solve_device_min_dofs
                                 else None)
                    gmg_dev = FusedGMG(
                        self.gmg, self.A, self.forest,
                        device=solve_dev, dtype=self.dtype,
                        use_dst=(cfg.problem == "GaussianCharges"
                                 and cfg.degree == 1),
                        host_cache=self._fused_host_cache,
                        prev=getattr(self, "_fused_gmg_prev", None))
                    # keep for next cycle's system-ELL delta ship
                    self._fused_gmg_prev = gmg_dev
                    if self.dtype == jnp.float32 and cfg.cg_rtol < 5e-7:
                        # an f32 CG recurrence saturates at a TRUE relative
                        # residual of ~6e-7; tolerances below that (the
                        # reference's 1e-8, src/step-50.cc:942) run
                        # mixed-precision iterative refinement: float64
                        # defect on host, f32 GMG-CG correction on device
                        from coulomb_gmg.solver.fused_gmg import \
                            solve_refined
                        x, k, res0, resf = solve_refined(
                            gmg_dev, self.plan.pattern.indptr,
                            self.plan.pattern.indices,
                            np.asarray(self.A.data), rhs_np, x0_np,
                            rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters,
                            fused=None if cfg.solve_fused else False)
                    else:
                        x, k, res0, resf = gmg_dev.solve(
                            rhs_np, x0_np, rtol=cfg.cg_rtol,
                            maxiter=cfg.cg_max_iters,
                            fused=None if cfg.solve_fused else False)
                else:
                    from coulomb_gmg.solver.bucketed_cg import bucketed_cg_solve
                    x, k, res0, resf = bucketed_cg_solve(
                        self.A.rowids, self.plan.pattern.indices,
                        np.asarray(self.A.data), rhs_np, x0_np,
                        rtol=cfg.cg_rtol, maxiter=cfg.cg_max_iters * 10,
                        device=self.device, dtype=self.dtype)
                pc("   Starting value " + fix10(res0))
                pc(f"   CG converged in {k} iterations.")
                pc("   Convergence value " + sci10(resf))
                pc("   L1 solution norm " + sci10(np.abs(x).sum()))
                pc("   L2 solution norm " + sci10(np.linalg.norm(x)))
                pc("   LInfinity solution norm " + sci10(np.abs(x).max()))
                self.solution = distribute(self.constraints, x)
                self.cg_iterations = k
                self.cg_start = res0
                self.norms = {
                    "l1_rhs": float(np.abs(rhs_np).sum()),
                    "l2_rhs": float(np.linalg.norm(rhs_np)),
                    "linf_rhs": float(np.abs(rhs_np).max()),
                    "l1_mat": float(colsum.max()),
                    "linf_mat": float(rowsum.max()),
                    "fro_mat": float(np.sqrt((data ** 2).sum())),
                    "l1_sol": float(np.abs(x).sum()),
                    "l2_sol": float(np.linalg.norm(x)),
                    "linf_sol": float(np.abs(x).max()),
                }
                return
            if cfg.preconditioner == "GMG":
                precond = self.gmg
                host = cfg.smoother == "ssor"
                if not host:
                    # jit the whole V-cycle once per topology; the outer CG
                    # runs host-side (few iterations, cheap dispatches)
                    gmg = self.gmg
                    precond = jax.jit(lambda g: gmg(g))
                    host = True
            else:
                precond = make_jacobi(self.A, cfg.jacobi_damping)
                host = False
            # pass the sparse structure as ARGUMENTS: jitting the bound
            # method closes over 44.8M-entry index arrays as constants at
            # 64k atoms, and XLA constant-folds them for seconds per cycle
            from coulomb_gmg.ops.spmv import csr_matvec
            _mv = jax.jit(csr_matvec, static_argnums=(4,))
            rowids_j = jnp.asarray(self.A.rowids)
            indices_j = jnp.asarray(self.A.indices)
            matvec = lambda x: _mv(rowids_j, indices_j, self.A.data, x,
                                   self.A.n_rows)
            res = cg(matvec, jnp.asarray(rhs, dtype=self.dtype),
                     x0=x0, precond=precond, tol=tol,
                     maxiter=cfg.cg_max_iters, host=host)
            x = np.asarray(res.x)
            pc("   Starting value " + fix10(float(res.initial_residual)))
            pc(f"   CG converged in {int(res.iterations)} iterations.")
            pc("   Convergence value " + sci10(float(res.final_residual)))
            pc("   L1 solution norm " + sci10(np.abs(x).sum()))
            pc("   L2 solution norm " + sci10(np.linalg.norm(x)))
            pc("   LInfinity solution norm " + sci10(np.abs(x).max()))
            self.solution = distribute(self.constraints, x)
            self.cg_iterations = int(res.iterations)
            self.cg_start = float(res.initial_residual)
            self.norms = {
                "l1_rhs": float(np.abs(rhs_np).sum()),
                "l2_rhs": float(np.linalg.norm(rhs_np)),
                "linf_rhs": float(np.abs(rhs_np).max()),
                "l1_mat": float(colsum.max()),
                "linf_mat": float(rowsum.max()),
                "fro_mat": float(np.sqrt((data ** 2).sum())),
                "l1_sol": float(np.abs(x).sum()),
                "l2_sol": float(np.linalg.norm(x)),
                "linf_sol": float(np.abs(x).max()),
            }

    # --------------------------------------------------------- adaptivity

    def estimate_and_mark(self):
        cfg = self.cfg
        with self.timer.scope("Estimate error and mark cells"):
            # plain-Kelly marking (the production configuration) never
            # reads the density — and in device-operator mode self.rho
            # may be device-resident and must not be pulled; the volume
            # term (both atom and analytic paths) uses the host view.
            rho_q = (self.rho_host() if cfg.estimator_volume_term else None)
            # numpy throughout: estimate() is host code, and jnp.asarray
            # under an accelerator backend would round-trip these arrays
            # through the device
            # face plan: built once at cycle 0, then updated INCREMENTALLY
            # across refinements (refine() below) — only faces touching
            # new cells are rediscovered (adapt/estimator.py:update_face_plan)
            if getattr(self, "_face_plan", None) is None:
                from coulomb_gmg.adapt.estimator import build_face_plan
                self._face_plan = build_face_plan(self.forest)
            if (self.spmd is not None and not cfg.estimator_volume_term
                    and cfg.degree == 1):
                # Kelly face jumps sharded over the device mesh
                # (parallel/spmd.py:estimate; src/step-50.cc:1020-1090)
                err = self.spmd.estimate(
                    self.forest, self.forest.dofs_of(cfg.degree).cell2dof,
                    np.asarray(self.solution), plan=self._face_plan)
            else:
                err = estimate(
                    self.forest, self.forest.dofs_of(cfg.degree).cell2dof,
                    np.asarray(self.solution),
                    np.asarray(rho_q) if rho_q is not None else None,
                    self.tab_rhs.points, self.tab_rhs.weights,
                    degree=cfg.degree,
                    use_volume_term=cfg.estimator_volume_term,
                    plan=self._face_plan)
            self.error_per_cell = err
            self.flags, thr = mark_cells(err, cfg.refine_fraction_of_max)
        self.pcout("Threshold value for refinement:\t" + sci10(thr))
        self.threshold = thr

    def refine(self, cycle: int):
        cfg = self.cfg
        with self.timer.scope(
                "Refine, solution transfer and sending atoms list to child cells"):
            old = self.forest
            new = old.refine(self.flags)
            # the old->new covering map is shared by every transfer below
            # (building it costs per-level key sorts over all new cells)
            from coulomb_gmg.adapt.transfer import old_cell_of_new
            omap = old_cell_of_new(old, new)
            if self.lammpsinput and cfg.flag_rhs_assembly:
                if self.mask is not None:
                    self.mask = transfer_cell_mask(old, new, self.mask,
                                                   omap=omap)
                if self.lists is not None:
                    # children inherit the parent's padded atom list — the
                    # p4est attach/unpack semantics (src/step-50.cc:441-456)
                    self.lists = transfer_cell_mask(old, new, self.lists,
                                                    omap=omap)
            u_new = transfer_solution(old, new, self.solution,
                                      degree=cfg.degree, omap=omap)
            if getattr(self, "_face_plan", None) is not None:
                from coulomb_gmg.adapt.estimator import update_face_plan
                self._face_plan = update_face_plan(old, new,
                                                   self._face_plan, omap)
            self.forest = new
            self.solution = u_new
        self.setup(cycle)
        self.solution = set_zero(self.constraints, self.solution)

    # ------------------------------------------------------- postprocess

    def postprocess_energy(self):
        with self.timer.scope("Postprocess electrostatic energy"):
            if self.spmd is not None:
                # shard-ownership point-evaluation dedup
                # (src/step-50.cc:1334-1398)
                from coulomb_gmg.parallel.spmd import (
                    electrostatic_energy_spmd)
                e = electrostatic_energy_spmd(
                    self.spmd, self.forest, self.solution,
                    self.atoms.positions, self.atoms.charges, self.cfg.r_c,
                    degree=self.cfg.degree)
            else:
                e = electrostatic_energy(
                    self.forest, self.solution, self.atoms.positions,
                    self.atoms.charges, self.cfg.r_c, degree=self.cfg.degree)
        pc = self.pcout
        pc("\nTotal analytical electrostatic energy :   " + sci10(e["analytic"]))
        pc("Short-ranged energy contribution :  " + sci10(e["short_range"]))
        pc("FE solution long-ranged energy contribution :    "
           + sci10(e["fe_long_range"]))
        pc("Self energy contribution : " + sci10(e["self_energy"]))
        pc("Total electrostatic energy with split in short- and long-ranged : "
           + sci10(e["total_split"]))
        pc("Absolute Error between both energies :\t" + sci10(e["abs_error"])
           + "\n")
        pc("Relative Error in total electrostatic energy :\t"
           + sci10(e["rel_error"]))
        return e

    def postprocess_energy_norm(self):
        if self.cfg.problem != "GaussianCharges" or not self.lammpsinput:
            return None
        if not self.cfg.flag_postprocess_error:
            return None
        with self.timer.scope("Postprocess FE error"):
            work = self.forest.n_cells * len(self.tab_lap.points) * \
                self.atoms.n
            # placement independent of the solver backend (see hot_device):
            # any run with the GPU visible offloads this pair stage in f32.
            # x64 runs stay on the host: float64 on the device is its own
            # change (ROADMAP Queue 2, item 2).  The 2e9 floor is not
            # measured on the H100 (ROADMAP Queue 3, item 5).
            dev = (self.device
                   if work >= 2e9 and not jax.config.jax_enable_x64
                   else None)
            # float32 pair sums on float32 runs; float64 parity runs keep
            # full precision
            f32 = dev is not None or self.dtype == jnp.float32
            if self.spmd is not None:
                err = self.spmd.energy_norm_error(
                    self.forest, self.tab_lap, self.solution,
                    self.atoms.positions, self.atoms.charges, self.cfg.r_c,
                    dtype=np.float32 if f32 else None)
            else:
                err = energy_norm_error(
                    self.forest, self.tab_lap, self.solution,
                    self.atoms.positions, self.atoms.charges,
                    self.cfg.r_c, device=dev,
                    dtype=np.float32 if f32 else None)
        self.pcout("Error in FE solution in energy norm:  " + sci10(err))
        return err

    def output_results(self, cycle: int):
        """VTU/PVTU/VisIt output (src/step-50.cc:1149-1308), gated by
        cfg.write_vtu; optional fields follow the reference's flags."""
        import jax.numpy as jnp
        from coulomb_gmg.io.vtu import (
            write_vtu, write_pvtu, write_visit_record, nodal_gradient)
        cfg = self.cfg
        f = self.forest
        pos = f.dofs.positions
        # VTU stays vertex-based: higher-degree solutions are restricted to
        # their vertex values for visualization
        from coulomb_gmg.mesh.dofs import restrict_to_vertices
        u_vtx = restrict_to_vertices(f, f.dofs_of(cfg.degree), self.solution)
        point_data = {"solution": u_vtx,
                      "grad_phi": nodal_gradient(f, u_vtx)}
        if cfg.flag_analytical_solution and cfg.problem == "GaussianCharges":
            if self.lammpsinput and self.atoms.n < 10:
                point_data["Analytical_Solution_atoms"] = np.asarray(
                    P.analytic_solution(jnp.asarray(pos),
                                        jnp.asarray(self.atoms.positions),
                                        jnp.asarray(self.atoms.charges),
                                        cfg.r_c))
            elif not self.lammpsinput:
                point_data["Analytical_Solution_without_lammps"] = np.asarray(
                    P.analytic_solution_without_lammps(jnp.asarray(pos),
                                                       cfg.r_c))
        if cfg.flag_rhs_field and self.lammpsinput and self.atoms.n < 10:
            point_data["interpolated_rhs"] = np.asarray(
                P.gaussian_rhs(jnp.asarray(pos), cfg.r_c)
                if cfg.problem == "GaussianCharges"
                else P.step16_rhs(jnp.asarray(pos)))
        owners = (self.spmd.owners(f.n_cells) if self.spmd is not None
                  else np.zeros(f.n_cells, np.int32))
        cell_data = {"subdomain": owners.astype(np.float64)}
        if self.error_per_cell is not None and \
                len(self.error_per_cell) == f.n_cells:
            cell_data["error_indicator"] = self.error_per_cell
        if cfg.flag_atoms_support and self.lammpsinput and \
                cfg.flag_rhs_assembly and self.mask is not None:
            for i in range(self.atoms.n):
                cell_data[f"support_{i}"] = self.mask[:, i].astype(np.float64)
        base = os.path.join(cfg.output_dir, f"solution-{cycle:05d}")
        # one VTU piece per shard with the shard's own cells — the
        # reference's per-rank pieces + master records
        # (src/step-50.cc:1252-1307)
        D = self.spmd.D if self.spmd is not None else 1
        pieces = []
        for d in range(D):
            piece = f"{base}.{d:04d}.vtu"
            cells = np.where(owners == d)[0] if D > 1 else None
            write_vtu(piece, f, point_data, cell_data, cells=cells)
            pieces.append(piece)
        write_pvtu(f"{base}.pvtu", pieces, point_names=list(point_data),
                   cell_names=list(cell_data))
        write_visit_record(f"{base}.visit", pieces)

    # ---------------------------------------------------------------- run

    def run(self):
        cfg = self.cfg
        pc = self.pcout
        from contextlib import nullcontext
        pc(f"Running with JAX/XLA on {len(jax.devices())} device(s)...")
        pc(f"Dimension:\t{cfg.dim}")

        # hybrid placement: default all eager work to the CPU backend; the
        # shape-stable jitted kernels run on the GPU via committed
        # device_put inputs.
        ctx = (jax.default_device(jax.devices("cpu")[0])
               if self.use_bucketed else nullcontext())
        with ctx:
            return self._run_cycles()

    def _run_cycles(self):
        cfg = self.cfg
        pc = self.pcout

        start_cycle = 0
        if cfg.resume_from:
            from coulomb_gmg.utils.checkpoint import load_checkpoint
            (self.forest, self.solution, self.flags, self.mask,
             self.lists, done) = load_checkpoint(cfg.resume_from)
            start_cycle = done + 1
            pc(f"Resuming after cycle {done} from {cfg.resume_from}")

        for cycle in range(start_cycle, cfg.n_adaptive_cycles):
            pc(f"Cycle {cycle}:")
            if cycle == 0:
                self.forest = self.make_initial_mesh()
            else:
                self.refine(cycle)
            pc(f"   Number of active cells:       {self.forest.n_cells}")
            if cycle == 0:
                self.setup(cycle)
            dofs = self.forest.dofs_of(cfg.degree)
            by_level = ", ".join(str(ld.n_dofs) for ld in dofs.levels)
            pc(f"   Number of degrees of freedom: {dofs.n_dofs} "
               f"(by level: {by_level})")
            if cfg.dim == 2 and cfg.write_vtu:
                # gnuplot grid debug is 2D-only in the reference
                # (src/step-50.cc:1542-1543); gate on the same output switch
                # as VTU so test runs stay file-free.
                from coulomb_gmg.io.gnuplot import grid_output_debug
                grid_output_debug(self.forest, self.mask, cycle, cfg.dim,
                                  cfg.output_dir)
            self.assemble_system()
            if cfg.preconditioner == "GMG":
                self.assemble_multigrid()
            self.solve()
            self.estimate_and_mark()
            if cfg.write_vtu:
                self.output_results(cycle)
            cyc = {
                "cycle": cycle,
                "n_cells": self.forest.n_cells,
                "n_dofs": dofs.n_dofs,
                "dofs_by_level": [ld.n_dofs for ld in dofs.levels],
                "cg_iterations": self.cg_iterations,
                "cg_start": self.cg_start,
                "threshold": self.threshold,
                **self.norms,
            }
            if self.lammpsinput and self.atoms.n < 300:
                cyc["energy"] = self.postprocess_energy()
            if self.cfg.problem == "GaussianCharges" and self.lammpsinput:
                cyc["energy_norm_error"] = self.postprocess_energy_norm()
            self.results.append(cyc)
            if cfg.checkpoint_dir:
                from coulomb_gmg.utils.checkpoint import save_checkpoint
                save_checkpoint(os.path.join(
                    cfg.checkpoint_dir, f"ckpt_cycle{cycle:03d}.npz"),
                    self, cycle)

        if cfg.flag_output_time:
            self.timer.summary(pc)
            pc(f"   \nTotal Elapsed wall time for solution: "
               f"{self.timer.total_wall()} seconds.\n")
        return self.results
