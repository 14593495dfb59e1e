"""coulomb_gmg — JAX geometric-multigrid Poisson solver for
long-range Coulomb interactions of Gaussian-smeared point charges.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
deal.II application (see /root/reference, `src/step-50.cc`): h-adaptive Q1 FEM
on structured forest-of-octree meshes, GMG-preconditioned CG with
Jacobi/Chebyshev/colored-SSOR smoothers, Gaussian charge-density RHS assembly
with locality cutoff, dipole-expansion boundary conditions, electrostatic
energy splitting, and SPMD sharding over GPU device meshes.

Nothing here is a translation of the reference's C++: meshes are flat integer
arrays (Morton/SFC ordered), operators are batched closed-form Q1 element
tensors scattered into sparse formats, and everything inside a solve cycle is
a single jitted program per mesh topology.
"""

from coulomb_gmg.config import Config, load_prm, parse_prm_text

__all__ = ["Config", "load_prm", "parse_prm_text"]
__version__ = "0.1.0"
