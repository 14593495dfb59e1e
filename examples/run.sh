#!/usr/bin/env bash
# Launch analogue of the reference's run.sh / jobscript (PBS+mpirun):
# single-program SPMD — device parallelism comes from the JAX mesh,
# not process ranks.
set -euo pipefail
cd "$(dirname "$0")/.."

# golden-parity (host, float64):
python -m coulomb_gmg.cli examples/gaussian-charges.prm --cpu --cycles 6

# GPU (float32, Chebyshev GMG):
# python -m coulomb_gmg.cli examples/gaussian-charges.prm

# the reference's PUBLISHED production scaling study (plain-Kelly marking,
# 1e-8 tolerance; per-cycle cell counts reproduce Plotting/ncells_per_atom.dat
# exactly).  --sizes n runs 8*n^3 atoms; 20 = the 64,000-atom headline:
# JAX_ENABLE_X64=1 python tools/bench_scaling.py --sizes 20 --cycles 5 \
#     --production --dtype float64 --timers

# headline benchmark on one GPU (fails without one), and the smoke test:
# python bench.py
# python chip_smoke.py
