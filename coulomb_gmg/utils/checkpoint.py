"""Checkpoint / resume for the adaptive pipeline.

The reference has NO cross-run persistence (SURVEY §5.4: a PBS walltime
kill loses the whole 5h+ run; `Plotting/RELEASE_atoms_Vs_walltime.dat:9`
records an 86,400 s timeout).  Here every adaptive cycle can snapshot the
complete resumable state — mesh topology (level/ijk arrays), the
constraint-distributed solution, the atom-locality state, and the cycle
counter — as one compressed npz; a fresh process resumes at the next
cycle.  Everything else (DoFs, constraints, operators) is deterministic
re-derivation from that state.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_checkpoint(path: str, sim, cycle: int) -> str:
    """Write the cycle snapshot; returns the file path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    f = sim.forest
    payload = dict(
        cycle=np.asarray(cycle),
        dim=np.asarray(f.dim),
        base_reps=np.asarray(f.base_reps),
        lower=np.asarray(f.lower),
        h0=np.asarray(f.h0),
        level=np.asarray(f.level),
        ijk=np.asarray(f.ijk),
        solution=np.asarray(sim.solution),
        flags=np.asarray(sim.flags),
    )
    if sim.mask is not None:
        payload["mask"] = np.asarray(sim.mask)
    if sim.lists is not None:
        payload["lists"] = np.asarray(sim.lists)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str):
    """Returns (forest, solution, flags, mask, lists, cycle)."""
    from coulomb_gmg.mesh.forest import Forest
    with np.load(path, allow_pickle=False) as z:
        f = Forest(dim=int(z["dim"]), base_reps=int(z["base_reps"]),
                   lower=z["lower"], h0=float(z["h0"]),
                   level=z["level"], ijk=z["ijk"])
        return (f, z["solution"], z["flags"],
                z["mask"] if "mask" in z else None,
                z["lists"] if "lists" in z else None,
                int(z["cycle"]))
