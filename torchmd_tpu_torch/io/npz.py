"""NPZ molecule loader (minimal NNP input format).

The port's own copy of `torchmd_tpu.io.npz`; it imports nothing of the JAX
package.

Mirrors the behavior of the reference's `torchmd/npzmol.py:5-39`:
loads `z` (atomic numbers) and `coord`, optional `charges`, `bonds`, `box`,
and derives masses/elements from the periodic table. Sets `embedding = z`
for neural-network potentials.
"""

from __future__ import annotations

import numpy as np

from .periodictable import MASS_BY_NUMBER, SYMBOL_BY_NUMBER


def read_npz(path: str) -> dict:
    data = np.load(path)
    z = np.asarray(data["z"])
    coords = np.asarray(data["coord"], dtype=np.float64)
    if coords.ndim == 2:
        coords = coords[:, :, None]
    out = {
        "z": z,
        "coords": coords,
        "embedding": z.copy(),
        "masses": np.array([MASS_BY_NUMBER[int(el)] for el in z], dtype=np.float64),
        "element": np.array([SYMBOL_BY_NUMBER[int(el)] for el in z], dtype=object),
    }
    out["atomtype"] = out["element"].copy()
    out["charge"] = (
        np.asarray(data["charges"], dtype=np.float64)
        if "charges" in data.files
        else np.zeros(len(z), dtype=np.float64)
    )
    out["bonds"] = (
        np.asarray(data["bonds"], dtype=np.int64)
        if "bonds" in data.files
        else np.zeros((0, 2), dtype=np.int64)
    )
    out["box"] = (
        np.asarray(data["box"], dtype=np.float64).reshape(3, -1)
        if "box" in data.files
        else np.zeros((3, 1))
    )
    return out
