"""TRIPOS MOL2 reader (atoms, charges, bonds).

The port's own copy of `torchmd_tpu.io.mol2`; it imports nothing of the JAX
package.

The reference reads mol2 through moleculekit (bundled example:
tests/data/benzamidine-amber/mol.mol2); this is the self-contained
equivalent for the sections MD needs.
"""

from __future__ import annotations

import numpy as np


def read_mol2(path: str) -> dict:
    names, types, charges, coords = [], [], [], []
    bonds = []
    section = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            ls = line.strip()
            if ls.startswith("@<TRIPOS>"):
                section = ls[9:].upper()
                continue
            if not ls:
                continue
            if section == "ATOM":
                parts = ls.split()
                names.append(parts[1])
                coords.append([float(parts[2]), float(parts[3]), float(parts[4])])
                types.append(parts[5])
                charges.append(float(parts[8]) if len(parts) > 8 else 0.0)
            elif section == "BOND":
                parts = ls.split()
                bonds.append([int(parts[1]) - 1, int(parts[2]) - 1])

    from .periodictable import element_from_name

    elements = [element_from_name(t.split(".")[0]) for t in types]
    return {
        "name": np.array(names, dtype=object),
        "atomtype": np.array(types, dtype=object),
        "element": np.array(elements, dtype=object),
        "charge": np.array(charges, dtype=np.float64),
        "coords": np.array(coords, dtype=np.float64)[:, :, None],
        "bonds": np.array(bonds, dtype=np.int64).reshape(-1, 2),
    }
