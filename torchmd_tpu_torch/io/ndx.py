"""GROMACS index (.ndx) file reader.

The port's own copy of `torchmd_tpu.io.ndx`; it imports nothing of the JAX
package.

Completes the GROMACS analysis workflow: .ndx files carry named atom
groups ("Protein", "SOL", custom selections from gmx make_ndx) used for
energy decomposition and trajectory analysis. Pair with
`analysis.interaction_energies(forces, pos, sel_a=groups["Protein"],
sel_b=groups["LIG"])`.

Format: `[ name ]` section headers followed by whitespace-separated
1-based atom indices over any number of lines (';' comments allowed).
Indices come back 0-based.
"""

from __future__ import annotations

import numpy as np


def read_ndx(filename) -> dict:
    """Parse a .ndx file -> {group_name: (n,) int64 0-based indices}.
    Duplicate group names keep the LAST definition (GROMACS behavior)."""
    groups: dict = {}
    name = None
    acc: list = []

    def flush():
        if name is not None:
            groups[name] = np.asarray(acc, dtype=np.int64) - 1

    with open(filename) as fh:
        for raw in fh:
            line = raw.split(";", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                flush()
                name = line[1:-1].strip()
                acc = []
                continue
            if name is None:
                raise ValueError(
                    f"{filename}: atom indices before any [ group ] header"
                )
            for tok in line.split():
                acc.append(int(tok))
    flush()
    return groups


def write_ndx(filename, groups: dict):
    """Write {name: indices} (0-based) to .ndx (1-based, 15 per line)."""
    with open(filename, "w") as fh:
        for name, idx in groups.items():
            fh.write(f"[ {name} ]\n")
            idx = np.asarray(idx, dtype=np.int64) + 1
            for i in range(0, len(idx), 15):
                fh.write(" ".join(str(v) for v in idx[i:i + 15]) + "\n")
