"""NAMD/ACEMD binary .coor and text .xsc readers.

Covers the restart-product inputs the reference accepts
(torchmd/run.py:171-175, tests/test_torchmd.py:352-359):
  - .coor: int32 natoms followed by natoms*3 float64 coordinates (Angstrom),
    little-endian.
  - .xsc: text; last non-comment line is "step ax ay az bx by bz cx cy cz ..."
    giving the box vectors in Angstrom.
"""

from __future__ import annotations

import struct

import numpy as np


def read_coor(path: str) -> np.ndarray:
    """Returns coords (natoms, 3) float64 in Angstrom."""
    with open(path, "rb") as f:
        data = f.read()
    (natoms,) = struct.unpack("<i", data[:4])
    if len(data) < 4 + natoms * 24:
        # big-endian fallback
        (natoms,) = struct.unpack(">i", data[:4])
        coords = np.frombuffer(data[4 : 4 + natoms * 24], dtype=">f8")
    else:
        coords = np.frombuffer(data[4 : 4 + natoms * 24], dtype="<f8")
    return coords.reshape(natoms, 3).astype(np.float64)


def read_xsc(path: str) -> np.ndarray:
    """Returns box diagonal (3,) in Angstrom from the last data line."""
    box = None
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            if len(vals) >= 10:
                box = np.array([vals[1], vals[5], vals[9]], dtype=np.float64)
    if box is None:
        raise ValueError(f"No extended-system data line found in {path}")
    return box
