"""CHARMM/NAMD DCD trajectory writer + reader.

The port's own copy of `torchmd_tpu.io.dcd`; it imports nothing of the JAX
package.

Binary trajectory interop beyond the reference's npy/xyz outputs: DCD is
the lingua franca consumed by VMD, MDAnalysis and mdtraj. Standard
Fortran-record CHARMM format ('CORD', optional unit cell per frame,
float32 x/y/z blocks).
"""

from __future__ import annotations

import struct

import numpy as np


def _rec(payload: bytes) -> bytes:
    n = struct.pack("<i", len(payload))
    return n + payload + n


class DCDWriter:
    def __init__(self, path: str, natoms: int, timestep_fs: float = 1.0,
                 save_period: int = 1, title: str = "torchmd-tpu"):
        self.path = path
        self.natoms = natoms
        self.nframes = 0
        self._f = open(path, "wb")
        # AKMA timestep as CHARMM stores it
        delta = timestep_fs / 48.88821
        header = struct.pack(
            "<4s9if10i",
            b"CORD",
            0,              # nframes (patched on close)
            1,              # first step
            save_period,    # step interval
            0, 0, 0, 0, 0, 0,
            np.float32(delta),
            1,              # unit cell present
            0, 0, 0, 0, 0, 0, 0, 0,
            24,             # CHARMM version
        )
        self._f.write(_rec(header))
        t = title.encode()[:79].ljust(80)
        self._f.write(_rec(struct.pack("<i", 1) + t))
        self._f.write(_rec(struct.pack("<i", natoms)))
        self._header_end = self._f.tell()

    def write_frame(self, coords, box=None):
        coords = np.asarray(coords, dtype=np.float32)
        if coords.shape != (self.natoms, 3):
            raise ValueError(f"coords must be ({self.natoms}, 3)")
        if box is None:
            box = np.zeros(3)
        box = np.asarray(box, dtype=np.float64).reshape(-1)[:3]
        # CHARMM unit cell record: a, gamma, b, beta, alpha, c (doubles)
        cell = struct.pack("<6d", box[0], 90.0, box[1], 90.0, 90.0, box[2])
        self._f.write(_rec(cell))
        for k in range(3):
            self._f.write(_rec(coords[:, k].tobytes()))
        self.nframes += 1

    def close(self):
        # patch the frame count
        self._f.seek(4 + 4)  # record marker + 'CORD'
        self._f.write(struct.pack("<i", self.nframes))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_dcd(path: str) -> dict:
    """Returns coords (natoms, 3, nframes) and box (3, nframes)."""
    with open(path, "rb") as f:
        data = f.read()

    def rec(off):
        (n,) = struct.unpack_from("<i", data, off)
        payload = data[off + 4: off + 4 + n]
        return payload, off + 8 + n

    hdr, off = rec(0)
    if hdr[:4] != b"CORD":
        raise ValueError("not a DCD file")
    nframes = struct.unpack_from("<i", hdr, 4)[0]
    has_cell = struct.unpack_from("<i", hdr, 44)[0]
    _, off = rec(off)  # titles
    nat, off = rec(off)
    (natoms,) = struct.unpack("<i", nat)

    frames, boxes = [], []
    while off < len(data):
        if has_cell:
            cell, off = rec(off)
            a, _, b, _, _, c = struct.unpack("<6d", cell)
            boxes.append([a, b, c])
        xyz = []
        for _ in range(3):
            comp, off = rec(off)
            xyz.append(np.frombuffer(comp, dtype="<f4"))
        frames.append(np.stack(xyz, axis=1))
    coords = (
        np.stack(frames, axis=2).astype(np.float64)
        if frames else np.zeros((natoms, 3, 0))
    )
    box = np.asarray(boxes).T if boxes else np.zeros((3, 0))
    return {"coords": coords, "box": box, "nframes_header": nframes}
