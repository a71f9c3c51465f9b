"""GROMACS TRR trajectory reader/writer (pure numpy).

The port's own copy of `torchmd_tpu.io.trr`; it imports nothing of the JAX
package.

New capability beyond the reference: TRR is GROMACS's full-precision
trajectory container (XDR big-endian records; positions/velocities/forces
in nm, nm/ps). Layout follows xdrfile_trr.c's do_trnheader: per frame

    int magic = 1993
    xdr string "GMX_trn_file"   (int len+1, bytes padded to 4)
    int ir_size, e_size, box_size, vir_size, pres_size,
        top_size, sym_size, x_size, v_size, f_size, natoms, step, nre
    real t, lambda              (real = f32 or f64, inferred from sizes)
    [box 3x3] [vir 3x3] [pres 3x3] [x 3N] [v 3N] [f 3N]  (present if size>0)

Everything is converted to the framework's Angstrom conventions
(coordinates A, velocities A/ps). Only rectangular boxes are accepted.
"""

from __future__ import annotations

import struct

import numpy as np

NM2ANG = 10.0
MAGIC = 1993
_TAG = b"GMX_trn_file"


def _xdr_pad(n):
    return (4 - n % 4) % 4


def read_trr(filename):
    """Parse a .trr file -> dict with coords (natoms, 3, nframes) [A],
    box (3, nframes) [A], and optional velocities/forces arrays of the
    same shape ([A/ps], [kcal-free raw kJ/mol/nm left unconverted is
    avoided: forces come back in kcal/mol/A])."""
    with open(filename, "rb") as fh:
        data = fh.read()
    off = 0
    frames_x, frames_v, frames_f, boxes, steps, times = [], [], [], [], [], []

    def geti():
        nonlocal off
        (v,) = struct.unpack_from(">i", data, off)
        off += 4
        return v

    while off < len(data):
        magic = geti()
        if magic != MAGIC:
            raise ValueError(
                f"{filename}: bad TRR magic {magic} at offset {off - 4}"
            )
        slen = geti()
        nbytes = slen - 1 if slen > 0 else 0
        tag = data[off:off + nbytes]
        off += nbytes + _xdr_pad(nbytes)
        if not tag.startswith(b"GMX"):
            raise ValueError(f"{filename}: unexpected TRR tag {tag!r}")
        (ir_size, e_size, box_size, vir_size, pres_size, top_size,
         sym_size, x_size, v_size, f_size, natoms, step, nre) = (
            struct.unpack_from(">13i", data, off)
        )
        off += 52
        # infer real width
        if box_size:
            width = box_size // 9
        elif x_size:
            width = x_size // (natoms * 3)
        else:
            width = 4
        fmt = ">f4" if width == 4 else ">f8"
        t = np.frombuffer(data, fmt, 1, off)[0]
        off += width
        off += width  # lambda
        steps.append(step)
        times.append(float(t))

        def arr(count):
            nonlocal off
            a = np.frombuffer(data, fmt, count, off).astype(np.float64)
            off += count * width
            return a

        if box_size:
            b = arr(9).reshape(3, 3)
            if np.any(np.abs(b - np.diag(np.diag(b))) > 1e-9):
                raise ValueError(
                    f"{filename}: triclinic TRR box; only rectangular "
                    "boxes are supported"
                )
            boxes.append(np.diag(b) * NM2ANG)
        else:
            boxes.append(np.zeros(3))
        if vir_size:
            off += 9 * width
        if pres_size:
            off += 9 * width
        off += ir_size + e_size + top_size + sym_size
        if x_size:
            frames_x.append(arr(natoms * 3).reshape(natoms, 3) * NM2ANG)
        if v_size:
            frames_v.append(arr(natoms * 3).reshape(natoms, 3) * NM2ANG)
        if f_size:
            # kJ/mol/nm -> kcal/mol/A
            frames_f.append(
                arr(natoms * 3).reshape(natoms, 3) / 4.184 / NM2ANG
            )

    out = {
        "coords": (
            np.stack(frames_x, axis=2) if frames_x
            else np.zeros((0, 3, 0))
        ),
        "box": (np.stack(boxes, axis=1) if boxes else np.zeros((3, 0))),
        "step": np.asarray(steps, dtype=np.int64),
        "time": np.asarray(times, dtype=np.float64),
        "velocities": (
            np.stack(frames_v, axis=2) if frames_v else None
        ),
        "forces": (np.stack(frames_f, axis=2) if frames_f else None),
    }
    return out


def write_trr(filename, coords, box=None, velocities=None, forces=None,
              timestep_ps=0.0, double=False):
    """Write frames to .trr. coords (natoms, 3, nframes) in Angstrom;
    box (3, nframes) or (3,) Angstrom diagonal; velocities in A/ps;
    forces in kcal/mol/A."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim == 2:
        coords = coords[:, :, None]
    natoms, _, nframes = coords.shape
    width = 8 if double else 4
    fmt = ">f8" if double else ">f4"

    def reals(a):
        return np.ascontiguousarray(
            np.asarray(a, dtype=np.float64), dtype=np.dtype(fmt)
        ).tobytes()

    with open(filename, "wb") as fh:
        for fr in range(nframes):
            bx = None
            if box is not None:
                b = np.asarray(box, dtype=np.float64)
                bx = b[:, min(fr, b.shape[1] - 1)] if b.ndim == 2 else b
                if not np.any(bx):
                    bx = None
            box_size = 9 * width if bx is not None else 0
            x_size = natoms * 3 * width
            v_size = natoms * 3 * width if velocities is not None else 0
            f_size = natoms * 3 * width if forces is not None else 0
            head = struct.pack(">i", MAGIC)
            head += struct.pack(">i", len(_TAG) + 1) + _TAG
            head += b"\x00" * _xdr_pad(len(_TAG))
            head += struct.pack(
                ">13i", 0, 0, box_size, 0, 0, 0, 0,
                x_size, v_size, f_size, natoms, fr, 0,
            )
            head += reals([fr * timestep_ps, 0.0])
            fh.write(head)
            if bx is not None:
                fh.write(reals(np.diag(bx / NM2ANG)))
            fh.write(reals(coords[:, :, fr] / NM2ANG))
            if velocities is not None:
                v = np.asarray(velocities, dtype=np.float64)
                vf = v[:, :, fr] if v.ndim == 3 else v
                fh.write(reals(vf / NM2ANG))
            if forces is not None:
                f = np.asarray(forces, dtype=np.float64)
                ff = f[:, :, fr] if f.ndim == 3 else f
                fh.write(reals(ff * 4.184 * NM2ANG))
