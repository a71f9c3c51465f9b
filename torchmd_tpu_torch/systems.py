"""Simulation state containers.

`System` keeps the reference's mutable container API
(torchmd/systems.py:5-98) exactly as the JAX package does: numpy-backed
pos/vel/forces/box/masses with the same `set_*` semantics and shapes
((nreplicas, natoms, 3) state, (nreplicas, 3, 3) box, diagonal used).
`SimState` is the device-side state the Integrator steps; it is synced
back into `System` once per `step()` call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_PRECISION = {
    "single": np.float32,
    "double": np.float64,
    np.float32: np.float32,
    np.float64: np.float64,
}


def resolve_precision(precision) -> np.dtype:
    """'single'/'double', a numpy dtype or a torch dtype -> numpy dtype."""
    if precision is None:
        return np.dtype(np.float32)
    if isinstance(precision, str):
        return np.dtype(_PRECISION[precision])
    if isinstance(precision, torch.dtype):
        return np.dtype(np.float64 if precision == torch.float64
                        else np.float32)
    return np.dtype(precision)


def torch_dtype(precision) -> torch.dtype:
    """The torch float dtype of a precision spec."""
    return (torch.float64 if resolve_precision(precision) == np.float64
            else torch.float32)


def resolve_device(device) -> torch.device:
    """`device`, or the CUDA card when None. Without a card, None raises:
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless asked otherwise; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def to_numpy(x) -> np.ndarray:
    """numpy view of an array-like, copying a torch tensor to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SimState(NamedTuple):
    """Per-step MD state on the device."""

    pos: torch.Tensor     # (nreplicas, natoms, 3)
    vel: torch.Tensor     # (nreplicas, natoms, 3)
    forces: torch.Tensor  # (nreplicas, natoms, 3)


class System:
    def __init__(self, natoms, nreplicas=1, precision="single", device=None):
        dtype = resolve_precision(precision)
        self.box = np.zeros((nreplicas, 3, 3), dtype=dtype)
        self.pos = np.zeros((nreplicas, natoms, 3), dtype=dtype)
        self.vel = np.zeros((nreplicas, natoms, 3), dtype=dtype)
        self.forces = np.zeros((nreplicas, natoms, 3), dtype=dtype)
        self.masses = np.zeros((natoms, 1), dtype=dtype)
        self.device = device
        self.dtype = dtype

    @property
    def natoms(self):
        return self.pos.shape[1]

    @property
    def nreplicas(self):
        return self.pos.shape[0]

    @property
    def box_diag(self) -> np.ndarray:
        """(nreplicas, 3) rectangular box lengths."""
        return np.stack([np.diag(self.box[r]) for r in range(self.nreplicas)])

    # ------------------------------------------------------------------
    def set_positions(self, pos):
        """Accepts (natoms, 3), (natoms, 3, 1) or (natoms, 3, nreplicas),
        matching the reference (systems.py:42-60)."""
        pos = to_numpy(pos).astype(self.dtype)
        if pos.shape[1] != 3:
            raise RuntimeError(
                f"Positions shape must be (natoms, 3, nreplicas); got {pos.shape}"
            )
        if pos.ndim == 2:
            pos = pos[:, :, None]
        atom_pos = np.transpose(pos, (2, 0, 1))
        if self.nreplicas > 1 and atom_pos.shape[0] != self.nreplicas:
            atom_pos = np.repeat(atom_pos[[0]], self.nreplicas, axis=0)
        self.pos[:] = atom_pos

    def set_velocities(self, vel):
        vel = to_numpy(vel).astype(self.dtype)
        if vel.shape != (self.nreplicas, self.natoms, 3):
            raise RuntimeError("Velocities shape must be (nreplicas, natoms, 3)")
        self.vel[:] = vel

    def set_box(self, box):
        box = to_numpy(box).astype(np.float64)
        if box.ndim == 1:
            if len(box) != 3:
                raise RuntimeError("Box must have at least 3 elements")
            box = box[:, None]
        if box.shape[0] != 3:
            raise RuntimeError("Box shape must be (3, 1) or (3, nreplicas)")
        box = np.swapaxes(box, 1, 0)
        if self.nreplicas > 1 and box.shape[0] != self.nreplicas:
            box = np.repeat(box[[0]], self.nreplicas, axis=0)
        for r in range(min(box.shape[0], self.nreplicas)):
            np.fill_diagonal(self.box[r], box[r].astype(self.dtype))

    def set_forces(self, forces):
        forces = to_numpy(forces).astype(self.dtype)
        if forces.shape != (self.nreplicas, self.natoms, 3):
            raise RuntimeError("Forces shape must be (nreplicas, natoms, 3)")
        self.forces[:] = forces

    def set_masses(self, masses):
        masses = to_numpy(masses).astype(self.dtype).reshape(-1)
        if masses.shape != (self.natoms,):
            raise RuntimeError("Masses shape must be (natoms,)")
        self.masses[:, 0] = masses

    # ------------------------------------------------------------------
    def to_(self, device):  # API parity; storage is host-side numpy
        self.device = device

    def precision_(self, precision):
        dtype = resolve_precision(precision)
        for name in ("box", "pos", "vel", "forces", "masses"):
            setattr(self, name, getattr(self, name).astype(dtype))
        self.dtype = dtype
