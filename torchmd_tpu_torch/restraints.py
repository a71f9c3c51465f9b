"""Restraints as external potentials on torch tensors.

Counterpart of `torchmd_tpu.restraints`: harmonic, flat-bottom and
anisotropic positional restraints, and the GROMACS
[position_restraints], [distance_restraints] and [dihedral_restraints]
records of a topology (`parameters.gmx_posres`, `gmx_distres`,
`gmx_dihres`, present when their #ifdef is active, e.g. an .mdp
`define = -DPOSRES`). Each has `energy_fn(pos, box)`, a torch energy of
one conformation, so it plugs into `Forces(external=...)` (forces by
`torch.autograd`) and composes with other sources through
`external.combine_externals`. Constants are copied to the positions'
device and dtype once and kept.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class _Restraint:
    """Constants kept on the host (float64, int64 indices) and handed out
    on the positions' (device, dtype), copied once per pair."""

    def _store(self, **host):
        self._host = {k: np.asarray(v, np.int64 if k in ("idx", "pairs", "quads")
                                    else np.float64)
                      for k, v in host.items() if v is not None}
        self._cache = {}

    def _consts(self, like):
        key = (like.device, like.dtype)
        if key not in self._cache:
            self._cache[key] = {
                k: torch.as_tensor(v, device=like.device,
                                   dtype=torch.int64 if v.dtype == np.int64 else like.dtype)
                for k, v in self._host.items()}
        return self._cache[key]

    def calculate(self, pos, box):
        from .external import TorchExternal

        return TorchExternal(self.energy_fn).calculate(pos, box)


def _rows(pos, c):
    return pos if "idx" not in c else pos[c["idx"]]


class HarmonicPositionalRestraint(_Restraint):
    """E = sum_i k_i |r_i - r0_i|^2 over the selected atoms."""

    def __init__(self, ref_pos, k, atom_idx=None):
        self._store(ref=ref_pos, k=k, idx=atom_idx)

    def energy_fn(self, pos, box):
        c = self._consts(pos)
        d = _rows(pos, c) - c["ref"]
        return (c["k"] * (d * d).sum(-1)).sum()


class FlatBottomRestraint(_Restraint):
    """Zero within radius r0 of the reference points, k (|d| - r0)^2
    beyond it."""

    def __init__(self, ref_pos, k, r0, atom_idx=None):
        self.r0 = float(r0)
        self._store(ref=ref_pos, k=k, idx=atom_idx)

    def energy_fn(self, pos, box):
        c = self._consts(pos)
        d = torch.sqrt(((_rows(pos, c) - c["ref"]) ** 2).sum(-1) + 1e-24)
        over = torch.clamp(d - self.r0, min=0.0)
        return (c["k"] * over * over).sum()


class AnisotropicPositionalRestraint(_Restraint):
    """Per-axis harmonic restraint, E = sum_i (kx dx^2 + ky dy^2 + kz dz^2):
    the GROMACS [position_restraints] funct 1 form, with its 1/2 and its
    kJ/nm^2 folded into k by the caller."""

    def __init__(self, ref_pos, kvec, atom_idx=None):
        self._store(ref=ref_pos, k=kvec, idx=atom_idx)

    def energy_fn(self, pos, box):
        c = self._consts(pos)
        d = _rows(pos, c) - c["ref"]
        return (c["k"] * d * d).sum()


def make_gromacs_posres(parameters, ref_pos):
    """The restraint of a GROMACS topology's [position_restraints] records
    (`parameters.gmx_posres`, rows (atom, kx, ky, kz)); `ref_pos`
    (natoms, 3) gives the reference coordinates (GROMACS `-r`, normally
    the starting structure). None without records."""
    rec = getattr(parameters, "gmx_posres", None)
    if not rec:
        return None
    idx = np.asarray([r[0] for r in rec], dtype=np.int64)
    k = np.asarray([r[1:4] for r in rec], dtype=np.float64)
    return AnisotropicPositionalRestraint(np.asarray(ref_pos, np.float64)[idx], k,
                                          atom_idx=idx)


class GromacsDistanceRestraint(_Restraint):
    """GROMACS [distance_restraints] funct 1 (instantaneous form):
        r < low        : 1/2 k (r - low)^2
        low <= r <= up1: 0
        up1 < r <= up2 : 1/2 k (r - up1)^2
        r > up2        : 1/2 k (up2 - up1) (2r - up2 - up1)
    Lengths in A, k in kcal/mol/A^2 (per pair, the row's factor applied);
    minimum image in the box."""

    def __init__(self, pairs, low, up1, up2, k):
        self._store(pairs=pairs, low=low, up1=up1, up2=up2, k=k)

    def energy_fn(self, pos, box):
        from .potentials import wrap_displacement

        c = self._consts(pos)
        d = wrap_displacement(pos[c["pairs"][:, 0]] - pos[c["pairs"][:, 1]], box)
        r = torch.sqrt((d * d).sum(-1) + 1e-24)
        low, up1, up2, k = c["low"], c["up1"], c["up2"], c["k"]
        e = torch.where(
            r < low, 0.5 * k * (r - low) ** 2,
            torch.where(r <= up1, torch.zeros_like(r),
                        torch.where(r <= up2, 0.5 * k * (r - up1) ** 2,
                                    0.5 * k * (up2 - up1) * (2.0 * r - up2 - up1))))
        return e.sum()


class GromacsDihedralRestraint(_Restraint):
    """GROMACS [dihedral_restraints] funct 1: flat within +-dphi of phi0,
    1/2 k (|dphi wrapped| - dphi)^2 outside. Radians, k in
    kcal/mol/rad^2."""

    def __init__(self, quads, phi0, dphi, k):
        self._store(quads=quads, phi0=phi0, dphi=dphi, k=k)

    def energy_fn(self, pos, box):
        from .potentials import _dihedral_phi

        c = self._consts(pos)
        diff = _dihedral_phi(pos, c["quads"], box) - c["phi0"]
        diff = diff - 2.0 * math.pi * torch.round(diff / (2.0 * math.pi))
        over = torch.clamp(diff.abs() - c["dphi"], min=0.0)
        return (0.5 * c["k"] * over * over).sum()


def make_gromacs_distres(parameters, fc_kj_nm2=1000.0):
    """The restraint of `parameters.gmx_distres` (rows (i, j, low, up1, up2,
    fac) in A; fac scales the global force constant `fc_kj_nm2`, the .mdp
    disre-fc). None without records."""
    rec = getattr(parameters, "gmx_distres", None)
    if not rec:
        return None
    rec = np.asarray(rec, dtype=np.float64)
    k = rec[:, 5] * fc_kj_nm2 / 4.184 / 100.0
    return GromacsDistanceRestraint(rec[:, :2].astype(np.int64), rec[:, 2], rec[:, 3],
                                    rec[:, 4], k)


def make_gromacs_dihres(parameters):
    """The restraint of `parameters.gmx_dihres` (rows (i, j, k, l,
    phi0_rad, dphi_rad, k_kcal_rad2)). None without records."""
    rec = getattr(parameters, "gmx_dihres", None)
    if not rec:
        return None
    rec = np.asarray(rec, dtype=np.float64)
    return GromacsDihedralRestraint(rec[:, :4].astype(np.int64), rec[:, 4], rec[:, 5],
                                    rec[:, 6])
