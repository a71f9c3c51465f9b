"""Force-field abstract interface and extension-dispatch factory.

Mirrors the reference API surface (torchmd/forcefields/forcefield.py:5-62):
nine getters keyed by atom-type names, plus `ForceField.create(mol, prm)`.

Getter unit conventions (identical to the reference):
  get_bond     -> (k0 [kcal/mol/A^2], req [A])
  get_angle    -> (k0 [kcal/mol/rad^2], theta0 [rad])
  get_dihedral -> list of [phi_k [kcal/mol], phase [rad], per]
  get_improper -> (k, phase [rad], per)  (per == 0 means harmonic)
  get_14       -> (scnb, scee, sigma14_1, eps14_1, sigma14_4, eps14_4)
  get_LJ       -> (sigma [A], epsilon [kcal/mol])
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod


class _ForceFieldBase(ABC):
    @abstractmethod
    def get_atom_types(self):
        ...

    @abstractmethod
    def get_charge(self, at):
        ...

    @abstractmethod
    def get_mass(self, at):
        ...

    @abstractmethod
    def get_LJ(self, at):
        ...

    @abstractmethod
    def get_bond(self, at1, at2):
        ...

    @abstractmethod
    def get_angle(self, at1, at2, at3):
        ...

    @abstractmethod
    def get_dihedral(self, at1, at2, at3, at4):
        ...

    @abstractmethod
    def get_14(self, at1, at2, at3, at4):
        ...

    @abstractmethod
    def get_improper(self, at1, at2, at3, at4):
        ...


class NullForcefield(_ForceFieldBase):
    """Placeholder for runs with no molecular-mechanics terms (external
    potential only). Any parameter lookup raises."""

    def __init__(self, mol):
        self.mol = mol

    def _unavailable(self, *a):
        raise RuntimeError(
            "No force-field file was provided; only external-potential "
            "terms are available."
        )

    get_atom_types = _unavailable
    get_charge = _unavailable
    get_LJ = _unavailable
    get_bond = _unavailable
    get_angle = _unavailable
    get_dihedral = _unavailable
    get_14 = _unavailable
    get_improper = _unavailable

    def get_mass(self, at):
        import numpy as np

        idx = np.where(self.mol.atomtype == at)[0][0]
        return self.mol.masses[idx]


class ForceField:
    """Factory selecting a force-field reader by file extension."""

    @staticmethod
    def create(mol, prm):
        """AMBER and GROMACS files; YAML and CHARMM files raise
        NotImplementedError (their readers come with a later slice)."""
        from .ff_amber import AmberForcefield
        from .ff_gromacs import GromacsForcefield

        if prm is None:
            # No parameter file: valid for external-potential-only runs
            # (e.g. npz + NNP with empty force terms)
            return NullForcefield(mol)
        files = list(prm) if isinstance(prm, (list, tuple)) else [prm]
        exts = {os.path.splitext(str(p))[-1].lower() for p in files}
        if exts & {".prmtop", ".frcmod", ".dat"}:
            # AMBER file set (base .dat + frcmod overlays, tleap-style)
            return AmberForcefield(mol, prm)
        if not isinstance(prm, (list, tuple)) and exts & {".top", ".itp"}:
            return GromacsForcefield(mol, prm)
        if exts & {".yaml", ".yml", ".prm", ".rtf"}:
            raise NotImplementedError(
                f"{sorted(exts)} force fields are not ported yet (ff_yaml and "
                "ff_charmm come with a later slice of the port)")
        raise ValueError(f"Unrecognized force-field file: {prm}")
