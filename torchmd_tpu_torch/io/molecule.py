"""Molecule: self-contained topology + coordinates container (the port's
own copy of `torchmd_tpu.io.molecule`).

Replaces the subset of `moleculekit.molecule.Molecule` that the reference
framework relies on (torchmd/run.py:158-175, tests/test_torchmd.py:346-359):
construction from PSF/PRMTOP/PDB topologies and `.read()` of
PDB/XTC/COOR/XSC coordinate/box inputs.

Conventions (identical to moleculekit where the reference depends on them):
  - coords: (natoms, 3, nframes) float, Angstrom
  - box:    (3, nframes) float, Angstrom box diagonal; zeros mean "no box"
  - charge in units of e; masses in g/mol
  - bonds/angles/dihedrals/impropers: 0-based int index arrays
"""

from __future__ import annotations

import os

import numpy as np


def _queued(fmt):
    raise NotImplementedError(
        f"{fmt} files are not read or written by the port yet; a later slice "
        "brings the xtc/trr/dcd/npz/mol2 readers")


class Molecule:
    def __init__(self, filename: str | None = None):
        self.numAtoms = 0
        self.name = np.zeros(0, dtype=object)
        self.resname = np.zeros(0, dtype=object)
        self.resid = np.zeros(0, dtype=np.int64)
        self.segid = np.zeros(0, dtype=object)
        self.element = np.zeros(0, dtype=object)
        self.atomtype = np.zeros(0, dtype=object)
        self.charge = np.zeros(0, dtype=np.float64)
        self.masses: np.ndarray | None = None
        self.bonds = np.zeros((0, 2), dtype=np.int64)
        self.angles = np.zeros((0, 3), dtype=np.int64)
        self.dihedrals = np.zeros((0, 4), dtype=np.int64)
        self.impropers = np.zeros((0, 4), dtype=np.int64)
        self.crossterms = np.zeros((0, 8), dtype=np.int64)  # CMAP (PSF NCRTERM)
        self.coords = np.zeros((0, 3, 1), dtype=np.float64)
        self.box = np.zeros((3, 1), dtype=np.float64)
        self.crystalinfo = None
        self.embedding = None
        self.prmtop = None  # parsed Prmtop when topology came from one

        if filename is not None:
            self.read(filename)

    # ------------------------------------------------------------------
    def read(self, filename):
        """Read topology or coordinates, dispatching on file extension.
        Accepts a single path or a list of paths (read sequentially)."""
        if isinstance(filename, (list, tuple)):
            for f in filename:
                self.read(f)
            return self

        ext = os.path.splitext(str(filename))[-1].lower()
        if ext == ".psf":
            self._read_psf(filename)
        elif ext == ".prmtop":
            self._read_prmtop(filename)
        elif ext == ".pdb":
            self._read_pdb(filename)
        elif ext in (".xtc", ".trr", ".npz", ".mol2"):
            _queued(ext)
        elif ext == ".coor":
            from .namd import read_coor

            coords = read_coor(filename)
            self._set_coords(coords[:, :, None])
        elif ext == ".xsc":
            from .namd import read_xsc

            self.box = read_xsc(filename).reshape(3, 1)
        elif ext in (".top", ".itp"):
            self._read_gmxtop(filename)
        elif ext == ".gro":
            self._read_gro(filename)
        else:
            raise ValueError(f"Unsupported file extension: {filename}")
        return self

    # ------------------------------------------------------------------
    def _read_psf(self, filename):
        from .psf import read_psf

        d = read_psf(filename)
        self.numAtoms = len(d["name"])
        for k in (
            "name", "resname", "resid", "segid", "atomtype", "charge",
            "masses", "bonds", "angles", "dihedrals", "impropers",
            "crossterms", "element",
        ):
            setattr(self, k, d[k])
        if self.coords.shape[0] != self.numAtoms:
            self.coords = np.zeros((self.numAtoms, 3, 1), dtype=np.float64)

    def _read_prmtop(self, filename):
        from .prmtop import Prmtop
        from .periodictable import SYMBOL_BY_NUMBER, element_from_name

        top = Prmtop(filename)
        self.prmtop = top
        self.numAtoms = top.natoms
        self.name = top.atom_name.copy()
        self.atomtype = top.atomtype.copy()
        self.charge = top.charge.copy()
        self.masses = top.masses.copy()
        self.bonds = top.bonds.copy()
        self.angles = top.angles.copy()
        self.dihedrals = top.dihedrals.copy()
        self.impropers = top.impropers.copy()
        self.element = np.array(
            [
                SYMBOL_BY_NUMBER.get(int(z), element_from_name(str(nm)))
                for z, nm in zip(top.atomic_number, top.atom_name)
            ],
            dtype=object,
        )
        if self.coords.shape[0] != self.numAtoms:
            self.coords = np.zeros((self.numAtoms, 3, 1), dtype=np.float64)

    def _read_pdb(self, filename):
        from .pdb import read_pdb

        d = read_pdb(filename)
        if self.numAtoms == 0:
            # PDB as topology
            self.numAtoms = len(d["name"])
            self.name = d["name"]
            self.resname = d["resname"]
            self.resid = d["resid"]
            self.segid = d["segid"]
            self.element = d["element"]
            if len(self.atomtype) != self.numAtoms:
                self.atomtype = d["element"].copy()
            if len(self.charge) != self.numAtoms:
                self.charge = np.zeros(self.numAtoms, dtype=np.float64)
            self.bonds = d["bonds"]
        self.crystalinfo = d["crystalinfo"] or self.crystalinfo
        self._set_coords(d["coords"])

    def _read_gmxtop(self, filename):
        """GROMACS topology (.top/.itp): atoms, connectivity and the
        bonded-term index lists (parameters are assembled separately by
        forcefields.ff_gromacs.GromacsForcefield)."""
        from ..forcefields.ff_gromacs import load_gmx_top
        from .periodictable import element_from_name

        top, arr = load_gmx_top(filename)
        self.numAtoms = arr["natoms"]
        self.atomtype = arr["atomtype"]
        self.charge = arr["charge"]
        self.masses = arr["masses"]
        self.name = arr["name"]
        self.resname = arr["resname"]
        self.resid = arr["resid"]
        self.segid = np.array(
            [f"M{int(m)}" for m in arr["molid"]], dtype=object
        )
        self.element = np.array(
            [element_from_name(str(nm)) for nm in arr["name"]], dtype=object
        )
        # connectivity for wrapping/constraints: bonds + constraints +
        # settle triangles
        edges = [tuple(b) for b in arr["bond_idx"]]
        edges += [(i, j) for i, j, _f, _b in arr["constraints_full"]]
        for o, h1, h2, _doh, _dhh in arr["settles_full"]:
            edges += [(o, h1), (o, h2), (h1, h2)]
        for idx, _nk, _funct, _prm in arr["vsites_full"]:
            # site-host edge keeps virtual sites in their molecule's
            # group for PBC wrapping
            edges.append((idx[0], idx[1]))
        self.bonds = (
            np.unique(
                np.sort(np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                        axis=1), axis=0,
            )
            if edges else np.zeros((0, 2), np.int64)
        )
        self.angles = arr["angle_idx"]
        self.dihedrals = arr["dih_idx"]
        self.impropers = arr["impr_idx"]
        if self.coords.shape[0] != self.numAtoms:
            self.coords = np.zeros((self.numAtoms, 3, 1), dtype=np.float64)

    def _read_gro(self, filename):
        from .gro import read_gro

        d = read_gro(filename)
        if self.numAtoms == 0:
            self.numAtoms = len(d["name"])
            self.name = d["name"]
            self.resname = d["resname"]
            self.resid = d["resid"]
            from .periodictable import element_from_name

            self.element = np.array(
                [element_from_name(str(nm)) for nm in d["name"]],
                dtype=object,
            )
            if len(self.atomtype) != self.numAtoms:
                self.atomtype = self.element.copy()
            if len(self.charge) != self.numAtoms:
                self.charge = np.zeros(self.numAtoms, dtype=np.float64)
        self._set_coords(d["coords"])
        if np.any(d["box"]):
            self.box = d["box"]
        if d["velocities"] is not None:
            self.velocities = d["velocities"]

    def _set_coords(self, coords):
        coords = np.asarray(coords, dtype=np.float64)
        if coords.ndim == 2:
            coords = coords[:, :, None]
        if self.numAtoms == 0:
            self.numAtoms = coords.shape[0]
        if coords.shape[0] != self.numAtoms:
            raise ValueError(
                f"Coordinate atom count {coords.shape[0]} != topology {self.numAtoms}"
            )
        self.coords = coords

    # ------------------------------------------------------------------
    def write(self, filename, frame=None):
        """Write coordinates/topology, dispatching on extension
        (.pdb single frame, .xyz / .dcd all frames or `frame`) --
        the moleculekit `mol.write` surface the reference relies on."""
        ext = os.path.splitext(str(filename))[-1].lower()
        if ext == ".pdb":
            from .pdb import write_pdb

            write_pdb(filename, self, frame=frame or 0)
        elif ext == ".xyz":
            frames = (
                range(self.nframes) if frame is None else [frame]
            )
            with open(filename, "w") as fh:
                for fidx in frames:
                    fh.write(f"{self.numAtoms}\n\n")
                    el = (
                        self.element
                        if len(self.element) == self.numAtoms
                        else ["X"] * self.numAtoms
                    )
                    for e, xyz in zip(el, self.coords[:, :, fidx]):
                        fh.write(
                            f"{e} {xyz[0]:.6f} {xyz[1]:.6f} {xyz[2]:.6f}\n"
                        )
        elif ext in (".dcd", ".xtc", ".trr"):
            _queued(ext)
        elif ext == ".gro":
            from .gro import write_gro

            write_gro(filename, self, frame=frame or 0)
        else:
            raise ValueError(f"Unsupported output extension: {filename}")
        return self

    @property
    def nframes(self) -> int:
        return self.coords.shape[2]

    def dropFrames(self, keep=0):
        keep = [keep] if np.isscalar(keep) else list(keep)
        self.coords = self.coords[:, :, keep]
        if self.box.shape[1] > 1:
            self.box = self.box[:, keep]


class npzMolecule(Molecule):
    """Convenience alias mirroring the reference's npzMolecule entry point
    (torchmd/npzmol.py:5)."""

    def __init__(self, file: str):
        super().__init__(file)
