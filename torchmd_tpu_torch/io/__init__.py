from .molecule import Molecule, npzMolecule

__all__ = ["Molecule", "npzMolecule"]
