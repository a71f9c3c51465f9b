"""Reference-name alias: `from torchmd_tpu_torch.npzmol import npzMolecule`
(mirrors torchmd/npzmol.py)."""

from .io.molecule import npzMolecule

__all__ = ["npzMolecule"]
