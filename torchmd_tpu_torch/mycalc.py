"""Reference-name alias: `from torchmd_tpu_torch.mycalc import MyCalc`
(mirrors torchmd/mycalc.py). `MyCalc` needs the `ase` package."""

from .calculators.ase_calc import MyCalc

__all__ = ["MyCalc"]
