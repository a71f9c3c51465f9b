"""ASE calculator adapter (the port's counterpart of
`torchmd_tpu.calculators.ase_calc`).

Equivalent of the reference's `torchmd/mycalc.py:11-64` (`MyCalc`): wraps
a `Forces` evaluator so ASE optimizers and dynamics can drive it.
Energies in kcal/mol are converted to eV for ASE and forces to eV/A.
`ase` is imported when a `MyCalc` is made: without it the constructor
raises ImportError naming the package.
"""

from __future__ import annotations

import numpy as np

KCALMOL_TO_EV = 0.04336410390059322


def _ase():
    try:
        from ase.calculators.calculator import Calculator, all_changes
    except ImportError as e:
        raise ImportError(
            "MyCalc needs the 'ase' package (Atomic Simulation Environment), "
            "which is not installed") from e
    return Calculator, all_changes


class MyCalc:
    """ASE Calculator over a torchmd_tpu_torch `Forces` evaluator. An
    instance is an `ase.calculators.calculator.Calculator`: the class is
    built on first use, when `ase` is imported."""

    implemented_properties = ["energy", "forces"]
    _cls = None

    def __new__(cls, evaluator, restart=None, label="torchmd-tpu-torch",
                atoms=None, **kwargs):
        if MyCalc._cls is None:
            MyCalc._cls = _make_class()
        return MyCalc._cls(evaluator, restart=restart, label=label, atoms=atoms,
                           **kwargs)


def _make_class():
    Calculator, all_changes = _ase()

    class _MyCalc(Calculator):
        implemented_properties = ["energy", "forces"]

        def __init__(self, evaluator, restart=None, label="torchmd-tpu-torch",
                     atoms=None, **kwargs):
            Calculator.__init__(self, restart=restart, label=label, atoms=atoms,
                                **kwargs)
            self.evaluator = evaluator

        def calculate(self, atoms=None, properties=("energy",),
                      system_changes=all_changes):
            Calculator.calculate(self, atoms, properties, system_changes)
            if atoms is None:
                atoms = self.atoms
            pos = np.asarray(atoms.get_positions(), dtype=np.float64)[None]
            cell = np.asarray(atoms.get_cell())
            box = np.diag(cell)[None] if cell.size else np.zeros((1, 3))
            epot = self.evaluator.compute(pos, box)
            forces = self.evaluator.last_forces[0].cpu().numpy()
            self.results = {
                "energy": float(epot[0]) * KCALMOL_TO_EV,
                "forces": forces * KCALMOL_TO_EV,
            }

    _MyCalc.__name__ = _MyCalc.__qualname__ = "MyCalc"
    return _MyCalc
