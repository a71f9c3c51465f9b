"""Physical constants and unit conventions (ACEMD/CHARMM style).

Units across the framework: energies in kcal/mol, distances in Angstrom,
temperatures in Kelvin, masses in g/mol, timesteps in femtoseconds.
Internal integrator time unit is the AKMA unit (1 AKMA time = 48.88821 fs),
so dt_internal = dt_fs / TIMEFACTOR.

Parity notes (reference TorchMD):
  - TIMEFACTOR / BOLTZMANN: torchmd/integrator.py:4-5
  - ELEC_FACTOR derivation from CODATA constants: torchmd/forces.py:375-378
"""

from __future__ import annotations

# AKMA time conversion: femtoseconds per internal time unit.
TIMEFACTOR = 48.88821

# Boltzmann constant in kcal/mol/K.
BOLTZMANN = 0.001987191
# Alias matching the reference's (misspelled) public name.
BOLTZMAN = BOLTZMANN

# Internal time units per picosecond.
PICOSEC2TIMEU = 1000.0 / TIMEFACTOR

FS2NS = 1e-6


def _elec_factor() -> float:
    """Coulomb's constant in kcal*Angstrom/(mol*e^2), from CODATA constants."""
    try:
        from scipy import constants as const

        f = 1.0 / (4 * const.pi * const.epsilon_0)
        f *= const.elementary_charge**2
        f /= const.angstrom
        f *= const.Avogadro / (const.kilo * const.calorie)
        return float(f)
    except Exception:
        # CODATA-2018 value of the expression above.
        return 332.0637132991921


ELEC_FACTOR = _elec_factor()
