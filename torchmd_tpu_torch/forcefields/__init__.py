from .forcefield import ForceField, _ForceFieldBase

__all__ = ["ForceField", "_ForceFieldBase"]
